"""fleet's layers: the model-parallel ones (``mpu``)."""
