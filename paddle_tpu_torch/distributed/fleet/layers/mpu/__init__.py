"""fleet's model-parallel layers, their collectives and the model-parallel
random stream. Counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/__init__.py``."""
