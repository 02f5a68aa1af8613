"""Surface checks of the port (metrics and HTTP), runnable with
``python -m paddle_tpu_torch.tools.<name>``."""
