"""paddle.framework: ``save`` / ``load`` and ``DataParallel``.
Counterpart of ``paddle_tpu/framework/``."""
from .io import load, save
from .layer_helpers import DataParallel

__all__ = ["save", "load", "DataParallel"]
