from . import functional
from .layer.common import Dropout, Embedding, Linear
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm",
           "functional"]
