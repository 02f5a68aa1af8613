from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm"]
