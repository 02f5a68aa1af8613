from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear"]
