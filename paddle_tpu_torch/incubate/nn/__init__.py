from . import functional
from .layer import FusedFeedForward, FusedMultiTransformer

__all__ = ["FusedFeedForward", "FusedMultiTransformer", "functional"]
