from .layer import FusedMultiTransformer

__all__ = ["FusedMultiTransformer"]
