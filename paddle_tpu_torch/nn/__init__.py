from .layer.common import Embedding, Linear

__all__ = ["Embedding", "Linear"]
