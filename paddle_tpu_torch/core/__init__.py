"""Core pieces of the port shared by its layers: the framework's global
random key stream (``rng``)."""
from .rng import get_seed, next_key, seed

__all__ = ["get_seed", "next_key", "seed"]
