"""Serving path of the port: the engine and the decoder it drives."""
from .generation import FusedDecoder
from .serving import ServingEngine

__all__ = ["FusedDecoder", "ServingEngine"]
