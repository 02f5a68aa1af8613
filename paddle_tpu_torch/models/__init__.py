from . import gpt

__all__ = ["gpt"]
