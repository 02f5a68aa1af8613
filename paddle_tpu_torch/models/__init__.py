from . import gpt, llama

__all__ = ["gpt", "llama"]
