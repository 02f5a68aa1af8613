"""Serving path of the port: the engine, the decoder it drives, and
their host pieces (the block pool, the prefix caches, the n-gram
drafter)."""
from .generation import FusedDecoder
from .paged_kv import BlockPool, PagedPrefixCache, PagedPrefixStore
from .prefix_cache import PrefixCache, PrefixStore
from .serving import ServingEngine
from .spec_decode import NGramDrafter

__all__ = ["FusedDecoder", "ServingEngine", "PrefixCache", "PrefixStore",
           "NGramDrafter", "BlockPool", "PagedPrefixCache",
           "PagedPrefixStore"]
