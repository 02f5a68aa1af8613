"""fleet.utils: the hybrid-parallel gradient and parameter helpers
(recompute and the sequence-parallel helpers stay with ROADMAP Queue 1
item 10(e))."""
from . import hybrid_parallel_util

__all__ = ["hybrid_parallel_util"]
