"""fleet.utils: activation recompute and the hybrid-parallel gradient and
parameter helpers (``sequence_parallel_utils`` stays with ROADMAP Queue 1
item 10(e))."""
from . import hybrid_parallel_util, recompute_mod
from .recompute_mod import recompute, recompute_sequential

__all__ = ["hybrid_parallel_util", "recompute_mod", "recompute",
           "recompute_sequential"]
