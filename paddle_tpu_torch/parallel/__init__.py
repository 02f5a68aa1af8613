"""paddle_tpu_torch.parallel — context parallelism over the hybrid mesh.

Counterpart of ``paddle_tpu/parallel/__init__.py``'s ``current_mesh`` and
its context-parallel exports (``parallel/context_parallel.py``). The rest
of that module (``apply_shardings``, ``shard_batch``,
``init_serving_mesh``, ...) stays with ROADMAP Queue 1 items 8 and 10(e).
"""
from __future__ import annotations

from .context_parallel import (make_ring_attention_fn,
                               make_ulysses_attention_fn, ring_attention,
                               ulysses_attention)

__all__ = ["current_mesh", "ring_attention", "ulysses_attention",
           "make_ring_attention_fn", "make_ulysses_attention_fn"]


def current_mesh():
    """The active hybrid mesh (a ``DeviceMesh`` with axes pp, dp,
    sharding, sep, mp) that ``fleet.init`` built, or None."""
    from ..distributed.fleet.base.topology import _HYBRID_GROUP
    hcg = _HYBRID_GROUP[0]
    return hcg.mesh if hcg is not None else None
