"""paddle.distributed.all_reduce. Counterpart of
``paddle_tpu/distributed/communication/all_reduce.py``: SUM, MAX, MIN,
PROD and AVG in place over the group (``ops`` counts the call)."""
from __future__ import annotations

from .group import ReduceOp, as_group
from .ops import _all_reduce

__all__ = ["all_reduce"]


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    return _all_reduce(tensor, op, as_group(group), sync_op)
