"""paddle.DataParallel. Counterpart of
``paddle_tpu/framework/layer_helpers.py``.

At wrap time the model's parameters and floating buffers are broadcast
from the group's first rank (the reference's ``sync_params_buffers``),
so ranks built from different seeds start equal. After each backward the
gradients are mean all-reduced over the group in 25 MB buckets by the
``communication.reducer`` hooks: one all-reduce a bucket a backward.
Under ``no_sync()`` they accumulate locally; the next backward outside
it, or ``apply_gradients()``, reduces what has accumulated.
"""
from __future__ import annotations

import contextlib

import torch.nn as nn

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    """``layers`` data-parallel over ``group`` (a ``Group`` or torch
    ProcessGroup; default every process). ``comm_buffer_size`` is the
    bucket size in MB; ``strategy``, ``last_comm_buffer_size`` and
    ``find_unused_parameters`` are taken and unused (a parameter without
    a gradient sends zeros and keeps None)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from ..distributed.communication.group import as_group
        from ..distributed.communication.ops import _sync_model
        from ..distributed.communication.reducer import (Entry, Reducer,
                                                         reduced_by_hooks)
        self._layers = layers
        self.group = as_group(group)
        params = [p for p in layers.parameters() if p.requires_grad]
        if any(reduced_by_hooks(p) for p in params):
            raise ValueError(
                "DataParallel: the model's gradients are already reduced "
                "by another wrapper (GroupSharded or DataParallel); a "
                "second one would average them twice")
        _sync_model(layers, self.group)
        self._reducer = Reducer([Entry(p) for p in params], self.group,
                                cap_bytes=int(comm_buffer_size * 2 ** 20))

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def no_sync(self):
        @contextlib.contextmanager
        def ctx():
            self._reducer.enabled = False
            try:
                yield
            finally:
                self._reducer.enabled = True
        return ctx()

    def apply_gradients(self):
        """Reduce the gradients accumulated under ``no_sync`` now (nothing
        if the last backward reduced them)."""
        if not self._reducer.synced:
            self._reducer.sync_now()

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)
