"""Activation recompute. Counterpart of
``paddle_tpu/distributed/fleet/utils/recompute_mod.py`` (Paddle's
``fleet.utils.recompute`` / ``recompute_sequential`` /
``RecomputeFunction``).

Built on ``torch.utils.checkpoint`` (``use_reentrant=False``): the
forward keeps no activation of ``function`` but its inputs, and the
backward runs ``function`` again with gradients on. PyTorch's
``preserve_rng_state`` restores only its global CPU and CUDA generators;
the port draws every dropout mask and attention-dropout seed on the host
from an explicit CPU ``torch.Generator`` (``nn.functional.common``) and
samples from ``core.rng``'s key stream. So with ``preserve_rng_state``
(the default) the states of every generator held by the modules that
``function`` belongs to (a module, a bound method of one, or a
``functools.partial`` of either), and the global key, are taken before
the forward and put back for the recomputation, then restored: the
recomputed block draws the masks the forward drew, as JAX's snapshot of
its key makes it (JAX ``recompute_mod.py:34, 47, 63``).

Under a GroupSharded stage 3 the recomputed modules' pre-hooks gather
their parameters again in backward: one all-gather more a sharded
parameter of a recomputed module, and no reduce-scatter more (the
gradient flows through the forward's gather). The recomputation is not
stopped early (``set_checkpoint_early_stop(False)``), so every module's
forward hooks run to their end.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ....core import rng as core_rng

__all__ = ["recompute", "recompute_sequential", "RecomputeFunction"]


def _owners(function):
    """The modules ``function`` belongs to."""
    while isinstance(function, functools.partial):
        function = function.func
    owner = function if isinstance(function, nn.Module) else getattr(
        function, "__self__", None)
    return [owner] if isinstance(owner, nn.Module) else []


def _generators(function):
    """Every ``torch.Generator`` an attribute of the owners' modules holds,
    once each."""
    seen = {}
    for owner in _owners(function):
        for mod in owner.modules():
            for v in vars(mod).values():
                if isinstance(v, torch.Generator):
                    seen.setdefault(id(v), v)
    return list(seen.values())


class _RngSnapshot:
    """The generators' states and the global key at the forward, put back
    for the recomputation."""

    def __init__(self, gens):
        self.gens = gens
        self.states = self.key = None

    @contextlib.contextmanager
    def take(self):
        self.states = [g.get_state() for g in self.gens]
        self.key = core_rng.get_rng_state().clone()
        yield

    @contextlib.contextmanager
    def replay(self):
        now = [g.get_state() for g in self.gens]
        now_key = core_rng.get_rng_state()
        for g, s in zip(self.gens, self.states):
            g.set_state(s)
        core_rng.set_rng_state(self.key.clone())
        try:
            yield
        finally:
            for g, s in zip(self.gens, now):
                g.set_state(s)
            core_rng.set_rng_state(now_key)


def recompute(function: Callable, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in
    backward. ``preserve_rng_state`` (default True) and
    ``use_reentrant`` (taken; the port is always non-reentrant) are
    Paddle's keywords and are not passed on."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    run = functools.partial(function, **kwargs) if kwargs else function
    kw = {}
    if preserve:
        snap = _RngSnapshot(_generators(function))
        kw["context_fn"] = lambda: (snap.take(), snap.replay())
    # the recomputation runs to the function's end: stopped early, a
    # module's forward hooks would not finish (stage 3's post-hook puts
    # the parameter at rest back)
    with set_checkpoint_early_stop(False):
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=preserve, **kw)


class RecomputeFunction:
    @staticmethod
    def apply(function, *args, **kwargs):
        return recompute(function, *args, **kwargs)


def recompute_sequential(ctx, functions, *args):
    """``functions`` (a sequence of layers, or a module whose children are
    its layers) applied in turn, cut into ``ctx["segments"]`` (default
    1) equal runs, each recomputed."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = (list(functions.children()) if isinstance(functions, nn.Module)
              else list(functions))
    parts = np.array_split(np.arange(len(layers)), segments)
    out = args[0] if len(args) == 1 else args

    for part in parts:
        out = recompute(nn.Sequential(*(layers[i] for i in part)), out)
    return out
