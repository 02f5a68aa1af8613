"""Dynamic loss scaling. Counterpart of ``paddle_tpu/amp/grad_scaler.py``.

The JAX package's rule: the loss is multiplied by the scale; before the
optimizer steps, every gradient is unscaled in fp32 and rounded back to
its dtype, and a step whose gradients hold an inf or a NaN is skipped.
``update`` then halves the scale (``decr_ratio``, floored at 1) after
``decr_every_n_nan_or_inf`` such steps in a row, or doubles it
(``incr_ratio``) after ``incr_every_n_steps`` finite ones. The finite
checks of all gradients fold into one flag on the device, read once a
step (the one host sync: whether to step). Where the optimizer steps shards (the GroupSharded stages) or
more than one process trains, the flag is the MAX over every process, so
that every rank skips the same step.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler", "OptimizerState"]


class OptimizerState:
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


def _over_world(optimizer) -> bool:
    """Whether the found-inf flag is taken over every process: more than
    one process trains, or the optimizer steps a shard."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return False
    return dist.get_world_size() > 1 or any(
        getattr(p, "_shard_info", None) is not None
        for _, p in optimizer._params)


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_states: dict[int, int] = {}

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def _check_finite_and_unscale(self, optimizer) -> bool:
        inv = 1.0 / self._scale
        finite = []
        for _, p in optimizer._params:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            finite.append(torch.isfinite(g).all())
            p.grad.copy_(g)
        if not finite:
            return False
        bad = (~torch.stack(finite).all()).float()
        if _over_world(optimizer):
            from ..distributed.communication.all_reduce import all_reduce
            from ..distributed.communication.group import ReduceOp
            all_reduce(bad, op=ReduceOp.MAX)
        return bool(bad.item())

    def unscale_(self, optimizer):
        if not self._enable:
            return
        if self._opt_states.get(id(optimizer)) == OptimizerState.UNSCALED:
            return
        self._found_inf = self._check_finite_and_unscale(optimizer)
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._opt_states.get(id(optimizer)) != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._opt_states.clear()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "enable": self._enable,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
