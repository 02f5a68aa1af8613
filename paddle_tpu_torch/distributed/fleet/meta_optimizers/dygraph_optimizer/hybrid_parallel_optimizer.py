"""Hybrid-parallel optimizer and grad scaler. Counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py``.

``HybridParallelOptimizer`` wraps the user's optimizer for the fleet
topology: under a sharding degree above 1 it steps through stage 1
(``DygraphShardingOptimizer``), unless it is already a GroupSharded
optimizer; its ``step`` mean-all-reduces over the dp group the
gradients that no reducer owns (``DataParallel`` and the GroupSharded
stages reduce theirs after backward, and a second mean would count only
in the collectives). A global-norm clip needs no wrapper: ``nn.clip``
sums the shards' squared-norm partials over their sharding group, the
mp slices' over their model-parallel group (a parameter replicated over
mp counted once) and each stage's total over the pipe group (a shared
weight once).
``HybridParallelGradScaler`` steps the wrapped optimizer; its found-inf
flag is the MAX over every process (``amp.GradScaler`` takes it so
wherever more than one process trains or a shard is stepped), so every
rank skips the same step.
"""
from __future__ import annotations

__all__ = ["HybridParallelOptimizer", "HybridParallelGradScaler"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        from ...meta_parallel.sharding.group_sharded import \
            DygraphShardingOptimizer
        # a stage-3 optimizer already steps shards (its parameters carry
        # _shard_info): it is not wrapped again
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1 \
                and not isinstance(optimizer, DygraphShardingOptimizer) \
                and not any(getattr(p, "_shard_info", None) is not None
                            for _, p in optimizer._params):
            optimizer = DygraphShardingOptimizer(optimizer, hcg)
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @property
    def _learning_rate(self):
        return self._inner_opt._learning_rate

    def step(self):
        if self._hcg is not None and \
                self._hcg.get_data_parallel_world_size() > 1:
            from ....communication.reducer import reduced_by_hooks
            from ...utils.hybrid_parallel_util import \
                fused_allreduce_gradients
            own = [p for _, p in self._inner_opt._params
                   if not reduced_by_hooks(p)]
            fused_allreduce_gradients(own, self._hcg)
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None


class HybridParallelGradScaler:
    """``scaler`` over the hybrid topology: ``step`` steps ``optimizer``
    itself (a ``HybridParallelOptimizer``, so its dp reduction runs; JAX
    steps the inner one, whose dp gradients XLA has reduced)."""

    def __init__(self, scaler, hcg):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, item):
        return getattr(self._scaler, item)

    def scale(self, var):
        return self._scaler.scale(var)

    def step(self, optimizer):
        self._scaler.step(optimizer)

    def update(self):
        self._scaler.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
