"""GroupSharded (ZeRO) stages 1/2/3 over a ``torch.distributed`` process
group. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding/group_sharded.py``.

JAX realises sharding as placement on a GSPMD mesh and lets XLA insert
the collectives; here every rank is a process, so the reductions,
scatters and gathers are explicit. The layout is JAX's
(``shard_spec_for``, filtered as ``parallel._valid_spec`` filters it):
a tensor is split along its largest axis into ``N`` equal chunks (``N``
the sharding group's size) and rank ``r`` of the group holds chunk
``r``, a tensor of JAX's per-device shard shape; a tensor whose largest
axis does not divide by ``N`` (or a 0-d one) stays whole on every rank.

Stage 1 (``DygraphShardingOptimizer``, "os"): the optimizer steps one
shard tensor per sharded parameter (its accumulators and, under AMP O2,
its fp32 master are created at the shard's shape); the shards of a
gradient bucket are views of one flat buffer
(``communication.reducer``'s rank-major layout); the gradients are mean
all-reduced whole after backward and each shard takes its chunk; after
the step each bucket's parameters are all-gathered back from that
buffer. Stage 2 (``GroupShardedOptimizerStage2`` +
``GroupShardedStage2``, "os_g"): the same, but each bucket's gradients
are reduce-scattered into the shards' (views of the returned row), so
between backward and step a rank holds 1/N of each and the parameter
none. Stage 3 (``GroupShardedStage3``, "p_g_os"): each sharded parameter
rests as its shard (the module's parameter keeps its shape, dtype and
device over a one-element stride-0 placeholder). A forward pre-hook on
each module that owns one all-gathers it (``_GatherParam``) for the
module's forward, a post-hook puts the placeholder back, and a
torch-function mode gathers it for any other read (BERT's MLM decoder
reads the word embedding outside its module). Saved for backward, a
gathered parameter is packed as a token (``saved_tensors_hooks``) and
gathered again when backward unpacks it, so no full copy outlives the op
that uses it; ``_GatherParam``'s backward reduce-scatters the gradient
into the shard's. Replicated parameters of every stage are mean
all-reduced. Under a dp group of more than one rank every reduced
gradient (or shard) is then all-reduced over it too, and the mean is
over the sharding times the dp ranks, the ranks that consume distinct
data (``parallel.data_spec``).

Under fleet's model-parallel layers each rank's parameter is its mp
slice; a stage splits it over the sharding group along the axis
``augment_spec_for`` adds to its ``sharding_spec`` (the largest axis the
mp split leaves free that divides, JAX's choice on the logical shape;
``sharded_axis``), so a rank rests 1/(mp sharding) of it, and a Column
bias, whose one axis mp takes, stays whole over sharding. Under a
pipeline the groups are the stage's and the stage's parameters are what
a stage shards. A model run unwrapped (a pipeline's stage, or
``fleet.distributed_model`` on the inner model) runs under the same
stage-3 forward context (``stage3_forward``; the model carries it), and
its replicated gradients' reducer lives as long as the model.

Collectives a step issues (``COLLECTIVES``; ``b_s`` / ``b_r`` the
buckets of the sharded / replicated parameters, ``communication.
reducer.bucket_plan`` at 32 MB; ``dp`` 1 where the dp group has more
than one rank, else 0):

- "os":   all_reduce (b_s + b_r)(1 + dp), all_gather b_s;
- "os_g": reduce_scatter b_s, all_reduce b_s dp + b_r (1 + dp),
          all_gather b_s;
- "p_g_os": all_gather one per module forward per sharded parameter it
          owns plus one per other read, and one per saved view unpacked
          in backward; reduce_scatter one per gather of the forward, each
          with an all_reduce where dp; all_reduce b_r (1 + dp); all
          per backward: with M micro-batches a step, M times, and
          under recompute one more all_gather a micro-batch for each
          sharded parameter of a recomputed module (its saved views are
          the recomputation's, made outside the saved-tensor hooks, and
          are not gathered again);

plus, in any stage, one all_reduce for ``ClipGradByGlobalNorm`` /
``ClipGradByNorm`` (the shards' squared-norm partials), one for a
``GradScaler``'s found-inf flag (its MAX over every process), and two
per sharded parameter for ``Lamb``'s trust ratio and up to four for
``Adafactor``'s means (their partials summed over the group:
``optimizer.optimizer`` reads the shard's ``_shard_info``).
``sharding_step_counts`` computes the stage-1/2 line.

``offload=True`` raises at every level, as in JAX; ``buffer_max_size``
and ``sync_buffers`` are taken and ignored with one warning a process
(the buckets are 32 MB; buffers are broadcast at wrap time).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn as nn
from torch.overrides import TorchFunctionMode

from ....communication.group import ReduceOp, as_group
from ....communication.ops import (_all_gather_flat, _all_reduce,
                                   _reduce_scatter_flat, _sync_from_first,
                                   _sync_model)
from ....communication.reducer import (Entry, Reducer, shard_axis,
                                       shard_leaf)

__all__ = ["GroupShardedStage2", "GroupShardedStage3",
           "GroupShardedOptimizerStage2", "DygraphShardingOptimizer",
           "shard_spec_for", "augment_spec_for",
           "annotate_optimizer_sharding", "sharding_step_counts",
           "gather_optimizer_state", "sharded_axis", "stage3_forward"]


def shard_spec_for(t, axis_name: str = "sharding"):
    """JAX's rule: ``axis_name`` on the largest axis (a tuple spec), None
    for a 0-d tensor."""
    shape = tuple(t.shape)
    if not shape:
        return None
    ax = max(range(len(shape)), key=lambda i: shape[i])
    spec = [None] * len(shape)
    spec[ax] = axis_name
    return tuple(spec)


def augment_spec_for(t, axis_name: str = "sharding", *, degree=None):
    """``t.sharding_spec`` (if any) with ``axis_name`` added on the largest
    axis it leaves free that divides by ``degree`` (default the active
    mesh's degree of ``axis_name``); None where no axis is free. The
    free axes are whole in an mp slice, so the choice is JAX's on the
    logical shape."""
    shape = tuple(t.shape)
    if not shape:
        return None
    prior = getattr(t, "sharding_spec", None)
    prior = list(prior) if prior is not None else [None] * len(shape)
    prior += [None] * (len(shape) - len(prior))
    if degree is None:
        from .....parallel import current_mesh, mesh_degree
        degree = mesh_degree(current_mesh(), axis_name)
    free = [i for i in range(len(shape))
            if prior[i] is None and shape[i] % degree == 0]
    if not free:
        return None
    prior[max(free, key=lambda i: shape[i])] = axis_name
    return tuple(prior)


def sharded_axis(p, degree):
    """The axis along which a GroupSharded stage splits ``p`` over
    ``degree`` ranks, as JAX places it: a parameter of fleet's
    model-parallel layers (it carries a ``sharding_spec``) on the axis
    ``augment_spec_for`` adds, any other by ``shard_axis`` (the largest,
    where it divides); None where it stays whole."""
    if getattr(p, "sharding_spec", None) is None:
        return shard_axis(p.shape, degree)
    spec = augment_spec_for(p, degree=degree)
    return None if spec is None else spec.index("sharding")


def annotate_optimizer_sharding(optimizer, axis_name: str = "sharding"):
    """Mark ``optimizer``'s accumulators and masters with their
    ``shard_spec_for`` spec, as JAX does (an annotation: the sharded
    state itself is ``DygraphShardingOptimizer``'s)."""
    optimizer._sharding_axis = axis_name
    tensors = [t for slot in optimizer._accumulators.values()
               for t in slot.values() if isinstance(t, torch.Tensor)]
    for t in tensors + list(optimizer._master_weights.values()):
        if getattr(t, "sharding_spec", None) is None and t.dim() > 0:
            t.sharding_spec = shard_spec_for(t, axis_name)
    return optimizer


# ----------------------------------------------------------------- helpers
def _make_shard(p, axis, group):
    """This rank's chunk of ``p`` along ``axis``, a copy: a leaf of JAX's
    shard shape with ``p``'s optimizer attributes and a
    ``_shard_info``."""
    c = p.shape[axis] // group.nranks
    return shard_leaf(p, p.detach().narrow(axis, group.rank * c, c).clone(),
                      axis, group)


def _default_groups(group, dp_group):
    """(sharding ``Group``, dp ``Group`` or None): ``group`` or the fleet
    topology's sharding group (else every process); ``dp_group`` or the
    topology's dp group where its degree is above 1."""
    from ...base.topology import _HYBRID_GROUP
    hcg = _HYBRID_GROUP[0]
    if group is None and hcg is not None:
        group = hcg.get_sharding_parallel_group()
    if dp_group is None and hcg is not None and \
            hcg.get_data_parallel_world_size() > 1:
        dp_group = hcg.get_data_parallel_group()
    return as_group(group), (None if dp_group is None
                             else as_group(dp_group))


def _shard_optimizer(opt, shards):
    """Point ``opt`` at the shards: ``shards`` maps id(param) -> (param,
    shard); an accumulator or master made before at the parameter's
    shape is cut to the shard's."""
    opt._params = [(n, shards[id(p)][1] if id(p) in shards else p)
                   for n, p in opt._params]
    opt._names = {id(p): n for n, p in opt._params}
    for slot in [*opt._accumulators.values(), opt._master_weights]:
        for pid in [k for k in slot if k in shards]:
            p, s = shards[pid]
            v = slot.pop(pid)
            if isinstance(v, torch.Tensor) and v.shape == p.shape:
                info = s._shard_info
                c = p.shape[info.axis] // info.group.nranks
                v = v.narrow(info.axis, info.group.rank * c, c).clone()
            slot[id(s)] = v


def _all_gather_along(x, axis, group):
    """The tensor whose chunks along ``axis`` are the group's ``x``s, in
    rank order: the all-gathered buffer itself (``axis`` 0) or a view of
    it."""
    moved = x.detach().movedim(axis, 0).contiguous()
    out = moved.new_empty((group.nranks * moved.shape[0], *moved.shape[1:]))
    _all_gather_flat(out, moved, group)
    return out.movedim(0, axis) if axis else out


def _state_split(optimizer, acc, info):
    """(full shape, split axis or None) of ``optimizer``'s state ``acc``
    of a parameter sharded as ``info``: a state of the parameter's shape
    is split as the parameter is; one reduced over an axis (the
    optimizer's ``_reduced_axes``: Adafactor's factored moments) lacks
    that axis, and is whole where that was the split axis."""
    full, axis = info.full_shape, info.axis
    d = getattr(optimizer, "_reduced_axes", {}).get(acc)
    if d is None:
        return full, axis
    d %= len(full)
    return full[:d] + full[d + 1:], (None if d == axis
                                     else axis - (axis > d))


def _innermost(optimizer):
    """The port's optimizer under any wrappers of it."""
    while True:
        inner = vars(optimizer).get("_inner_opt",
                                    vars(optimizer).get("_inner"))
        if inner is None:
            return optimizer
        optimizer = inner


def gather_optimizer_state(optimizer):
    """``optimizer``'s state dict with each sharded state (accumulator or
    master) all-gathered to its full shape: the state a serial optimizer
    would hold. A collective: every rank of the sharding groups calls
    it. Takes a GroupSharded stage's optimizer or any wrapper of it."""
    inner = _innermost(optimizer)
    sd = dict(inner.state_dict())
    slots = sorted([*inner._accumulators.items(),
                    ("master", inner._master_weights)], key=lambda kv: kv[0])
    for name, t in inner._params:
        info = getattr(t, "_shard_info", None)
        if info is None:
            continue
        for acc, slot in slots:
            v = slot.get(id(t))
            if not isinstance(v, torch.Tensor) or v.dim() == 0:
                continue
            full, axis = _state_split(inner, acc, info)
            if axis is not None and v.dim() == len(full):
                sd[f"{name}_{acc}"] = _all_gather_along(
                    v, axis, info.group).contiguous()
    return sd


def sharding_step_counts(level, n_sharded_buckets, n_replicated_buckets,
                         dp=False):
    """The collectives a stage-1 ("os") or stage-2 ("os_g") step issues
    for its gradients and parameters, by op (the module docstring's
    lines, without the clip's and the scaler's)."""
    d = 1 if dp else 0
    bs, br = n_sharded_buckets, n_replicated_buckets
    if level == "os":
        out = {"all_reduce": (bs + br) * (1 + d), "all_gather": bs}
    elif level == "os_g":
        out = {"reduce_scatter": bs, "all_reduce": bs * d + br * (1 + d),
               "all_gather": bs}
    else:
        raise ValueError(f"no stated stage-1/2 count for level {level!r}")
    return {k: v for k, v in out.items() if v}


class DygraphShardingOptimizer:
    """Stage 1: optimizer state sharded. Wraps any of the port's
    optimizers (made over the model's parameters): broadcasts them from
    rank 0 at wrap time, then steps one shard tensor per sharded
    parameter. The port's extras: the sharding ``group`` and ``dp_group``
    (default ``hcg``'s, else the fleet topology's, else every process and
    no dp)."""

    _scatter = False

    def __init__(self, optimizer, hcg=None, *, group=None, dp_group=None):
        if hcg is not None:
            group = group if group is not None else \
                hcg.get_sharding_parallel_group()
            if dp_group is None and hcg.get_data_parallel_world_size() > 1:
                dp_group = hcg.get_data_parallel_group()
        self._inner = optimizer
        self._group, self._dp_group = _default_groups(group, dp_group)
        n = self._group.nranks
        params = [p for _, p in optimizer._params]
        _sync_from_first(params, self._group, self._dp_group)
        self._entries = [Entry(p, sharded_axis(p, n)) for p in params
                         if p.requires_grad]
        self._reducer = Reducer(self._entries, self._group, self._dp_group,
                                scatter=self._scatter)
        _shard_optimizer(optimizer, {id(e.param): (e.param, e.shard)
                                     for e in self._entries
                                     if e.shard is not None})

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step_counts(self):
        """This optimizer's stated gradient and parameter collectives a
        step (``sharding_step_counts``)."""
        n_s = sum(b.sharded for b in self._reducer.buckets)
        n_all = len(self._reducer.buckets)
        return sharding_step_counts(
            "os_g" if self._scatter else "os", n_s, n_all - n_s,
            dp=self._reducer._dp)

    def step(self):
        self._inner.step()
        self._reducer.gather_params()

    def clear_grad(self, *a, **k):
        self._inner.clear_grad(*a, **k)
        for e in self._entries:
            if e.shard is not None:
                e.param.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, sd):
        """Load ``sd``; a sharded state at its full shape (as
        ``gather_optimizer_state`` gives it) is cut to this rank's
        chunk."""
        inner = self._inner
        names = sorted(((inner._names[id(e.shard)], e.shard._shard_info)
                        for e in self._entries if e.shard is not None),
                       key=lambda ni: -len(ni[0]))
        out = {}
        for key, v in sd.items():
            hit = next(((n, info) for n, info in names
                        if key.startswith(n + "_")), None)
            if hit is not None:
                full, axis = _state_split(inner, key[len(hit[0]) + 1:],
                                          hit[1])
                if axis is not None and \
                        tuple(getattr(v, "shape", ())) == full:
                    v = torch.as_tensor(v)
                    c = full[axis] // self._group.nranks
                    v = v.narrow(axis, self._group.rank * c, c)
            out[key] = v
        return inner.set_state_dict(out)


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """Stage 2: as stage 1, with each sharded gradient reduce-scattered
    into its shard after backward. ``params`` and ``device`` are taken
    and unused (the optimizer's parameters and their device rule);
    ``dp_group`` may come in ``kw``."""

    _scatter = True

    def __init__(self, params, optim, group=None, offload=False, device="tpu",
                 **kw):
        if offload:
            raise NotImplementedError(
                "GroupShardedOptimizerStage2(offload=True): CPU offload is "
                "not implemented in the port (the sharded state stays on "
                "the parameters' device)")
        super().__init__(optim, group=group, dp_group=kw.get("dp_group"))

    def reshard_grads(self) -> int:
        """The number of gradients held sharded at rest: the shards'
        gradients whose parameters hold none (the reduce-scatter ran at
        the end of backward)."""
        return sum(1 for e in self._entries if e.shard is not None
                   and e.shard.grad is not None and e.param.grad is None)

    def step(self):
        self.reshard_grads()
        super().step()


def _warn_ignored_once(sync_buffers, buffer_max_size):
    if (sync_buffers or buffer_max_size != 2 ** 23) and \
            not GroupShardedStage2._warned_ignored:
        GroupShardedStage2._warned_ignored = True
        import warnings
        warnings.warn(
            "GroupShardedStage2: buffer_max_size/sync_buffers are accepted "
            "for API parity but ignored in the port — gradients go in "
            "32 MB buckets and buffers are broadcast once at wrap time",
            UserWarning, stacklevel=3)


class _Wrapper(nn.Module):
    """A model wrapper: forward and the state calls go to ``_layers``."""

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def clear_gradients(self):
        for p in self._layers.parameters():
            p.grad = None


class GroupShardedStage2(_Wrapper):
    """Stage-2 model wrapper over ``sharding_optimizer`` (a
    ``GroupShardedOptimizerStage2``, or a list of them), whose reducer
    shards the gradients. Broadcasts the model's buffers from rank 0."""

    _warned_ignored = False

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device="tpu", dp_group=None):
        super().__init__()
        _warn_ignored_once(sync_buffers, buffer_max_size)
        self._layers = layer
        self._sharding_optimizers = (sharding_optimizer
                                     if isinstance(sharding_optimizer, list)
                                     else [sharding_optimizer])
        opt = self._sharding_optimizers[0]
        _sync_from_first([b for b in layer.buffers()
                          if b.is_floating_point()],
                         opt._group, opt._dp_group)


# ------------------------------------------------------------------ stage 3
class _Param3:
    """A stage-3 parameter: the module's ``param`` (at rest over a
    placeholder), its ``shard`` (the leaf the optimizer steps), the split
    ``axis`` and the state that tracks its gathers."""

    def __init__(self, param, shard, axis, state):
        self.param, self.shard, self.axis, self.state = param, shard, axis, \
            state

    @torch.no_grad()
    def gather(self):
        """The full parameter, all-gathered from the shards."""
        # contiguous, so that a saved view's _base is this tensor
        full = _all_gather_along(self.shard, self.axis,
                                 self.state.group).contiguous()
        self.state.track(full, self)
        return full

    @torch.no_grad()
    def scatter_grad(self, grad):
        """This rank's chunk of the mean of every rank's ``grad``."""
        st = self.state
        n = st.group.nranks
        moved = grad.movedim(self.axis, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
        _reduce_scatter_flat(out, moved.view(-1), st.group)
        denom = n
        if st.dp_group is not None and st.dp_group.nranks > 1:
            _all_reduce(out, ReduceOp.SUM, st.dp_group)
            denom *= st.dp_group.nranks
        return out.div_(denom).movedim(0, self.axis).contiguous()


class _GatherParam(torch.autograd.Function):
    """shard -> full parameter; backward reduce-scatters the gradient."""

    @staticmethod
    def forward(ctx, shard, entry):
        ctx.entry = entry
        return entry.gather()

    @staticmethod
    def backward(ctx, grad):
        return ctx.entry.scatter_grad(grad), None


_PACKED = object()
# metadata reads that the placeholder answers (it has the full shape)
_META = {torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel,
         torch.Tensor.is_floating_point, torch.Tensor.element_size,
         torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__,
         torch.Tensor.device.__get__, torch.Tensor.ndim.__get__,
         torch.Tensor.requires_grad.__get__, torch.Tensor.is_cuda.__get__,
         torch.Tensor.layout.__get__, torch.Tensor.__hash__}


class _RestGuard(TorchFunctionMode):
    """Inside a stage-3 forward: a parameter read at rest (outside its
    module's forward) is gathered for the op that reads it."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _META:
            args = tuple(self.state.swap(a) for a in args)
            kwargs = {k: self.state.swap(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


class _Stage3State:
    def __init__(self, group, dp_group):
        self.group, self.dp_group = group, dp_group
        self.at_rest: dict = {}             # id(param) -> _Param3
        self._live: dict = {}               # id(gathered) -> (ref, _Param3)
        self.live_bytes = 0
        self.peak_bytes = 0

    def track(self, full, entry):
        self._live[id(full)] = (weakref.ref(full), entry)
        nb = full.numel() * full.element_size()
        self.live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(full, self._freed, nb)

    def _freed(self, nb):
        self.live_bytes -= nb

    def swap(self, a):
        if isinstance(a, (list, tuple)):
            return type(a)(self.swap(x) for x in a)
        e = self.at_rest.get(id(a)) if isinstance(a, torch.Tensor) else None
        if e is not None and e.param is a:
            return _GatherParam.apply(e.shard, e)
        return a

    def pack(self, t):
        base = t._base if t._base is not None else t
        hit = self._live.get(id(base))
        if hit is None or hit[0]() is not base:
            return t
        return (_PACKED, hit[1], t.size(), t.stride(), t.storage_offset())

    @staticmethod
    def unpack(obj):
        if isinstance(obj, tuple) and obj and obj[0] is _PACKED:
            _, entry, size, stride, offset = obj
            return entry.gather().as_strided(size, stride, offset)
        return obj


@contextlib.contextmanager
def stage3_forward(state):
    """A forward of a stage-3 model (``state`` its ``_Stage3State``; None:
    nothing): a gathered parameter saved for backward is packed as a
    token, a parameter read outside its module is gathered for that op,
    and the gathered copies are forgotten after."""
    if state is None:
        yield
        return
    try:
        with torch.autograd.graph.saved_tensors_hooks(state.pack,
                                                      state.unpack), \
                _RestGuard(state):
            yield
    finally:
        state._live.clear()


def _placeholder(p):
    """A one-element stride-0 tensor of p's shape, dtype and device."""
    return torch.zeros((), dtype=p.dtype, device=p.device).expand(p.shape)


class GroupShardedStage3(_Wrapper):
    """Stage 3: parameters rest sharded. Broadcasts the model from rank
    0 (``pretrain_sync_models``), shards every trainable parameter whose
    largest axis divides (``exclude_layer``: module types or names whose
    parameters stay whole), points ``optimizer`` (if given) at the
    shards, and all-reduces the whole parameters' gradients. ``device``,
    ``segment_size`` and ``sync_comm`` are taken and unused;
    ``sync_buffers`` warns once, as stage 2's. The port's extra:
    ``peak_gathered_bytes()``, the most bytes of gathered parameters
    alive at once since the wrap."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 device="tpu", segment_size=2 ** 20, pretrain_sync_models=True,
                 offload=False, sync_comm=False, dp_group=None,
                 exclude_layer=None):
        super().__init__()
        if offload:
            raise NotImplementedError(
                "GroupShardedStage3(offload=True): CPU offload is not "
                "implemented in the port — parameters rest sharded on "
                "their device; drop the flag rather than lose it silently")
        _warn_ignored_once(sync_buffers, 2 ** 23)
        self._layers = layer
        group, dp_group = _default_groups(group, dp_group)
        self._group, self._dp_group = group, dp_group
        if pretrain_sync_models:
            _sync_model(layer, group, dp_group)
        excluded = set()
        for name, mod in layer.named_modules():
            if exclude_layer and (name in exclude_layer
                                  or type(mod).__name__ in exclude_layer
                                  or type(mod) in exclude_layer):
                excluded.update(id(p) for p in mod.parameters())
        self._state = st = _Stage3State(group, dp_group)
        shards, replicated = {}, []
        for mod in layer.modules():
            own = []
            for pname, p in mod._parameters.items():
                if p is None or not p.requires_grad:
                    continue
                e = st.at_rest.get(id(p))
                if e is None:
                    axis = sharded_axis(p, group.nranks)
                    if axis is None or id(p) in excluded:
                        if all(r is not p for r in replicated):
                            replicated.append(p)
                        continue
                    e = _Param3(p, _make_shard(p, axis, group), axis, st)
                    st.at_rest[id(p)] = e
                    shards[id(p)] = (p, e.shard)
                    p.data = _placeholder(p)
                    p._stage3 = True
                own.append((pname, e))
            if own:
                mod.register_forward_pre_hook(self._pre_hook(own))
                mod.register_forward_hook(self._post_hook(own))
        self._entries = list(st.at_rest.values())
        self._reducer = Reducer([Entry(p) for p in replicated], group,
                                dp_group)
        # the forward context of whatever runs the model unwrapped (a
        # pipeline's stage, fleet.distributed_model on the inner model);
        # the replicated gradients' reducer lives as long as the model,
        # not the wrapper
        st.reducer = self._reducer
        layer._stage3_state = st
        self._gathered = False
        if optimizer is not None:
            _shard_optimizer(optimizer, shards)

    @staticmethod
    def _pre_hook(own):
        def hook(mod, args):
            for pname, e in own:
                mod._parameters[pname] = _GatherParam.apply(e.shard, e)
        return hook

    @staticmethod
    def _post_hook(own):
        def hook(mod, args, out):
            for pname, e in own:
                mod._parameters[pname] = e.param
        return hook

    def forward(self, *inputs, **kwargs):
        if self._gathered:
            self._release()
        with stage3_forward(self._state):
            return self._layers(*inputs, **kwargs)

    def peak_gathered_bytes(self):
        return self._state.peak_bytes

    @torch.no_grad()
    def _release(self):
        for e in self._entries:
            e.param.data = _placeholder(e.param)
        self._gathered = False

    @torch.no_grad()
    def get_all_parameters(self, convert2cpu: bool = False):
        """Gather every sharded parameter into the model (until the next
        forward) and return the model's parameters."""
        for e in self._entries:
            e.param.data = e.gather()
        self._state._live.clear()
        self._gathered = True
        return list(self._layers.parameters())

    def state_dict(self, *a, **k):
        """The model's full state (gathered; the parameters rest sharded
        again after)."""
        was = self._gathered
        self.get_all_parameters()
        sd = self._layers.state_dict(*a, **k)
        if not was:
            self._release()
        return sd
