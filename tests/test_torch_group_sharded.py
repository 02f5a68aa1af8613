"""The port's GroupSharded stages 1/2/3 against the JAX package's, on the
CPU.

One group of 4 gloo processes, spawned once for the module (a FileStore
under the test's temporary directory, a 60 s process-group timeout, a
join limit), runs:

- Placement at ``sharding_degree`` 4 (JAX's ``TestZeROPlacement``): a
  Linear(64, 128) - Tanh - Linear(128, 64) - Tanh - Linear(64, 5) model
  under AMP O2 (bf16, fp32 AdamW masters) through
  ``group_sharded_parallel`` at "os", "os_g" and "p_g_os". Each rank's
  shape of every moment, master, stage-2 gradient (after two backwards)
  and stage-3 parameter must equal the addressable shard shape JAX gives
  at degree 4 (JAX's own test on its 4-device mesh after
  ``apply_shardings``; the last bias, [5], stays whole on both sides);
  per-rank state bytes at most logical / 4 plus the whole tensors; stage
  3's gathered bytes alive at once at most one Linear's; the offload
  refusals and the warn-once contract.
- Numerics on dp 2 x sharding 2: ``bert_tiny(dropout=0.0)`` (E=64, 2
  layers, V=1024; B=2 a rank, S=64, 15% MLM labels, NSP), fp32, AdamW
  (lr 1e-3) with ``ClipGradByGlobalNorm(1.0)``, 3 steps at each level.
  Rank 0 takes JAX's weights through ``weights.bert_from_jax_state``;
  the other ranks start from other seeds, which the wrap's broadcast
  must overwrite. The reference is JAX's eager data-parallel step: JAX's
  serial model on each rank's sub-batch (``parallel.shard_batch``), the
  gradients averaged over the 4 ranks that consume distinct data, then
  JAX's AdamW (JAX's own eager path and Paddle's reducer average
  local-mean gradients; BERT's MLM labels differ in count between
  sub-batches, so this is not the whole-batch step). Each rank's losses
  within TOLERANCES["train_loss_fp32"], its step-1 gradient shards
  within ["train_grads_fp32"], the parameters after 3 steps within
  ["train_params_fp32"] but for the share ["train_params_outliers"]
  allows. ``COLLECTIVES`` per step equal to the design's counts
  (``group_sharded``'s docstring; the bucket plan rebuilt here).
- Stage 3 with ``Momentum``, ``Lamb`` and ``Adafactor`` (the updates
  that read whole-parameter statistics: Lamb's trust ratio and
  Adafactor's means sum the shards' partials over the group), held to
  the same eager JAX reference with JAX's own optimizer; the O2 bf16
  losses of 3 stage-2 steps against that reference under JAX's
  ``amp.decorate(level="O2")`` within ["bert_o2_loss_bf16"]; a
  ``GradScaler`` with an inf planted in rank 2's gradient alone: every
  rank skips that step and halves its scale; ``save_group_sharded_model``
  at stage 3 (AdamW and Adafactor), read back by JAX's
  ``paddle_tpu.framework.io.load``: the model's gathered state, and the
  optimizer's state gathered to full shapes.

JAX is imported inside the tests only: the spawned processes import this
module and stay torch-only.
"""
import datetime
import os
import pickle
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch import TOLERANCES, amp
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication import ops
from paddle_tpu_torch.distributed.communication.reducer import (bucket_plan,
                                                                shard_axis)
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
    group_sharded as gs
from paddle_tpu_torch.distributed.sharding import (group_sharded_parallel,
                                                   save_group_sharded_model)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear
from paddle_tpu_torch.optimizer import Adafactor, AdamW, Lamb, Momentum
from paddle_tpu_torch.parallel import shard_batch
from paddle_tpu_torch.profile_train import bert_batch
from paddle_tpu_torch.weights import bert_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N = 4
JOIN_LIMIT_S = 180
LEVELS = ("os", "os_g", "p_g_os")
B, S, STEPS, LR = 8, 64, 3, 1e-3
D = 64
OTHER_OPTS = {"momentum": (Momentum, 1e-2), "lamb": (Lamb, 1e-3),
              "adafactor": (Adafactor, 1e-2)}


def _strategy(dp, sharding):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": sharding, "sep_degree": 1}
    return s


def _batch():
    """The global batch as numpy (ids, mlm labels, nsp labels)."""
    ids, y = bert_batch(0, B, S, 1024, "cpu")
    return (ids.numpy(), y["masked_lm_labels"].numpy(),
            y["next_sentence_labels"].numpy())


def _torch_batch(rows=None):
    ids, lab, nsp = (torch.from_numpy(a) for a in _batch())
    if rows is not None:
        ids, lab, nsp = ids[rows], lab[rows], nsp[rows]
    return ids, {"masked_lm_labels": lab, "next_sentence_labels": nsp}


def _bert(state, rank):
    """Rank 0: JAX's weights; the others: a seed of their own."""
    cfg = tbert.bert_tiny(dropout=0.0)
    if rank == 0:
        return bert_from_jax_state(state, cfg, device="cpu")
    return tbert.BertForPretraining(cfg, device="cpu", seed=50 + rank)


def _opt(model, kind="adamw"):
    if kind == "adamw":
        return AdamW(LR, parameters=model.named_parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    cls, lr = OTHER_OPTS[kind]
    return cls(lr, parameters=model.named_parameters())


def _inner(opt):
    return getattr(opt, "_inner", opt)


def _shard_grads(opt):
    """name -> (axis or None, this rank's gradient) of the stepped
    tensors."""
    out = {}
    for name, t in _inner(opt)._params:
        info = getattr(t, "_shard_info", None)
        if t.grad is not None:
            out[name] = (info.axis if info else None,
                         t.grad.float().numpy().copy())
    return out


def _full_params(model, wrapped):
    if isinstance(wrapped, gs.GroupShardedStage3):
        wrapped.get_all_parameters()
    return {n: p.detach().float().numpy().copy()
            for n, p in model.named_parameters()}


def _train(state, rank, level, kind="adamw", o2=False, steps=STEPS):
    model = _bert(state, rank)
    opt = _opt(model, kind)
    if o2:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    wrapped, sopt, _ = group_sharded_parallel(model, opt, level=level)
    x, y = _torch_batch()
    x, y = shard_batch(x), {k: shard_batch(v) for k, v in y.items()}
    losses, counts, grads = [], [], None
    for i in range(steps):
        ops.reset_collectives()
        with amp.auto_cast(enable=o2, level="O2"):
            loss = wrapped(x, **y)
        loss.backward()
        if i == 0:
            grads = _shard_grads(sopt)
        sopt.step()
        sopt.clear_grad()
        counts.append(dict(ops.COLLECTIVES))
        losses.append(loss.item())
    design = sopt.step_counts() if hasattr(sopt, "step_counts") else None
    return {"losses": losses, "counts": counts, "grads": grads,
            "design": design, "params": _full_params(model, wrapped),
            "model": model, "wrapped": wrapped, "opt": sopt}


def _mlp(seed):
    g = torch.Generator().manual_seed(seed)
    lin = lambda i, o: Linear(i, o, device="cpu", trainable=True,  # noqa
                              generator=g)
    return torch.nn.Sequential(lin(D, 2 * D), torch.nn.Tanh(),
                               lin(2 * D, D), torch.nn.Tanh(), lin(D, 5))


def _mlp_xy():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((8, D)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal(
            (8, 5)).astype(np.float32)))


def _nbytes(t):
    return t.numel() * t.element_size()


def _placement(rank, level):
    """Shapes and bytes of a degree-4 wrap of ``_mlp`` under O2."""
    model = _mlp(11 + rank)
    opt = AdamW(LR, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    logical = sum(_nbytes(p) for p in model.parameters())
    wrapped, sopt, _ = group_sharded_parallel(model, opt, level=level)
    x, y = _mlp_xy()
    loss_fn = lambda: ((wrapped(x.bfloat16()).float() - y) ** 2).mean()  # noqa
    out = {}
    for _ in range(2 if level == "os_g" else 1):
        loss_fn().backward()
    if level == "os_g":
        out["resharded"] = sopt.reshard_grads()
        out["grads"] = {n: tuple(t.grad.shape) for n, t in _inner(sopt)._params
                        if hasattr(t, "_shard_info")}
        out["full_grads"] = [n for n, p in model.named_parameters()
                             if p.grad is not None]
    sopt.step()
    sopt.clear_grad()
    inner = _inner(sopt)
    names = inner._names
    out["moments"] = {names[pid]: tuple(t.shape) for pid, t in
                      inner._accumulators["moment1"].items()}
    out["masters"] = {names[pid]: tuple(t.shape) for pid, t in
                      inner._master_weights.items()}
    state = [t for slot in inner._accumulators.values()
             for t in slot.values() if isinstance(t, torch.Tensor)]
    state += list(inner._master_weights.values())
    # fp32 moment1, moment2 and master: 12 bytes an element
    logical_state = 12 * sum(p.numel() for p in model.parameters())
    whole = [t for _, t in inner._params if not hasattr(t, "_shard_info")]
    out["state_bytes"] = (sum(_nbytes(t) for t in state), logical_state,
                          sum(3 * 4 * t.numel() for t in whole))
    if level == "p_g_os":
        out["params"] = {n: tuple(t.shape) for n, t in inner._params}
        rest = sum(p.untyped_storage().nbytes()
                   for p in model.parameters())
        shards = sum(_nbytes(t) for _, t in inner._params
                     if hasattr(t, "_shard_info"))
        out["param_bytes"] = (rest + shards, logical,
                              sum(_nbytes(t) for t in whole))
        out["peak_gathered"] = wrapped.peak_gathered_bytes()
    return out


def _refusals():
    model = _mlp(0)
    opt = AdamW(LR, parameters=model.named_parameters())
    got = []
    for level in LEVELS:
        try:
            group_sharded_parallel(model, opt, level=level, offload=True)
        except NotImplementedError as e:
            got.append("offload" in str(e))
    gs.GroupShardedStage2._warned_ignored = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for kw in ({"buffer_max_size": 2 ** 20}, {"sync_buffers": True}):
            m = _mlp(0)
            o = gs.GroupShardedOptimizerStage2(
                m.parameters(), AdamW(LR, parameters=m.named_parameters()))
            gs.GroupShardedStage2(m, o, **kw)
    return got, sum("API parity but ignored" in str(w.message) for w in rec)


def _scaler_run(state, rank, inf_step=1):
    """fp32 stage 2 under GradScaler; rank 2 plants an inf at
    ``inf_step``."""
    model = _bert(state, rank)
    wrapped, sopt, scaler = group_sharded_parallel(
        model, _opt(model), level="os_g", scaler=amp.GradScaler())
    x, y = _torch_batch()
    x, y = shard_batch(x), {k: shard_batch(v) for k, v in y.items()}
    flags, scales, moved = [], [], None
    for i in range(3):
        scaler.scale(wrapped(x, **y)).backward()
        if i == inf_step:
            before = [p.detach().clone() for p in model.parameters()]
            if rank == 2:
                _inner(sopt)._params[0][1].grad.mul_(float("inf"))
        scaler.step(sopt)
        flags.append(scaler._found_inf)
        scaler.update()
        sopt.clear_grad()
        scales.append(scaler.get_loss_scaling())
        if i == inf_step:
            moved = sum(not torch.equal(p, b)
                        for p, b in zip(model.parameters(), before))
    return {"flags": flags, "scales": scales, "moved": moved}


def _save(run, path):
    """``save_group_sharded_model`` of a stage-3 run into ``path``; the
    model's gathered state and this rank's shards of the optimizer's."""
    save_group_sharded_model(run["wrapped"], path, run["opt"])
    return {"saved_state": {k: v.numpy() for k, v in
                            run["wrapped"].state_dict().items()},
            "opt_shards": {k: v.float().numpy() for k, v in
                           _inner(run["opt"]).state_dict().items()
                           if isinstance(v, torch.Tensor) and v.dim()}}


def _reload(opt):
    """Whether the gathered state, loaded back through stage 2's
    ``set_state_dict``, gives this rank's shards as they were."""
    inner = _inner(opt)
    before = {k: v.clone() for k, v in inner.state_dict().items()
              if isinstance(v, torch.Tensor)}
    opt.set_state_dict(gs.gather_optimizer_state(opt))
    after = inner.state_dict()
    return sorted(before) == sorted(
        k for k, v in after.items() if isinstance(v, torch.Tensor)) and all(
            torch.equal(before[k], after[k]) for k in before)


def _worker(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "refs.pkl"), "rb") as f:
        state = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), N),
        rank=rank, world_size=N, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        fleet.init(strategy=_strategy(1, N), device="cpu")
        for level in LEVELS:
            out["placement", level] = _placement(rank, level)
        out["refusals"] = _refusals()
        fleet.init(strategy=_strategy(2, 2), device="cpu")
        for level in LEVELS:
            run = _train(state, rank, level)
            if level == "p_g_os":
                run.update(_save(run, os.path.join(workdir, "saved")))
            if level == "os_g":
                run["reloaded"] = _reload(run["opt"])
            for k in ("model", "wrapped", "opt"):
                run.pop(k)
            out["train", level] = run
        for kind in OTHER_OPTS:
            run = _train(state, rank, "p_g_os", kind)
            out["other", kind] = {"params": run["params"]}
            if kind == "adafactor":
                out["other", kind].update(
                    _save(run, os.path.join(workdir, "saved_adafactor")))
        out["o2"] = _train(state, rank, "os_g", o2=True)["losses"]
        out["scaler"] = _scaler_run(state, rank)
    finally:
        topology._HYBRID_GROUP[0] = None
        fleet._fleet_state.update(strategy=None, hcg=None)
        pdist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def jax_bert():
    """The state of JAX's BertForPretraining(bert_tiny(dropout=0.0)) from
    paddle.seed(0), as numpy."""
    import paddle_tpu as paddle
    from paddle_tpu.models import bert as jbert
    paddle.seed(0)
    m = jbert.BertForPretraining(jbert.bert_tiny(dropout=0.0))
    return {k: np.asarray(v._data) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def spawned(jax_bert, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("gs_group"))
    with open(os.path.join(workdir, "refs.pkl"), "wb") as f:
        pickle.dump(jax_bert, f)
    ctx = mp.start_processes(_worker, args=(workdir,), nprocs=N, join=False,
                             start_method="spawn")
    yield ctx, workdir, time.monotonic() + JOIN_LIMIT_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(10)


def _jax_dp_run(state, kind="adamw", o2=False):
    """JAX's eager data-parallel reference: per step, JAX's serial model
    (from ``state``) on each rank's sub-batch, the gradients averaged (in
    fp32, cast back to the parameter's dtype), then JAX's optimizer:
    AdamW with the clip, or ``kind``'s of ``OTHER_OPTS``; with ``o2``,
    both taken through JAX's ``amp.decorate(level="O2")`` and the forward
    under its ``auto_cast``."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.tensor.tensor import Tensor
    m = jbert.BertForPretraining(jbert.bert_tiny(dropout=0.0))
    m.set_state_dict(state)
    if kind == "adamw":
        opt = paddle.optimizer.AdamW(
            learning_rate=LR, parameters=m.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    else:
        cls, lr = OTHER_OPTS[kind]
        opt = getattr(paddle.optimizer, cls.__name__)(
            learning_rate=lr, parameters=m.parameters())
    if o2:
        m, opt = paddle.amp.decorate(m, opt, level="O2", dtype="bfloat16")
    ids, lab, nsp = _batch()
    names = [n for n, _ in m.named_parameters()]
    losses, grads = [], None
    for step in range(STEPS):
        acc = [None] * len(names)
        step_losses = []
        for r in range(N):
            rows = slice(2 * r, 2 * r + 2)
            with paddle.amp.auto_cast(enable=o2, level="O2",
                                      dtype="bfloat16"):
                loss = m(paddle.to_tensor(ids[rows].astype(np.int32)),
                         masked_lm_labels=paddle.to_tensor(
                             lab[rows].astype(np.int32)),
                         next_sentence_labels=paddle.to_tensor(
                             nsp[rows].astype(np.int32)))
            loss.backward()
            for i, (_, p) in enumerate(m.named_parameters()):
                if p.grad is None:      # unused (no token type ids)
                    continue
                g = np.asarray(p.grad._data).astype(np.float32)
                acc[i] = g if acc[i] is None else acc[i] + g
            opt.clear_grad()
            step_losses.append(float(np.asarray(loss.numpy(), np.float32)))
        for i, (_, p) in enumerate(m.named_parameters()):
            if acc[i] is not None:
                p.grad = Tensor(jnp.asarray(acc[i] / N).astype(p._data.dtype))
        if step == 0:
            grads = {n: a / N for n, a in zip(names, acc) if a is not None}
        opt.step()
        opt.clear_grad()
        losses.append(step_losses)
    return {"losses": losses, "grads": grads,
            "params": {n: np.asarray(p._data).astype(np.float32)
                       for n, p in m.named_parameters()}}


@pytest.fixture(scope="module")
def refs(spawned, jax_bert):
    """JAX's degree-4 placement and its eager dp runs: AdamW in fp32, the
    other optimizers, AdamW under O2."""
    state = jax_bert
    out = {"jax": _jax_dp_run(state)}
    for kind in OTHER_OPTS:
        out["other", kind] = _jax_dp_run(state, kind)
    out["o2"] = _jax_dp_run(state, o2=True)["losses"]
    # last: JAX's eager steps slow down several times once fleet.init has
    # built a mesh
    out["placement"] = _jax_placement()
    return out


def _jax_placement():
    """JAX's TestZeROPlacement at sharding_degree 4: name -> the
    addressable shard shape of each parameter's moment (after "os"), of
    its gradient (after "os_g"'s reshard) and of the parameter (after
    "p_g_os")."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet.base import topology as jtopo
    from paddle_tpu.distributed.sharding import group_sharded_parallel as jgs
    from paddle_tpu.parallel import apply_shardings

    def shard(t):
        shapes = {tuple(s.data.shape) for s in t._data.addressable_shards}
        assert len(shapes) == 1, shapes
        return shapes.pop()

    out = {}
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": N}
    try:
        for level in LEVELS:
            jfleet.init(is_collective=True, strategy=strategy)
            paddle.seed(5)
            model = paddle.nn.Sequential(
                paddle.nn.Linear(D, 2 * D), paddle.nn.Tanh(),
                paddle.nn.Linear(2 * D, D), paddle.nn.Tanh(),
                paddle.nn.Linear(D, 5))
            names = [f"{i}.{k}" for i in (0, 2, 4) for k in ("weight",
                                                              "bias")]
            opt = paddle.optimizer.AdamW(learning_rate=LR,
                                         parameters=model.parameters())
            model, opt, _ = jgs(model, opt, level=level)
            x, y = (paddle.to_tensor(a.numpy()) for a in _mlp_xy())
            params = list(model.parameters())
            if level == "os_g":
                apply_shardings()
                ((model(x) - y) ** 2).mean().backward()
                opt.reshard_grads()
                out["grads"] = {n: shard(p.grad)
                                for n, p in zip(names, params)}
                continue

            @paddle.jit.to_static
            def step(x, y):
                loss = ((model(x) - y) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss

            step(x, y)
            apply_shardings()
            step(x, y)
            inner = getattr(opt, "_inner", opt)
            by_id = {id(p): n for n, p in zip(names, params)}
            if level == "os":
                slot = inner._accumulators["moment1"]
                pname = {p.name: n for n, p in zip(names, params)}
                out["moments"] = {pname[k] if k in pname else by_id[k]:
                                  shard(t) for k, t in slot.items()}
            else:
                out["params"] = {n: shard(p) for n, p in zip(names, params)}
    finally:
        jtopo._HYBRID_GROUP[0] = None
    return out


@pytest.fixture(scope="module")
def group(spawned, refs):
    """Every rank's results, read once the group has finished (``refs``
    first: JAX's references run while the group trains)."""
    ctx, workdir, deadline = spawned
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            pytest.fail(f"the gloo group did not finish in {JOIN_LIMIT_S} s")
    results = []
    for rank in range(N):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results, workdir


def assert_params_close(got, want, lr, steps):
    """Within TOLERANCES["train_params_fp32"] but for the share of
    elements ["train_params_outliers"] allows, each within its per-step
    cap (Adam turns rounding noise near a zero gradient into ~lr)."""
    tol, out = TOLERANCES["train_params_fp32"], \
        TOLERANCES["train_params_outliers"]
    n_out = n_all = 0
    worst = 0.0
    for n, w in want.items():
        g = np.asarray(got[n], np.float32)
        n_out += int((~np.isclose(g, w, **tol)).sum())
        n_all += w.size
        worst = max(worst, float(np.abs(g - w).max()))
    assert n_out <= out["share"] * n_all, (n_out, n_all)
    assert worst <= out["per_step_lr"] * lr * steps, worst


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("level", LEVELS)
def test_shard_shapes_match_jax_at_degree_4(group, refs, level):
    """Moments and masters at every level, stage-2 gradients and stage-3
    parameters: each rank's shape equals JAX's per-device shard."""
    results, _ = group
    want = refs["placement"]
    for r in range(N):
        p = results[r]["placement", level]
        assert p["moments"] == want["moments"]
        assert p["masters"] == want["moments"]
        if level == "os_g":
            sharded = {n: s for n, s in want["grads"].items()
                       if n != "4.bias"}
            assert p["grads"] == sharded
            assert want["grads"]["4.bias"] == (5,)
            assert p["full_grads"] == ["4.bias"]
            assert p["resharded"] == len(sharded)
        if level == "p_g_os":
            assert p["params"] == want["params"]


@pytest.mark.parametrize("level", LEVELS)
def test_state_bytes_are_a_quarter(group, level):
    """Moments and masters (and stage 3's parameters at rest) at most
    logical / 4 plus the whole tensors; stage 3 gathers at most one
    Linear's parameters at a time."""
    results, _ = group
    for r in range(N):
        p = results[r]["placement", level]
        held, logical, whole = p["state_bytes"]
        assert held <= logical / N + whole + 64, (held, logical, whole)
        if level == "p_g_os":
            held, logical, whole = p["param_bytes"]
            assert held <= logical / N + whole + 64, (held, logical, whole)
            biggest = (2 * D * D + 2 * D) * 2
            assert 0 < p["peak_gathered"] <= biggest, p["peak_gathered"]


def test_offload_refused_and_knobs_warn_once(group):
    results, _ = group
    for r in range(N):
        assert results[r]["refusals"] == ([True] * 3, 1)


# -------------------------------------------------------------- numerics
@pytest.mark.parametrize("level", LEVELS)
def test_bert_matches_jax_eager_dp_step(group, refs, level):
    results, _ = group
    want = refs["jax"]
    for r in range(N):
        run = results[r]["train", level]
        np.testing.assert_allclose(run["losses"],
                                   [s[r] for s in want["losses"]],
                                   **TOLERANCES["train_loss_fp32"])
        assert_params_close(run["params"], want["params"], LR, STEPS)
    # step-1 gradients: the sharding pair of dp row 0 (ranks 0, 1)
    # together hold each averaged gradient; dp row 1 the same
    for dp in (0, 1):
        pair = [results[2 * dp + k]["train", level]["grads"]
                for k in range(2)]
        assert set(pair[0]) == set(want["grads"])
        for n, g in want["grads"].items():
            axis, a = pair[0][n]
            got = a if axis is None else np.concatenate(
                [a, pair[1][n][1]], axis)
            np.testing.assert_allclose(got, g, err_msg=n,
                                       **TOLERANCES["train_grads_fp32"])


def _expected_counts(level, model):
    """The design's collectives a step for ``model``'s parameters at
    sharding 2 under dp 2: ``group_sharded``'s docstring, the bucket plan
    rebuilt from its rule, plus the clip's all-reduce."""
    params = [p for p in model.parameters() if p.requires_grad]
    sharded = [p for p in params if shard_axis(p.shape, 2) is not None]
    whole = [p for p in params if shard_axis(p.shape, 2) is None]
    b_s = len(bucket_plan([_nbytes(p) for p in sharded])) if sharded else 0
    b_r = len(bucket_plan([_nbytes(p) for p in whole])) if whole else 0
    if level == "os":
        want = {"all_reduce": 2 * (b_s + b_r), "all_gather": b_s}
    elif level == "os_g":
        want = {"reduce_scatter": b_s, "all_reduce": b_s + 2 * b_r,
                "all_gather": b_s}
    else:
        # one gather a module call a parameter its forward uses, plus the
        # MLM decoder's read of the word embedding outside its module; one
        # more for each view of a parameter that backward unpacks (both
        # counted on the plain model); a reduce-scatter and a dp
        # all-reduce a forward gather
        saved, used = _plain_counts(model)
        fwd = len([p for p in sharded if id(p) in used]) + 1
        want = {"all_gather": fwd + saved, "reduce_scatter": fwd,
                "all_reduce": fwd + 2 * b_r}
    want["all_reduce"] = want.get("all_reduce", 0) + 1
    return {k: v for k, v in want.items() if v}


def _plain_counts(model):
    """(saved views of parameters, ids of the parameters that get a
    gradient) of one step of the unwrapped model."""
    ids = {id(p) for p in model.parameters()}
    count = [0]

    def pack(t):
        base = t._base if t._base is not None else t
        count[0] += id(base) in ids
        return t

    x, y = _torch_batch(slice(0, 2))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(x, **y)
    loss.backward()
    return count[0], {id(p) for p in model.parameters()
                      if p.grad is not None}


@pytest.mark.parametrize("level", LEVELS)
def test_collectives_per_step_match_the_design(group, jax_bert, level):
    results, _ = group
    model = bert_from_jax_state(jax_bert, tbert.bert_tiny(dropout=0.0),
                                device="cpu")
    want = _expected_counts(level, model)
    for r in range(N):
        run = results[r]["train", level]
        assert run["counts"] == [want] * STEPS, (r, run["counts"], want)
        if level != "p_g_os":
            design = dict(run["design"])
            design["all_reduce"] = design.get("all_reduce", 0) + 1
            assert design == want


@pytest.mark.parametrize("kind", list(OTHER_OPTS))
def test_stage3_whole_parameter_statistics(group, refs, kind):
    """Lamb's trust ratio and Adafactor's means read the whole parameter:
    stage 3 sums the shards' partials and takes JAX's eager dp step."""
    results, _ = group
    want = refs["other", kind]["params"]
    for r in range(N):
        assert_params_close(results[r]["other", kind]["params"], want,
                            OTHER_OPTS[kind][1], STEPS)


def test_o2_bf16_losses(group, refs):
    results, _ = group
    for r in range(N):
        np.testing.assert_allclose(results[r]["o2"],
                                   [s[r] for s in refs["o2"]],
                                   **TOLERANCES["bert_o2_loss_bf16"])


def test_an_inf_on_one_rank_skips_the_step_everywhere(group):
    results, _ = group
    for r in range(N):
        s = results[r]["scaler"]
        assert s["flags"] == [False, True, False]
        assert s["scales"] == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15]
        assert s["moved"] == 0


def test_saved_model_reads_in_jax(group):
    from paddle_tpu.framework.io import load
    results, workdir = group
    got = load(os.path.join(workdir, "saved", "model.pdparams"))
    want = results[0]["train", "p_g_os"]["saved_state"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]._data), v)
    np.testing.assert_array_equal(
        want["mlm_bias"], results[0]["train", "p_g_os"]["params"]["mlm_bias"])


def test_gathered_optimizer_state_loads_back_into_the_shards(group):
    results, _ = group
    assert [results[r]["train", "os_g"]["reloaded"] for r in range(N)] == \
        [True] * N


@pytest.mark.parametrize("run,sub", [(("train", "p_g_os"), "saved"),
                                     (("other", "adafactor"),
                                      "saved_adafactor")],
                         ids=["adamw", "adafactor"])
def test_saved_optimizer_state_is_gathered(group, run, sub):
    """model.pdopt, read by JAX's load, holds every sharded state at its
    full shape (Adafactor's factored moments too): the sharding pair's
    (ranks 0 and 1) shards joined along their split axis; a whole state
    as both ranks hold it."""
    from paddle_tpu.framework.io import load
    results, workdir = group
    got = load(os.path.join(workdir, sub, "model.pdopt"), return_numpy=True)
    pair = [results[r][run]["opt_shards"] for r in (0, 1)]
    joined = []
    for k, a in pair[0].items():
        want, b = np.asarray(got[k], np.float32), pair[1][k]
        if a.shape == want.shape:
            np.testing.assert_array_equal(a, want, err_msg=k)
            np.testing.assert_array_equal(b, want, err_msg=k)
            continue
        axis = [i for i, (x, y) in enumerate(zip(a.shape, want.shape))
                if x != y]
        assert len(axis) == 1 and want.shape[axis[0]] == 2 * a.shape[
            axis[0]], (k, a.shape, want.shape)
        np.testing.assert_array_equal(np.concatenate([a, b], axis[0]), want,
                                      err_msg=k)
        joined.append(k)
    assert joined
    if sub == "saved_adafactor":
        assert any(k.endswith(("_vrow", "_vcol")) for k in joined), joined
