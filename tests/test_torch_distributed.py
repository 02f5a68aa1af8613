"""The port's collectives, topology, DataParallel and fleet wrappers
against the JAX package's, on the CPU.

One group of 4 gloo processes, spawned once for the module (a FileStore
under the test's temporary directory, a 60 s process-group timeout, a
join limit), runs every op of ``distributed.communication`` on per-rank
numpy inputs: ``all_reduce`` (SUM, MAX, MIN, PROD, AVG; fp32 and int32),
``all_gather``, ``broadcast``, ``reduce``, ``scatter``, ``gather``,
``alltoall``, ``alltoall_single``, ``send`` / ``recv``, ``isend`` /
``irecv``, ``batch_isend_irecv`` (a ring each), ``reduce_scatter`` in
both forms, a ``new_group`` of ranks {0, 2}, the object collectives,
``barrier`` and ``get_backend``. The parent holds them to JAX's
``shard_map`` results of the same ops on the same inputs over a
4-device CPU mesh (``lax.psum`` / ``pmax`` / ``pmin`` / ``pmean``,
``all_gather``, ``ppermute``, ``all_to_all``, ``psum_scatter``, as JAX's
``ProcessGroupXLA`` lowers them; PROD as the product of the gathered
values): integers exactly, fp32 within TOLERANCES["attention_fp32"]. Each
op counts once in ``COLLECTIVES``.

The same group then builds a fleet dp 2 x sharding 2 topology (ranks,
coordinates, groups and ``get_parallel_mode``), trains JAX's
``gpt2_tiny(dropout=0.0)`` one step under ``fleet.distributed_model``
(``DataParallel`` at dp 4) and ``fleet.distributed_optimizer``, rank 0
from JAX's weights and the others from other seeds (the wrap's broadcast
makes them equal), against JAX's whole-batch serial step (the oracle of
JAX's tests/test_distributed.py:192; every token is labelled, so the
mean of the ranks' local-mean gradients is the global mean): the loss
within ["train_loss_fp32"], the parameters within ["train_params_fp32"],
and exactly one all-reduce (one 25 MB bucket) for the step; and
``no_sync`` / ``apply_gradients``.

In this process: JAX's world-1 cases (its ``TestEagerCollectivesSingle
World``) over a one-rank gloo group, the topology's rank mapping and
``get_parallel_mode`` against JAX's over a grid of degrees, and
``spawn`` running a 2-rank data-parallel step against the whole-batch
step. JAX is imported inside the tests only: the spawned processes
import this module and stay torch-only.
"""
import datetime
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication import ops
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.framework import DataParallel
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel import shard_batch
from paddle_tpu_torch.weights import gpt_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N = 4
JOIN_LIMIT_S = 180
GPT = {"vocab_size": 1024, "hidden_size": 64, "num_layers": 2,
       "num_heads": 2, "max_position": 128, "dropout": 0.0}
RED_OPS = ("SUM", "MAX", "MIN", "PROD", "AVG")


def _x(rank):
    """Rank ``rank``'s inputs: fp32 [3, 4], int32 [5], a list of 4
    tensors [2] and one [8, 2], from a seed of its own."""
    rng = np.random.default_rng(100 + rank)
    return {"f": rng.standard_normal((3, 4)).astype(np.float32),
            "i": rng.integers(-5, 6, (5,)).astype(np.int32),
            "l": rng.standard_normal((4, 2)).astype(np.float32),
            "s": rng.standard_normal((8, 2)).astype(np.float32)}


def _gpt_data():
    return np.random.RandomState(0).randint(0, 1000, (8, 17)).astype(np.int64)


def _strategy(dp, sharding=1):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": sharding, "sep_degree": 1}
    return s


def _t(a):
    return torch.from_numpy(np.array(a))


def _collectives(rank):
    """Every op on this rank's inputs; numpy results by op."""
    x, out = _x(rank), {}
    ops.reset_collectives()
    for name in RED_OPS:
        t = _t(x["f"])
        pdist.all_reduce(t, getattr(pdist.ReduceOp, name))
        out["all_reduce", name, "f"] = t.numpy()
        if name != "AVG":
            t = _t(x["i"])
            pdist.all_reduce(t, getattr(pdist.ReduceOp, name))
            out["all_reduce", name, "i"] = t.numpy()
    got = []
    pdist.all_gather(got, _t(x["f"]))
    out["all_gather"] = np.stack([g.numpy() for g in got])
    t = _t(x["f"])
    pdist.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    t = _t(x["f"])
    pdist.reduce(t, dst=1)
    out["reduce"] = t.numpy()
    t = torch.zeros(2)
    pdist.scatter(t, [_t(r) for r in x["l"]] if rank == 0 else None, src=0)
    out["scatter"] = t.numpy()
    got = ["untouched"]
    pdist.gather(_t(x["f"]), got, dst=3)
    out["gather"] = (np.stack([g.numpy() for g in got]) if rank == 3
                     else got)
    got = []
    pdist.alltoall([_t(r) for r in x["l"]], got)
    out["alltoall"] = np.stack([g.numpy() for g in got])
    out["alltoall_single"] = pdist.alltoall_single(_t(x["s"])).numpy()
    nxt, prv = (rank + 1) % N, (rank - 1) % N
    t = torch.zeros(3, 4)
    if rank % 2 == 0:
        pdist.send(_t(x["f"]), dst=nxt)
        pdist.recv(t, src=prv)
    else:
        pdist.recv(t, src=prv)
        pdist.send(_t(x["f"]), dst=nxt)
    out["send_recv"] = t.numpy()
    t = torch.zeros(3, 4)
    tasks = [pdist.isend(_t(x["f"]), dst=nxt), pdist.irecv(t, src=prv)]
    for task in tasks:
        task.wait()
    out["isend_irecv"] = t.numpy()
    t = torch.zeros(3, 4)
    for task in pdist.batch_isend_irecv([
            pdist.P2POp(pdist.isend, _t(x["f"]), nxt),
            pdist.P2POp(pdist.irecv, t, prv)]):
        task.wait()
    out["batch_isend_irecv"] = t.numpy()
    t = torch.zeros(2)
    pdist.reduce_scatter(t, [_t(r) for r in x["l"]])
    out["reduce_scatter_list"] = t.numpy()
    t = _t(x["s"][:, 0])
    pdist.reduce_scatter(t)
    out["reduce_scatter"] = t.numpy()
    g02 = pdist.new_group([0, 2])
    t = _t(x["f"])
    if rank in (0, 2):
        pdist.all_reduce(t, group=g02)
    out["new_group"] = (t.numpy(), g02.rank, g02.nranks)
    objs = []
    pdist.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = objs
    objs = [None, None] if rank != 1 else [("from", 1), {"k": [1, 2]}]
    pdist.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    objs = []
    pdist.scatter_object_list(
        objs, [("to", r) for r in range(N)] if rank == 0 else None, src=0)
    out["scatter_object_list"] = objs
    pdist.barrier()
    out["backend"] = pdist.get_backend()
    out["counts"] = dict(ops.COLLECTIVES)
    out["backends"] = dict(ops.COLLECTIVE_BACKENDS)
    return out


def _topology(rank):
    fleet.init(strategy=_strategy(2, 2), device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    return {"dp_rank": hcg.get_data_parallel_rank(),
            "sharding_rank": hcg.get_sharding_parallel_rank(),
            "sizes": (hcg.get_data_parallel_world_size(),
                      hcg.get_sharding_parallel_world_size()),
            "dp_ranks": dist.get_process_group_ranks(
                hcg.get_data_parallel_group()),
            "sharding_ranks": dist.get_process_group_ranks(
                hcg.get_sharding_parallel_group()),
            "src": (hcg.get_data_parallel_group_src_rank(),
                    hcg.get_sharding_parallel_group_src_rank()),
            "global": hcg.get_global_rank(),
            "mode": hcg.get_parallel_mode(),
            "batch_rows": shard_batch(torch.arange(8)).tolist()}


def _gpt_step(rank, state):
    """One dp-4 step of GPT-2-tiny through fleet's wrappers."""
    fleet.init(strategy=_strategy(N), device="cpu")
    from paddle_tpu_torch.models.gpt import gpt2_tiny
    model = (gpt_from_jax_state(state, GPTConfig(**GPT), device="cpu")
             if rank == 0 else gpt2_tiny(device="cpu", seed=7 + rank,
                                         dropout=0.0))
    dp_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(
        AdamW(1e-3, parameters=model.named_parameters()))
    data = _gpt_data()
    x = shard_batch(torch.from_numpy(data[:, :-1]))
    y = shard_batch(torch.from_numpy(data[:, 1:]))
    ops.reset_collectives()
    loss = dp_model(x, labels=y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    counts = dict(ops.COLLECTIVES)
    return {"type": type(dp_model).__name__, "loss": loss.item(),
            "counts": counts,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def _mlp(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.nn.Sequential(
        Linear(6, 8, device="cpu", trainable=True, generator=g),
        torch.nn.Tanh(),
        Linear(8, 3, device="cpu", trainable=True, generator=g))


def _xy(rows, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((rows, 6)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal(
            (rows, 3)).astype(np.float32)))


def _no_sync(rank):
    """Two backwards under ``no_sync`` then ``apply_gradients``: the
    gradients, and the all-reduces at each stage."""
    model = DataParallel(_mlp(rank))
    x, y = _xy(8, seed=10 + rank)
    ops.reset_collectives()
    with model.no_sync():
        for half in (slice(0, 4), slice(4, 8)):
            ((model(x[half]) - y[half]) ** 2).mean().backward()
    inside = dict(ops.COLLECTIVES)
    model.apply_gradients()
    model.apply_gradients()
    return {"inside": inside, "after": dict(ops.COLLECTIVES),
            "grads": [p.grad.numpy().copy() for p in model.parameters()],
            "params": [p.detach().numpy().copy()
                       for p in model.parameters()]}


def _worker(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "refs.pkl"), "rb") as f:
        gpt_state = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), N),
        rank=rank, world_size=N, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        out["collectives"] = _collectives(rank)
        out["topology"] = _topology(rank)
        out["gpt"] = _gpt_step(rank, gpt_state)
        out["no_sync"] = _no_sync(rank)
    finally:
        topology._HYBRID_GROUP[0] = None
        fleet._fleet_state.update(strategy=None, hcg=None)
        pdist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX's gpt2_tiny(dropout=0.0) from paddle.seed(123), its state as
    numpy."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import gpt2_tiny
    paddle.seed(123)
    m = gpt2_tiny(dropout=0.0)
    return m, {k: np.asarray(v._data) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def spawned(jax_gpt, tmp_path_factory):
    """The 4 gloo ranks, started as soon as the JAX weights exist; killed
    at the module's end if still alive."""
    workdir = str(tmp_path_factory.mktemp("dist_group"))
    with open(os.path.join(workdir, "refs.pkl"), "wb") as f:
        pickle.dump(jax_gpt[1], f)
    ctx = mp.start_processes(_worker, args=(workdir,), nprocs=N, join=False,
                             start_method="spawn")
    yield ctx, workdir, time.monotonic() + JOIN_LIMIT_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(10)


@pytest.fixture(scope="module")
def refs(spawned, jax_gpt):
    """JAX's shard_map results on a 4-device mesh, and its whole-batch
    GPT-2-tiny step."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    import paddle_tpu as paddle
    mesh = Mesh(np.array(jax.devices()[:N]), ("r",))
    xs = [_x(r) for r in range(N)]

    def smap(fn, key, out_spec=P("r")):
        stacked = jnp.asarray(np.concatenate([x[key] for x in xs]))
        res = shard_map(fn, mesh=mesh, in_specs=P("r"), out_specs=out_spec,
                        check_rep=False)(stacked)
        res = np.asarray(res)
        return (np.split(res, N) if out_spec == P("r")
                else [res] * N)

    me = lambda: lax.axis_index("r")           # noqa: E731
    gather = lambda x: lax.all_gather(x, "r")  # noqa: E731
    out = {}
    for name, fn in (("SUM", lambda x: lax.psum(x, "r")),
                     ("MAX", lambda x: lax.pmax(x, "r")),
                     ("MIN", lambda x: lax.pmin(x, "r")),
                     ("PROD", lambda x: jnp.prod(gather(x), 0)),
                     ("AVG", lambda x: lax.pmean(x, "r"))):
        out["all_reduce", name, "f"] = smap(fn, "f")
        if name != "AVG":
            out["all_reduce", name, "i"] = smap(fn, "i")
    out["all_gather"] = smap(gather, "f", P())
    out["broadcast"] = smap(lambda x: gather(x)[2], "f", P())
    out["reduce"] = smap(lambda x: jnp.where(me() == 1, lax.psum(x, "r"), x),
                         "f")
    out["scatter"] = smap(lambda x: gather(x)[0][me()][None], "l")
    out["gather"] = smap(gather, "f", P())
    out["alltoall"] = smap(lambda x: lax.all_to_all(x, "r", 0, 0, tiled=True),
                           "l")
    out["alltoall_single"] = smap(
        lambda x: lax.all_to_all(x, "r", 0, 0, tiled=True), "s")
    ring = [(i, (i + 1) % N) for i in range(N)]
    out["ring"] = smap(lambda x: lax.ppermute(x, "r", ring), "f")
    out["reduce_scatter_list"] = smap(
        lambda x: lax.psum_scatter(x.reshape(-1), "r", tiled=True), "l")
    xs_s = [{"c": x["s"][:, 0]} for x in xs]
    stacked = jnp.asarray(np.concatenate([x["c"] for x in xs_s]))
    out["reduce_scatter"] = np.split(np.asarray(shard_map(
        lambda x: lax.psum_scatter(x, "r", tiled=True), mesh=mesh,
        in_specs=P("r"), out_specs=P("r"), check_rep=False)(stacked)), N)
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("r",))
    pair = jnp.asarray(np.concatenate([xs[0]["f"], xs[2]["f"]]))
    out["new_group"] = np.split(np.asarray(shard_map(
        lambda x: lax.psum(x, "r"), mesh=mesh2, in_specs=P("r"),
        out_specs=P("r"), check_rep=False)(pair)), 2)[0]
    # the whole-batch serial GPT-2-tiny step (tests/test_distributed.py:192)
    m, _ = jax_gpt
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=m.parameters())
    data = _gpt_data().astype(np.int32)
    loss = m(paddle.to_tensor(data[:, :-1]),
             labels=paddle.to_tensor(data[:, 1:]))
    loss.backward()
    opt.step()
    opt.clear_grad()
    out["gpt"] = (float(loss.numpy()),
                  {k: np.asarray(v._data) for k, v in m.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def group(spawned, refs):
    """Every rank's results, read once the group has finished (``refs``
    first: JAX's references run while the group works)."""
    ctx, workdir, deadline = spawned
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            pytest.fail(f"the gloo group did not finish in {JOIN_LIMIT_S} s")
    results = []
    for rank in range(N):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def assert_params_close(got, want, lr, steps):
    """Parameters after ``steps`` Adam steps at ``lr``: within
    TOLERANCES["train_params_fp32"] but for the share of elements that
    ["train_params_outliers"] allows, each within its per-step cap (Adam
    turns a gradient's rounding noise near zero into a step of ~lr)."""
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


def _close(got, want):
    if np.issubdtype(np.asarray(want).dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOLERANCES["attention_fp32"])


@pytest.mark.parametrize("op", RED_OPS)
def test_all_reduce_matches_shard_map(group, refs, op):
    for dtype in ("f", "i"):
        if (op == "AVG") and dtype == "i":
            continue
        for r in range(N):
            _close(group[r]["collectives"]["all_reduce", op, dtype],
                   refs["all_reduce", op, dtype][r])


def test_collectives_match_shard_map(group, refs):
    for r in range(N):
        c = group[r]["collectives"]
        for name in ("all_gather", "broadcast", "reduce", "alltoall",
                     "alltoall_single", "reduce_scatter_list",
                     "reduce_scatter"):
            _close(c[name], np.reshape(refs[name][r], np.shape(c[name])))
        _close(c["scatter"], refs["scatter"][r].reshape(-1))
        for name in ("send_recv", "isend_irecv", "batch_isend_irecv"):
            _close(c[name], refs["ring"][r])
    _close(group[3]["collectives"]["gather"], refs["gather"][3])
    assert [group[r]["collectives"]["gather"] for r in range(3)] == \
        [["untouched"]] * 3


def test_new_group_and_objects(group, refs):
    for r in range(N):
        c = group[r]["collectives"]
        t, rank_in, nranks = c["new_group"]
        if r in (0, 2):
            _close(t, refs["new_group"])
            assert (rank_in, nranks) == (r // 2, 2)
        else:
            _close(t, _x(r)["f"])
            assert (rank_in, nranks) == (-1, 2)
        assert c["all_gather_object"] == [{"rank": k} for k in range(N)]
        assert c["broadcast_object_list"] == [("from", 1), {"k": [1, 2]}]
        assert c["scatter_object_list"] == [("to", r)]
        assert c["backend"] == "GLOO"


def test_each_op_counts_once(group):
    """``COLLECTIVES`` holds one call per op call, all on gloo."""
    c = group[0]["collectives"]
    want = {"all_reduce": 10, "all_gather": 1, "broadcast": 1, "reduce": 1,
            "scatter": 1, "gather": 1, "alltoall": 1, "alltoall_single": 1,
            "send": 2, "recv": 2, "batch_isend_irecv": 2,
            "reduce_scatter": 2, "all_gather_object": 1,
            "broadcast_object_list": 1, "scatter_object_list": 1,
            "barrier": 1}
    assert c["counts"] == want
    assert c["backends"] == {"gloo": sum(want.values())}
    assert group[1]["collectives"]["counts"]["all_reduce"] == 9


def test_topology_dp2_sharding2(group):
    """Mesh order (pp, dp, sharding, sep, mp): rank = 2 dp + sharding."""
    for r in range(N):
        t = group[r]["topology"]
        dp, sh = divmod(r, 2)
        assert (t["dp_rank"], t["sharding_rank"]) == (dp, sh)
        assert t["sizes"] == (2, 2)
        assert t["dp_ranks"] == [sh, 2 + sh]
        assert t["sharding_ranks"] == [2 * dp, 2 * dp + 1]
        assert t["src"] == (sh, 2 * dp)
        assert t["global"] == r
        assert t["mode"] == "sharding_parallel"
        assert t["batch_rows"] == [2 * r, 2 * r + 1]


def test_gpt2_dp_matches_whole_batch_step(group, refs):
    """DataParallel through fleet against JAX's whole-batch serial step:
    the mean of the ranks' losses and every rank's parameters; one
    all-reduce bucket, and the HybridParallelOptimizer adds none."""
    loss, state = refs["gpt"]
    for r in range(N):
        g = group[r]["gpt"]
        assert g["type"] == "DataParallel"
        assert g["counts"] == {"all_reduce": 1}
        assert_params_close(g["params"], state, lr=1e-3, steps=1)
    np.testing.assert_allclose(np.mean([g["gpt"]["loss"] for g in group]),
                               loss, **TOLERANCES["train_loss_fp32"])


def test_no_sync_then_apply_gradients(group):
    """No all-reduce under ``no_sync``; ``apply_gradients`` reduces the
    accumulated gradients once (a second call does nothing): every rank
    holds the mean of the ranks' sums."""
    want = None
    sums = []
    for r in range(N):
        model = _mlp(0)
        x, y = _xy(8, seed=10 + r)
        for half in (slice(0, 4), slice(4, 8)):
            ((model(x[half]) - y[half]) ** 2).mean().backward()
        sums.append([p.grad.numpy() for p in model.parameters()])
    want = [np.mean([s[i] for s in sums], 0) for i in range(len(sums[0]))]
    for r in range(N):
        ns = group[r]["no_sync"]
        assert ns["inside"] == {}
        assert ns["after"] == {"all_reduce": 1}
        for got, w in zip(ns["grads"], want):
            np.testing.assert_allclose(got, w,
                                       **TOLERANCES["train_grads_fp32"])
        for got, w in zip(ns["params"], _mlp(0).parameters()):
            np.testing.assert_array_equal(got, w.detach().numpy())


# ------------------------------------------------------------- in-process
@pytest.fixture
def world1():
    """A one-rank gloo group in this process, destroyed after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    pdist.destroy_process_group()


def test_eager_collectives_single_world(world1):
    """JAX's TestEagerCollectivesSingleWorld on a one-rank group."""
    t = torch.tensor([1.0, 2.0])
    pdist.all_reduce(t)
    np.testing.assert_allclose(t.numpy(), [1.0, 2.0])
    outs = []
    pdist.all_gather(outs, torch.tensor([3.0]))
    assert len(outs) == 1
    np.testing.assert_allclose(outs[0].numpy(), [3.0])
    t = torch.tensor([5.0])
    pdist.broadcast(t, src=0)
    pdist.barrier()
    np.testing.assert_allclose(t.numpy(), [5.0])
    outs = []
    pdist.gather(torch.tensor([7.0]), outs, dst=0)
    assert len(outs) == 1
    np.testing.assert_allclose(outs[0].numpy(), [7.0])
    objs = [{"a": 1}, "x"]
    pdist.broadcast_object_list(objs, src=0)
    assert objs == [{"a": 1}, "x"]
    out = []
    pdist.scatter_object_list(out, [("p", 2)], src=0)
    assert out == [("p", 2)]
    with pytest.raises(ValueError, match="one object per rank"):
        pdist.scatter_object_list([], [("a",), ("b",)], src=0)
    assert pdist.get_backend() == "GLOO"
    t = torch.tensor([1.0])
    tasks = pdist.batch_isend_irecv([pdist.P2POp(pdist.isend, t, 0),
                                     pdist.P2POp(pdist.irecv, t, 0)])
    assert len(tasks) == 2
    for task in tasks:
        task.wait()
    with pytest.raises(ValueError):
        pdist.P2POp(pdist.all_reduce, t, 0)
    assert pdist.is_initialized() and pdist.get_group(0).nranks == 1
    env = pdist.ParallelEnv()
    assert (env.rank, env.world_size, env.nranks) == (0, 1, 1)


@pytest.mark.parametrize("wrap", ["dp", "os", "os_g", "p_g_os"])
def test_a_dropped_wrapper_frees_its_model(world1, wrap):
    """The gradient hooks hold their reducer weakly: once the caller drops
    the model, its wrapper and optimizer, the parameters are freed (a
    hook in C++ would otherwise keep the cycle alive)."""
    import gc
    import weakref
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    model = _mlp(0)
    opt = SGD(0.1, parameters=model.named_parameters())
    if wrap == "dp":
        wrapped = DataParallel(model)
    else:
        wrapped, opt, _ = group_sharded_parallel(model, opt, level=wrap)
    x, y = _xy(4)
    ((wrapped(x) - y) ** 2).mean().backward()
    opt.step()
    ref = weakref.ref(model[0].weight)
    del model, opt, wrapped
    gc.collect()
    assert ref() is None


def test_collectives_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        pdist.all_reduce(torch.ones(2))


def test_reduce_ops_and_strategy_follow_jax():
    from paddle_tpu.distributed import ReduceOp
    from paddle_tpu.distributed.fleet import DistributedStrategy
    for name in RED_OPS:
        assert getattr(pdist.ReduceOp, name) == getattr(ReduceOp, name)
    got, want = fleet.DistributedStrategy(), DistributedStrategy()
    assert vars(got) == vars(want)
    assert repr(got) == repr(want)


def test_topology_ranks_and_parallel_mode_follow_jax():
    """JAX's rank/coordinate cases with a sharding axis, and
    ``get_parallel_mode`` over a grid of degrees (the rule alone: the
    port's groups need their processes)."""
    import itertools
    from paddle_tpu.distributed.fleet.base import topology as jtopo
    names = ("data", "pipe", "sharding", "sep", "model")
    for dims in ((2, 2, 1, 1, 2), (2, 1, 2, 1, 1), (1, 1, 4, 2, 1)):
        got = topology.CommunicateTopology(names, dims)
        want = jtopo.CommunicateTopology(names, dims)
        assert got.world_size() == want.world_size()
        for r in range(got.world_size()):
            assert got.get_coord(r) == want.get_coord(r)
            assert got.get_rank(**dict(zip(names, got.get_coord(r)))) == r
        for axis in names:
            assert got.get_comm_list(axis) == want.get_comm_list(axis)
    topo = topology.CommunicateTopology(names, (2, 1, 2, 1, 1))
    assert topo.get_rank(data=1, pipe=0, sharding=1, sep=0, model=0) == 3
    assert topo.get_coord(2) == (1, 0, 0, 0, 0)
    assert [0, 1] in topo.get_comm_list("sharding")
    for dp, pp, sh, mp_ in itertools.product((1, 2), repeat=4):
        stub = types.SimpleNamespace(_dp_degree=dp, _pp_degree=pp,
                                     _sharding_degree=sh, _mp_degree=mp_)
        assert topology.HybridCommunicateGroup.get_parallel_mode(stub) == \
            jtopo.HybridCommunicateGroup.get_parallel_mode(stub), \
            (dp, pp, sh, mp_)


def _spawn_dp_step(workdir):
    """One rank of ``spawn``'s 2-rank data-parallel step of ``_mlp``:
    its parameters after one SGD step on its half of the batch."""
    torch.set_num_threads(1)
    pdist.init_parallel_env(device="cpu")
    rank = pdist.get_rank()
    model = DataParallel(_mlp(rank))
    opt = SGD(0.1, parameters=model.named_parameters())
    x, y = _xy(8)
    ops.reset_collectives()
    ((model(x[4 * rank:4 * rank + 4]) - y[4 * rank:4 * rank + 4]) ** 2
     ).mean().backward()
    opt.step()
    with open(os.path.join(workdir, f"spawn{rank}.pkl"), "wb") as f:
        pickle.dump(([p.detach().numpy() for p in model.parameters()],
                     dict(ops.COLLECTIVES), os.environ["PADDLE_TRAINER_ID"]),
                    f)
    pdist.destroy_process_group()


def test_spawn_runs_a_dp_step(tmp_path):
    pdist.spawn(_spawn_dp_step, args=(str(tmp_path),), nprocs=2)
    model = _mlp(0)
    opt = SGD(0.1, parameters=model.named_parameters())
    x, y = _xy(8)
    ((model(x) - y) ** 2).mean().backward()
    opt.step()
    for r in range(2):
        with open(tmp_path / f"spawn{r}.pkl", "rb") as f:
            params, counts, trainer_id = pickle.load(f)
        assert counts == {"all_reduce": 1} and trainer_id == str(r)
        for got, want in zip(params, model.parameters()):
            np.testing.assert_allclose(got, want.detach().numpy(),
                                       **TOLERANCES["train_params_fp32"])


def test_spawn_raises_on_a_failed_child():
    with pytest.raises(RuntimeError, match="exited non-zero"):
        pdist.spawn(os._exit, args=(3,), nprocs=2)


def test_framework_io_reads_and_writes_jax_files(tmp_path):
    """``framework.save`` / ``load`` and JAX's read each other's files."""
    from paddle_tpu.framework import io as jio
    state = {"w": torch.arange(6.0).reshape(2, 3), "n": 3,
             "nested": [torch.ones(2, dtype=torch.bfloat16),
                        (torch.tensor([1, 2]),)]}
    from paddle_tpu_torch.framework import load, save
    save(state, str(tmp_path / "a.pdparams"))
    got = jio.load(str(tmp_path / "a.pdparams"), return_numpy=True)
    np.testing.assert_array_equal(got["w"], state["w"].numpy())
    assert got["n"] == 3 and got["nested"][0].dtype.name == "bfloat16"
    jio.save(got, str(tmp_path / "b.pdparams"))
    back = load(str(tmp_path / "b.pdparams"))
    assert torch.equal(back["w"], state["w"])
    assert torch.equal(back["nested"][0], state["nested"][0])
    assert torch.equal(back["nested"][1][0], state["nested"][1][0])
