"""The port's context parallelism against the JAX package's.

JAX's ``make_ring_attention_fn`` / ``make_ulysses_attention_fn`` on a
4-device CPU ``Mesh`` (``shard_map``, jitted) are the reference, computed
once for the module: B=2, S=64, D=8, H=4 causal and not and GQA 8 / 2
causal (JAX's tests/test_context_parallel.py shapes), the ring with its
composite chunk, and GQA also with ``PADDLE_TPU_RING_KERNEL_CPU=1`` (its
Pallas chunk kernel in interpret mode; the port takes the kernel's plain
version); and JAX's ``llama_tiny(tensor_parallel=False,
context_parallel=True)`` under a fleet ``sep_degree`` 4 (seq 32): logits,
the loss and the step-1 gradients.

In this process, ``_ring_attention_serial`` (the port's ring loop for 4
ranks in one process) and ``_chunk_attn`` / ``_merge`` are held to them.
One group of 4 gloo processes, spawned once for the module, runs the
distributed path on a fleet ``sep_degree`` 4 mesh: ``make_ring_attention_
fn`` with the composite chunk and with the kernel's plain version,
``make_ulysses_attention_fn`` with the composite and with the flash
kernels' plain versions, ``llama_tiny`` with ``context_parallel=True`` and
``"ulysses"`` from the JAX weights (``weights.llama_from_jax_state``); then
a dp 2 x sep 2 mesh, whose sep groups must be {0, 1} and {2, 3}. Every
rank returns its outputs and gradients, which must be the global-view
ones, through a file, and the parent holds them to JAX within
TOLERANCES["attention_fp32"] / ["attention_grad_fp32"] (attention) and
["logits_fp32"] / ["train_loss_fp32"] / ["train_grads_fp32"] (LLaMA).

The group rendezvous through a FileStore under the test's temporary
directory, its process group has a 60 s timeout and the parent joins it
with a limit, so a hung collective fails the test instead of the suite.
JAX is imported inside the tests only: the spawned processes import this
module and stay torch-only.
"""
import contextlib
import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.parallel import context_parallel as cp
from paddle_tpu_torch.parallel import current_mesh
from paddle_tpu_torch.weights import llama_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N, B, S, D = 4, 2, 64, 8
# case -> (heads, kv heads, causal)
CASES = {"causal": (4, 4, True), "full": (4, 4, False), "gqa": (8, 2, True)}
ULYSSES = ("causal", "full")
# (case, with the chunk kernel): the composite for every case, the
# kernel (JAX: in interpret mode) for causal GQA, whose steps take every
# kind of diagonal offset
KEYS = [("causal", False), ("full", False), ("gqa", False), ("gqa", True)]
LLAMA = {"vocab_size": 256, "hidden_size": 64, "num_layers": 2,
         "num_heads": 4, "intermediate_size": 128, "max_position": 128,
         "tensor_parallel": False}
LLAMA_B, LLAMA_S = 2, 32
JOIN_LIMIT_S = 180


def _inputs(case, seed=0):
    """Numpy q, k, v [B, S, H(k), D] and the output cotangent."""
    h, hk, _ = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case) + 10 * seed)
    q = rng.standard_normal((B, S, h, D)).astype(np.float32)
    k = rng.standard_normal((B, S, hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, hk, D)).astype(np.float32)
    g = rng.standard_normal((B, S, h, D)).astype(np.float32)
    return q, k, v, g


def _llama_ids():
    ids = np.random.default_rng(0).integers(0, 256, (LLAMA_B, LLAMA_S + 1))
    return ids[:, :-1], ids[:, 1:]


@contextlib.contextmanager
def _env(name, value):
    """``name`` set to ``value`` (None: unset) inside, restored after."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _run_attn(fn, q, k, v, g):
    """(o, [dq, dk, dv]) of fn through the loss sum(o * g), as numpy."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fn(qt, kt, vt)
    (o * torch.from_numpy(g)).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _run_llama(state, scheme):
    """(logits, loss, step-1 gradients) of the port's llama_tiny with
    ``context_parallel=scheme`` from the JAX weights."""
    model = llama_from_jax_state(
        state, LlamaConfig(**LLAMA, context_parallel=scheme), device="cpu")
    x, y = (torch.from_numpy(a) for a in _llama_ids())
    with torch.no_grad():
        logits = model(x).numpy()
    loss = model(x, labels=y)
    loss.backward()
    return logits, loss.item(), {n: p.grad.numpy()
                                 for n, p in model.named_parameters()}


def _strategy(dp, sep):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1, "sep_degree": sep}
    return s


def _worker(rank, workdir):
    """One rank of the gloo group: every distributed run, its results
    pickled to ``workdir/rank<rank>.pkl``."""
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "refs.pkl"), "rb") as f:
        llama_state = pickle.load(f)["llama_state"]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), N),
        rank=rank, world_size=N, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        fleet.init(strategy=_strategy(1, N), device="cpu")
        mesh = current_mesh()
        for case, kern in KEYS:
            with _env("PADDLE_TPU_RING_KERNEL_CPU", "1" if kern else None):
                out["ring", case, kern] = _run_attn(
                    cp.make_ring_attention_fn(mesh, causal=CASES[case][2]),
                    *_inputs(case))
        for case in ULYSSES:
            for flash in (False, True):
                with _env("PADDLE_TPU_ULYSSES_FLASH_CPU",
                          "1" if flash else None):
                    out["ulysses", case, flash] = _run_attn(
                        cp.make_ulysses_attention_fn(
                            mesh, causal=CASES[case][2]), *_inputs(case))
        try:
            _run_attn(cp.make_ulysses_attention_fn(mesh, causal=True),
                      *_inputs("gqa"))
        except ValueError as e:
            out["ulysses_gqa_error"] = str(e)
        for scheme in (True, "ulysses"):
            out["llama", scheme] = _run_llama(llama_state, scheme)
        fleet.init(strategy=_strategy(2, 2), device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        dp = hcg.get_data_parallel_rank()
        out["dp2_sep2"] = (
            dp, hcg.get_sep_parallel_rank(),
            (hcg.get_data_parallel_world_size(),
             hcg.get_sep_parallel_world_size()),
            dist.get_process_group_ranks(hcg.get_data_parallel_group()),
            dist.get_process_group_ranks(hcg.get_sep_parallel_group()),
            _run_attn(cp.make_ring_attention_fn(current_mesh(), causal=True),
                      *_inputs("causal", seed=1 + dp)))
    finally:
        topology._HYBRID_GROUP[0] = None
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_attn(make, mesh, case, seed=0):
    """(o, [dq, dk, dv]) of JAX's global-view function through the loss
    sum(o * g), as numpy."""
    import jax
    import jax.numpy as jnp
    q, k, v, g = _inputs(case, seed)
    fn = jax.jit(make(mesh, causal=CASES[case][2]))
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _jax_llama_model():
    """JAX's llama_tiny(tensor_parallel=False, context_parallel=True) from
    paddle.seed(5), and its state as numpy."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import llama_tiny
    paddle.seed(5)
    m = llama_tiny(tensor_parallel=False, context_parallel=True)
    return m, {k: np.array(v.numpy()) for k, v in m.state_dict().items()}


def _jax_llama(m):
    """JAX's ring LLaMA under fleet sep_degree 4: (logits, loss, step-1
    gradients). The shard_map function is jitted (as JAX's own tests call
    it) so that its layers share one compile."""
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.parallel.context_parallel as jcp
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet.base.topology import _HYBRID_GROUP
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": N}
    make = jcp.make_ring_attention_fn
    jcp.make_ring_attention_fn = lambda *a, **k: jax.jit(make(*a, **k))
    try:
        jfleet.init(is_collective=True, strategy=strategy)
        assert m.llama.layers[0].self_attn._ring_fn() is not None
        x, y = (paddle.to_tensor(a.astype(np.int32)) for a in _llama_ids())
        logits = m(x).numpy()
        loss = m(x, labels=y)
        loss.backward()
        grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
        return logits, float(loss.numpy()), grads
    finally:
        jcp.make_ring_attention_fn = make
        _HYBRID_GROUP[0] = None


@pytest.fixture(scope="module")
def jax_llama():
    return _jax_llama_model()


@pytest.fixture(scope="module")
def spawned(jax_llama, tmp_path_factory):
    """The 4 gloo ranks, started as soon as the JAX weights exist so that
    they run while this process computes the JAX references; killed at
    the module's end if still alive."""
    workdir = str(tmp_path_factory.mktemp("cp_group"))
    with open(os.path.join(workdir, "refs.pkl"), "wb") as f:
        pickle.dump({"llama_state": jax_llama[1]}, f)
    ctx = mp.start_processes(_worker, args=(workdir,), nprocs=N, join=False,
                             start_method="spawn")
    yield ctx, workdir, time.monotonic() + JOIN_LIMIT_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(10)


@pytest.fixture(scope="module")
def refs(spawned, jax_llama):
    """Every JAX reference of the module, computed once."""
    import jax
    from jax.sharding import Mesh
    import paddle_tpu.parallel.context_parallel as jcp
    mesh4 = Mesh(np.array(jax.devices()[:N]), ("sep",))
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("sep",))
    out = {}
    for case, kern in KEYS:
        with _env("PADDLE_TPU_RING_KERNEL_CPU", "1" if kern else None):
            out["ring", case, kern] = _jax_attn(jcp.make_ring_attention_fn,
                                                mesh4, case)
    for case in ULYSSES:
        out["ulysses", case] = _jax_attn(jcp.make_ulysses_attention_fn,
                                         mesh4, case)
    for dp in (0, 1):
        out["dp2_sep2", dp] = _jax_attn(jcp.make_ring_attention_fn, mesh2,
                                        "causal", seed=1 + dp)
    out["llama"] = _jax_llama(jax_llama[0])
    return out


@pytest.fixture(scope="module")
def group(spawned):
    """The results of the 4 spawned gloo ranks, one dict a rank; fails if
    they have not all finished by the join limit."""
    ctx, workdir, deadline = spawned
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            pytest.fail(f"the gloo group did not finish in {JOIN_LIMIT_S} s")
    results = []
    for rank in range(N):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _close_attn(got, want):
    o, grads = got
    o_w, grads_w = want
    np.testing.assert_allclose(o, o_w, **TOLERANCES["attention_fp32"])
    for name, a, w in zip(("dq", "dk", "dv"), grads, grads_w):
        np.testing.assert_allclose(a, w, err_msg=name,
                                   **TOLERANCES["attention_grad_fp32"])


IDS = [f"{case}-{'kernel' if kern else 'composite'}" for case, kern in KEYS]


@pytest.mark.parametrize("case,kern", KEYS, ids=IDS)
def test_serial_ring_matches_jax(refs, monkeypatch, case, kern):
    """The ring loop for 4 ranks in one process (the harness of the
    card's check) against JAX's shard_map ring, forward and gradients."""
    if kern:
        monkeypatch.setenv("PADDLE_TPU_RING_KERNEL_CPU", "1")
    causal = CASES[case][2]
    _close_attn(_run_attn(lambda q, k, v: cp._ring_attention_serial(
        q, k, v, N, causal), *_inputs(case)), refs["ring", case, kern])


@pytest.mark.parametrize("case,kern", KEYS, ids=IDS)
def test_distributed_ring_matches_jax(refs, group, case, kern):
    """make_ring_attention_fn over 4 gloo ranks: every rank's output and
    gradients equal JAX's global-view ones."""
    for rank, res in enumerate(group):
        _close_attn(res["ring", case, kern], refs["ring", case, kern])


@pytest.mark.parametrize("case,flash", [(c, f) for c in ULYSSES
                                        for f in (False, True)])
def test_distributed_ulysses_matches_jax(refs, group, case, flash):
    for res in group:
        _close_attn(res["ulysses", case, flash], refs["ulysses", case])


def test_ulysses_refuses_kv_heads_below_sep(group):
    for res in group:
        assert res["ulysses_gqa_error"].startswith(
            "kv heads 2 not divisible by sep=4")


def test_dp2_sep2_mesh_picks_the_sep_groups(refs, group):
    """On a dp 2 x sep 2 mesh rank r is (dp r // 2, sep r % 2), its sep
    group the ranks of its dp index and its dp group those of its sep
    index, and each dp group's ring equals JAX's over its own inputs."""
    for rank, res in enumerate(group):
        dp, sep, sizes, dp_ranks, sep_ranks, got = res["dp2_sep2"]
        assert (dp, sep, sizes) == (rank // 2, rank % 2, (2, 2))
        assert dp_ranks == [sep, sep + 2]
        assert sep_ranks == [2 * dp, 2 * dp + 1]
        _close_attn(got, refs["dp2_sep2", dp])


@pytest.mark.parametrize("scheme", [True, "ulysses"], ids=["ring",
                                                            "ulysses"])
def test_llama_context_parallel_matches_jax(refs, group, scheme):
    """llama_tiny with context_parallel on sep 4 against JAX's ring LLaMA
    on its sep 4 mesh: logits, loss and step-1 gradients on every rank."""
    logits_w, loss_w, grads_w = refs["llama"]
    for res in group:
        logits, loss, grads = res["llama", scheme]
        np.testing.assert_allclose(logits, logits_w,
                                   **TOLERANCES["logits_fp32"])
        np.testing.assert_allclose(loss, loss_w,
                                   **TOLERANCES["train_loss_fp32"])
        assert set(grads) == set(grads_w)
        for name in grads_w:
            np.testing.assert_allclose(grads[name], grads_w[name],
                                       err_msg=name,
                                       **TOLERANCES["train_grads_fp32"])


def test_chunk_attn_and_merge_match_jax():
    """_chunk_attn (GQA, a mask with fully masked rows) and _merge against
    JAX's, values and gradients through both outputs."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu.parallel.context_parallel as jcp
    q, k, v, g = _inputs("gqa")
    rng = np.random.default_rng(3)
    glse = rng.standard_normal((B, 8, S)).astype(np.float32)
    mask = np.arange(S)[None, :] <= np.arange(S)[:, None] - 20

    def jax_fn(q, k, v):
        o, lse = jcp._chunk_attn(q, k, v, 0.3, jnp.asarray(mask))
        o2, lse2 = jcp._chunk_attn(q, k, v, 0.3, None)
        return jcp._merge(o, lse, o2 * 0.5, lse2 - 1.0)
    want, vjp = jax.vjp(jax.jit(jax_fn), *map(jnp.asarray, (q, k, v)))
    want_g = vjp((jnp.asarray(g), jnp.asarray(glse)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = cp._chunk_attn(qt, kt, vt, 0.3, torch.from_numpy(mask))
    o2, lse2 = cp._chunk_attn(qt, kt, vt, 0.3, None)
    got = cp._merge(o, lse, o2 * 0.5, lse2 - 1.0)
    assert torch.equal(lse[:, :, :20], torch.full_like(lse[:, :, :20],
                                                       -1e30))
    assert torch.equal(o[:, :20], torch.zeros_like(o[:, :20]))
    torch.autograd.backward(got, (torch.from_numpy(g),
                                  torch.from_numpy(glse)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   **TOLERANCES["attention_fp32"])
    for name, a, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   err_msg=name,
                                   **TOLERANCES["attention_grad_fp32"])


def test_ring_kernel_gate_matches_jax(monkeypatch):
    """_use_ring_kernel on CPU tensors: the composite by default, the
    kernel's plain version under PADDLE_TPU_RING_KERNEL_CPU=1, the
    composite again under PADDLE_TPU_RING_COMPOSITE=1, and never for a
    head dim above 256 — as JAX decides off the TPU."""
    import jax.numpy as jnp
    import paddle_tpu.parallel.context_parallel as jcp
    for env in ({}, {"PADDLE_TPU_RING_KERNEL_CPU": "1"},
                {"PADDLE_TPU_RING_KERNEL_CPU": "1",
                 "PADDLE_TPU_RING_COMPOSITE": "1"}):
        for name in ("PADDLE_TPU_RING_KERNEL_CPU",
                     "PADDLE_TPU_RING_COMPOSITE"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        for d in (64, 288):
            want = jcp._use_ring_kernel(jnp.zeros((2, 16, 4, d)),
                                        jnp.zeros((2, 16, 4, d)))
            assert cp._use_ring_kernel(torch.zeros((2, 16, 4, d)),
                                       torch.zeros((2, 16, 4, d))) == want


def test_ring_needs_a_divisible_sequence():
    q = torch.zeros((1, 66, 4, 8))
    with pytest.raises(ValueError, match="divisible by the sep degree 4"):
        cp._ring_attention_serial(q, q, q, N)


def test_topology_matches_jax_and_refuses_unported_degrees():
    """CommunicateTopology (copied) maps ranks as JAX's does; a pipeline
    degree above 1, or a model degree beside another one, raises before
    any process group is touched (a sharding degree is ported)."""
    from paddle_tpu.distributed.fleet.base.topology import \
        CommunicateTopology as JaxTopology
    names = ("data", "pipe", "sharding", "sep", "model")
    for dims in ((2, 1, 1, 4, 1), (2, 1, 1, 2, 2)):
        got = topology.CommunicateTopology(names, dims)
        want = JaxTopology(names, dims)
        for axis in names:
            assert got.get_comm_list(axis) == want.get_comm_list(axis)
        assert [got.get_coord(r) for r in range(got.world_size())] == \
            [want.get_coord(r) for r in range(want.world_size())]
    for dims in ((1, 2, 1, 2, 1), (1, 2, 2, 1, 1), (1, 1, 1, 2, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            topology.HybridCommunicateGroup(
                topology.CommunicateTopology(names, dims), device_type="cpu")
