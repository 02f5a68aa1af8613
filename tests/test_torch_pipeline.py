"""The port's pipeline parallelism against the JAX package's, on the CPU.

One group of 2 gloo processes, spawned once for the module (a FileStore
under the test's temporary directory, a 60 s process-group timeout, a
join limit), runs under a fleet topology of pp 2, one stage a process:

- JAX's ``tests/test_fleet_pipeline.py`` cases, each stage built from
  ``LayerDesc``s of the same classes as JAX's and loaded with JAX's
  state (``weights.module_from_jax_state`` reads the stage's own keys):
  the pp 2 1F1B run (Stem, 8 Blocks, Head; ``accumulate_steps`` 4, SGD
  0.1, 3 steps), the interleaved run (2 virtual chunks a stage) and the
  tied weights (a ``SharedLayerDesc`` stem reused by the head's
  transpose, 2 steps at ``accumulate_steps`` 2); each rank's losses and
  the parameters gathered over the stages (``gather_full_state``)
  against JAX's serial run at JAX's tolerances (atol / rtol 1e-5), then
  ``eval_batch``'s loss and mean output (on every rank) against JAX's
  trained model's; and
  each step's ``COLLECTIVES`` equal to the design's
  (``pipeline_parallel``'s docstring: the sends and receives, the loss's
  broadcast, the shared weights' all-reduces, the announcements at the
  first step);
- ``parallel.pipeline`` against ``tests/test_pipeline_engine.py``:
  ``make_gpipe_fn`` forward at 1 and 2 layers a stage over 4 and 8
  micro-batches, its backward, and ``gpipe_interleaved`` at 6 and 7
  micro-batches (tails that do not fill a wave), outputs and gradients
  against JAX's serial layers and ``jax.grad`` within 1e-5.

In this process: ``segment_parts`` equal to JAX's, the micro-batch round
trip, the pp-1 micro-batch loop (a world-1 gloo group) against JAX's
serial steps, an activation whose shape departs from the one announced
raising before any send, and LLaMA's layers as a pipeline with recompute
under stage 3 (``chip_smoke.py`` phase 3k's run at a small size) against
the unwrapped model, with stage 3's gathers and reduce-scatters under
recompute and micro-batches counted.
"""
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
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication import ops
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel,
    PipelineParallelWithInterleave, SharedLayerDesc)
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_layers as mpl
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    pipeline_parallel as ppar
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models.llama import (LlamaBlock, LlamaConfig,
                                           LlamaForCausalLM)
from paddle_tpu_torch.nn import Linear, RMSNorm
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel.pipeline import (gpipe_interleaved,
                                                make_gpipe_fn, microbatch,
                                                unmicrobatch)
from paddle_tpu_torch.weights import gather_full_state, module_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N = 2
JOIN_LIMIT_S = 180
D, NLAYERS, TOL = 16, 8, {"atol": 1e-5, "rtol": 1e-5}
ENGINE_D = 16


class Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(D, D, trainable=True)

    def forward(self, x):
        return torch.tanh(self.fc(x)) + x


class Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(D, 4, trainable=True)

    def forward(self, x):
        return self.fc(x)


class Stem(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(D, D, trainable=True)

    def forward(self, x):
        return self.fc(x)


def mse(out, label):
    return ((out - label) ** 2).mean()


def head_fwd(layer, x):
    return x @ layer.fc.weight.t()


def _descs(kind):
    if kind == "tied":
        return ([SharedLayerDesc("tied", Stem)]
                + [LayerDesc(Block) for _ in range(4)]
                + [SharedLayerDesc("tied", Stem, forward_func=head_fwd)])
    return ([LayerDesc(Stem)] + [LayerDesc(Block) for _ in range(NLAYERS)]
            + [LayerDesc(Head)])


def _data(nsteps=3, batch=8, out=4):
    rng = np.random.RandomState(0)
    xs = [rng.randn(batch, D).astype(np.float32) for _ in range(nsteps)]
    ys = [rng.randn(batch, out).astype(np.float32) for _ in range(nsteps)]
    return xs, ys


def _tied_data():
    rng = np.random.RandomState(5)
    xs = [rng.randn(4, D).astype(np.float32) for _ in range(2)]
    ys = [rng.randn(4, D).astype(np.float32) for _ in range(2)]
    return xs, ys


# the fleet runs: name -> (descs, accumulate_steps, virtual chunks, data)
RUNS = {"pp2": ("plain", 4, 1, _data), "interleave": ("plain", 4, 2, _data),
        "tied": ("tied", 2, 1, _tied_data)}


def _strategy(pp, accumulate):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": pp,
                        "sharding_degree": 1, "sep_degree": 1,
                        "pp_configs": {"accumulate_steps": accumulate}}
    return s


def _fleet_run(state, name, pp):
    kind, acc, v, data = RUNS[name]
    fleet.init(strategy=_strategy(pp, acc), device="cpu")
    model = PipelineLayer(_descs(kind), num_stages=pp, loss_fn=mse,
                          num_virtual_pipeline_stages=v)
    module_from_jax_state(model, state)
    wrapped = fleet.distributed_model(model)
    opt = SGD(0.1, parameters=model.named_parameters())
    xs, ys = data()
    losses, counts = [], []
    for x, y in zip(xs, ys):
        ops.reset_collectives()
        loss = wrapped.train_batch([torch.from_numpy(x),
                                    torch.from_numpy(y)], opt)
        counts.append(dict(ops.COLLECTIVES))
        losses.append(loss.item())
    x, y = (torch.from_numpy(a) for a in (xs[0], ys[0]))
    return {"losses": losses, "counts": counts,
            "type": type(wrapped).__name__,
            "eval": (wrapped.eval_batch([x, y]).item(),
                     wrapped.eval_batch([x, y], compute_loss=False).numpy()),
            "params": {k: v.numpy() for k, v in
                       gather_full_state(model).items()}}


# ------------------------------------------------------- gpipe engine
def _engine_params(n_layers, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(n_layers, ENGINE_D, ENGINE_D)
                  * ENGINE_D ** -0.5).astype(np.float32),
            "b": (rng.randn(n_layers, ENGINE_D) * 0.1).astype(np.float32)}


def _stage_fn(stage_params, h):
    for w, b in zip(stage_params["w"], stage_params["b"]):
        h = torch.tanh(h @ w + b)
    return h


def _chunk_fn(cp, h):
    return torch.tanh(h @ cp["w"] + cp["b"])


def _stack(params, pp):
    return {k: torch.from_numpy(v.reshape(pp, v.shape[0] // pp,
                                          *v.shape[1:])).requires_grad_()
            for k, v in params.items()}


def _engine_runs(rank):
    out = {}
    for lps in (1, 2):
        for m in (4, 8):
            params = _engine_params(N * lps)
            x = torch.from_numpy(np.random.RandomState(1).randn(
                16, ENGINE_D).astype(np.float32))
            fn = make_gpipe_fn(_stage_fn, None, num_micro=m)
            with torch.no_grad():
                out["fwd", lps, m] = fn(_stack(params, N), x).numpy()
    params = _engine_params(N * 2)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        8, ENGINE_D).astype(np.float32))
    stacked = _stack(params, N)
    (make_gpipe_fn(_stage_fn, None, num_micro=4)(stacked, x) ** 2
     ).mean().backward()
    out["bwd"] = {k: v.grad[rank].numpy() for k, v in stacked.items()}
    v = 2
    for m in (6, 7):
        params = _engine_params(N * v)
        x = torch.from_numpy(np.random.RandomState(3).randn(
            m, 2, ENGINE_D).astype(np.float32))
        # stage i holds global chunks {i, P + i}
        chunk = {k: torch.from_numpy(
            a.reshape(v, N, *a.shape[1:])[:, rank].copy()).requires_grad_()
            for k, a in params.items()}
        loss = (gpipe_interleaved(_chunk_fn, chunk, x, num_chunks=v)
                ** 2).mean()
        loss.backward()
        out["interleaved", m] = (loss.item(), {k: t.grad.numpy()
                                               for k, t in chunk.items()})
    return out


def _worker(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "states.pkl"), "rb") as f:
        states = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), N),
        rank=rank, world_size=N, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        for name in RUNS:
            out[name] = _fleet_run(states[RUNS[name][0]], name, N)
        out["engine"] = _engine_runs(rank)
    finally:
        topology._HYBRID_GROUP[0] = None
        fleet._fleet_state.update(strategy=None, hcg=None)
        pdist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------- the parent
def _jax_models():
    import test_fleet_pipeline as J
    return J, {"plain": J.make_model(7),
               "tied": J.TestFleetPipelineShared()._make(11)}


@pytest.fixture(scope="module")
def jax_states():
    _, models = _jax_models()
    return {k: {n: np.asarray(v._data) for n, v in m.state_dict().items()}
            for k, m in models.items()}


@pytest.fixture(scope="module")
def spawned(jax_states, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("pp_group"))
    with open(os.path.join(workdir, "states.pkl"), "wb") as f:
        pickle.dump(jax_states, f)
    ctx = mp.start_processes(_worker, args=(workdir,), nprocs=N, join=False,
                             start_method="spawn")
    yield ctx, workdir, time.monotonic() + JOIN_LIMIT_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(10)


def _jax_serial(kind):
    """JAX's serial steps (SGD 0.1) of the run's model: losses and
    parameters by name."""
    import paddle_tpu as paddle
    J, models = _jax_models()
    model = models[kind]
    opt = paddle.optimizer.SGD(0.1, parameters=model.parameters())
    xs, ys = (_tied_data if kind == "tied" else _data)()
    losses = J.serial_steps(model, opt, xs, ys, len(xs))
    out = np.asarray(model.forward(paddle.to_tensor(xs[0]))._data)
    acc = RUNS["tied" if kind == "tied" else "pp2"][1]
    return {"losses": losses,
            "eval": (float(((out - ys[0]) ** 2).mean()),
                     out.reshape(acc, -1, *out.shape[1:]).mean(0)),
            "params": {n: np.asarray(v._data)
                       for n, v in model.state_dict().items()}}


def _jax_engine():
    """JAX's serial layers and their gradients for the engine cases."""
    import jax
    import jax.numpy as jnp
    import test_pipeline_engine as E
    out = {}
    for lps in (1, 2):
        for m in (4, 8):
            params = jax.tree.map(jnp.asarray, _engine_params(N * lps))
            x = jnp.asarray(np.random.RandomState(1).randn(16, ENGINE_D),
                            jnp.float32)
            out["fwd", lps, m] = np.asarray(E.serial_apply(params, x))
    params = jax.tree.map(jnp.asarray, _engine_params(N * 2))
    x = jnp.asarray(np.random.RandomState(2).randn(8, ENGINE_D), jnp.float32)
    g = jax.grad(lambda p: jnp.mean(E.serial_apply(p, x) ** 2))(params)
    out["bwd"] = {k: np.asarray(v).reshape(N, 2, *v.shape[1:])
                  for k, v in g.items()}
    v = 2
    for m in (6, 7):
        params = jax.tree.map(jnp.asarray, _engine_params(N * v))
        xm = jnp.asarray(np.random.RandomState(3).randn(m, 2, ENGINE_D),
                         jnp.float32)

        def loss(p):
            return jnp.mean(E.serial_apply(p, xm.reshape(-1, ENGINE_D)) ** 2)
        g = jax.grad(loss)(params)
        out["interleaved", m] = (float(loss(params)), {
            k: np.asarray(a).reshape(v, N, *a.shape[1:])
            for k, a in g.items()})
    return out


@pytest.fixture(scope="module")
def refs(spawned):
    return {"plain": _jax_serial("plain"), "tied": _jax_serial("tied"),
            "engine": _jax_engine()}


@pytest.fixture(scope="module")
def group(spawned, refs):
    ctx, workdir, deadline = spawned
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            pytest.fail(f"the gloo group did not finish in {JOIN_LIMIT_S} s")
    results = []
    for rank in range(N):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("name", list(RUNS))
def test_fleet_pipeline_matches_jax_serial(group, refs, name):
    want = refs[RUNS[name][0]]
    kind = ("PipelineParallelWithInterleave" if name == "interleave"
            else "PipelineParallel")
    for r in range(N):
        run = group[r][name]
        assert run["type"] == kind
        np.testing.assert_allclose(run["losses"], want["losses"], **TOL)
        assert sorted(run["params"]) == sorted(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(run["params"][k], w, **TOL,
                                       err_msg=k)
        np.testing.assert_allclose(run["eval"][0], want["eval"][0], **TOL)
        np.testing.assert_allclose(run["eval"][1], want["eval"][1], **TOL)


def _p2p(name, stage, m):
    """The design's sends and receives a step on ``stage`` (of 2)."""
    v = RUNS[name][2]
    sent = v * m - (m if stage == N - 1 else 0)
    received = v * m - (m if stage == 0 else 0)
    return 2 * (sent + received)


@pytest.mark.parametrize("name", list(RUNS))
def test_collectives_a_step_follow_the_design(group, name):
    """Point-to-point calls: 2 (sent + received) activations a step, one
    gradient for each; one announcement a chunk a link at the first step;
    one broadcast of the loss; the tied stem's two parameters all-reduced
    over the two stages."""
    kind, m, v, data = RUNS[name]
    for r in range(N):
        counts = group[r][name]["counts"]
        for step, got in enumerate(counts):
            want = {"batch_isend_irecv": _p2p(name, r, m), "broadcast": 1}
            if step == 0:
                want["batch_isend_irecv"] += v - (1 if r == N - 1 else 0) \
                    + v - (1 if r == 0 else 0)
            if kind == "tied":
                want["all_reduce"] = 2
            assert got == want, (r, step, got)


@pytest.mark.parametrize("lps,m", [(1, 4), (1, 8), (2, 4), (2, 8)])
def test_gpipe_forward_matches_serial(group, refs, lps, m):
    for r in range(N):
        np.testing.assert_allclose(group[r]["engine"]["fwd", lps, m],
                                   refs["engine"]["fwd", lps, m], **TOL)


def test_gpipe_backward_matches_serial(group, refs):
    for r in range(N):
        for k, g in group[r]["engine"]["bwd"].items():
            np.testing.assert_allclose(g, refs["engine"]["bwd"][k][r], **TOL)


@pytest.mark.parametrize("m", [6, 7])
def test_gpipe_interleaved_odd_microbatches(group, refs, m):
    want_loss, want = refs["engine"]["interleaved", m]
    for r in range(N):
        loss, grads = group[r]["engine"]["interleaved", m]
        np.testing.assert_allclose(loss, want_loss, **TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k][:, r], **TOL)


# ----------------------------------------------------------- in process
def test_segment_parts_follow_jax():
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import \
        PipelineLayer as JaxPipelineLayer
    for n_layers in (4, 7, 10):
        for stages in (1, 2, 3, 4):
            fns = [torch.tanh] * n_layers
            got = PipelineLayer(fns, num_stages=stages)
            want = JaxPipelineLayer([lambda x: x] * n_layers,
                                    num_stages=stages)
            assert got.segment_parts == want.segment_parts
            for i in range(n_layers):
                assert got.get_stage_from_index(i) == \
                    want.get_stage_from_index(i)


def test_microbatch_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    mb = microbatch(x, 4)
    assert mb.shape == (4, 3, 2)
    assert torch.equal(unmicrobatch(mb), x)


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    topology._HYBRID_GROUP[0] = None
    fleet._fleet_state.update(strategy=None, hcg=None)
    pdist.destroy_process_group()


def test_pp1_microbatch_loop_matches_jax(world1, jax_states):
    """pp 1 runs the same schedule as a micro-batch loop (4 micro-batches,
    no point-to-point call) and equals JAX's serial steps."""
    want = _jax_serial("plain")
    fleet.init(strategy=_strategy(1, 4), device="cpu")
    model = PipelineLayer(_descs("plain"), num_stages=1, loss_fn=mse)
    module_from_jax_state(model, jax_states["plain"])
    wrapped = fleet.distributed_model(model)
    assert type(wrapped) is PipelineParallel
    opt = SGD(0.1, parameters=model.named_parameters())
    ops.reset_collectives()
    losses = [wrapped.train_batch([torch.from_numpy(x),
                                   torch.from_numpy(y)], opt).item()
              for x, y in zip(*_data())]
    assert "batch_isend_irecv" not in ops.COLLECTIVES
    np.testing.assert_allclose(losses, want["losses"], **TOL)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want["params"][k], **TOL)
    assert isinstance(fleet.distributed_model(PipelineLayer(
        _descs("plain"), num_stages=1, num_virtual_pipeline_stages=2)),
        PipelineParallelWithInterleave)


def test_shape_mismatch_raises_before_sending(world1):
    fleet.init(strategy=_strategy(1, 1), device="cpu")
    links = ppar._Links(fleet.get_hybrid_communicate_group(),
                        torch.device("cpu"))
    links.sent["k"] = ((4, D), torch.float32)
    ops.reset_collectives()
    with pytest.raises(ValueError, match="static for a step"):
        links.announce("k", torch.zeros(4, D + 1), 0)
    with pytest.raises(ValueError, match="static for a step"):
        links.check("k", torch.zeros(4, D, dtype=torch.bfloat16))
    assert not ops.COLLECTIVES


# --------------------------------- stage 3 under recompute, at world 1
LLAMA = {"vocab_size": 256, "hidden_size": 64, "num_layers": 2,
         "num_heads": 4, "intermediate_size": 128, "max_position": 128}


class LlamaStem(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.embed_tokens = mpl.VocabParallelEmbedding(c.vocab_size,
                                                       c.hidden_size)

    def forward(self, ids):
        return self.embed_tokens(ids)


class LlamaHead(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.lm_head = mpl.ColumnParallelLinear(
            c.hidden_size, c.vocab_size, has_bias=False, gather_output=False)

    def forward(self, h):
        return self.lm_head(self.norm(h))


def _pipeline_names(state, layers):
    """A LlamaForCausalLM state under a stem / blocks / head pipeline's
    names."""
    out = {}
    for k, v in state.items():
        v = v.detach().clone()
        if k.startswith("llama.layers."):
            i, rest = k[len("llama.layers."):].split(".", 1)
            out[f"run_function.{int(i) + 1}.{rest}"] = v
        elif k == "llama.embed_tokens.weight":
            out["run_function.0.embed_tokens.weight"] = v
        else:       # llama.norm.weight, lm_head.weight
            out[f"run_function.{layers + 1}.{k.removeprefix('llama.')}"] = v
    return out


def test_stage3_pipeline_with_recompute_matches_unwrapped(world1):
    """LLaMA's layers as a PipelineLayer with recompute, under p_g_os at
    world 1 through PipelineParallel (2 micro-batches), 3 AdamW steps:
    the parameters equal the unwrapped LlamaForCausalLM's on the whole
    batch within TOLERANCES["train_params_fp32"]; each step's gathers are
    9 L + 3 a micro-batch's forward, 9 L more for the recomputed blocks
    and 2 for the saved weights outside them, with a reduce-scatter a
    forward gather; the recomputation runs every module's forward to its
    end, so no parameter is left gathered (every module's parameter is
    the one at rest after the step)."""
    L, M, B, S = LLAMA["num_layers"], 2, 2, 16
    fleet.init(strategy=_strategy(1, M), device="cpu")
    serial = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=3)
    state = _pipeline_names(serial.state_dict(), L)
    ids = np.random.default_rng(4).integers(0, LLAMA["vocab_size"],
                                            (B, S + 1))
    x, y = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
    opt = AdamW(1e-3, parameters=serial.named_parameters())
    for _ in range(3):
        serial(x, labels=y).backward()
        opt.step()
        opt.clear_grad()
    want = _pipeline_names(serial.state_dict(), L)
    c = LlamaConfig(**LLAMA, recompute=True)
    ce = mpl.ParallelCrossEntropy()
    model = PipelineLayer(
        [LayerDesc(LlamaStem, c)]
        + [LayerDesc(LlamaBlock, c, device="cpu") for _ in range(L)]
        + [LayerDesc(LlamaHead, c)], num_stages=1,
        loss_fn=lambda o, lb: ce(o.reshape(-1, o.shape[-1]),
                                 lb.reshape(-1)).mean())
    module_from_jax_state(model, state)
    opt = AdamW(1e-3, parameters=model.named_parameters())
    _, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    wrapped = fleet.distributed_model(model)
    counts = []
    for _ in range(3):
        ops.reset_collectives()
        wrapped.train_batch([x, y], opt)
        counts.append(dict(ops.COLLECTIVES))
    fwd = 9 * L + 3
    assert counts == [{"all_gather": M * (fwd + 9 * L + 2),
                       "reduce_scatter": M * fwd}] * 3
    assert all(getattr(p, "_stage3", False)
               for p in model.parameters())
    got = gather_full_state(model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   **TOLERANCES["train_params_fp32"],
                                   err_msg=k)
