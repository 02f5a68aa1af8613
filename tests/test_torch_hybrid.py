"""The port's hybrid parallelism, mp 2 x pp 2 x sharding 2, against the
JAX package's, on the CPU: the counterpart of
``tests/test_hybrid_composition.py`` (BASELINE configs[2]'s hybrid).

One group of 8 gloo processes, spawned once for the module (a FileStore
under the test's temporary directory, a 60 s process-group timeout, a
join limit), under a fleet topology of pp 2 x sharding 2 x mp 2 (JAX's
rank map: rank = 4 pp + 2 sharding + mp), runs:

- JAX's ``TPBlock`` pipeline (4 blocks of a ``ColumnParallelLinear`` up,
  gelu, a ``RowParallelLinear`` down and a residual; 2 stages, MSE,
  ``accumulate_steps`` 2) from JAX's state, through
  ``group_sharded_parallel(level="p_g_os")`` and
  ``fleet.distributed_model`` (``PipelineParallel``), 3 AdamW steps of
  ``train_batch`` (lr 0.01), each sharding rank on its half of the
  batch: the losses (averaged over sharding) within rtol 2e-4 / atol
  2e-5 and every parameter (``gather_full_state``) within 5e-4 of JAX's
  serial run, JAX's own tolerances;
- the at-rest layout: ``run_function.0.fc1.weight``'s stage-3 shard of
  its mp slice is ``w.size // 4`` on every rank of stage 0, of the shape
  JAX's ``addressable_shards`` give (JAX's placement on its 8-device
  mesh), and AdamW's moments have the shard's shape;
- each step's ``COLLECTIVES`` equal to the design's: the stages'
  point-to-point calls (``pipeline_parallel``), the mp all-reduces of
  ``mp_layers`` (a block's Row forward, and its Column backward where
  the block's input needs a gradient: not stage 0's first block), stage
  3's all-gather a sharded parameter a module forward plus one a saved
  view unpacked in backward (a block's two weights, but the first
  block's fc1 weight, whose input needs no gradient) and its
  reduce-scatter a forward gather, the replicated Column biases' one
  bucket all-reduced over sharding a backward, and the loss's
  broadcast; all per micro-batch but the broadcast; and at most one
  block's gathered parameters alive at once;
- ``llama_tiny``'s layers as a ``PipelineLayer`` (an embedding stem, the
  two ``LlamaBlock``s, a norm-and-head epilogue: ``LayerDesc``s of the
  same classes in both packages) at mp 2 x pp 2 with ``recompute`` and
  sharding 2 as stage 1 (``fleet.distributed_optimizer``), 3 AdamW steps
  under a ``ClipGradByGlobalNorm`` that binds: the losses (averaged over
  sharding) within TOLERANCES["train_loss_fp32"] and the parameters
  within ["train_params_fp32"] of JAX's serial step;
- a ``GradScaler`` with an inf planted in one rank's gradient: every rank
  of both stages skips the step (parameters unchanged) and halves its
  scale;
- each rank's coordinates, stage accessors and group members against
  JAX's rank map.

In this process: the topology's rank map and ``get_parallel_mode`` over
grids of all five degrees against JAX's, and one process with a model
degree alone still building PR 22's serving mesh.

JAX is imported inside the tests only: the spawned processes import this
module and stay torch-only.
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

from paddle_tpu_torch import TOLERANCES, amp
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication import ops
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_layers as mpl
from paddle_tpu_torch.distributed.fleet.meta_parallel import (LayerDesc,
                                                              PipelineLayer)
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models.llama import LlamaBlock, LlamaConfig
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import gather_full_state, module_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N = 8
JOIN_LIMIT_S = 240
D, STEPS, M = 16, 3, 2
TINY = {"vocab_size": 256, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128, "max_position": 128,
        "recompute": True}
LB, LS, LLR, CLIP = 4, 16, 1e-3, 0.05


class TPBlock(torch.nn.Module):
    """Megatron block: column-parallel up, row-parallel down, residual."""

    def __init__(self):
        super().__init__()
        self.fc1 = mpl.ColumnParallelLinear(D, 4 * D, gather_output=False)
        self.fc2 = mpl.RowParallelLinear(4 * D, D, input_is_parallel=True)

    def forward(self, x):
        return x + self.fc2(F.gelu(self.fc1(x)))


def _mse(out, label):
    return ((out - label) ** 2).mean()


class Stem(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.embed_tokens = mpl.VocabParallelEmbedding(c.vocab_size,
                                                       c.hidden_size)

    def forward(self, ids):
        return self.embed_tokens(ids)


class Head(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.lm_head = mpl.ColumnParallelLinear(c.hidden_size, c.vocab_size,
                                                has_bias=False,
                                                gather_output=False)

    def forward(self, h):
        return self.lm_head(self.norm(h))


def _block(c):
    return LlamaBlock(c, device="cpu")


def _strategy():
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 2,
                        "sharding_degree": 2, "sep_degree": 1,
                        "pp_configs": {"accumulate_steps": M}}
    return s


def _xy():
    rng = np.random.RandomState(0)
    return (rng.randn(8, D).astype(np.float32),
            rng.randn(8, D).astype(np.float32))


def _llama_batch():
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                            (LB, LS + 1))
    return ids[:, :-1], ids[:, 1:]


def _rows(hcg, n):
    r = hcg.get_sharding_parallel_rank()
    return slice(r * n // 2, (r + 1) * n // 2)


def _tp_pipeline(state):
    model = PipelineLayer([LayerDesc(TPBlock) for _ in range(4)],
                          num_stages=2, loss_fn=_mse)
    module_from_jax_state(model, state)
    opt = AdamW(0.01, parameters=model.named_parameters())
    _, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    return model, fleet.distributed_model(model), opt


def _tp_run(state):
    hcg = fleet.get_hybrid_communicate_group()
    model, wrapped, opt = _tp_pipeline(state)
    x, y = (torch.from_numpy(a[_rows(hcg, 8)]) for a in _xy())
    losses, counts = [], []
    for _ in range(STEPS):
        ops.reset_collectives()
        losses.append(wrapped.train_batch([x, y], opt).item())
        counts.append(dict(ops.COLLECTIVES))
    block = sum(p.numel() * p.element_size()
                for p in model.run_function[hcg.get_stage_id() * 2]
                .parameters() if getattr(p, "_stage3", False))
    out = {"losses": losses, "counts": counts,
           "type": type(wrapped).__name__,
           "gathered": (model._stage3_state.peak_bytes, block)}
    if hcg.get_stage_id() == 0:
        w = model.run_function[0].fc1.weight
        out["at_rest"] = {
            "logical": mpl.logical_shape(w), "shard": tuple(w._shard.shape),
            "moment": tuple(opt._accumulators["moment1"][id(w._shard)]
                            .shape)}
    out["params"] = {k: v.numpy() for k, v in
                     gather_full_state(model).items()}
    return out


def _scaler_run(state):
    """One step with an inf planted in rank 5's gradient."""
    hcg = fleet.get_hybrid_communicate_group()
    model, wrapped, opt = _tp_pipeline(state)
    x, y = (torch.from_numpy(a[_rows(hcg, 8)]) for a in _xy())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    before = [p.detach().clone() for _, p in opt._params]
    model.train()
    wrapped.forward_backward_pipeline([x, y], scaler)
    if dist.get_rank() == 5:
        opt._params[0][1].grad.view(-1)[0] = float("inf")
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return {"unchanged": all(torch.equal(a, p) for a, (_, p)
                             in zip(before, opt._params)),
            "scale": scaler.get_loss_scaling()}


def _llama_descs(c):
    return ([LayerDesc(Stem, c)] + [LayerDesc(_block, c)
                                   for _ in range(c.num_layers)]
            + [LayerDesc(Head, c)])


def _llama_run(state):
    hcg = fleet.get_hybrid_communicate_group()
    c = LlamaConfig(**TINY)
    ce = mpl.ParallelCrossEntropy()

    def loss_fn(logits, labels):
        return ce(logits.reshape(-1, logits.shape[-1]),
                  labels.reshape(-1)).mean()

    model = PipelineLayer(_llama_descs(c), num_stages=2, loss_fn=loss_fn)
    module_from_jax_state(model, state)
    wrapped = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(AdamW(
        LLR, parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(CLIP)))
    x, y = (torch.from_numpy(a[_rows(hcg, LB)]) for a in _llama_batch())
    losses = [wrapped.train_batch([x, y], opt).item() for _ in range(STEPS)]
    return {"losses": losses,
            "params": {k: v.numpy() for k, v in
                       gather_full_state(model).items()}}


def _topology_view():
    """This rank's coordinates, stage accessors and group members."""
    hcg = fleet.get_hybrid_communicate_group()
    groups = {a: dist.get_process_group_ranks(getattr(
        hcg, f"get_{a}_parallel_group")())
        for a in ("data", "pipe", "sharding", "sep", "model")}
    return {"coord": (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                      hcg.get_sharding_parallel_rank(),
                      hcg.get_sep_parallel_rank(),
                      hcg.get_model_parallel_rank()),
            "first_last": (hcg.is_first_stage(), hcg.is_last_stage()),
            "stage_ranks": [hcg.get_rank_from_stage(s) for s in range(2)],
            "groups": groups, "mode": hcg.get_parallel_mode(),
            "mp_src": hcg.get_model_parallel_group_src_rank(),
            "p2p": hcg.get_p2p_groups()}


def _worker(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "states.pkl"), "rb") as f:
        states = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), N),
        rank=rank, world_size=N, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        fleet.init(strategy=_strategy(), device="cpu")
        out["topology"] = _topology_view()
        out["tp"] = _tp_run(states["tp"])
        out["scaler"] = _scaler_run(states["tp"])
        out["llama"] = _llama_run(states["llama"])
    finally:
        topology._HYBRID_GROUP[0] = None
        fleet._fleet_state.update(strategy=None, hcg=None)
        pdist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------- the parent
def _jax_llama_model():
    """JAX's llama_tiny layers as a PipelineLayer of the same classes."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear, ParallelCrossEntropy, VocabParallelEmbedding)
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import \
        LayerDesc as JDesc
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import \
        PipelineLayer as JPipe
    from paddle_tpu.models.llama import LlamaBlock as JBlock
    from paddle_tpu.models.llama import LlamaConfig as JConfig

    class JStem(paddle.nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.embed_tokens = VocabParallelEmbedding(c.vocab_size,
                                                       c.hidden_size)

        def forward(self, ids):
            return self.embed_tokens(ids)

    class JHead(paddle.nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.norm = paddle.nn.RMSNorm(c.hidden_size, c.rms_eps)
            self.lm_head = ColumnParallelLinear(
                c.hidden_size, c.vocab_size, has_bias=False,
                gather_output=False)

        def forward(self, h):
            return self.lm_head(self.norm(h))

    ce = ParallelCrossEntropy()

    def loss_fn(logits, labels):
        return ce(logits.reshape([-1, logits.shape[-1]]),
                  labels.reshape([-1])).mean()

    c = JConfig(**TINY)
    paddle.seed(0)
    return JPipe([JDesc(JStem, c)] + [JDesc(JBlock, c) for _ in range(
        c.num_layers)] + [JDesc(JHead, c)], num_stages=1, loss_fn=loss_fn)


@pytest.fixture(scope="module")
def jax_states():
    import paddle_tpu as paddle
    import test_hybrid_composition as H
    paddle.seed(7)
    tp = H._build(stages=1)
    return {"tp": {k: np.asarray(v._data) for k, v in tp.state_dict().items()},
            "llama": {k: np.asarray(v._data) for k, v in
                      _jax_llama_model().state_dict().items()}}


@pytest.fixture(scope="module")
def spawned(jax_states, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("hybrid_group"))
    with open(os.path.join(workdir, "states.pkl"), "wb") as f:
        pickle.dump(jax_states, f)
    ctx = mp.start_processes(_worker, args=(workdir,), nprocs=N, join=False,
                             start_method="spawn")
    yield ctx, workdir, time.monotonic() + JOIN_LIMIT_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(10)


def _jax_serial(model, opt, x, y, loss_fn):
    import paddle_tpu as paddle
    losses = []
    for _ in range(STEPS):
        loss = loss_fn(model(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(loss._data)))
    return {"losses": losses,
            "params": {k: np.asarray(v._data)
                       for k, v in model.state_dict().items()}}


def _jax_placement():
    """JAX's at-rest shard shape of run_function.0.fc1.weight under
    mp 2 x pp 2 x sharding 2 and p_g_os (its 8-device mesh)."""
    import paddle_tpu as paddle
    import test_hybrid_composition as H
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet.base import topology as jtopo
    from paddle_tpu.distributed.sharding import group_sharded_parallel as jgs
    from paddle_tpu.parallel import apply_shardings
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 2, "sharding_degree": 2,
                               "pp_configs": {"accumulate_steps": M}}
    try:
        jfleet.init(is_collective=True, strategy=strategy)
        paddle.seed(11)
        model = H._build(stages=2)
        opt = paddle.optimizer.AdamW(learning_rate=0.01,
                                     parameters=model.parameters())
        jgs(model, opt, level="p_g_os")
        apply_shardings()
        w = model.run_function[0].fc1.weight
        return {tuple(s.data.shape) for s in w._data.addressable_shards}
    finally:
        jtopo._HYBRID_GROUP[0] = None


@pytest.fixture(scope="module")
def refs(spawned, jax_states):
    import paddle_tpu as paddle
    import test_hybrid_composition as H
    tp = H._build(stages=1)
    tp.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in jax_states["tp"].items()})
    opt = paddle.optimizer.AdamW(learning_rate=0.01,
                                 parameters=tp.parameters())
    out = {"tp": _jax_serial(tp, opt, *_xy(), H._mse)}
    llama = _jax_llama_model()
    opt = paddle.optimizer.AdamW(
        learning_rate=LLR, parameters=llama.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    x, y = (a.astype(np.int32) for a in _llama_batch())
    out["llama"] = _jax_serial(llama, opt, x, y, llama.loss)
    # last: JAX's eager steps slow down once fleet.init has built a mesh
    out["placement"] = _jax_placement()
    return out


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


def _sharding_mean(group, run, step):
    """rank -> the mean of its sharding pair's step losses."""
    return {r: np.mean([group[q][run]["losses"][step]
                        for q in (r & ~2, r | 2)]) for r in range(N)}


# ----------------------------------------------------------------- tests
def test_mp_pp_stage3_matches_jax_serial(group, refs):
    want = refs["tp"]
    for step in range(STEPS):
        for r, got in _sharding_mean(group, "tp", step).items():
            np.testing.assert_allclose(got, want["losses"][step],
                                       rtol=2e-4, atol=2e-5)
    for r in range(N):
        run = group[r]["tp"]
        assert run["type"] == "PipelineParallel"
        assert sorted(run["params"]) == sorted(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(run["params"][k], w, rtol=5e-4,
                                       atol=5e-4, err_msg=k)


def test_mp_pp_stage3_at_rest_placement(group, refs):
    """fc1.weight is cut over mp (its own axis) and over sharding (stage
    3's, composed): 1/4 of the elements a rank, JAX's shard shape; the
    AdamW moment has the shard's shape."""
    want = refs["placement"]
    assert len(want) == 1
    for r in range(4):
        got = group[r]["tp"]["at_rest"]
        assert got["logical"] == (D, 4 * D)
        assert {got["shard"]} == want
        assert int(np.prod(got["shard"])) == D * 4 * D // 4
        assert got["moment"] == got["shard"]


def _tp_counts(stage, first_step):
    """The design's collectives a step on a rank of ``stage``: two
    blocks a stage, M micro-batches."""
    first = stage == 0
    grad_blocks = 1 if first else 2        # blocks whose input needs grad
    unpacked = 2 * 2 - (1 if first else 0)   # saved weights unpacked
    p2p = 2 * M + (1 if first_step else 0)
    return {"batch_isend_irecv": p2p, "broadcast": 1,
            # mp: a Row forward a block, a Column backward where needed;
            # plus the replicated fc1 biases' one bucket over sharding
            "all_reduce": M * (2 + grad_blocks) + M,
            # stage 3: fc1.weight, fc2.weight and fc2.bias a block
            "all_gather": M * (3 * 2 + unpacked),
            "reduce_scatter": M * 3 * 2}


def test_gathered_bytes_stay_within_a_block(group):
    """Stage 3 under the pipeline's micro-batches keeps at most one
    block's gathered parameters alive at once (a saved weight is packed
    as a token, not held)."""
    for r in range(N):
        peak, block = group[r]["tp"]["gathered"]
        assert 0 < peak <= block, (r, peak, block)


def test_collectives_a_step_follow_the_design(group):
    for r in range(N):
        stage = r // 4
        counts = group[r]["tp"]["counts"]
        assert counts == [_tp_counts(stage, s == 0) for s in range(STEPS)], \
            (r, counts)


def test_llama_pipeline_mp_pp_recompute_matches_jax(group, refs):
    want = refs["llama"]
    for step in range(STEPS):
        for r, got in _sharding_mean(group, "llama", step).items():
            np.testing.assert_allclose(got, want["losses"][step],
                                       **TOLERANCES["train_loss_fp32"])
    for r in range(N):
        run = group[r]["llama"]
        assert sorted(run["params"]) == sorted(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(run["params"][k], w,
                                       **TOLERANCES["train_params_fp32"],
                                       err_msg=k)


def test_one_rank_inf_skips_every_stage(group):
    for r in range(N):
        got = group[r]["scaler"]
        assert got["unchanged"], r
        assert got["scale"] == 512.0, r


NAMES = ("data", "pipe", "sharding", "sep", "model")
DIMS = (1, 2, 2, 1, 2)


def test_topology_over_processes_follows_jax(group):
    """Each rank's coordinates, stage accessors, get_parallel_mode and
    the members of its group on every axis equal JAX's rank map's."""
    from paddle_tpu.distributed.fleet.base import topology as jtopo
    want = jtopo.CommunicateTopology(NAMES, DIMS)
    for r in range(N):
        got = group[r]["topology"]
        assert got["coord"] == want.get_coord(r)
        stage = want.get_coord(r)[1]
        assert got["first_last"] == (stage == 0, stage == 1)
        assert got["stage_ranks"] == [want.get_rank_from_stage(r, pipe=s)
                                      for s in range(2)]
        for axis in NAMES:
            row = next(c for c in want.get_comm_list(axis) if r in c)
            assert got["groups"][axis] == row, (r, axis)
        assert got["mp_src"] == got["groups"]["model"][0]
        assert got["mode"] == "pipeline_parallel" and got["p2p"] is None


def test_topology_grid_follows_jax():
    """Ranks, coordinates and comm lists over grids of all five axes, and
    get_parallel_mode's answers (the rule alone: the groups need their
    processes)."""
    import itertools
    import types
    from paddle_tpu.distributed.fleet.base import topology as jtopo
    for dims in itertools.product((1, 2), (1, 2), (1, 2), (1, 2), (1, 3)):
        got = topology.CommunicateTopology(NAMES, dims)
        want = jtopo.CommunicateTopology(NAMES, dims)
        for r in range(got.world_size()):
            assert got.get_coord(r) == want.get_coord(r)
            assert got.get_rank_from_stage(r, pipe=dims[1] - 1) == \
                want.get_rank_from_stage(r, pipe=dims[1] - 1)
        for axis in NAMES:
            assert got.get_comm_list(axis) == want.get_comm_list(axis)
        stub = types.SimpleNamespace(
            _dp_degree=dims[0], _pp_degree=dims[1], _sharding_degree=dims[2],
            _sep_degree=dims[3], _mp_degree=dims[4])
        assert topology.HybridCommunicateGroup.get_parallel_mode(stub) == \
            jtopo.HybridCommunicateGroup.get_parallel_mode(stub), dims


def test_single_process_mp_is_still_the_serving_mesh():
    """One process with mp 2 alone: PR 22's serving mesh, no process
    group; mp beside another degree in one process is refused."""
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 1,
                        "sharding_degree": 1}
    before = dist.is_initialized()
    try:
        fleet.init(strategy=s, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        assert hcg.is_serving_mesh() and hcg.mesh.shape["mp"] == 2
        assert dist.is_initialized() == before
        s.hybrid_configs = dict(s.hybrid_configs, pp_degree=2)
        with pytest.raises(NotImplementedError, match="10\\(e\\)"):
            fleet.init(strategy=s, device="cpu")
        assert dist.is_initialized() == before
    finally:
        topology._HYBRID_GROUP[0] = None
        fleet._fleet_state.update(strategy=None, hcg=None)
