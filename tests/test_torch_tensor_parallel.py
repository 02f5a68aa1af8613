"""The port's tensor parallelism (fleet's model-parallel layers) against
the JAX package's, on the CPU.

One group of 4 gloo processes, spawned once for the module (a FileStore
under the test's temporary directory, a 60 s process-group timeout, a
join limit), runs under a fleet topology of dp 2 x mp 2 (mp groups
{0, 1} and {2, 3}, dp groups {0, 2} and {1, 3}, JAX's rank map):

- every op of ``mp_ops`` forward and backward on per-rank inputs, held to
  the arithmetic each one stands for (identity / sum, split / gather);
- each mp layer (``ColumnParallelLinear`` with and without
  ``gather_output``, ``RowParallelLinear`` with and without
  ``input_is_parallel``, ``VocabParallelEmbedding``) holding its slice
  of one full weight, its output and its input's and parameters'
  gradients (gathered over mp) against JAX's eager layer on that full
  weight, within TOLERANCES["attention_fp32"];
- ``ParallelCrossEntropy`` on JAX's ``TestParallelCrossEntropy`` case
  (``tests/test_distributed.py:486-524``: n 16, V 32, logits x 3, a -100
  row), this rank's vocabulary half: the loss and the gradient of its sum
  (gathered) against JAX's, atol / rtol 1e-5;
- ``llama_tiny(tensor_parallel=True)`` from JAX's state
  (``weights.llama_from_jax_state`` takes each rank's slices), each dp
  rank on its half of a fully labelled batch, through
  ``fleet.distributed_model`` (``TensorParallel``) and
  ``fleet.distributed_optimizer``, 3 AdamW steps under a
  ``ClipGradByGlobalNorm`` that binds: the logits (gathered over the
  vocabulary), the losses (averaged over dp), the step-1 gradients
  (gathered) and the step-3 parameters (``weights.gather_full_state``)
  against JAX's serial step on the whole batch within
  TOLERANCES["logits_fp32"] / ["train_loss_fp32"] / ["train_grads_fp32"]
  / ["train_params_fp32"]; and each step's ``COLLECTIVES`` equal to the
  design's (``mp_layers``' docstring: 4 + 7 L mp all-reduces, one dp
  all-reduce of the one 32 MB bucket, one clip all-reduce over mp);
- ``TensorParallel``'s broadcast: models built from a seed of each
  rank's own end with every replicated parameter equal on all four
  ranks and every distributed one equal across dp;
- ``num_kv_heads`` 1 at mp 2 refused, naming ROADMAP item 10(f).

In this process: ``recompute`` with dropout 0.1 against no recompute
(gradients bit-equal), and ``recompute_sequential`` against JAX's.
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

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication import ops
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_layers as mpl
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                      recompute_sequential)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Dropout, Linear
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import (gather_full_state,
                                      llama_from_jax_state)

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N = 4
JOIN_LIMIT_S = 180
B, S, STEPS, LR, CLIP = 4, 16, 3, 1e-3, 0.05
TINY = {"vocab_size": 256, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128, "max_position": 128}
IN, OUT, ROWS, VOCAB = 8, 12, 6, 16


def _strategy():
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1,
                        "sharding_degree": 1, "sep_degree": 1}
    return s


def _layer_inputs():
    """The full weights, the input and the output cotangent of the layer
    cases (numpy, fp32)."""
    rng = np.random.default_rng(7)
    f = np.float32
    return {"w": rng.standard_normal((IN, OUT)).astype(f),
            "b": rng.standard_normal(OUT).astype(f),
            "x": rng.standard_normal((ROWS, IN)).astype(f),
            "cot": rng.standard_normal((ROWS, OUT)).astype(f),
            "table": rng.standard_normal((VOCAB, IN)).astype(f),
            "ids": rng.integers(0, VOCAB, (ROWS,)),
            "ecot": rng.standard_normal((ROWS, IN)).astype(f)}


def _ce_inputs():
    rng = np.random.RandomState(0)
    logits = rng.randn(16, 32).astype(np.float32) * 3
    labels = rng.randint(0, 32, (16,)).astype(np.int64)
    labels[3] = -100
    return logits, labels


def _llama_batch():
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                            (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _cases():
    """Layer case name -> keyword arguments of the mp layer."""
    return {"column_gather": ("column", {"gather_output": True}),
            "column_split": ("column", {"gather_output": False}),
            "row_parallel_in": ("row", {"input_is_parallel": True}),
            "row_split_in": ("row", {"input_is_parallel": False})}


# ------------------------------------------------------------- the ranks
def _mp_op_results(rank):
    g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    out = {}
    for name, fn in (("identity", mp_ops._c_identity),
                     ("allreduce", mp_ops._mp_allreduce),
                     ("split", mp_ops._c_split),
                     ("concat", mp_ops._c_concat)):
        x = torch.arange(12.0).reshape(3, 4) * (rank + 1)
        x.requires_grad_(True)
        y = fn(x, group=g)
        cot = torch.ones_like(y) * (rank + 2)
        y.backward(cot)
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def _layer_results(rank, inp):
    g = mp_ops.mp_group()
    out = {}
    w, b = torch.from_numpy(inp["w"]), torch.from_numpy(inp["b"])
    for name, (kind, kw) in _cases().items():
        cls = (mpl.ColumnParallelLinear if kind == "column"
               else mpl.RowParallelLinear)
        layer = cls(IN, OUT, **kw)
        with torch.no_grad():
            layer.weight.copy_(mpl.local_slice(w, layer.weight.split_axis,
                                               g))
            bias_axis = getattr(layer.bias, "split_axis", None)
            layer.bias.copy_(mpl.local_slice(b, bias_axis, g))
        x = torch.from_numpy(inp["x"]).requires_grad_(True)
        xin = x
        if kind == "row" and kw["input_is_parallel"]:
            xin = mp_ops._c_split(x, g)
        y = layer(xin)
        cot = torch.from_numpy(inp["cot"])
        if kind == "column" and not kw["gather_output"]:
            cot = mpl.local_slice(cot, 1, g)
        y.backward(cot)
        out[name] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                     "dw": layer.weight.grad.numpy(),
                     "db": layer.bias.grad.numpy()}
    emb = mpl.VocabParallelEmbedding(VOCAB, IN)
    with torch.no_grad():
        emb.weight.copy_(mpl.local_slice(torch.from_numpy(inp["table"]), 0,
                                         g))
    y = emb(torch.from_numpy(inp["ids"]))
    y.backward(torch.from_numpy(inp["ecot"]))
    out["embedding"] = {"y": y.detach().numpy(),
                        "dw": emb.weight.grad.numpy()}
    logits, labels = _ce_inputs()
    lg = mpl.local_slice(torch.from_numpy(logits), 1, g).clone()
    lg.requires_grad_(True)
    loss = mpl.ParallelCrossEntropy()(lg, torch.from_numpy(labels))
    loss.sum().backward()
    out["ce"] = {"loss": loss.detach().numpy(), "grad": lg.grad.numpy()}
    return out


def _llama_run(state):
    hcg = fleet.get_hybrid_communicate_group()
    model = llama_from_jax_state(state, LlamaConfig(**TINY), device="cpu")
    g = mp_ops.mp_group()
    x, y = _llama_batch()
    dp = hcg.get_data_parallel_rank()
    rows = slice(dp * B // 2, (dp + 1) * B // 2)
    x, y = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
    with torch.no_grad():
        logits = mp_ops._c_concat(model(x), g).numpy()
    wrapped = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(AdamW(
        LR, parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(CLIP)))
    losses, counts, grads = [], [], None
    for step in range(STEPS):
        ops.reset_collectives()
        loss = wrapped(x, labels=y)
        loss.backward()
        opt.step()
        counts.append(dict(ops.COLLECTIVES))
        if step == 0:
            grads = _gather_named(model, {k: v.grad for k, v in
                                          model.named_parameters()})
        opt.clear_grad()
        losses.append(loss.item())
    return {"logits": logits, "losses": losses, "counts": counts,
            "grads": grads, "params": {k: v.numpy() for k, v in
                                       gather_full_state(model).items()},
            "type": type(wrapped).__name__}


def _gather_named(model, tensors):
    """name -> the full (mp-gathered) numpy value of ``tensors[name]``."""
    out = {}
    for name, p in model.named_parameters():
        t = tensors[name].detach()
        g, axis = getattr(p, "_mp_group", None), getattr(p, "split_axis",
                                                         None)
        if g is not None and axis is not None:
            parts = []
            pdist.all_gather(parts, t.contiguous(), group=g)
            t = torch.cat(parts, dim=axis)
        out[name] = t.numpy()
    return out


def _broadcast_run(rank):
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             seed=10 + rank)
    fleet.distributed_model(model)
    return {k: (mpl.mp_split(p) is not None, p.detach().numpy().copy())
            for k, p in model.named_parameters()}


def _worker(rank, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        state = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), N),
        rank=rank, world_size=N, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        fleet.init(strategy=_strategy(), device="cpu")
        out["ops"] = _mp_op_results(rank)
        out["layers"] = _layer_results(rank, _layer_inputs())
        out["llama"] = _llama_run(state)
        out["broadcast"] = _broadcast_run(rank)
        try:
            LlamaForCausalLM(LlamaConfig(**{**TINY, "num_kv_heads": 1}),
                             device="meta")
            out["kv_refusal"] = None
        except NotImplementedError as e:
            out["kv_refusal"] = str(e)
    finally:
        topology._HYBRID_GROUP[0] = None
        fleet._fleet_state.update(strategy=None, hcg=None)
        pdist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------- the parent
@pytest.fixture(scope="module")
def jax_state():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import llama_tiny
    paddle.seed(0)
    m = llama_tiny()
    return {k: np.asarray(v._data) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def spawned(jax_state, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp_group"))
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(jax_state, f)
    ctx = mp.start_processes(_worker, args=(workdir,), nprocs=N, join=False,
                             start_method="spawn")
    yield ctx, workdir, time.monotonic() + JOIN_LIMIT_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(10)


def _jax_layers():
    """JAX's eager mp layers (plain below a mesh) on the full weights:
    outputs and gradients by case."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.layers.mpu import mp_layers as jl
    inp = _layer_inputs()
    out = {}
    for name, (kind, kw) in _cases().items():
        cls = jl.ColumnParallelLinear if kind == "column" else \
            jl.RowParallelLinear
        layer = cls(IN, OUT, **kw)
        layer.weight.set_value(inp["w"])
        layer.bias.set_value(inp["b"])
        x = paddle.to_tensor(inp["x"])
        x.stop_gradient = False
        y = layer(x)
        (y * paddle.to_tensor(inp["cot"])).sum().backward()
        out[name] = {"y": y.numpy(), "dx": x.grad.numpy(),
                     "dw": layer.weight.grad.numpy(),
                     "db": layer.bias.grad.numpy()}
    emb = jl.VocabParallelEmbedding(VOCAB, IN)
    emb.weight.set_value(inp["table"])
    y = emb(paddle.to_tensor(inp["ids"].astype(np.int32)))
    (y * paddle.to_tensor(inp["ecot"])).sum().backward()
    out["embedding"] = {"y": y.numpy(), "dw": emb.weight.grad.numpy()}
    logits, labels = _ce_inputs()
    lg = paddle.to_tensor(logits)
    lg.stop_gradient = False
    loss = jl.ParallelCrossEntropy()(lg, paddle.to_tensor(
        labels.astype(np.int32)))
    loss.sum().backward()
    out["ce"] = {"loss": loss.numpy(), "grad": lg.grad.numpy()}
    return out


def _jax_llama(state):
    """JAX's serial llama_tiny step on the whole batch: logits, losses,
    step-1 gradients and final parameters; and step 1's global norm."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import llama_tiny
    m = llama_tiny()
    m.set_state_dict(state)
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=m.parameters(),
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(
                                     CLIP))
    x, y = (paddle.to_tensor(a.astype(np.int32)) for a in _llama_batch())
    logits = m(x).numpy()
    names = [n for n, _ in m.named_parameters()]
    losses, grads, norm = [], None, None
    for step in range(STEPS):
        loss = m(x, labels=y)
        loss.backward()
        if step == 0:
            grads = {n: np.asarray(p.grad._data)
                     for n, p in zip(names, m.parameters())}
            norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                     for g in grads.values())))
        opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(loss._data)))
    return {"logits": logits, "losses": losses, "grads": grads,
            "norm": norm,
            "params": {n: np.asarray(p._data)
                       for n, p in zip(names, m.parameters())}}


@pytest.fixture(scope="module")
def refs(spawned, jax_state):
    return {"layers": _jax_layers(), "llama": _jax_llama(jax_state)}


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


def _mp_pairs():
    return ((0, 1), (2, 3))


# ----------------------------------------------------------------- tests
def test_mp_ops_forward_and_backward(group):
    """Each op on each mp pair: identity and sum forward, split and
    gather; backward the sum, the identity, the gather and the split."""
    for pair in _mp_pairs():
        xs = [np.arange(12.0).reshape(3, 4) * (r + 1) for r in pair]
        cots = {r: r + 2 for r in pair}
        for i, r in enumerate(pair):
            got = group[r]["ops"]
            y, dx = got["identity"]
            np.testing.assert_array_equal(y, xs[i])
            np.testing.assert_array_equal(
                dx, np.full((3, 4), sum(cots.values()), np.float32))
            y, dx = got["allreduce"]
            np.testing.assert_array_equal(y, xs[0] + xs[1])
            np.testing.assert_array_equal(dx, np.full((3, 4), cots[r]))
            y, dx = got["split"]
            np.testing.assert_array_equal(y, xs[i][:, 2 * i:2 * i + 2])
            want = np.zeros((3, 4))
            for k, q in enumerate(pair):
                want[:, 2 * k:2 * k + 2] = cots[q]
            np.testing.assert_array_equal(dx, want)
            y, dx = got["concat"]
            np.testing.assert_array_equal(y, np.concatenate(xs, -1))
            np.testing.assert_array_equal(dx, np.full((3, 4), cots[r]))


@pytest.mark.parametrize("case", list(_cases()) + ["embedding"])
def test_mp_layers_match_jax(group, refs, case):
    """Outputs and the gradients of x, W and b (gathered over mp) equal
    JAX's eager layer on the full weight."""
    tol = TOLERANCES["attention_fp32"]
    want = refs["layers"][case]
    kind, kw = _cases().get(case, ("embedding", {}))
    for pair in _mp_pairs():
        got = [group[r]["layers"][case] for r in pair]
        if kind == "column" and not kw["gather_output"]:
            y = np.concatenate([g["y"] for g in got], -1)
        else:
            y = got[0]["y"]
            np.testing.assert_allclose(got[1]["y"], y, **tol)
        np.testing.assert_allclose(y, want["y"], **tol)
        axis = {"column": 1, "row": 0, "embedding": 0}[kind]
        dw = np.concatenate([g["dw"] for g in got], axis)
        np.testing.assert_allclose(dw, want["dw"], **tol)
        if kind == "embedding":
            continue
        for g in got:
            np.testing.assert_allclose(g["dx"], want["dx"], **tol)
        db = (np.concatenate([g["db"] for g in got]) if kind == "column"
              else got[0]["db"])
        np.testing.assert_allclose(db, want["db"], **tol)


def test_parallel_cross_entropy_matches_jax(group, refs):
    want = refs["layers"]["ce"]
    for pair in _mp_pairs():
        got = [group[r]["layers"]["ce"] for r in pair]
        for g in got:
            np.testing.assert_allclose(g["loss"], want["loss"], atol=1e-5,
                                       rtol=1e-5)
        np.testing.assert_allclose(
            np.concatenate([g["grad"] for g in got], -1), want["grad"],
            atol=1e-5, rtol=1e-5)
    assert want["loss"][3] == 0.0


def test_llama_tiny_mp2_dp2_matches_jax_serial(group, refs):
    """Logits, losses, step-1 gradients and step-3 parameters of the
    mp 2 x dp 2 run against JAX's serial step, the clip binding."""
    want = refs["llama"]
    assert want["norm"] > CLIP
    runs = [group[r]["llama"] for r in range(N)]
    assert {r["type"] for r in runs} == {"TensorParallel"}
    for r in range(N):
        dp = r // 2
        rows = slice(dp * B // 2, (dp + 1) * B // 2)
        np.testing.assert_allclose(runs[r]["logits"], want["logits"][rows],
                                   **TOLERANCES["logits_fp32"])
    for step in range(STEPS):
        mean = np.mean([runs[r]["losses"][step] for r in (0, 2)])
        np.testing.assert_allclose(mean, want["losses"][step],
                                   **TOLERANCES["train_loss_fp32"])
    for r in range(N):
        for name, w in want["grads"].items():
            np.testing.assert_allclose(runs[r]["grads"][name], w,
                                       **TOLERANCES["train_grads_fp32"],
                                       err_msg=name)
        for name, w in want["params"].items():
            np.testing.assert_allclose(runs[r]["params"][name], w,
                                       **TOLERANCES["train_params_fp32"],
                                       err_msg=name)


def test_llama_collectives_a_step_follow_the_design(group):
    """4 + 7 L mp all-reduces (the embedding's, two a block forward,
    five a block backward, the head's backward, the loss's two), the one
    dp bucket and the clip's one over mp: all-reduces and nothing
    else."""
    want = {"all_reduce": 4 + 7 * TINY["num_layers"] + 1 + 1}
    for r in range(N):
        assert group[r]["llama"]["counts"] == [want] * STEPS, \
            group[r]["llama"]["counts"]


def test_tensor_parallel_broadcast_makes_ranks_agree(group):
    runs = [group[r]["broadcast"] for r in range(N)]
    for name, (distributed, value) in runs[0].items():
        if distributed:
            for a, b in ((0, 2), (1, 3)):
                np.testing.assert_array_equal(runs[a][name][1],
                                              runs[b][name][1])
            assert not np.array_equal(runs[0][name][1], runs[1][name][1]), \
                name
        else:
            for r in range(1, N):
                np.testing.assert_array_equal(runs[r][name][1], value)


def test_kv_heads_not_divisible_by_mp_are_refused(group):
    for r in range(N):
        assert "10(f)" in group[r]["kv_refusal"]


# ------------------------------------------------------- recompute here
class _DropBlock(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = Linear(16, 32, trainable=True, generator=g)
        self.drop = Dropout(0.1, generator=torch.Generator().manual_seed(3))
        self.fc2 = Linear(32, 16, trainable=True, generator=g)

    def forward(self, x):
        return self.fc2(self.drop(torch.tanh(self.fc1(x))))


def test_recompute_with_dropout_keeps_gradients():
    """Dropout 0.1 drawn from the block's own generator: the recomputed
    backward draws the forward's masks, so every gradient is bit-equal
    to the run without recompute, and the generator ends where it
    would."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 16)).astype(np.float32))
    runs = []
    for use in (False, True):
        blk = _DropBlock(0)
        xi = x.clone().requires_grad_(True)
        out = recompute(blk, xi) if use else blk(xi)
        (out ** 2).sum().backward()
        runs.append(([p.grad.clone() for p in blk.parameters()]
                     + [xi.grad.clone()], blk.drop.generator.get_state()))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][1], runs[1][1])


def test_recompute_sequential_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.utils import \
        recompute_sequential as jrs
    rng = np.random.default_rng(2)
    ws = [rng.standard_normal((16, 16)).astype(np.float32) * 0.3
          for _ in range(4)]
    x = rng.standard_normal((4, 16)).astype(np.float32)
    jl = []
    for w in ws:
        lin = paddle.nn.Linear(16, 16)
        lin.weight.set_value(w)
        jl += [lin, paddle.nn.Tanh()]
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jrs({"segments": 2}, paddle.nn.Sequential(*jl), jx)
    (jout ** 2).sum().backward()
    tl = []
    for w in ws:
        lin = Linear(16, 16, trainable=True)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.zero_()
        tl += [lin, torch.nn.Tanh()]
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = recompute_sequential({"segments": 2}, torch.nn.Sequential(*tl),
                                tx)
    (tout ** 2).sum().backward()
    tol = TOLERANCES["attention_fp32"]
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **tol)
    for tlin, jlin in zip(tl[::2], jl[::2]):
        np.testing.assert_allclose(tlin.weight.grad.numpy(),
                                   jlin.weight.grad.numpy(), **tol)
