"""LLaMA training in the port against the JAX package.

The JAX ``llama_tiny`` (hidden 64, L=2, 4 heads, intermediate 128, V=256),
fp32, is built from ``paddle.seed(0)`` in three variants: its default
(``tensor_parallel=True``: separate projections and the vocab-parallel
loss, dense below mp 2); GQA (``num_kv_heads=2``) with
``tensor_parallel=False`` (q/k/v and gate/up each one matmul through
``fused_concat_linear``); and GQA with ``tie_word_embeddings``. Its
``state_dict()`` moves into the port with ``weights.llama_from_jax_state``
and the same numpy batch (B=2, S=16) goes through both: the logits, the
loss with a ``loss_mask`` and ignored labels, and 3 AdamW steps (lr 1e-3,
weight_decay 0.01) — the loss of each step, every gradient of step 1 and
every parameter after step 3 — held to ``TOLERANCES["logits_fp32"]``,
``["train_loss_fp32"]``, ``["train_grads_fp32"]`` and
``["train_params_fp32"]``. On the CPU the port's RMSNorm and attention
take their kernels' plain versions; JAX takes its composites.

Beside the harness: ``recompute=True`` gives the gradients of
``recompute=False`` (as tests/test_models.py checks in JAX),
``context_parallel`` and ``sequence_parallel`` without a mesh equal the
dense model, ``LlamaAttention`` with a KV cache equals JAX's, and the
functionals this slice adds or repairs (``silu``, ``fused_concat_linear``,
``cross_entropy`` in JAX's parameter order with its reductions) equal
JAX's.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaAttention as JaxAttention
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           llama2_7b, llama_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import llama_from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, S, STEPS, LR, WD, V = 2, 16, 3, 1e-3, 0.01, 256
TINY = {"vocab_size": V, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
        "intermediate_size": 128, "max_position": 128}
# each run: the LlamaConfig fields beside llama_tiny's
RUNS = {"tp": {},
        "gqa_fused": {"num_kv_heads": 2, "tensor_parallel": False},
        "gqa_tied": {"num_kv_heads": 2, "tie_word_embeddings": True}}


def _batch():
    """Ids and next-token labels, a second label set with two ignored
    positions (-100), and a 0/1 loss mask."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, S + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    y_ign = y.copy()
    y_ign[0, 3] = y_ign[1, 0] = -100
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return x, y, y_ign, mask


def _jax_run(cfg):
    """(state, logits, masked loss, losses, step-1 grads, final params) of
    the JAX model, as numpy."""
    paddle.seed(0)
    m = jax_llama_tiny(**cfg)
    state = {k: np.array(v.numpy()) for k, v in m.state_dict().items()}
    x, y, y_ign, mask = _batch()
    x, y, y_ign = (paddle.to_tensor(a.astype(np.int32)) for a in (x, y,
                                                                   y_ign))
    logits = m(x).numpy()
    masked = float(m(x, labels=y_ign, loss_mask=paddle.to_tensor(mask))
                   .numpy())
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                 parameters=m.parameters())
    losses, grads = [], None
    for i in range(STEPS):
        loss = m(x, labels=y)
        loss.backward()
        if i == 0:
            grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    params = {n: p.numpy() for n, p in m.named_parameters()}
    return state, logits, masked, losses, grads, params


def _port_run(state, cfg):
    """(logits, masked loss, losses, step-1 grads, final params)."""
    model = llama_from_jax_state(state, LlamaConfig(**TINY, **cfg),
                                 device="cpu")
    x, y, y_ign, mask = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        logits = model(x).numpy()
        masked = model(x, labels=y_ign, loss_mask=mask).item()
    opt = AdamW(LR, parameters=model.named_parameters(), weight_decay=WD)
    losses, grads = [], None
    for i in range(STEPS):
        loss = model(x, labels=y)
        loss.backward()
        if i == 0:
            grads = {n: p.grad.clone().numpy()
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return logits, masked, losses, grads, params


@functools.lru_cache(maxsize=None)
def _results(name):
    """Both sides' runs of one variant, computed once per module."""
    jax_out = _jax_run(RUNS[name])
    return jax_out[1:], _port_run(jax_out[0], RUNS[name])


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    return _results(request.param)


def test_state_names_and_shapes(runs, request):
    """The port's LLaMA has the JAX model's parameter names and shapes."""
    (*_, want), _ = runs
    cfg = RUNS[request.node.callspec.params["runs"]]
    port = llama_tiny(device="cpu", **cfg)
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} \
        == {n: w.shape for n, w in want.items()}
    assert all(p.requires_grad for p in port.parameters())
    assert ("lm_head.weight" in want) != bool(cfg.get("tie_word_embeddings"))


def test_logits(runs):
    (want, *_), (got, *_) = runs
    assert got.shape == (B, S, V)
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])


def test_losses(runs):
    """The masked loss (ignored labels inside) and the 3 steps' losses;
    the loss falls over the repeated batch."""
    (_, want_m, want, *_), (_, got_m, got, *_) = runs
    tol = TOLERANCES["train_loss_fp32"]
    np.testing.assert_allclose(got_m, want_m, **tol)
    np.testing.assert_allclose(got, want, **tol)
    assert got[-1] < got[0]


def test_grads_after_step_1(runs):
    (*_, want, _), (*_, got, _) = runs
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOLERANCES["train_grads_fp32"])


def test_params_after_step_3(runs):
    (*_, want), (*_, got) = runs
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOLERANCES["train_params_fp32"])


def test_loss_mask_and_ignore_index():
    """The masked loss is sum(loss m) / max(sum(m), 1) of the per-token
    terms; an all-zero mask gives 0; without a mask an ignored label's
    zero term stays in the mean's count, as in the JAX model."""
    model = llama_tiny(device="cpu", seed=2)
    x, _, y_ign, mask = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        terms = F.cross_entropy(model(x).reshape(-1, V), y_ign.reshape(-1),
                                reduction="none")
        m = mask.reshape(-1)
        torch.testing.assert_close(model(x, labels=y_ign, loss_mask=mask),
                                   (terms * m).sum() / m.sum())
        assert model(x, labels=y_ign, loss_mask=torch.zeros_like(
            mask)).item() == 0.0
        torch.testing.assert_close(model(x, labels=y_ign),
                                   terms.sum() / terms.numel())


@pytest.mark.parametrize("tensor_parallel", [True, False])
def test_recompute_gives_the_same_grads(tensor_parallel):
    x, y, _, _ = (torch.from_numpy(a) for a in _batch())
    grads = []
    for recompute in (False, True):
        model = llama_tiny(device="cpu", seed=7, recompute=recompute,
                           tensor_parallel=tensor_parallel)
        loss = model(x, labels=y)
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    (l1, g1), (l2, g2) = grads
    assert l1 == l2
    for name in g1:
        torch.testing.assert_close(g2[name], g1[name], rtol=0, atol=0)


def test_context_and_sequence_parallel_without_mesh_are_dense():
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        dense = llama_tiny(device="cpu", seed=3)(x)
        for kw in ({"context_parallel": True}, {"sequence_parallel": True},
                   {"context_parallel": "ulysses"}):
            assert torch.equal(llama_tiny(device="cpu", seed=3, **kw)(x),
                               dense)


@pytest.mark.parametrize("kw", [{"num_kv_heads": 2},
                                {"tensor_parallel": False}])
def test_attention_with_kv_cache_matches_jax(kw):
    """LlamaAttention appending to a cache (K/V already repeated over the
    heads) and attending it without a causal mask, rotary positions from
    0 (the JAX model's): output and the grown cache equal JAX's."""
    cfg = {**TINY, "num_layers": 1, **kw}
    paddle.seed(1)
    ja = JaxAttention(JaxConfig(**cfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 3, 64)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, 5, 4, 16)).astype(np.float32)
              for _ in range(2))
    want, (wk, wv) = ja(paddle.to_tensor(x),
                        kv_cache=(paddle.to_tensor(kc), paddle.to_tensor(vc)),
                        time_step=5)
    pa = LlamaAttention(LlamaConfig(**cfg), device="cpu")
    pa.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                        for k, v in ja.state_dict().items()})
    with torch.no_grad():
        got, (gk, gv) = pa(torch.from_numpy(x),
                           kv_cache=(torch.from_numpy(kc),
                                     torch.from_numpy(vc)), time_step=5)
    tol = TOLERANCES["logits_fp32"]
    assert gk.shape == (B, 8, 4, 16)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)


def test_model_functions_take_device_and_seed():
    """llama_tiny and llama2_7b take device= and seed=; the same seed
    gives the same weights, another seed others; llama2_7b's widths on
    the meta device."""
    a, b, c = (llama_tiny(device="cpu", seed=s) for s in (5, 5, 6))
    w = "llama.layers.0.self_attn.q_proj.weight"
    sa, sb, sc = (dict(m.named_parameters())[w] for m in (a, b, c))
    assert torch.equal(sa, sb) and not torch.equal(sa, sc)
    assert abs(sa.std().item() - 0.02) < 4e-3
    big = llama2_7b(device="meta")
    shapes = {n: tuple(p.shape) for n, p in big.named_parameters()}
    assert sum(p.numel() for p in big.parameters()) == 6738415616
    assert shapes["llama.embed_tokens.weight"] == (32000, 4096)
    assert shapes["llama.layers.0.mlp.gate_proj.weight"] == (4096, 11008)
    assert shapes["lm_head.weight"] == (4096, 32000)


def test_silu_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 7)).astype(np.float32)
    want = JF.silu(paddle.to_tensor(x)).numpy()
    for fn in (F.silu, F.swish):
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                                   **TOLERANCES["logits_fp32"])


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_concat_linear_matches_jax(with_bias):
    """One matmul over the concatenated weights equals JAX's, and the
    gradients split back onto each weight as separate linears give."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    ws = [rng.standard_normal((8, n)).astype(np.float32) for n in (4, 2, 6)]
    bs = [rng.standard_normal(n).astype(np.float32) for n in (4, 2, 6)]
    want = JF.fused_concat_linear(
        paddle.to_tensor(x), [paddle.to_tensor(w) for w in ws],
        [paddle.to_tensor(b) for b in bs] if with_bias else None).numpy()
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    tb = [torch.from_numpy(b) for b in bs] if with_bias else None
    got = F.fused_concat_linear(torch.from_numpy(x), tw, tb)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               **TOLERANCES["logits_fp32"])
    got.sum().backward()
    for w in tw:
        torch.testing.assert_close(
            w.grad, torch.from_numpy(x).reshape(-1, 8).sum(0)[:, None]
            .expand_as(w))


def test_fused_concat_linear_refuses_mixed_biases():
    x = torch.zeros((2, 8))
    ws = [torch.zeros((8, 4)), torch.zeros((8, 2))]
    with pytest.raises(ValueError):
        F.fused_concat_linear(x, ws, [torch.zeros(4), None])
    with pytest.raises(ValueError):
        JF.fused_concat_linear(paddle.to_tensor(x.numpy()),
                               [paddle.to_tensor(w.numpy()) for w in ws],
                               [paddle.to_tensor(np.zeros(4, np.float32)),
                                None])
    assert F.fused_concat_linear(x, ws, [None, None]).shape == (2, 6)


def _ce_inputs():
    """Logits [6, 5] and labels with an ignore_index row (-100) and an
    out-of-range one (7)."""
    rng = np.random.default_rng(8)
    x = (3 * rng.standard_normal((6, 5))).astype(np.float32)
    y = np.array([1, -100, 4, 7, 0, 2], np.int64)
    return x, y


def test_cross_entropy_in_jax_positional_order():
    """(input, label, weight, ignore_index, reduction): JAX's order, as
    LlamaForCausalLM calls it with reduction="none"."""
    x, y = _ce_inputs()
    want = JF.cross_entropy(paddle.to_tensor(x),
                            paddle.to_tensor(y.astype(np.int32)), None, -100,
                            "none").numpy()
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(y), None,
                          -100, "none")
    assert got.shape == (6,) and got[1] == 0 and got[3] == 0
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["train_loss_fp32"])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore_index", [-100, 2])
def test_cross_entropy_reductions_match_jax(reduction, ignore_index):
    """Each reduction with an ignored row and an out-of-range label: the
    mean divides by the count of labels other than ignore_index (the
    out-of-range one included), floored at 1."""
    x, y = _ce_inputs()
    want = JF.cross_entropy(paddle.to_tensor(x),
                            paddle.to_tensor(y.astype(np.int32)),
                            ignore_index=ignore_index,
                            reduction=reduction).numpy()
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                          ignore_index=ignore_index, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["train_loss_fp32"])
    all_ignored = F.cross_entropy(torch.from_numpy(x),
                                  torch.full((6,), ignore_index),
                                  ignore_index=ignore_index)
    assert all_ignored.item() == 0.0


@pytest.mark.parametrize("kw", [
    {"weight": torch.ones(5)}, {"soft_label": True},
    {"use_softmax": False}, {"label_smoothing": 0.1}, {"axis": 0}])
def test_cross_entropy_refuses_what_is_not_ported(kw):
    """The options once refused (class weights, soft labels,
    probabilities in, label smoothing, another class axis) now give
    JAX's loss, each over the labels of ``_ce_inputs`` (its ignored and
    out-of-range rows included) or, for soft labels, a distribution a
    row; ``"none"`` and ``"mean"``."""
    x, y = _ce_inputs()
    kw = {k: v.numpy() if torch.is_tensor(v) else v for k, v in kw.items()}
    if kw.get("soft_label"):
        y = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    if kw.get("use_softmax") is False:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    if kw.get("axis") == 0:
        x = x.T.copy()                  # classes on axis 0
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    for reduction in ("none", "mean"):
        want = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(y),
                                reduction=reduction, **jkw).numpy()
        got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                              reduction=reduction, **tkw)
        np.testing.assert_allclose(got.numpy(), want,
                                   **TOLERANCES["train_loss_fp32"])


def test_cross_entropy_rejects_an_unknown_reduction():
    x, y = map(torch.from_numpy, _ce_inputs())
    with pytest.raises(ValueError):
        F.cross_entropy(x, y, reduction="average")
