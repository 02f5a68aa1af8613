"""The port's fused functionals and layers against the JAX package's.

``incubate.nn.functional.fused_feedforward`` (both LayerNorm placements,
relu and gelu, the fused route under ``PADDLE_TPU_FUSED_FFN=1`` with the
backward kernels and the composite, ``downscale_in_infer`` in inference)
with its gradients, the ``FusedFeedForward`` layer through the weight
bridge, ``fused_rotary_position_embedding``, and
``FusedMultiTransformer.forward`` (``fused_multi_transformer``): with KV
caches, a chunk at ``time_step=0`` then one-token steps (outputs and
caches after every call; JAX with its composite cache attention and with
``PADDLE_TPU_FORCE_PALLAS=1``, its Pallas decode kernel in interpret
mode), with ``rotary_embs``, and without caches. The same numpy inputs
and weights go to both; fp32, held to ``TOLERANCES["logits_fp32"]`` (and
the FFN pieces to ``["ffn_fp32"]``). ``decode_attention_bhsd_reference``
and ``decode_attention`` are held to JAX's Pallas kernel (interpret mode)
over ragged lens, GQA and Sq > 1, to ``["attention_fp32"]``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedFeedForward as JaxFeedForward
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.incubate.nn import FusedFeedForward
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.weights import (feedforward_from_jax_state,
                                      from_jax_state, random_state)

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

LOGITS = TOLERANCES["logits_fp32"]
FFN = TOLERANCES["ffn_fp32"]
E, H, FF, L = 64, 4, 128, 2
B, SMAX, CHUNK, STEPS = 2, 32, 6, 4
D_MODEL, DFF = 128, 256          # the fused FFN needs 128-multiples


# ------------------------------------------------------------- decode attn
@pytest.mark.parametrize("hk,sq", [(4, 1), (2, 1), (4, 5), (2, 5)])
def test_decode_attention_bhsd_matches_jax(hk, sq):
    rng = np.random.default_rng(hk * 10 + sq)
    b, h, d, smax = 3, 4, 16, 40
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hk, smax, d)).astype(np.float32)
            for _ in range(2))
    lens = np.array([0, 7, smax - sq], np.int32)
    want = np.asarray(jax_da.decode_attention_bhsd(
        *map(jnp.asarray, (q, k, v, lens))))
    got = da.decode_attention_bhsd(*map(torch.from_numpy, (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    np.testing.assert_allclose(
        da.decode_attention_bhsd_reference(
            *map(torch.from_numpy, (q, k, v, lens))).numpy(), want,
        **TOLERANCES["attention_fp32"])
    # the model layout, and a cache in another dtype (cast to q's)
    qm, km, vm = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    want = np.asarray(jax_da.decode_attention(
        jnp.asarray(qm), jnp.asarray(km, jnp.bfloat16),
        jnp.asarray(vm, jnp.bfloat16), jnp.asarray(lens)))
    got = da.decode_attention(
        torch.from_numpy(qm), torch.from_numpy(km).to(torch.bfloat16),
        torch.from_numpy(vm).to(torch.bfloat16), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])


def test_decode_attention_gate_matches_jax():
    for q_shape, c_shape, dt in [((2, 1, 12, 64), (2, 1024, 12, 64),
                                  "float32"),
                                 ((2, 128, 12, 64), (2, 128, 6, 64),
                                  "bfloat16"),
                                 ((2, 129, 12, 64), (2, 256, 12, 64),
                                  "float32"),
                                 ((2, 4, 12, 512), (2, 64, 12, 512),
                                  "float16"),
                                 ((2, 4, 12, 64), (2, 64, 5, 64),
                                  "float32"),
                                 ((2, 4, 64), (2, 64, 64), "float32")]:
        assert da.is_supported(q_shape, c_shape, getattr(torch, dt)) \
            == jax_da.is_supported(q_shape, c_shape, getattr(jnp, dt))


# ---------------------------------------------------------- feed-forward
def _ffn_arrays(seed, lead):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, D_MODEL)).astype(np.float32)
    params = [
        (rng.standard_normal((D_MODEL, DFF)) / np.sqrt(D_MODEL)),
        (rng.standard_normal((DFF, D_MODEL)) / np.sqrt(DFF)),
        0.1 * rng.standard_normal(DFF), 0.1 * rng.standard_normal(D_MODEL),
        1 + 0.1 * rng.standard_normal(D_MODEL),
        0.1 * rng.standard_normal(D_MODEL),
        1 + 0.1 * rng.standard_normal(D_MODEL),
        0.1 * rng.standard_normal(D_MODEL)]
    g = rng.standard_normal((*lead, D_MODEL)).astype(np.float32)
    return x, [p.astype(np.float32) for p in params], g


def _jax_ffn(x, params, g, **kw):
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in (x, *params)]
    out = JIF.fused_feedforward(*ts, **kw)
    (out * paddle.to_tensor(g)).sum().backward()
    return [out.numpy()] + [None if t.grad is None else t.grad.numpy()
                            for t in ts]


def _port_ffn(x, params, g, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *params)]
    out = IF.fused_feedforward(*ts, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    return [out.detach().numpy()] + [None if t.grad is None
                                     else t.grad.numpy() for t in ts]


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("act,route", [("gelu", "fused"),
                                       ("gelu", "composite"),
                                       ("relu", "composite"),
                                       ("relu", "flag-on")])
def test_fused_feedforward_matches_jax(monkeypatch, pre_ln, act, route):
    """Output and every gradient equal JAX's; the port takes fused_ffn
    exactly under JAX's gate (the flag, gelu, dropouts 0, both biases)."""
    if route == "composite":
        monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
        monkeypatch.setenv("PADDLE_TPU_FUSED_FFN_BWD", "1")
    calls = []
    real = IF.fused_ffn
    monkeypatch.setattr(IF, "fused_ffn",
                        lambda *a: calls.append(1) or real(*a))
    x, params, g = _ffn_arrays(int(pre_ln), (2, 8))
    # linear1_weight, linear2_weight, linear1_bias, linear2_bias, LNs
    w1, w2, b1, b2, *lns = params
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=act,
              pre_layer_norm=pre_ln)
    got = _port_ffn(x, [w1, w2, b1, b2, *lns], g, **kw)
    want = _jax_ffn(x, [w1, w2, b1, b2, *lns], g, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:      # the LayerNorm the placement leaves unused
            assert a is None, f"part {i}"
        else:
            np.testing.assert_allclose(a, b, err_msg=f"part {i}", **FFN)
    assert len(calls) == (route == "fused")


def test_fused_feedforward_downscale_in_infer(monkeypatch):
    """Inference under downscale_in_infer scales both dropouts by 1 - p,
    so its dropouts are not inert and the fused route stays off."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    x, params, _ = _ffn_arrays(5, (3, 8))
    kw = dict(dropout1_rate=0.1, dropout2_rate=0.25, activation="gelu",
              training=False, mode="downscale_in_infer")
    got = IF.fused_feedforward(*map(torch.from_numpy, (x, *params)), **kw)
    want = JIF.fused_feedforward(*map(paddle.to_tensor, (x, *params)), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FFN)
    plain = IF.fused_feedforward(*map(torch.from_numpy, (x, *params)),
                                 **{**kw, "mode": "upscale_in_train"})
    assert not np.allclose(got.numpy(), plain.numpy())


@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_feedforward_layer_through_the_bridge(monkeypatch, pre_ln):
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN_BWD", "1")
    paddle.seed(3)
    jl = JaxFeedForward(D_MODEL, DFF, dropout_rate=0.0, activation="gelu",
                        normalize_before=pre_ln)
    state = {k: np.asarray(v._data) for k, v in jl.state_dict().items()}
    tl = feedforward_from_jax_state(state, dropout_rate=0.0,
                                    activation="gelu",
                                    normalize_before=pre_ln, device="cpu")
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} \
        == {n: a.shape for n, a in state.items()}
    x, _, g = _ffn_arrays(9, (2, 8))
    xj = paddle.to_tensor(x, stop_gradient=False)
    out_j = jl(xj)
    (out_j * paddle.to_tensor(g)).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tl(xt)
    (out_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j.numpy(), **FFN)
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), **FFN)
    grads_j = {n: p.grad for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        if grads_j[n] is None:     # pre-LN leaves ln2 unused, post-LN ln1
            assert p.grad is None, n
        else:
            np.testing.assert_allclose(p.grad.numpy(), grads_j[n].numpy(),
                                       err_msg=n, **FFN)


def test_fused_feedforward_layer_initialises_like_jax():
    """Xavier-normal weights from its seed, zero biases, unit scales."""
    a, b = (FusedFeedForward(D_MODEL, DFF, device="cpu", seed=s)
            for s in (1, 1))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    std = np.sqrt(2.0 / (D_MODEL + DFF))
    assert abs(a.linear1_weight.std().item() - std) < 0.05 * std
    assert torch.equal(a.linear1_bias, torch.zeros(DFF))
    assert torch.equal(a.ln2_scale, torch.ones(D_MODEL))
    assert all(p.requires_grad for p in a.parameters())


# --------------------------------------------------------------- rotary
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("given", [False, True])
def test_rotary_matches_jax(neox, given):
    rng = np.random.default_rng(int(neox) + 2 * int(given))
    q, k = (rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
            for _ in range(2))
    sc = {}
    if given:
        sc = {"sin": rng.standard_normal((5, 4)).astype(np.float32),
              "cos": rng.standard_normal((5, 4)).astype(np.float32)}
    got = IF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), use_neox_rotary_style=neox,
        position_offset=3, **{n: torch.from_numpy(a) for n, a in sc.items()})
    want = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k), use_neox_rotary_style=neox,
        position_offset=3, **{n: paddle.to_tensor(a) for n, a in sc.items()})
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGITS)


# ------------------------------------------------- fused_multi_transformer
def _fmt_pair(pre_ln):
    """The JAX layer and the port's (through the bridge) on the same
    random numpy weights."""
    fmt_np, emb_np, head_np = random_state(np.random.default_rng(1), E, H,
                                           FF, L, 16)
    paddle.seed(0)
    jmod = JaxFMT(E, H, FF, num_layers=L, normalize_before=pre_ln)
    jmod.set_state_dict(fmt_np)
    jmod.eval()
    tmod, _, _ = from_jax_state(fmt_np, emb_np, head_np,
                                normalize_before=pre_ln, device="cpu")
    return jmod, tmod


def _xs(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (B, n, E)).astype(np.float32)


@pytest.mark.parametrize("force_pallas", [False, True])
@pytest.mark.parametrize("rotary", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_cache_decode_matches_jax(monkeypatch, force_pallas, rotary,
                                  pre_ln):
    """A chunk at time_step 0, then one-token steps: every call's output
    and every cache (written in place, returned) equal JAX's; JAX with
    its composite and with its Pallas decode kernel."""
    if force_pallas:
        monkeypatch.setenv("PADDLE_TPU_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_FORCE_PALLAS", raising=False)
    jmod, tmod = _fmt_pair(pre_ln)
    shape = (2, B, H, SMAX, E // H)
    jc = [paddle.to_tensor(np.zeros(shape, np.float32)) for _ in range(L)]
    tc = [torch.zeros(shape) for _ in range(L)]
    xs = _xs(2, CHUNK + STEPS)
    rot = {}
    if rotary:     # its values are not read, as in the JAX function
        rot = {"j": paddle.to_tensor(np.ones(3, np.float32)),
               "t": torch.ones(3)}
    calls = []
    real = da.decode_attention_bhsd
    monkeypatch.setattr(da, "decode_attention_bhsd",
                        lambda *a: calls.append(1) or real(*a))
    for i in range(STEPS + 1):
        ts, n = (0, CHUNK) if i == 0 else (CHUNK + i - 1, 1)
        out_j, jc2 = jmod(paddle.to_tensor(xs[:, ts:ts + n]), caches=jc,
                          time_step=ts, rotary_embs=rot.get("j"))
        out_t, tc2 = tmod(torch.from_numpy(xs[:, ts:ts + n]), caches=tc,
                          time_step=ts, rotary_embs=rot.get("t"))
        assert all(a is b for a, b in zip(tc2, tc))     # in place
        np.testing.assert_allclose(out_t.numpy(), out_j.numpy(),
                                   err_msg=f"call {i}", **LOGITS)
        for j, (a, b) in enumerate(zip(tc, jc2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b._data),
                                       err_msg=f"call {i} cache {j}",
                                       **LOGITS)
    assert len(calls) == L * (STEPS + 1)


@pytest.mark.parametrize("rotary", [False, True])
@pytest.mark.parametrize("with_caches", [False, True])
def test_without_time_step_matches_jax(rotary, with_caches):
    """No time_step: causal attention over the chunk itself; given
    caches come back unchanged, else only the output returns."""
    jmod, tmod = _fmt_pair(True)
    xs = _xs(3, 7)
    shape = (2, B, H, SMAX, E // H)
    kw_j, kw_t = {}, {}
    if with_caches:
        kw_j["caches"] = [paddle.to_tensor(np.zeros(shape, np.float32))
                          for _ in range(L)]
        kw_t["caches"] = [torch.zeros(shape) for _ in range(L)]
    if rotary:
        kw_j["rotary_embs"] = paddle.to_tensor(np.ones(3, np.float32))
        kw_t["rotary_embs"] = torch.ones(3)
    out_j = jmod(paddle.to_tensor(xs), **kw_j)
    out_t = tmod(torch.from_numpy(xs), **kw_t)
    if with_caches:
        (out_j, _), (out_t, caches) = out_j, out_t
        assert all(not c.any() for c in caches)
    np.testing.assert_allclose(out_t.numpy(), out_j.numpy(), **LOGITS)
