"""The port's Transformer layers, initializers and attention functionals
against the JAX package's, on the CPU.

Each layer is built on both sides (dropout 0), JAX's parameters redrawn
from numpy and loaded into the port's by name, and the outputs compared
in fp32 within TOLERANCES["logits_fp32"]:

- ``MultiHeadAttention``: self attention (the fused q/k/v path) without
  a mask, with a bool and an additive mask; cross attention with other
  key and value widths; an incremental ``Cache`` over two calls (the
  outputs and the grown cache); a ``StaticCache``; ``need_weights``;
- ``TransformerEncoderLayer`` / ``TransformerDecoderLayer`` with
  ``normalize_before`` both ways, ``TransformerEncoder`` /
  ``TransformerDecoder`` (their clones) with a decoder cache, and
  ``Transformer`` with ``generate_square_subsequent_mask``.

The initializers: ``_fans`` and ``calculate_gain`` equal JAX's numbers;
``Constant``, ``Assign`` and ``Dirac`` JAX's values exactly; the random
ones (drawn from a generator, JAX's from its key) within their bounds,
with mean and standard deviation within 5 standard errors of the
distribution's (n = 65536; JAX's own draws held to the same), and
``Orthogonal`` orthonormal as JAX's is. Then ``F.flash_attention`` and
``F.flash_attn_unpadded`` against JAX's within
TOLERANCES["attention_fp32"].
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.nn.layer import transformer as jtr
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.nn.layer import transformer as ttr

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["logits_fp32"]
E, H, B = 16, 2, 2


def _redraw(jlayer, seed):
    """Every JAX parameter redrawn from numpy (LayerNorm scales near 1,
    small biases, matrices over sqrt(fan_in)); returns the state."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jlayer.state_dict().items():
        z = rng.standard_normal(tuple(v.shape))
        sd[k] = ((1 + 0.1 * z) if "norm" in k and k.endswith("weight")
                 else 0.1 * z if k.endswith("bias")
                 else z / np.sqrt(v.shape[0])).astype(np.float32)
    jlayer.set_state_dict(sd)
    return sd


def _pair(jcls, tcls, seed, *args, **kw):
    paddle.seed(seed)
    jl = jcls(*args, **kw)
    tl = tcls(*args, **kw, device="cpu")
    state = _redraw(jl, seed)
    assert set(dict(tl.named_parameters())) == set(state)
    tl.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    jl.eval()
    tl.eval()
    return jl, tl


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, what=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        return
    if want is None:
        assert got is None, what
        return
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL,
                               err_msg=what)


def _masks(s):
    keep = np.ones((B, 1, 1, s), bool)
    keep[0, ..., -2:] = False
    add = np.where(keep, 0.0, -1e9).astype(np.float32)
    return {"none": None, "bool": keep, "additive": add}


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_self_attention_matches_jax(mask):
    jl, tl = _pair(jtr.MultiHeadAttention, ttr.MultiHeadAttention, 1, E, H)
    x = _x(2, B, 5, E)
    m = _masks(5)[mask]
    want = jl(paddle.to_tensor(x), attn_mask=None if m is None
              else paddle.to_tensor(m))
    got = tl(torch.from_numpy(x), attn_mask=None if m is None
             else torch.from_numpy(m))
    _close(got, want, mask)


def test_cross_attention_and_caches_match_jax():
    """Other key / value widths; a Cache grown over two calls; a
    StaticCache of the memory; need_weights."""
    jl, tl = _pair(jtr.MultiHeadAttention, ttr.MultiHeadAttention, 3, E, H,
                   0.0, 12, 10)
    q, k, v = _x(4, B, 3, E), _x(5, B, 6, 12), _x(6, B, 6, 10)
    _close(tl(*map(torch.from_numpy, (q, k, v))),
           jl(*map(paddle.to_tensor, (q, k, v))), "cross")
    jl, tl = _pair(jtr.MultiHeadAttention, ttr.MultiHeadAttention, 7, E, H,
                   need_weights=True)
    x1, x2, mem = _x(8, B, 2, E), _x(9, B, 1, E), _x(10, B, 4, E)
    jc = jl.gen_cache(paddle.to_tensor(x1))
    tc = tl.gen_cache(torch.from_numpy(x1))
    for i, xs in enumerate((x1, x2)):
        jout = jl(paddle.to_tensor(xs), cache=jc)
        tout = tl(torch.from_numpy(xs), cache=tc)
        jc, tc = jout[-1], tout[-1]
        _close(tout[:2], jout[:2], f"cache call {i}")
        _close(tuple(tc), tuple(jc), f"cache after call {i}")
    js = jl.gen_cache(paddle.to_tensor(mem), type=jtr.MultiHeadAttention
                      .StaticCache)
    ts = tl.gen_cache(torch.from_numpy(mem), type=ttr.MultiHeadAttention
                      .StaticCache)
    _close(tuple(ts), tuple(js), "static cache")
    _close(tl(torch.from_numpy(x1), cache=ts),
           jl(paddle.to_tensor(x1), cache=js), "static")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches_jax(normalize_before):
    """An encoder layer (gelu, eps 1e-12) with a padding mask, and a
    2-layer encoder whose second layer is JAX's clone (default eps)."""
    args = (E, H, 32, 0.0, "gelu")
    kw = {"normalize_before": normalize_before, "layer_norm_eps": 1e-12}
    jl, tl = _pair(jtr.TransformerEncoderLayer, ttr.TransformerEncoderLayer,
                   11, *args, **kw)
    x, m = _x(12, B, 5, E), _masks(5)["bool"]
    _close(tl(torch.from_numpy(x), torch.from_numpy(m)),
           jl(paddle.to_tensor(x), paddle.to_tensor(m)), "layer")
    paddle.seed(13)
    jenc = jtr.TransformerEncoder(jtr.TransformerEncoderLayer(*args, **kw),
                                  2)
    tenc = ttr.TransformerEncoder(ttr.TransformerEncoderLayer(
        *args, **kw, device="cpu"), 2)
    assert [l.norm1.epsilon for l in tenc.layers] == \
        [l.norm1.epsilon for l in jenc.layers] == [1e-12, 1e-5]
    state = _redraw(jenc, 13)
    tenc.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    jenc.eval()
    tenc.eval()
    _close(tenc(torch.from_numpy(x)), jenc(paddle.to_tensor(x)), "encoder")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_and_transformer_match_jax(normalize_before):
    """A 2-layer decoder over a memory with a causal mask, and again
    step by step from its cache; the whole Transformer."""
    paddle.seed(14)
    args = (E, H, 32, 0.0)
    kw = {"normalize_before": normalize_before}
    jdec = jtr.TransformerDecoder(jtr.TransformerDecoderLayer(*args, **kw),
                                  2)
    tdec = ttr.TransformerDecoder(ttr.TransformerDecoderLayer(
        *args, **kw, device="cpu"), 2)
    state = _redraw(jdec, 14)
    tdec.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    jdec.eval()
    tdec.eval()
    tgt, mem = _x(15, B, 3, E), _x(16, B, 4, E)
    causal = np.where(np.tril(np.ones((3, 3), bool)), 0.0,
                      -np.inf).astype(np.float32)
    _close(tdec(*map(torch.from_numpy, (tgt, mem, causal))),
           jdec(*map(paddle.to_tensor, (tgt, mem, causal))), "decoder")
    jc = jdec.gen_cache(paddle.to_tensor(mem))
    tc = tdec.gen_cache(torch.from_numpy(mem))
    for t in range(2):
        jy, jc = jdec(paddle.to_tensor(tgt[:, t:t + 1]),
                      paddle.to_tensor(mem), cache=jc)
        ty, tc = tdec(torch.from_numpy(tgt[:, t:t + 1]),
                      torch.from_numpy(mem), cache=tc)
        _close(ty, jy, f"decoder step {t}")
    jm, tm = _pair(jtr.Transformer, ttr.Transformer, 17, E, H, 1, 1, 32,
                   0.0, normalize_before=normalize_before)
    np.testing.assert_array_equal(
        tm.generate_square_subsequent_mask(3).numpy(),
        jm.generate_square_subsequent_mask(3).numpy())
    _close(tm(torch.from_numpy(mem), torch.from_numpy(tgt),
              tgt_mask=torch.from_numpy(causal)),
           jm(paddle.to_tensor(mem), paddle.to_tensor(tgt),
              tgt_mask=paddle.to_tensor(causal)), "transformer")


def test_fans_and_gains_match_jax():
    for shape in ((), (5,), (3, 4), (8, 4, 3, 3), (6, 2, 5)):
        assert tinit._fans(shape) == jinit._fans(shape)
    for name in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu",
                 "unknown"):
        assert tinit.calculate_gain(name) == jinit.calculate_gain(name)
    for param in (None, 0.2):
        assert tinit.calculate_gain("leaky_relu", param) == \
            jinit.calculate_gain("leaky_relu", param)


N = 65536


def _trunc_std(a, b):
    """The standard deviation of a standard normal truncated to [a, b]."""
    pdf = [math.exp(-t * t / 2) / math.sqrt(2 * math.pi) for t in (a, b)]
    mass = 0.5 * (math.erf(b / math.sqrt(2)) - math.erf(a / math.sqrt(2)))
    mean = (pdf[0] - pdf[1]) / mass
    return math.sqrt(1 + (a * pdf[0] - b * pdf[1]) / mass - mean * mean)


# name -> (constructor arguments, shape, mean, std, bounds or None)
_S = (256, 256)
RANDOM = {
    "Normal": ((0.5, 2.0), _S, 0.5, 2.0, None),
    "TruncatedNormal": ((0.1, 0.5, -1.5, 2.0), _S,
                        None, 0.5 * _trunc_std(-1.5, 2.0),
                        (0.1 - 0.75, 0.1 + 1.0)),
    "Uniform": ((-0.5, 1.5), _S, 0.5, 2 / math.sqrt(12), (-0.5, 1.5)),
    "XavierNormal": ((), (128, 512), 0.0, math.sqrt(2 / 640), None),
    "XavierUniform": ((), (128, 512), 0.0, math.sqrt(6 / 640 / 3),
                      (-math.sqrt(6 / 640), math.sqrt(6 / 640))),
    "KaimingNormal": ((), (64, 16, 8, 8), 0.0, math.sqrt(2 / 1024), None),
    "KaimingUniform": ((None, 0.1, "leaky_relu"), (256, 256), 0.0,
                       math.sqrt(2 / 1.01) * math.sqrt(3 / 256)
                       / math.sqrt(3),
                       (-math.sqrt(2 / 1.01) * math.sqrt(3 / 256),
                        math.sqrt(2 / 1.01) * math.sqrt(3 / 256))),
}


def _moments_ok(a, mean, std, bounds, what):
    a = np.asarray(a, np.float64).ravel()
    n = a.size
    if bounds is not None:
        assert bounds[0] <= a.min() and a.max() <= bounds[1], what
    if mean is not None:
        assert abs(a.mean() - mean) < 5 * std / math.sqrt(n), what
    assert abs(a.std() - std) < 5 * std / math.sqrt(2 * n), what


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_initializers_match_jax_moments(name):
    args, shape, mean, std, bounds = RANDOM[name]
    paddle.seed(0)
    want = np.asarray(getattr(jinit, name)(*args)(shape))
    got = getattr(tinit, name)(*args)(
        shape, generator=torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    _moments_ok(want, mean, std, bounds, f"JAX {name}")
    _moments_ok(got, mean, std, bounds, f"port {name}")


def test_deterministic_initializers_equal_jax():
    value = np.arange(12, dtype=np.float32)
    for jobj, tobj, shape in (
            (jinit.Constant(0.25), tinit.Constant(0.25), (3, 4)),
            (jinit.Assign(value), tinit.Assign(value), (3, 4)),
            (jinit.Dirac(2), tinit.Dirac(2), (6, 4, 3, 3))):
        np.testing.assert_array_equal(tobj(shape, "float32").numpy(),
                                      np.asarray(jobj(shape)))
    assert tinit.Constant(2.0)((2,), torch.bfloat16).dtype == torch.bfloat16
    for shape in ((64, 16), (16, 64), (4, 8, 32)):
        paddle.seed(1)
        for q in (np.asarray(jinit.Orthogonal(2.0)(shape)),
                  tinit.Orthogonal(2.0)(shape, generator=torch.Generator()
                                        .manual_seed(1)).numpy()):
            m = q.reshape(-1, shape[-1]) / 2.0
            gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
            np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_functionals_match_jax(causal):
    """``F.flash_attention`` ([B, S, H, D], the flash route's plain
    version here) and ``F.flash_attn_unpadded`` (three packed sequences
    of 3, 4 and 5) against JAX's; ``sdp_kernel`` as a no-op context."""
    tol = TOLERANCES["attention_fp32"]
    q, k, v = (_x(20 + i, B, 7, H, 8) for i in range(3))
    with F.sdp_kernel(enable_math=False):
        got, none = F.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    want, _ = JF.flash_attention(*map(paddle.to_tensor, (q, k, v)),
                                 causal=causal)
    assert none is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    cu = np.array([0, 3, 7, 12], np.int32)
    q, k, v = (_x(30 + i, 12, H, 8) for i in range(3))
    got, _ = F.flash_attn_unpadded(*map(torch.from_numpy, (q, k, v)),
                                   torch.from_numpy(cu), torch.from_numpy(cu),
                                   5, 5, causal=causal)
    want, _ = JF.flash_attn_unpadded(*map(paddle.to_tensor, (q, k, v)),
                                     paddle.to_tensor(cu),
                                     paddle.to_tensor(cu), 5, 5,
                                     causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
