"""The port's fused FFN against the JAX package's.

``paddle_tpu.ops.pallas.fused_ffn.fused_ffn`` (its Pallas forward and,
under ``PADDLE_TPU_FUSED_FFN_BWD=1``, its two backward kernels, in
interpret mode off-TPU) with ``jax.vjp`` through its custom VJP, against
``paddle_tpu_torch.ops.fused_ffn.fused_ffn`` and autograd through it (on
CPU tensors the kernels' plain versions): the same numpy x, W1, b1, W2,
b2 and upstream gradient; the output and all five gradients, both
activations, the backward kernels on and off, held to
``TOLERANCES["ffn_fp32"]`` (and in bf16 to ``["ffn_bf16"]`` and
``["ffn_wgrad_bf16"]``). The shapes pass JAX's gate (K and F multiples of
128, M a multiple of 8), so JAX really runs its kernels. Where the gate
fails both sides take the composite, also held to JAX's. The CUDA
kernels are held to the plain versions on the card (the ``cuda`` test
here, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_ffn as jax_ffn
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import fused_ffn as ffn

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["ffn_fp32"]
PARTS = ("out", "dx", "dW1", "db1", "dW2", "db2")


def _inputs(seed, lead, k, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w1 = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, k)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(k)).astype(np.float32)
    g = rng.standard_normal((*lead, k)).astype(np.float32)
    return x, w1, b1, w2, b2, g


def _jax(arrays, act, fn=jax_ffn.fused_ffn, dtype=jnp.float32):
    *inputs, g = (jnp.asarray(a, dtype) for a in arrays)
    out, vjp = jax.vjp(lambda *a: fn(*a, act), *inputs)
    return [np.asarray(out.astype(jnp.float32))] + [
        np.asarray(t.astype(jnp.float32)) for t in vjp(g)]


def _port(arrays, act, dtype=torch.float32):
    *inputs, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    ts = [t.requires_grad_() for t in inputs]
    out = ffn.fused_ffn(*ts, act)
    out.backward(g)
    return [out.detach().float().numpy()] + [t.grad.float().numpy()
                                             for t in ts]


def _assert_parts(got, want, tols):
    for part, a, b, tol in zip(PARTS, got, want, tols):
        assert a.shape == b.shape, part
        np.testing.assert_allclose(a, b, err_msg=part, **tol)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("bwd", ["kernels", "composite"])
@pytest.mark.parametrize("lead,k,f", [((16,), 128, 256),
                                      ((2, 32), 128, 512),
                                      ((8,), 256, 128)])
def test_matches_jax(monkeypatch, act, bwd, lead, k, f):
    """Output and gradients equal JAX's fused_ffn, with its backward
    kernels (PADDLE_TPU_FUSED_FFN_BWD=1) and with its composite
    backward."""
    if bwd == "kernels":
        monkeypatch.setenv("PADDLE_TPU_FUSED_FFN_BWD", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_FUSED_FFN_BWD", raising=False)
    arrays = _inputs(k + f + len(lead), lead, k, f)
    calls = []
    for name in ("fused_ffn_bwd_dx", "fused_ffn_bwd_dw"):
        real = getattr(ffn, name)
        monkeypatch.setattr(ffn, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    _assert_parts(_port(arrays, act), _jax(arrays, act), [TOL] * 6)
    assert calls == (["fused_ffn_bwd_dx", "fused_ffn_bwd_dw"]
                     if bwd == "kernels" else [])


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_matches_jax_composite(act):
    """The kernels' route against JAX's plain composite (autodiff through
    ``_composite``): the same function."""
    arrays = _inputs(7, (24,), 128, 256)
    x, w1, b1, w2, b2, g = arrays
    want = _jax(arrays, act, fn=lambda a, w1, b1, w2, b2, act:
                jax_ffn._composite(a, w1, b1, w2, b2, act))
    _assert_parts(_port(arrays, act), want, [TOL] * 6)


@pytest.mark.parametrize("lead,k,f", [((16,), 64, 256),    # K % 128
                                      ((4,), 128, 256),    # M < 8
                                      ((12,), 128, 256),   # M % 8: no bm
                                      ((16,), 128, 192)])  # F % 128
def test_composite_where_jax_gate_fails(monkeypatch, lead, k, f):
    """Where JAX's gate fails both take the composite (no kernel or plain
    version runs), even with the backward flag on, and agree."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN_BWD", "1")
    for name in ("fused_ffn_fwd", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw"):
        monkeypatch.setattr(ffn, name, lambda *a, _n=name: pytest.fail(
            f"{_n} called outside JAX's gate"))
    arrays = _inputs(3, lead, k, f)
    _assert_parts(_port(arrays, "gelu_tanh"), _jax(arrays, "gelu_tanh"),
                  [TOL] * 6)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_bf16_matches_jax(monkeypatch, act):
    """bf16 with the backward kernels: the TPU kernels' roundings (t and
    dpre rounded to bf16 before their products, db1 from the fp32 dpre,
    db2 the fp32 sum of g) give JAX's values."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN_BWD", "1")
    arrays = _inputs(11, (32,), 128, 256)
    got = _port(arrays, act, torch.bfloat16)
    want = _jax(arrays, act, dtype=jnp.bfloat16)
    bf, wg = TOLERANCES["ffn_bf16"], TOLERANCES["ffn_wgrad_bf16"]
    _assert_parts(got, want, [bf, bf, wg, bf, wg, bf])


def test_routes_like_jax():
    """The gate, the F tile and the row tiles equal JAX's, so the port
    takes its kernels exactly where JAX takes its own."""
    for m, k, f, dt in [(8192, 768, 3072, "bfloat16"), (16, 128, 256,
                        "float32"), (64, 1024, 2816, "float16"),
                        (8, 8192, 512, "float32"), (24, 128, 384,
                        "bfloat16"), (4, 128, 128, "float32"),
                        (1000, 768, 3072, "float32")]:
        tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
        assert ffn.ffn_is_supported(m, k, f, tdt) \
            == jax_ffn.ffn_is_supported(m, k, f, jdt)
        bf = ffn._pick_bf(f)
        assert bf == jax_ffn._pick_bf(f)
        assert ffn._pick_bm(m, k, f, bf or 128, tdt) \
            == jax_ffn._pick_bm(m, k, f, bf or 128, jdt)
        for which in ("dx", "dw"):
            assert ffn._pick_bm_bwd(m, k, bf or 128, tdt, which) \
                == jax_ffn._pick_bm_bwd(m, k, bf or 128, jdt, which)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_dgelu_is_the_activation_derivative(act):
    pre = torch.linspace(-6, 6, 241, dtype=torch.float64,
                         requires_grad=True)
    (grad,) = torch.autograd.grad(ffn._ACTS[act](pre).sum(), pre)
    torch.testing.assert_close(ffn._dgelu(pre.detach(), act), grad)


def test_saves_only_the_inputs():
    """Like JAX's custom VJP, the forward keeps only its inputs: no [M, F]
    tensor waits for the backward."""
    x, w1, b1, w2, b2, _ = (torch.from_numpy(a).requires_grad_()
                            for a in _inputs(0, (16,), 128, 512))
    out = ffn.fused_ffn(x, w1, b1, w2, b2)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        tuple(t.shape) for t in (x, w1, b1, w2, b2)]
    assert all(s.data_ptr() == t.data_ptr()
               for s, t in zip(saved, (x, w1, b1, w2, b2)))


@pytest.mark.parametrize("bad", ["k", "dtype", "shape", "activation",
                                 "device"])
def test_kernel_wrappers_refuse(bad):
    x, w1, b1, w2, b2, g = (torch.from_numpy(a)
                            for a in _inputs(0, (16,), 128, 256))
    with pytest.raises(ValueError):
        if bad == "k":
            ffn.fused_ffn_fwd(x[:, :64], w1[:64], b1, w2[:, :64], b2[:64])
        elif bad == "dtype":
            ffn.fused_ffn_bwd_dx(x, g, w1.double(), b1, w2)
        elif bad == "shape":
            ffn.fused_ffn_bwd_dw(x, g[:8], w1, b1, w2)
        elif bad == "activation":
            ffn.fused_ffn(x, w1, b1, w2, b2, "relu")
        else:
            ffn.fused_ffn_fwd(*(t.to("meta") for t in (x, w1, b1, w2, b2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    tol = TOLERANCES["ffn_fp32_large" if dtype == "float32" else "ffn_bf16"]
    wtol = TOLERANCES["ffn_fp32_large" if dtype == "float32"
                      else "ffn_wgrad_bf16"]
    x, w1, b1, w2, b2, g = (torch.from_numpy(a).cuda().to(tdt)
                            for a in _inputs(5, (136,), 768, 3072))
    for act in ("gelu_tanh", "gelu"):
        torch.testing.assert_close(
            ffn.fused_ffn_fwd(x, w1, b1, w2, b2, act).float(),
            ffn.fused_ffn_fwd_reference(x, w1, b1, w2, b2, act).float(),
            **tol)
        torch.testing.assert_close(
            ffn.fused_ffn_bwd_dx(x, g, w1, b1, w2, act).float(),
            ffn.fused_ffn_bwd_dx_reference(x, g, w1, b1, w2, act).float(),
            **tol)
        got = ffn.fused_ffn_bwd_dw(x, g, w1, b1, w2, act)
        want = ffn.fused_ffn_bwd_dw_reference(x, g, w1, b1, w2, act)
        for a, b, t in zip(got, want, (wtol, wtol, tol)):
            torch.testing.assert_close(a.float(), b.float(), **t)
