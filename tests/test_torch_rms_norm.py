"""The port's RMSNorm against the JAX package's Pallas RMSNorm.

``paddle_tpu.ops.pallas.layer_norm.rms_norm`` (interpret mode off-TPU, as
tests/test_pallas_kernels.py runs it; rows padded to 8 inside) and
``jax.vjp`` through it, against ``paddle_tpu_torch.ops.layer_norm.
rms_norm`` and autograd through it (on CPU tensors the kernels' plain
versions): the same numpy x, gamma and upstream gradient, row counts 1,
7, 8, 40 and 300, D 64, 128 and 520, fp32 held to
TOLERANCES["layer_norm_fp32"] and bf16 to ["layer_norm_bf16"] (the
reasons stated there hold for RMSNorm too: the same fp32 row sums and
dgamma partials in another order, and in bf16 one rounding of y, dx and
dgamma on either side). The forward's rstd is held to numpy's in fp64.
``nn.functional.rms_norm`` takes the kernel path only when its gate
holds, else the composite, which is held to the JAX package's
``F.rms_norm``. The CUDA kernels are held to the plain versions on the
card (the ``cuda`` test here, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import layer_norm as jax_ln
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import layer_norm as ln

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["layer_norm_fp32"]
DTYPES = {"float32": (jnp.float32, torch.float32, "layer_norm_fp32"),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, "layer_norm_bf16")}


def _inputs(seed, n, d):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return x, gamma, dy


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [64, 128, 520])
@pytest.mark.parametrize("n", [1, 7, 8, 40, 300])
def test_matches_jax_kernel(n, d, dtype):
    jdt, tdt, tname = DTYPES[dtype]
    tol = TOLERANCES[tname]
    x, gamma, dy = _inputs(n * d, n, d)
    jx, jg, jdy = (jnp.asarray(a, jdt) for a in (x, gamma, dy))
    want_y, vjp = jax.vjp(lambda a, g: jax_ln.rms_norm(a, g, 1e-5), jx, jg)
    want_dx, want_dg = vjp(jdy)
    xt, gt = (torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (x, gamma))
    y = ln.rms_norm(xt, gt, 1e-5)
    assert y.dtype == tdt
    np.testing.assert_allclose(y.detach().float().numpy(), _f32(want_y),
                               **tol)
    y.backward(torch.from_numpy(dy).to(tdt))
    assert xt.grad.dtype == gt.grad.dtype == tdt
    for name, t, w in (("dx", xt, want_dx), ("dgamma", gt, want_dg)):
        np.testing.assert_allclose(t.grad.float().numpy(), _f32(w),
                                   err_msg=name, **tol)


def test_statistics_match_numpy():
    x, gamma, _ = _inputs(1, 37, 96)
    before = dict(ln.LAUNCHES)
    y, rstd = ln.rms_norm_fwd(*map(torch.from_numpy, (x, gamma)), 1e-6)
    assert ln.LAUNCHES == before       # the plain version launches nothing
    x64 = x.astype(np.float64)
    r = 1 / np.sqrt((x64 ** 2).mean(1, keepdims=True) + 1e-6)
    assert rstd.shape == (37, 1) and rstd.dtype == torch.float32
    np.testing.assert_allclose(rstd.numpy(), r, **TOL)
    np.testing.assert_allclose(y.numpy(), x64 * r * gamma, **TOL)
    _, _, dy = _inputs(2, 37, 96)
    ln.rms_norm_bwd(*map(torch.from_numpy, (x, gamma)), rstd,
                    torch.from_numpy(dy))
    assert ln.LAUNCHES == before


def test_functional_matches_jax():
    """F.rms_norm against the JAX package's F.rms_norm (its composite on
    the CPU): no weight, a bf16 weight on fp32 x (the composite, which
    promotes to fp32), a weight in x's dtype (the kernel route), an odd D
    and eps 1e-6 and 1e-5."""
    x, gamma, _ = _inputs(3, 6, 33)
    xt, gt = map(torch.from_numpy, (x, gamma))
    jx = paddle.to_tensor(x)
    gb = jnp.asarray(gamma, jnp.bfloat16)
    for w, jw in ((None, None), (gt, paddle.to_tensor(gamma)),
                  (torch.from_numpy(_f32(gb)).to(torch.bfloat16),
                   paddle.to_tensor(gb))):
        for eps in (1e-6, 1e-5):
            got = F.rms_norm(xt, w, eps)
            want = paddle.nn.functional.rms_norm(jx, jw, eps).numpy()
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_functional_gate():
    """The kernel route when the weight is [D] in x's dtype, else the
    composite: bf16 x with an fp32 weight rounds x * rstd to bf16 first
    and returns fp32, as the JAX composite does."""
    x, gamma, _ = _inputs(4, 5, 64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb, gf = torch.from_numpy(gamma).to(torch.bfloat16), \
        torch.from_numpy(gamma)
    kernel = F.rms_norm(xb, gb)
    assert kernel.dtype == torch.bfloat16
    assert torch.equal(kernel, ln.rms_norm(xb, gb, 1e-6))
    mixed = F.rms_norm(xb, gf)
    assert mixed.dtype == torch.float32
    rounded = F.rms_norm(xb, None)
    assert torch.equal(mixed, rounded.float() * gf)
    jmixed = paddle.nn.functional.rms_norm(
        paddle.to_tensor(jnp.asarray(x, jnp.bfloat16)),
        paddle.to_tensor(gamma)).numpy()
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed,
                                                         np.float32),
                               **TOLERANCES["layer_norm_bf16"])


def test_layer_module_state_names():
    """nn.RMSNorm: one trainable weight of ones, named as JAX's layer
    names it, and its forward is F.rms_norm with its epsilon."""
    m = RMSNorm(32, epsilon=1e-5, dtype=torch.float32, device="cpu")
    jm = paddle.nn.RMSNorm(32, 1e-5)
    assert [n for n, _ in m.named_parameters()] == list(jm.state_dict())
    assert torch.equal(m.weight, torch.ones(32)) and m.weight.requires_grad
    x = torch.from_numpy(_inputs(5, 5, 32)[0]).reshape(5, 1, 32)
    np.testing.assert_allclose(
        m(x).detach().numpy(), jm(paddle.to_tensor(x.numpy())).numpy(),
        **TOL)


@pytest.mark.parametrize("bad", ["shape", "dtype", "rows", "wide",
                                 "device"])
def test_rejects_what_the_kernels_do_not_take(bad):
    x, gamma, _ = map(torch.from_numpy, _inputs(0, 4, 16))
    if bad == "shape":
        gamma = gamma[:8]
    elif bad == "dtype":
        gamma = gamma.double()
    elif bad == "rows":
        x = x[:0]
    elif bad == "wide":
        x = torch.zeros((2, ln.MAX_D + 1))
        gamma = torch.ones(ln.MAX_D + 1)
    else:
        gamma = gamma.to("meta")
    with pytest.raises(ValueError):
        ln.rms_norm_fwd(x, gamma)


@pytest.mark.parametrize("bad", ["rstd_shape", "rstd_dtype", "dy_shape",
                                 "device"])
def test_backward_rejects_bad_statistics(bad):
    x, gamma, dy = map(torch.from_numpy, _inputs(6, 4, 16))
    rstd = torch.ones((4, 1))
    if bad == "rstd_shape":
        rstd = rstd[:, 0]
    elif bad == "rstd_dtype":
        rstd = rstd.double()
    elif bad == "dy_shape":
        dy = dy[:3]
    else:
        rstd = rstd.to("meta")
    with pytest.raises(ValueError):
        ln.rms_norm_bwd(x, gamma, rstd, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [97, 4096])
def test_kernels_match_plain_on_card(dtype, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    _, tdt, tname = DTYPES[dtype]
    tol = TOLERANCES[tname]
    x, gamma, dy = (torch.from_numpy(a).cuda().to(tdt)
                    for a in _inputs(5, 1001, d))
    got = ln.rms_norm_fwd(x, gamma, 1e-5)
    want = ln.rms_norm_fwd_reference(x, gamma, 1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)
    got = ln.rms_norm_bwd(x, gamma, got[1], dy)
    want = ln.rms_norm_bwd_reference(x, gamma, want[1], dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)
