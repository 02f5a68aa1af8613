"""The port's LayerNorm against the JAX package's Pallas LayerNorm.

``paddle_tpu.ops.pallas.layer_norm.layer_norm`` (interpret mode off-TPU,
as tests/test_pallas_kernels.py runs it; rows padded to 8 inside) and
``jax.grad`` through it, against ``paddle_tpu_torch.ops.layer_norm.
layer_norm`` and autograd through it (on CPU tensors the kernels' plain
versions): the same numpy x, gamma, beta and upstream gradient, fp32,
row counts 8, 37 (not a multiple of 8) and 256, D 64 and 768; y, dx,
dgamma and dbeta held to TOLERANCES["layer_norm_fp32"]. The forward's
mean and rstd are held to numpy's. ``nn.functional.layer_norm`` takes
the kernel path only when its gate holds, else the composite, which is
held to the JAX package's composite. The CUDA kernels are held to the
plain versions on the card (the ``cuda`` test here, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import layer_norm as jax_ln
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import layer_norm as ln

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["layer_norm_fp32"]


def _inputs(seed, n, d):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return x, gamma, beta, dy


@pytest.mark.parametrize("n,d", [(8, 64), (37, 64), (256, 768), (37, 768)])
def test_matches_jax_kernel(n, d):
    x, gamma, beta, dy = _inputs(n + d, n, d)

    def loss(x, g, b):
        return jnp.sum(jax_ln.layer_norm(x, g, b, 1e-5) * jnp.asarray(dy))
    want_y = np.asarray(jax_ln.layer_norm(*map(jnp.asarray,
                                               (x, gamma, beta)), 1e-5))
    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (x, gamma, beta)))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    y = ln.layer_norm(xt, gt, bt, 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    (y * torch.from_numpy(dy)).sum().backward()
    for name, t, w in zip(("dx", "dgamma", "dbeta"), (xt, gt, bt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


def test_statistics_match_numpy():
    x, gamma, beta, _ = _inputs(1, 37, 96)
    before = dict(ln.LAUNCHES)
    y, mean, rstd = ln.layer_norm_fwd(*map(torch.from_numpy,
                                           (x, gamma, beta)))
    assert ln.LAUNCHES == before       # the plain version launches nothing
    x64 = x.astype(np.float64)
    m = x64.mean(1, keepdims=True)
    r = 1 / np.sqrt(((x64 - m) ** 2).mean(1, keepdims=True) + 1e-5)
    assert mean.shape == rstd.shape == (37, 1)
    assert mean.dtype == rstd.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), m, **TOL)
    np.testing.assert_allclose(rstd.numpy(), r, **TOL)
    np.testing.assert_allclose(y.numpy(), (x64 - m) * r * gamma + beta,
                               **TOL)


def test_functional_gate_and_composite():
    """The kernel path when the gate holds; the composite (mixed dtypes,
    no bias, two normalised dims) matches the JAX package's composite."""
    x, gamma, beta, _ = _inputs(2, 6, 32)
    xt, gt, bt = map(torch.from_numpy, (x, gamma, beta))
    assert F.norm._kernel_ok(xt, (32,), gt, bt)
    assert not F.norm._kernel_ok(xt, (32,), gt.double(), bt)
    assert not F.norm._kernel_ok(xt, (32,), gt, None)
    np.testing.assert_allclose(F.layer_norm(xt, 32, gt, bt).numpy(),
                               ln.layer_norm(xt, gt, bt).numpy(), **TOL)
    jx = paddle.to_tensor(x)
    for shape, w in (((32,), None), ((6, 32), None)):
        want = paddle.nn.functional.layer_norm(jx, list(shape)).numpy()
        got = F.layer_norm(xt, shape, w).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    want = paddle.nn.functional.layer_norm(
        jx, [32], paddle.to_tensor(gamma)).numpy()
    np.testing.assert_allclose(F.layer_norm(xt, 32, gt).numpy(), want, **TOL)


def test_layer_module():
    m = LayerNorm(32, dtype=torch.float32, device="cpu")
    assert torch.equal(m.weight, torch.ones(32))
    assert torch.equal(m.bias, torch.zeros(32))
    assert m.weight.requires_grad and m.bias.requires_grad
    x = torch.from_numpy(_inputs(3, 5, 32)[0]).reshape(5, 1, 32)
    np.testing.assert_allclose(
        m(x).detach().numpy(),
        torch.nn.functional.layer_norm(x, (32,)).numpy(), **TOL)


@pytest.mark.parametrize("bad", ["shape", "dtype", "rows"])
def test_rejects_what_the_kernels_do_not_take(bad):
    x, gamma, beta, _ = map(torch.from_numpy, _inputs(0, 4, 16))
    if bad == "shape":
        gamma = gamma[:8]
    elif bad == "dtype":
        beta = beta.double()
    else:
        x = x[:0]
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x, gamma, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    tol = TOLERANCES["layer_norm_" + ("fp32" if dtype == "float32"
                                      else "bf16")]
    x, gamma, beta, dy = (torch.from_numpy(a).cuda().to(tdt)
                          for a in _inputs(5, 1001, 768))
    got = ln.layer_norm_fwd(x, gamma, beta)
    want = ln.layer_norm_fwd_reference(x, gamma, beta)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)
    got = ln.layer_norm_bwd(x, gamma, got[1], got[2], dy)
    want = ln.layer_norm_bwd_reference(x, gamma, want[1], want[2], dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)
