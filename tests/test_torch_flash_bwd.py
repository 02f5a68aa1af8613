"""The port's flash attention backward (and forward dropout) against the
JAX package's.

Gradients: JAX ``jax.grad`` through ``paddle_tpu.ops.pallas.
flash_attention.flash_attention`` (Pallas in interpret mode off-TPU, as
tests/test_pallas_kernels.py runs it: its fused one-tile backward, and
with 32-wide tiles forced its split dKV/dQ pair) against the port's
autograd through ``flash_attention``, whose backward on CPU tensors is
``flash_attention_bwd_reference``; the same numpy q, k, v and upstream
gradient, fp32, dropout 0, D = 32; causal and not, Sq = Sk, Sq < Sk and
Sq > Sk, GQA (H=4, Hk=2); held to TOLERANCES["attention_grad_fp32"].

Dropout: JAX's mask comes from the TPU's PRNG (or jax.random in
interpret mode) and cannot equal the port's hash, so it is not compared.
Instead the port's backward at dropout_p > 0 is held to autograd through
its plain forward with the keep mask materialised (the same seed), and
the keep rate to a binomial bound. The CUDA kernels are held to the
plain versions on the card (the ``cuda`` test here, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

H, D = 4, 32


def _inputs(seed, b, sq, sk, hk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, D)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, D)).astype(np.float32)
    g = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    return q, k, v, g


def _port_grads(q, k, v, g, causal, dropout_p=0.0, seed=0):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal, dropout_p=dropout_p,
                           dropout_seed=seed)
    (o * torch.from_numpy(g)).sum().backward()
    return o.detach(), [x.grad.numpy() for x in (qt, kt, vt)]


CASES = [  # (b, sq, sk, hk, causal)
    (2, 40, 40, 4, False),
    (1, 40, 40, 2, True),       # GQA
    (1, 24, 70, 4, True),       # sq < sk: bottom-right alignment
    (1, 37, 61, 2, False),
    (1, 50, 20, 2, True),       # sq > sk: 30 rows see no key
]


@pytest.mark.parametrize(
    "split,b,sq,sk,hk,causal",
    [(False, *c) for c in CASES] + [(True, *c) for c in CASES[1:3]],
    ids=[f"fused-{i}" for i in range(len(CASES))] + ["split-1", "split-2"])
def test_grads_match_jax(monkeypatch, split, b, sq, sk, hk, causal):
    if split:   # 32-wide tiles: JAX's split dKV / dQ kernels
        monkeypatch.setenv("PADDLE_TPU_FLASH_BQ", "32")
        monkeypatch.setenv("PADDLE_TPU_FLASH_BK", "32")
    q, k, v, g = _inputs(sq * 3 + sk + hk, b, sq, sk, hk)

    def loss(q, k, v):
        return jnp.sum(jax_fa.flash_attention(q, k, v, causal=causal)
                       * jnp.asarray(g))
    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = _port_grads(q, k, v, g, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, np.asarray(w), err_msg=name,
                                   **TOLERANCES["attention_grad_fp32"])
    if causal and sq > sk:      # rows that see no key: zero, not NaN
        assert np.all(got[0][:, :sq - sk] == 0) and np.isfinite(got[0]).all()


@pytest.mark.parametrize("b,sq,sk,hk,causal", CASES[1:4])
def test_dropout_grads_match_autograd_of_the_plain_forward(b, sq, sk, hk,
                                                           causal):
    """The backward regenerates the forward's mask from the seed: its
    gradients equal autograd through the plain forward, which
    materialises the mask (dropout_keep) for the same seed."""
    q, k, v, g = _inputs(7 + sq, b, sq, sk, hk)
    seed = 0x1234_5678_9ABC
    o, got = _port_grads(q, k, v, g, causal, 0.25, seed)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (q, k, v))
    o_ref, _ = fa.flash_attention_reference(qt, kt, vt, causal, None, 0.25,
                                            seed)
    (o_ref.transpose(1, 2) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(o.numpy(), o_ref.detach().transpose(1, 2)
                               .numpy(), **TOLERANCES["attention_fp32"])
    for name, a, x in zip(("dq", "dk", "dv"), got, (qt, kt, vt)):
        np.testing.assert_allclose(a, x.grad.transpose(1, 2).numpy(),
                                   err_msg=name,
                                   **TOLERANCES["attention_grad_fp32"])
    # and the dropout changed the result
    o0, _ = _port_grads(q, k, v, g, causal)
    assert not torch.allclose(o, o0, atol=1e-3)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_binomial_bound(p):
    """Over n = 2 * 12 * 256 * 256 draws the kept share is within five
    standard deviations of 1 - p; the two halves of a 64-bit seed both
    matter; one seed gives one mask."""
    n_shape = (2, 12, 256, 256)
    keep = fa.dropout_keep(987654321, *n_shape, p)
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - p)) \
        <= 5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(keep, fa.dropout_keep(987654321, *n_shape, p))
    other = fa.dropout_keep(987654321 + (1 << 32), *n_shape, p)
    assert not torch.equal(keep, other)
    # about p(1-p) * 2 of the draws differ between independent masks
    assert abs((keep != other).float().mean().item() - 2 * p * (1 - p)) \
        < 0.01


def test_sdpa_routes_to_flash_and_draws_its_seed():
    """F.scaled_dot_product_attention without a mask takes
    flash_attention with a seed drawn from the caller's generator; with
    a mask it takes the composite, which agrees at dropout 0."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 16, 16, 4))
    gens = [torch.Generator().manual_seed(5) for _ in range(3)]
    a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                       is_causal=True, generator=gens[0])
    b = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                       is_causal=True, generator=gens[1])
    assert torch.equal(a, b)
    seed = F.draw_seed(gens[2])
    want = fa.flash_attention(q, k, v, causal=True, dropout_p=0.2,
                              dropout_seed=seed)
    assert torch.equal(a, want)
    mask = torch.ones((16, 16), dtype=torch.bool).tril()
    np.testing.assert_allclose(
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask).numpy(),
        F.scaled_dot_product_attention(q, k, v, is_causal=True).numpy(),
        **TOLERANCES["attention_fp32"])
    ev = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert torch.equal(ev, fa.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("bad", ["dropout", "seed", "lse"])
def test_rejects_what_the_kernels_do_not_take(bad):
    q, k, v, g = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  for x in _inputs(0, 1, 8, 8, 4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        if bad == "dropout":
            fa.flash_attention_fwd(q, k, v, dropout_p=1.0)
        elif bad == "seed":
            fa.flash_attention_bwd(q, k, v, o, lse, g, seed=-1)
        else:
            fa.flash_attention_bwd(q, k, v, o, lse[..., 0], g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    tag = "fp32" if dtype == "float32" else "bf16"
    q, k, v, g = (torch.from_numpy(x).cuda().to(tdt).transpose(1, 2)
                  .contiguous() for x in _inputs(9, 2, 37, 70, 2))
    assert torch.equal(fa.dropout_keep(11, 2, H, 37, 70, 0.1, "cuda").cpu(),
                       fa.dropout_keep(11, 2, H, 37, 70, 0.1))
    for causal in (False, True):
        for p in (0.0, 0.1):
            o, lse = fa.flash_attention_fwd(q, k, v, causal, None, p, 11)
            got = fa.flash_attention_bwd(q, k, v, o, lse, g, causal, None,
                                         p, 11)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, g,
                                                    causal, None, p, 11)
            for a, w in zip(got, want):
                torch.testing.assert_close(
                    a.float(), w.float(),
                    **TOLERANCES["attention_grad_" + tag])
