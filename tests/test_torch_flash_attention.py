"""The port's flash attention forward against the JAX package's.

The plain PyTorch version (what ``flash_attention`` computes on CPU
tensors) is held to ``paddle_tpu.ops.pallas.flash_attention.
flash_attention`` (Pallas in interpret mode off-TPU, as
tests/test_pallas_kernels.py runs it) on the same numpy inputs, fp32,
atol = rtol = 1e-5 (TOLERANCES["attention_fp32"]): causal and not,
sq == sk and sq < sk (bottom-right alignment), GQA groups 1 and 2, a
ragged length, D = 64. ``lse`` is held to a numpy log-sum-exp of the
masked scaled scores. The CUDA kernel is compared with the plain version
on the card (the ``cuda`` test here, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import flash_attention as fa

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

H, D = 4, 64


def _inputs(seed, b, sq, sk, group):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((b, sk, H // group, D)).astype(np.float32)
    v = rng.standard_normal((b, sk, H // group, D)).astype(np.float32)
    return q, k, v


def _numpy_lse(q, k, causal):
    """log-sum-exp over the attended keys of the scaled scores, [B, H, Sq];
    -1e30 for a row that attends nothing."""
    g = q.shape[2] // k.shape[2]
    kk = np.repeat(k, g, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * D ** -0.5
    sq, sk = q.shape[1], k.shape[1]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask = np.arange(sk)[None, :] <= np.arange(sq)[:, None] + sk - sq
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        out = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    return np.where(mask.any(-1), out, -1e30)


CASES = [  # (b, sq, sk, group, causal)
    (2, 64, 64, 1, False),
    (1, 64, 64, 2, True),
    (1, 37, 37, 1, True),       # ragged S
    (1, 37, 37, 2, False),
    (1, 24, 70, 1, True),       # sq < sk: bottom-right alignment
    (2, 8, 37, 2, True),
]


@pytest.mark.parametrize("b,sq,sk,group,causal", CASES)
def test_reference_matches_jax(b, sq, sk, group, causal):
    q, k, v = _inputs(sq * 7 + sk + group, b, sq, sk, group)
    want = np.asarray(jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    before = fa.LAUNCHES["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
    assert fa.LAUNCHES["flash_attention_fwd"] == before
    assert torch.equal(o.transpose(1, 2), got)
    assert lse.shape == (b, H, sq, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse[..., 0].numpy(), _numpy_lse(q, k, causal),
                               **TOLERANCES["attention_fp32"])


def test_row_that_attends_nothing():
    # causal with sq > sk: the first sq - sk rows see no key
    q, k, v = _inputs(3, 1, 12, 5, 1)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    o, lse = fa.flash_attention_fwd(qt, kt, vt, causal=True)
    assert not o[:, :, :7].any() and o[:, :, 7:].abs().sum() > 0
    assert torch.all(lse[:, :, :7] == -1e30)
    np.testing.assert_allclose(lse[..., 0].numpy(), _numpy_lse(q, k, True),
                               **TOLERANCES["attention_fp32"])


def test_dropout_raises():
    # dropout_p in (0, 1) runs (tests/test_torch_flash_bwd.py); a rate
    # that keeps nothing, or none at all, is refused
    q, k, v = map(torch.from_numpy, _inputs(0, 1, 8, 8, 1))
    assert fa.flash_attention(q, k, v, dropout_p=0.1,
                              dropout_seed=3).shape == q.shape
    for p in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout_p"):
            fa.flash_attention(q, k, v, dropout_p=p)


@pytest.mark.parametrize("bad", ["heads", "dtype", "head_dim"])
def test_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(x).transpose(1, 2).contiguous()
               for x in _inputs(0, 1, 8, 8, 1))
    if bad == "heads":
        k, v = k[:, :3], v[:, :3]
    elif bad == "dtype":
        k = k.double()
    else:
        q, k, v = (torch.zeros(1, H, 8, 320) for _ in range(3))
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v)


def test_is_supported():
    assert fa.is_supported((1, 1000, 12, 64), torch.bfloat16)
    assert fa.is_supported((2, 37, 4, 256), torch.float32)
    assert not fa.is_supported((2, 37, 4, 320), torch.float32)
    assert not fa.is_supported((37, 4, 64), torch.float32)
    assert not fa.is_supported((2, 37, 4, 64), torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_reference_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).cuda().to(tdt).transpose(1, 2)
               .contiguous() for x in _inputs(9, 2, 37, 70, 2))
    tol = TOLERANCES["attention_fp32" if dtype == "float32"
                     else "attention_bf16"]
    for causal in (False, True):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
        torch.testing.assert_close(o.float(), o_ref.float(), **tol)
        torch.testing.assert_close(lse, lse_ref, **tol)
