"""The port's ring attention chunk step against the JAX package's.

``paddle_tpu.ops.pallas.ring_chunk_attention.ring_chunk_attention``
(Pallas in interpret mode off-TPU, as tests/test_pallas_kernels.py runs
it) against the port's ``ring_chunk_attention``, whose wrappers compute
their plain versions on CPU tensors: the same numpy q [1, 4, Sq, 32] and
k, v [1, 2, 64, 32] (GQA), fp32, at diagonal offsets 64 (full), 0, -17
(shifted), -64 and -70 (every row masked), and Sq = 40 at offset 30.
The forward's o and lse are held to TOLERANCES["attention_fp32"]; dq, dk
and dv to ["attention_grad_fp32"], through the JAX test's loss on o and a
bounded function of lse (so dlse != 0) and through a vjp with random
cotangents for both outputs, which also drives the plain backward
directly. A fully masked chunk gives o = 0, lse = -1e30 and zero
gradients exactly, with no NaN. The CUDA kernels are held to the plain
versions on the card (chip_smoke.py phase 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import ring_chunk_attention as jax_rc
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import ring_chunk_attention as rc

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, HK, SK, D = 1, 4, 2, 64, 32
# (Sq, offset): full, the diagonal, a shifted one, fully masked twice,
# and Sq != Sk
CASES = [(64, 64), (64, 0), (64, -17), (64, -64), (64, -70), (40, 30)]


def _inputs(sq, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    k = rng.standard_normal((B, HK, SK, D)).astype(np.float32)
    v = rng.standard_normal((B, HK, SK, D)).astype(np.float32)
    g = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    glse = rng.standard_normal((B, H, sq)).astype(np.float32)
    return q, k, v, g, glse


def _masked(sq, off):
    return off <= -sq


@pytest.mark.parametrize("sq,off", CASES)
def test_forward_matches_jax(sq, off):
    q, k, v, _, _ = _inputs(sq, 0)
    o_j, lse_j = jax_rc.ring_chunk_attention(*map(jnp.asarray, (q, k, v)),
                                             off)
    o, lse = rc.ring_chunk_attention(*map(torch.from_numpy, (q, k, v)), off)
    assert o.shape == (B, H, sq, D) and lse.shape == (B, H, sq)
    assert lse.dtype == torch.float32
    tol = TOLERANCES["attention_fp32"]
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **tol)
    if _masked(sq, off):
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.equal(lse, torch.full_like(lse, -1e30))


@pytest.mark.parametrize("sq,off", CASES)
def test_grads_through_o_and_lse_match_jax(sq, off):
    """JAX's test_ring_chunk_attention_vs_composite loss: o weighted by
    sigmoid(clip(lse)), so the lse cotangent is not zero."""
    q, k, v, g, _ = _inputs(sq, 1)

    def jax_loss(q, k, v):
        o, lse = jax_rc.ring_chunk_attention(q, k, v, off)
        w = jax.nn.sigmoid(jnp.clip(lse, -30.0, 30.0))[..., None]
        return jnp.sum(o * w * jnp.asarray(g))
    want = jax.grad(jax_loss, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = rc.ring_chunk_attention(qt, kt, vt, off)
    w = torch.sigmoid(lse.clamp(-30.0, 30.0))[..., None]
    (o * w * torch.from_numpy(g)).sum().backward()
    for name, got, w_ in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w_),
                                   err_msg=name,
                                   **TOLERANCES["attention_grad_fp32"])


@pytest.mark.parametrize("sq,off", CASES)
def test_plain_backward_matches_jax_vjp(sq, off):
    """Random cotangents for o and lse (dlse != 0 on every row, masked
    ones included): the plain backward and the backward wrappers on CPU
    tensors against JAX's vjp."""
    q, k, v, g, glse = _inputs(sq, 2)
    (o_j, lse_j), vjp = jax.vjp(
        lambda q, k, v: jax_rc.ring_chunk_attention(q, k, v, off),
        *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(g), jnp.asarray(glse)))
    qt, kt, vt, gt, glt = map(torch.from_numpy, (q, k, v, g, glse))
    o, lse = rc.ring_chunk_attention_reference(qt, kt, vt, off)
    got = rc.ring_chunk_attention_bwd_reference(qt, kt, vt, o, lse, gt, glt,
                                                off)
    delta = (gt * o).sum(-1) - glt
    wrapped = (rc.ring_chunk_attention_bwd_dq(qt, kt, vt, gt, lse, delta,
                                              off),
               *rc.ring_chunk_attention_bwd_dkv(qt, kt, vt, gt, lse, delta,
                                                off))
    for name, a, b, w in zip(("dq", "dk", "dv"), got, wrapped, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOLERANCES["attention_grad_fp32"])
        assert torch.equal(a, b), name
        if _masked(sq, off):
            assert torch.equal(a, torch.zeros_like(a)), name


def test_support_and_refusals():
    for qs, ks, dt in (((1, 4, 64, 32), (1, 2, 64, 32), torch.float32),
                       ((1, 4, 64, 256), (1, 4, 64, 256), torch.bfloat16),
                       ((1, 4, 64, 288), (1, 4, 64, 288), torch.float16),
                       ((1, 4, 64, 32), (1, 3, 64, 32), torch.float32)):
        jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
               torch.float16: jnp.float16}[dt]
        assert rc.is_supported(qs, ks, dt) == jax_rc.is_supported(qs, ks,
                                                                   jdt)
    assert not rc.is_supported((1, 4, 64, 32), (1, 4, 64, 32), torch.int8)
    q = torch.zeros((1, 4, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    for args in ((q, torch.zeros((1, 3, 8, 32)), torch.zeros((1, 3, 8, 32))),
                 (q, kv.bfloat16(), kv.bfloat16()),
                 (q, kv.to("meta"), kv.to("meta")),
                 (torch.zeros((1, 4, 8, 288)), torch.zeros((1, 2, 8, 288)),
                  torch.zeros((1, 2, 8, 288))),
                 (q, kv, torch.zeros((1, 2, 9, 32)))):
        with pytest.raises(ValueError):
            rc.ring_chunk_attention(*args, 0)
        with pytest.raises(ValueError):
            rc.ring_chunk_attention_fwd(*args, 0)
