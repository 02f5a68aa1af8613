"""The rounding-aware bound that holds the flash and ring chunk kernels to
their plain versions at the training shapes (``rounding_terms``,
``rounding_bound``, ``ring_chunk_rounding_terms``) and the witness
search of ``tools/check_flash_rounding.py``, on the CPU's plain versions.

The bound admits what two roundings of the same fp32 operands to
neighbouring bf16 values can do, and still refuses a kernel that skips a
64-row tile of queries or keys.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.device import TOLERANCES
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ring_chunk_attention as rca
from paddle_tpu_torch.tools import check_flash_rounding as cfr

torch.set_num_threads(1)


def _inputs(seed, b, h, hk, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, sq, d))).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hk, sk, d))).to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("hk,sq,sk,causal,p", [
    (2, 5, 7, True, 0.0), (1, 7, 5, False, 0.0), (2, 6, 6, True, 0.5),
    (1, 4, 9, False, 0.3)])
def test_rounding_terms_equal_their_definition(hk, sq, sk, causal, p):
    """Each output's terms, summed element by element in fp64: o_i over
    |p m|_ij |v_j|, dv_j over |p m|_ij |dO_i|, dk_j over |ds_ij| |q_i|,
    dq_i over |ds_ij| |k_j| (dk, dv over the GQA group)."""
    b, h, d, seed = 1, 2, 4, 11
    q, k, v, do = _inputs(3, b, h, hk, sq, sk, d, torch.float32)
    o, lse = fa.flash_attention_reference(q, k, v, causal, None, p, seed)
    got = fa.rounding_terms(q, k, v, o, lse, do, causal, None, p, seed)
    keep = (fa.dropout_keep(seed, b, h, sq, sk, p).double() / (1 - p)
            if p > 0 else torch.ones(b, h, sq, sk, dtype=torch.float64))
    Q, K, V, dO, O = (x.double() for x in (q, k, v, do, o))
    g, scale = h // hk, d ** -0.5
    want = [torch.zeros(b, h, sq, d, dtype=torch.float64),
            torch.zeros(b, h, sq, d, dtype=torch.float64),
            torch.zeros(b, hk, sk, d, dtype=torch.float64),
            torch.zeros(b, hk, sk, d, dtype=torch.float64)]
    off = sk - sq if causal else sk
    for hh in range(h):
        kh = hh // g
        delta = (dO[0, hh] * O[0, hh]).sum(-1)
        for i in range(sq):
            for j in range(sk):
                if j > i + off:
                    continue
                pij = torch.exp(Q[0, hh, i] @ K[0, kh, j] * scale
                                - lse[0, hh, i, 0].double())
                pm = pij * keep[0, hh, i, j]
                ds = abs(pij * ((dO[0, hh, i] @ V[0, kh, j])
                                * keep[0, hh, i, j] - delta[i]) * scale)
                want[0][0, hh, i] += pm * V[0, kh, j].abs()
                want[1][0, hh, i] += ds * K[0, kh, j].abs()
                want[2][0, kh, j] += ds * Q[0, hh, i].abs()
                want[3][0, kh, j] += pm * dO[0, hh, i].abs()
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.double(), w, atol=1e-5, rtol=1e-5,
                                   msg=name)


def test_ring_terms_are_the_flash_terms_at_the_offset():
    """The chunk step's terms at offset Sk - Sq and dlse = 0 are causal
    flash's; a dlse enters through delta and moves only dq and dk."""
    q, k, v, do = _inputs(5, 1, 2, 2, 6, 9, 4, torch.float32)
    o, lse = fa.flash_attention_reference(q, k, v, True)
    want = fa.rounding_terms(q, k, v, o, lse, do, True)
    zero = torch.zeros(1, 2, 6)
    got = rca.ring_chunk_rounding_terms(q, k, v, o, lse[..., 0], do, zero, 3)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=0, rtol=0)
    moved = rca.ring_chunk_rounding_terms(q, k, v, o, lse[..., 0], do,
                                          zero + 0.5, 3)
    assert torch.equal(moved[0], want[0]) and torch.equal(moved[3], want[3])
    assert not torch.equal(moved[1], want[1])


def _truncate(x):
    """fp32 to bf16 toward zero: one bf16 unit or none from nearest."""
    return (x.view(torch.int32) & -65536).view(torch.float32).to(
        torch.bfloat16).float()


def _truncating_kernel(causal, p):
    """A "kernel" that rounds every p m and ds toward zero where the plain
    version rounds to nearest (each operand the same or one bf16 unit
    away), at [1, 2, 128, 64] bf16: (its o, dq, dk, dv; the plain
    versions'; their terms)."""
    seed = 7
    q, k, v, do = _inputs(1, 1, 2, 2, 128, 128, 64, torch.bfloat16)
    o, lse = fa.flash_attention_reference(q, k, v, causal, None, p, seed)
    want = (o, *fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                                 None, p, seed))
    terms = fa.rounding_terms(q, k, v, o, lse, do, causal, None, p, seed)
    pd, ds = cfr.plain_operands(q, k, v, o, lse, do, causal, p, seed)
    s, mask = fa._scores(q, k, fa._diagonal(causal, 128, 128), 64 ** -0.5)
    s = torch.where(mask, s, torch.full_like(s, fa.NEG_INF))
    pt = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                     torch.zeros_like(s))
    dm = fa._keep_scale(q, k, p, seed)
    keep = 1.0 if dm is None else dm
    got = (torch.einsum("bhqk,bhkd->bhqd", _truncate(pt * keep), v.float())
           / pt.sum(-1, keepdim=True),
           torch.einsum("bhqk,bhkd->bhqd", _truncate(ds), k.float()),
           torch.einsum("bhqk,bhqd->bhkd", _truncate(ds), q.float()),
           torch.einsum("bhqk,bhqd->bhkd", _truncate(pd), do.float()))
    return tuple(g.to(torch.bfloat16) for g in got), want, terms


def _tol(name):
    return TOLERANCES["attention_bf16" if name == "o"
                      else "attention_grad_bf16"]


@pytest.mark.parametrize("causal,p", [(True, 0.0), (False, 0.1)])
def test_one_unit_per_operand_stays_within_the_bound(causal, p):
    """The truncating kernel stays within rounding_bound in o, dq, dk and
    dv."""
    got, want, terms = _truncating_kernel(causal, p)
    for name, g, w, t in zip(("o", "dq", "dk", "dv"), got, want, terms):
        diff = (g.float() - w.float()).abs()
        assert diff.max() > 0, name
        assert (diff <= fa.rounding_bound(w, t, **_tol(name))).all(), name


def test_the_rms_only_bound_refuses_one_unit_flips():
    """The bound without the terms (atol times the rms, rtol times the
    element, the card check's before it took the terms) refuses the
    truncating kernel's causal dv, where the p m near the diagonal are
    large: a bf16 unit of one of them times its |dO| passes it."""
    got, want, _ = _truncating_kernel(True, 0.0)
    w = want[3].float()
    tol = _tol("dv")
    rms = w.pow(2).mean().sqrt()
    diff = (got[3].float() - w).abs()
    assert (diff > tol["atol"] * rms + tol["rtol"] * w.abs()).any()


@pytest.mark.parametrize("causal,p", [(True, 0.0), (False, 0.1)])
def test_a_skipped_tile_is_refused(causal, p):
    """Taking any one 64-row tile of queries (dk, dv) or keys (o, dq) out
    of the plain output breaks rounding_bound somewhere."""
    seed = 3
    q, k, v, do = _inputs(2, 1, 2, 2, 256, 256, 64, torch.bfloat16)
    o, lse = fa.flash_attention_reference(q, k, v, causal, None, p, seed)
    outs = (o, *fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                                 None, p, seed))
    terms = fa.rounding_terms(q, k, v, o, lse, do, causal, None, p, seed)
    ops = cfr.plain_operands(q, k, v, o, lse, do, causal, p, seed)
    missed = cfr.tile_drops(q, k, v, do, outs, terms, *ops)
    assert missed == {name: [] for name in cfr.OUTPUTS}


def test_witness_finds_a_planted_flip():
    """A row whose kernel rounded one operand just past a midpoint the
    other way: the witness names that operand and lands on every element
    of the kernel's row."""
    rng = np.random.default_rng(9)
    a32 = torch.from_numpy(rng.random(64) * 0.3).float()
    a32[7] = 0.5 + 2.0 ** -9 + 2.0 ** -22   # just past the midpoint: up
    rows = torch.from_numpy(rng.standard_normal((64, 32))).float()
    plain = (a32.to(torch.bfloat16).double()[:, None] * rows.double()).sum(0)
    flipped = a32.to(torch.bfloat16).double()
    flipped[7] = 0.5
    kernel = (flipped[:, None] * rows.double()).sum(0)
    wit = cfr.witness(a32, rows, kernel.to(torch.bfloat16).float(),
                      plain.to(torch.bfloat16).float(), 1.0)
    assert [f["index"] for f in wit["flipped"]] == [7]
    assert wit["flipped"][0]["flipped_to"] == 0.5
    assert wit["row_equal_after"] == wit["row_len"] == 32
    assert wit["row_gap_rms_after"] == 0.0 < wit["row_gap_rms_before"]
