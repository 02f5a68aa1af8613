"""The int8 flat stream on the split-KV design and the int4 dequant-matmul
on the tensor cores, on the CPU: the plain versions of the two kernels'
arithmetic against the JAX package, and the rules that pick their
designs and ranges. chip_smoke.py holds the kernels to the plain versions
on the card.

- ``decode_attention_paged_flat_i8_split_reference``, the plain
  split-and-merge arithmetic of the flat mode of split_decode.cuh's int8
  flavor, against JAX's ``decode_attention_paged_flat_i8`` in interpret
  mode, fp32, TOLERANCES["attention_fp32"], for S = 1, 2, 3 and 5, Bt 16
  at GQA group 2 and Bt 64 at group 1: a pad chunk, rows past a chunk's count, a
  chunk at base 0, one ending on a block edge and a sentinel inside a
  slot's table; rows that attend nothing exactly 0; in bf16 and fp16
  against the port's plain version at TOLERANCES["attention_bf16"] /
  ["attention_fp16"] (only where p is rounded differs), S = 5.
- ``fused_dequant_matmul_split_reference``, the plain split-K arithmetic
  (K in S ranges of whole 32-row steps summed in split order, then the
  scale), against JAX's ``fused_dequant_matmul`` in interpret mode, fp32,
  TOLERANCES["matmul_fp32"], for M 1, 8 and 17, both orientations, K/2
  not a multiple of 32 and O not a multiple of 8; ``out_dtype`` keyword
  only, as in JAX, and any of fp32, bf16 and fp16 from a bf16 activation.
- ``dequant_path`` and ``dequant_splits``: the tensor-core design for
  bf16 / fp16 at aligned rows, the ranges covering every step exactly
  once, S = 1 where the output tiles fill the card; the flat stream's
  design and ranges (``paged_path``, ``decode_splits`` over T / 8
  chunks).
- CPU tensors count no launch and no path.
"""
import copy
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged_flat_i8 as jax_flat_i8
from paddle_tpu.ops.pallas.fused_dequant_matmul import \
    fused_dequant_matmul as jax_fdm
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference.generation import _absmax_int4, _pack_int4
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import fused_dequant_matmul as fdm

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

H, D, L, LAYER, N_POS = 4, 16, 2, 1, 192
# (slot, base, count) per chunk: one at base 0, one past its count, one
# ending on a block edge (64), a pad chunk, one over slot 2's unmapped
# entry (position 70), short and full chunks deep in their slots
CHUNKS = [(0, 0, 8), (0, 8, 5), (1, 56, 8), (2, 0, 0), (2, 70, 3),
          (1, 130, 2), (0, 180, 8)]


def _flat_inputs(bt, group):
    rng = np.random.default_rng(bt + group)
    hk = H // group
    nslots, nblk = 3, N_POS // bt
    top = [0] * nslots
    for s, base, n in CHUNKS:
        top[s] = max(top[s], base + max(n, 1))
    nb = nslots * nblk + 1
    perm = rng.permutation(nb)
    tables = np.full((nslots, nblk), nb, np.int32)
    k = 0
    for s in range(nslots):
        need = min(-(-top[s] // bt), nblk)
        tables[s, :need] = perm[k:k + need]
        k += need
    tables[2, 70 // bt] = nb          # read through the NB - 1 clamp
    q = rng.standard_normal((8 * len(CHUNKS), H, D)).astype(np.float32)
    pool = rng.integers(-127, 128, (L, 2, nb, hk, bt, D)).astype(np.int8)
    sc = rng.uniform(0.002, 0.05, (L, 2, nb, hk, 1, bt)).astype(np.float32)
    cslot, cbase, cn = (np.array(col, np.int32) for col in zip(*CHUNKS))
    return q, pool, sc, tables, cslot, cbase, cn


@functools.lru_cache(maxsize=None)
def _jax_flat(bt, group):
    return np.asarray(jax_flat_i8(*map(jnp.asarray, _flat_inputs(bt, group)),
                                  LAYER))


def _flat_args(bt, group, dtype=torch.float32):
    q, *rest = map(torch.from_numpy, _flat_inputs(bt, group))
    return (q.to(dtype), *rest, LAYER)


# each case loops over the split counts; the two cover Bt 16 and 64,
# groups 1 and 2
@pytest.mark.parametrize("bt, group", [(16, 2), (64, 1)])
def test_flat_i8_split_reference_matches_jax(bt, group):
    want = _jax_flat(bt, group)
    for splits in (1, 2, 3, 5):
        got = da.decode_attention_paged_flat_i8_split_reference(
            *_flat_args(bt, group), splits=splits)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want,
                                   **TOLERANCES["attention_fp32"])
        # rows past each chunk's count, and the pad chunk, are exactly 0
        for ci, (_, _, n) in enumerate(CHUNKS):
            rows = got.numpy()[8 * ci:8 * ci + 8]
            assert not rows[n:].any() and (n == 0 or rows[:n].all(-1).any())


@pytest.mark.parametrize("dtype, tname", [
    (torch.bfloat16, "attention_bf16"), (torch.float16, "attention_fp16")])
def test_flat_i8_split_reference_in_16_bits(dtype, tname):
    args = _flat_args(64, 2, dtype)
    want = da.decode_attention_paged_flat_i8_reference(*args)
    pads = [8 * i + r for i, (_, _, n) in enumerate(CHUNKS)
            for r in range(n, 8)]
    got = da.decode_attention_paged_flat_i8_split_reference(*args, splits=5)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[tname])
    assert not got[pads].any()


def test_flat_i8_design_and_ranges():
    """The flat stream takes paged_path's design: a chunk of 8 tokens is
    a row of the split design, its ranges decode_splits' over T / 8
    chunks (one range on a CPU tensor or the per-head design)."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in (40, 64, 100):
            want = ("split_kv" if dtype != torch.float32 and d % 8 == 0
                    else "per_head")
            assert da.paged_path(dtype, d) == want
            q = torch.zeros(16, 8, 12, d, dtype=dtype)  # T = 128 as chunks
            assert da._range_splits(q, 12, 1024) == (want, 1, 1024)
    assert set(da.PATH_LAUNCHES["decode_attention_paged_flat_i8"]) == {
        "split_kv", "per_head"}
    # the main flat shape: 16 chunks x 12 heads, six ranges of 192
    assert da.decode_splits(16, 12, 1024, 132) == (6, 192)


# ----------------------------------------------------- fused dequant-matmul
def _packed(rng, k, o, transposed):
    """An int4 weight packed as ``_stacked`` packs it: contiguous [K/2, O],
    or the transpose of a packed [O, K/2] (what qkv_of hands the kernel);
    scales [1, O]."""
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32))
    if transposed:
        q, s = _absmax_int4(w.T.contiguous(), -1)
        return _pack_int4(q, -1).T, s.T
    q, s = _absmax_int4(w, 0)
    return _pack_int4(q, 0), s


# (K, O): K/2 = 80 (two whole 32-row steps and a ragged one), O = 36
DQ_SHAPE = (160, 36)


@functools.lru_cache(maxsize=None)
def _dq_inputs(m, transposed):
    rng = np.random.default_rng(m + 2 * transposed)
    wp, s = _packed(rng, *DQ_SHAPE, transposed)
    a = rng.standard_normal((m, DQ_SHAPE[0])).astype(np.float32)
    want = np.asarray(jax_fdm(jnp.asarray(a), jnp.asarray(wp.numpy()),
                              jnp.asarray(s.numpy())))
    return torch.from_numpy(a), wp, s, want


@pytest.mark.parametrize("transposed", [False, True])
def test_dequant_split_reference_matches_jax(transposed):
    for m in (1, 8, 17):
        a, wp, s, want = _dq_inputs(m, transposed)
        assert wp.is_contiguous() != transposed
        for splits in (1, 2, 3):
            got = fdm.fused_dequant_matmul_split_reference(a, wp, s,
                                                           splits=splits)
            assert got.shape == (m, DQ_SHAPE[1])
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want,
                                       **TOLERANCES["matmul_fp32"])


def test_dequant_out_dtype_is_keyword_only_as_in_jax():
    """JAX's ``fused_dequant_matmul(a, w_packed, scales, *,
    out_dtype=None)``: the same parameters, kinds and defaults."""
    def kinds(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert kinds(fdm.fused_dequant_matmul) == kinds(jax_fdm)
    a, wp, s, _ = _dq_inputs(8, False)
    with pytest.raises(TypeError):
        fdm.fused_dequant_matmul(a, wp, s, torch.float32)


def test_dequant_writes_any_out_dtype():
    a, wp, s, _ = _dq_inputs(17, True)
    ab = a.to(torch.bfloat16)
    want = np.asarray(jax_fdm(jnp.asarray(ab.float().numpy(), jnp.bfloat16),
                              jnp.asarray(wp.numpy()), jnp.asarray(s.numpy()),
                              out_dtype=jnp.float32))
    for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = fdm.fused_dequant_matmul(ab, wp, s, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        # the cast to a 16-bit output is the only rounding past JAX's fp32
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **TOLERANCES["matmul_bf16"])


def test_dequant_path():
    """The tensor-core design for bf16 / fp16 where the rows stage in
    16-byte copies, the fma design otherwise; and the split rule at
    GPT-2's main shapes (``_main_shapes``)."""
    _main_shapes()
    for k, o, k_contig, aligned in [
            (768, 2304, 1, True), (768, 768, 0, True), (768, 3072, 0, True),
            (3072, 768, 0, True),                 # GPT-2's four
            (160, 36, 0, False),                  # O % 16 != 0
            (168, 48, 1, False),                  # K/2 % 16 != 0
            (100, 48, 0, False),                  # K % 8 != 0
            (64, 48, 1, True)]:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            want = ("tensor_core" if aligned and dtype != torch.float32
                    else "fma")
            assert fdm.dequant_path(dtype, k, o, k_contig) == want


@pytest.mark.parametrize("path", ["tensor_core", "fma"])
def test_dequant_splits_cover_each_step_once(path):
    for m, k2, o in [(8, 384, 2304), (8, 384, 768), (8, 384, 3072),
                     (8, 1536, 768), (128, 384, 2304), (128, 1536, 768),
                     (512, 384, 3072), (512, 1536, 768), (1, 80, 36),
                     (17, 16, 48), (4096, 384, 3072)]:
        _check_dequant_splits(path, m, k2, o, 132)


def _check_dequant_splits(path, m, k2, o, n_sm):
    bm, s, chunk = fdm.dequant_splits(m, k2, o, path, n_sm)
    assert (bm, s, chunk) == fdm.dequant_splits(m, k2, o, path, n_sm)
    assert chunk % 32 == 0 and 1 <= s == -(-k2 // chunk)
    steps = -(-k2 // 32)
    covered = [j for z in range(s)
               for j in range(z * chunk // 32, min((z + 1) * chunk // 32,
                                                   steps))]
    assert covered == list(range(steps))          # each once, in order
    bn = 128 if path == "tensor_core" else 64
    tiles = -(-o // bn) * -(-m // bm)
    assert bm in ((16, 64, 128) if path == "tensor_core" else (16, 32, 64))
    if tiles >= 2 * n_sm:
        assert s == 1
    if path == "tensor_core" and s > 1:
        # the K ranges of a tile are the blocks of one cluster
        most = fdm._MAX_SPLITS if bm == 16 else fdm._MAX_SPLITS_WG
        assert s <= most and tiles * s <= 2 * n_sm


def _main_shapes():
    """GPT-2's decode (M 8): BM 16 and the K walk split over a wave of
    the card, at most a cluster's 16 ranges; the row block (M 128) BM 64
    in four ranges of three steps; bulk prefill (M 512) BM 128, unsplit
    where the tiles fill the card."""
    sp = functools.partial(fdm.dequant_splits, path="tensor_core", n_sm=132)
    assert sp(8, 384, 3072) == (16, 4, 96)          # f1: 24 tiles
    assert sp(8, 1536, 768) == (16, 16, 96)         # f2: 6 tiles
    assert sp(128, 384, 2304) == (64, 4, 96)        # qkv: 36 tiles
    assert sp(512, 384, 2304) == (128, 1, 384)      # qkv: 72 tiles
    assert sp(512, 384, 768) == (128, 4, 96)        # lin: 24 tiles


def test_cpu_tensors_count_no_launch():
    before = copy.deepcopy((da.LAUNCHES, da.PATH_LAUNCHES, fdm.LAUNCHES,
                            fdm.PATH_LAUNCHES))
    for dtype in (torch.bfloat16, torch.float32):
        args = _flat_args(16, 1, dtype)
        assert torch.equal(da.decode_attention_paged_flat_i8(*args),
                           da.decode_attention_paged_flat_i8_reference(*args))
        a, wp, s, _ = _dq_inputs(8, True)
        assert torch.equal(fdm.fused_dequant_matmul(a.to(dtype), wp, s),
                           fdm.fused_dequant_matmul_reference(a.to(dtype),
                                                              wp, s))
    assert (da.LAUNCHES, da.PATH_LAUNCHES, fdm.LAUNCHES,
            fdm.PATH_LAUNCHES) == before
