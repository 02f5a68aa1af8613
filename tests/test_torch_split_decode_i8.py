"""The int8 flavor of the split-KV decode design on the CPU: the int8 pool
(``decode_attention_paged_i8``) and the int8 dense ring
(``decode_attention_stacked_i8``), whose bf16 / fp16 launches run
``csrc/split_decode.cuh``'s int8 flavor on the card (chip_smoke.py holds
the kernels to the plain versions there).

- ``decode_attention_paged_i8_split_reference`` and
  ``decode_attention_stacked_i8_split_reference``, the plain emulation of
  the split-and-merge arithmetic over position ranges, against JAX's
  ``decode_attention_paged_i8`` and ``decode_attention_stacked_i8`` in
  interpret mode, fp32, TOLERANCES["attention_fp32"], for S = 1, 2, 3, 5
  and 8, Sq 1 and 16, GQA groups 1 and 2: an empty row, a row ending on a
  block edge, one ending inside a range, a sentinel inside a table; in
  bf16 and fp16 against the port's plain versions at
  TOLERANCES["attention_bf16"] / ["attention_fp16"] (only where p is
  rounded differs).
- ``decode_splits``: ranges of whole 64-position tiles that cover every
  position exactly once, S = 1 where the B * Hk blocks fill a wave, the
  same for a pool's nblk * Bt positions and a ring's Smax.
- The int8 reads take ``paged_path``'s design; CPU tensors count no
  launch and no path.
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged_i8 as jax_paged_i8
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_stacked_i8 as jax_stacked_i8
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, BT, NBLK, L, LAYER = 4, 4, 16, 16, 8, 2, 1
SMAX = NBLK * BT                     # the ring holds the pool's positions


def _int8_kv(rng, shape):
    """Random int8 K/V of ``shape`` [L, 2, N, Hk, P, D] and positive fp32
    scales [L, 2, N, Hk, 1, P] (a few all-zero rows among them)."""
    kv = rng.integers(-127, 128, shape).astype(np.int8)
    sc = rng.uniform(0.002, 0.05, shape[:4] + (1, shape[4])).astype(
        np.float32)
    kv[:, :, 1, :, 5:8] = 0
    return kv, sc


def _lens(sq):
    # an empty row, a row ending on a block edge, one ending inside a
    # range, a full one
    return np.array([0, 3 * BT - sq, 23, NBLK * BT - sq], np.int32)


def _pool_inputs(seed, sq, group):
    """Each row's blocks in shuffled order, the sentinel NB past them and
    once inside row 3's range (it reads block NB - 1)."""
    rng = np.random.default_rng(seed)
    lens = _lens(sq)
    nb = B * NBLK + 1
    perm = rng.permutation(nb)
    tables = np.full((B, NBLK), nb, np.int32)
    k = 0
    for r in range(B):
        need = min((int(lens[r]) + sq - 1) // BT + 1, NBLK)
        tables[r, :need] = perm[k:k + need]
        k += need
    tables[3, 2] = nb
    qt = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    pool, sc = _int8_kv(rng, (L, 2, nb, H // group, BT, D))
    return qt, pool, sc, tables, lens


def _ring_inputs(seed, sq, group):
    rng = np.random.default_rng(seed)
    qt = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    ring, sc = _int8_kv(rng, (L, 2, B, H // group, SMAX, D))
    return qt, ring, sc, _lens(sq)


@functools.lru_cache(maxsize=None)
def _jax_want(kind, sq, group):
    if kind == "pool":
        qt, pool, sc, tables, lens = _pool_inputs(sq + group, sq, group)
        return np.asarray(jax_paged_i8(
            *map(jnp.asarray, (qt, pool, sc, tables)), LAYER,
            jnp.asarray(lens)))
    qt, ring, sc, lens = _ring_inputs(sq + group, sq, group)
    return np.asarray(jax_stacked_i8(*map(jnp.asarray, (qt, ring, sc)),
                                     LAYER, jnp.asarray(lens)))


def _torch_args(kind, sq, group, dtype=torch.float32):
    if kind == "pool":
        qt, pool, sc, tables, lens = _pool_inputs(sq + group, sq, group)
        return (torch.from_numpy(qt).to(dtype), torch.from_numpy(pool),
                torch.from_numpy(sc), torch.from_numpy(tables), LAYER,
                torch.from_numpy(lens))
    qt, ring, sc, lens = _ring_inputs(sq + group, sq, group)
    return (torch.from_numpy(qt).to(dtype), torch.from_numpy(ring),
            torch.from_numpy(sc), LAYER, torch.from_numpy(lens))


_SPLIT_REF = {"pool": da.decode_attention_paged_i8_split_reference,
              "ring": da.decode_attention_stacked_i8_split_reference}
_PLAIN = {"pool": da.decode_attention_paged_i8_reference,
          "ring": da.decode_attention_stacked_i8_reference}
_WRAPPER = {"pool": da.decode_attention_paged_i8,
            "ring": da.decode_attention_stacked_i8}


@pytest.mark.parametrize("kind", ["pool", "ring"])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("sq", [1, 16])
@pytest.mark.parametrize("group", [1, 2])
def test_i8_split_reference_matches_jax(kind, splits, sq, group):
    got = _SPLIT_REF[kind](*_torch_args(kind, sq, group), splits=splits)
    assert got.shape == (B, H, sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_want(kind, sq, group),
                               **TOLERANCES["attention_fp32"])
    # the empty row attends its own new tokens; nothing is all-zero
    assert np.abs(got.numpy()[0]).sum() > 0


@pytest.mark.parametrize("kind", ["pool", "ring"])
@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("dtype, tname", [
    (torch.bfloat16, "attention_bf16"), (torch.float16, "attention_fp16")])
def test_i8_split_reference_in_16_bits(kind, splits, dtype, tname):
    args = _torch_args(kind, 16, 2, dtype)
    got = _SPLIT_REF[kind](*args, splits=splits)
    want = _PLAIN[kind](*args)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[tname])


@pytest.mark.parametrize("kind", ["pool", "ring"])
def test_i8_split_reference_with_empty_ranges(kind):
    """Every row at lens 0 attends its first position only: with S = 8
    ranges of 16 positions, all but the first are empty and add nothing
    to the merge."""
    args = list(_torch_args(kind, 1, 1))
    args[-1] = torch.zeros(B, dtype=torch.int32)
    got = _SPLIT_REF[kind](*args, splits=8)
    torch.testing.assert_close(got, _PLAIN[kind](*args),
                               **TOLERANCES["attention_fp32"])


@pytest.mark.parametrize("b, hk, n_pos, n_sm", [
    (8, 12, 2048, 132),        # chip_smoke's pool decode shape (nblk 32)
    (8, 12, 1024, 132),        # the engine's Smax 1024, pool and ring
    (1, 8, 4096, 132),         # one long row
    (3, 2, 224, 132),          # a table of 7 blocks of 32: a ragged tile
    (2, 4, 64, 132),           # one tile
    (2, 4, 16, 132),           # less than a tile (Bt 16, one block)
    (22, 48, 1024, 132),       # 1056 blocks: a wave already
    (64, 32, 4096, 132),
    (8, 12, 2048, 16),         # a small card
])
def test_decode_splits_cover_each_position_once(b, hk, n_pos, n_sm):
    s, span = da.decode_splits(b, hk, n_pos, n_sm)
    assert (s, span) == da.decode_splits(b, hk, n_pos, n_sm)
    assert span % 64 == 0 and 1 <= s == -(-n_pos // span)
    covered = [p for i in range(s)
               for p in range(i * span, min((i + 1) * span, n_pos))]
    assert covered == list(range(n_pos))          # each once, in order
    wave = da._WAVE_BLOCKS_PER_SM * n_sm
    if b * hk >= wave:
        assert s == 1
    if s > 1:
        assert span >= da._MIN_SPLIT_POSITIONS
        assert b * hk * (s - 1) < wave            # no more than a wave needs


def test_decode_splits_at_the_main_shapes():
    """B 8, Hk 12 on 132 SMs: chip_smoke's pool (32 blocks of 64) in
    eleven ranges of 192 positions, as the fp pool's paged_splits cuts
    it; the engine's pool (16 blocks of 64) and the ring (Smax 1024) hold
    the same positions and take the same eight ranges of 128."""
    assert da.decode_splits(8, 12, 32 * 64, 132) == (11, 192)
    assert da.paged_splits(8, 12, 32, 64, 132) == (11, 3)
    assert da.decode_splits(8, 12, 16 * 64, 132) == (8, 128)
    assert da.paged_splits(8, 12, 16, 64, 132) == (8, 2)
    assert da.decode_splits(8, 12, 1024, 132) == (8, 128)
    # a pool of small blocks: the ranges still take whole tiles
    assert da.decode_splits(8, 12, 64 * 16, 132) == (8, 128)
    assert da.decode_splits(22, 48, 1024, 132) == (1, 1024)
    # a short table: one range
    assert da.decode_splits(8, 12, 128, 132) == (1, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [16, 36, 64, 128])
def test_i8_design_rule(dtype, d):
    """The int8 reads' design is paged_path's: split_kv for bf16 / fp16
    queries at D a multiple of 8, per_head otherwise; on a CPU tensor one
    range over all positions."""
    want = ("split_kv" if dtype != torch.float32 and d % 8 == 0
            else "per_head")
    qt = torch.zeros(2, 4, 1, d, dtype=dtype)
    assert da._range_splits(qt, 2, 256) == (want, 1, 256)
    assert set(da.PATH_LAUNCHES["decode_attention_paged_i8"]) == \
        set(da.PATH_LAUNCHES["decode_attention_stacked_i8"]) == \
        {"split_kv", "per_head"}


@pytest.mark.parametrize("kind", ["pool", "ring"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch(kind, dtype):
    args = _torch_args(kind, 16, 2, dtype)
    before = copy.deepcopy((da.LAUNCHES, da.PATH_LAUNCHES))
    got = _WRAPPER[kind](*args)
    assert torch.equal(got, _PLAIN[kind](*args))
    assert (da.LAUNCHES, da.PATH_LAUNCHES) == before
