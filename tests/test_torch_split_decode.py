"""The split-KV design of ``decode_attention_paged`` on the CPU: its rules
and its arithmetic (the kernel itself runs only on the card, where
chip_smoke.py holds it to the plain version).

- ``paged_splits``: S and the table blocks a split (cb) come from the
  shapes and the SM count alone; the S ranges cover every table block
  exactly once; S is 1 where the B * Hk blocks already fill a wave.
- ``decode_attention_paged_split_reference``, the plain emulation of the
  split-and-merge arithmetic (per-range fp32 partials merged in split
  order), against JAX's ``decode_attention_paged`` in interpret mode,
  fp32, TOLERANCES["attention_fp32"], for S = 1-8: an empty row, a row
  ending on a block edge, a sentinel inside a table, group 1 and 2, Sq 1
  and 16; in bf16 against the port's plain version at
  TOLERANCES["attention_bf16"] (only where p is rounded differs).
- ``paged_path``: bf16 and fp16 at D a multiple of 8 take the split
  design, the rest the per-head one; CPU tensors count no launch and no
  path; an unknown path is refused before any device is touched.
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged as jax_decode_attention_paged
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, BT, NBLK, L, LAYER = 4, 4, 16, 16, 8, 2, 1


def _inputs(seed, sq, group):
    """Ragged lens (an empty row, a row ending exactly on a block edge, a
    long one), each row's blocks in shuffled order, the sentinel NB past
    them and once inside a row's range (it reads block NB - 1)."""
    rng = np.random.default_rng(seed)
    hk = H // group
    lens = np.array([0, 3 * BT - sq, 23, NBLK * BT - sq], np.int32)
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
    pool = rng.standard_normal((L, 2, nb, hk, BT, D)).astype(np.float32)
    return qt, pool, tables, lens


@functools.lru_cache(maxsize=None)
def _jax_want(sq, group):
    qt, pool, tables, lens = _inputs(sq + group, sq, group)
    return np.asarray(jax_decode_attention_paged(
        jnp.asarray(qt), jnp.asarray(pool), jnp.asarray(tables), LAYER,
        jnp.asarray(lens)))


def _torch_args(sq, group, dtype=torch.float32):
    qt, pool, tables, lens = _inputs(sq + group, sq, group)
    return (torch.from_numpy(qt).to(dtype), torch.from_numpy(pool).to(dtype),
            torch.from_numpy(tables), LAYER, torch.from_numpy(lens))


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("sq", [1, 16])
@pytest.mark.parametrize("group", [1, 2])
def test_split_reference_matches_jax(splits, sq, group):
    got = da.decode_attention_paged_split_reference(
        *_torch_args(sq, group), splits=splits)
    np.testing.assert_allclose(got.numpy(), _jax_want(sq, group),
                               **TOLERANCES["attention_fp32"])
    # the empty row attends its own new tokens; nothing is all-zero
    assert np.abs(got.numpy()[0]).sum() > 0


@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_reference_in_16_bits(splits, dtype):
    args = _torch_args(16, 2, dtype)
    got = da.decode_attention_paged_split_reference(*args, splits=splits)
    want = da.decode_attention_paged_reference(*args)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **TOLERANCES["attention_bf16"])


def test_split_reference_with_empty_ranges():
    """Every row at lens 0 attends its first Sq positions only: with cb =
    1 block and S = NBLK, all ranges but the first are empty and add
    nothing to the merge."""
    args = _torch_args(1, 1)
    lens = torch.zeros(B, dtype=torch.int32)
    got = da.decode_attention_paged_split_reference(
        *args[:4], lens, splits=NBLK)
    want = da.decode_attention_paged_reference(*args[:4], lens)
    torch.testing.assert_close(got, want, **TOLERANCES["attention_fp32"])


@pytest.mark.parametrize("b, hk, nblk, bt, n_sm", [
    (8, 12, 32, 64, 132),      # chip_smoke's decode shape
    (8, 12, 16, 64, 132),      # the engine's Smax 1024
    (1, 8, 256, 16, 132),      # one long row, small blocks
    (3, 2, 7, 32, 132),        # ragged table width
    (2, 4, 1, 64, 132),        # one table block
    (22, 48, 16, 64, 132),     # 1056 blocks: a wave already
    (64, 32, 64, 16, 132),
    (8, 12, 32, 64, 16),       # a small card
])
def test_paged_splits_cover_each_block_once(b, hk, nblk, bt, n_sm):
    s, cb = da.paged_splits(b, hk, nblk, bt, n_sm)
    assert (s, cb) == da.paged_splits(b, hk, nblk, bt, n_sm)
    assert 1 <= s <= nblk and s == -(-nblk // cb)
    covered = [blk for i in range(s)
               for blk in range(i * cb, min((i + 1) * cb, nblk))]
    assert covered == list(range(nblk))      # each once, in order
    wave = da._WAVE_BLOCKS_PER_SM * n_sm
    if b * hk >= wave:
        assert s == 1
    if s > 1:
        assert cb * bt >= da._MIN_SPLIT_POSITIONS
        # no more ranges than a wave needs
        assert b * hk * (s - 1) < wave


def test_paged_splits_at_the_decode_shape():
    """B 8, Hk 12 on 132 SMs: eleven ranges of three 64-position blocks
    over chip_smoke's 32-block tables (at lens 1024, six of them hold
    positions); eight of two over the engine's 16-block tables."""
    assert da.paged_splits(8, 12, 32, 64, 132) == (11, 3)
    assert da.paged_splits(8, 12, 16, 64, 132) == (8, 2)
    assert da.paged_splits(22, 48, 16, 64, 132) == (1, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [8, 36, 64, 96, 128, 256])
def test_paged_path(dtype, d):
    want = ("split_kv" if dtype != torch.float32 and d % 8 == 0
            else "per_head")
    assert da.paged_path(dtype, d) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch(dtype):
    args = _torch_args(16, 2, dtype)
    before = copy.deepcopy((da.LAUNCHES, da.PATH_LAUNCHES))
    got = da.decode_attention_paged(*args)
    assert torch.equal(got, da.decode_attention_paged_reference(*args))
    assert (da.LAUNCHES, da.PATH_LAUNCHES) == before


def test_unknown_path_is_refused_before_any_device():
    qt = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="unknown kernel path"):
        da._launch("decode_attention_paged", [("qt", qt)], qt, (), 1.0,
                   qt.dtype, path="tc")
