"""The fp reads over a contiguous cache on the split-KV decode design, on
the CPU: the one-layer cache (``decode_attention_bhsd``, K and V two
tensors) and the fp dense ring (``decode_attention_stacked``), whose bf16
/ fp16 launches run ``csrc/split_decode.cuh``'s fp flavor with no table
on the card (chip_smoke.py holds the kernels to the plain versions there).

- ``decode_attention_bhsd_split_reference`` and
  ``decode_attention_stacked_split_reference``, the plain emulation of the
  split-and-merge arithmetic over position ranges, against JAX's
  ``decode_attention_bhsd`` and ``decode_attention_stacked`` in interpret
  mode, fp32, TOLERANCES["attention_fp32"], for S = 1, 2, 3, 5 and 8, Sq 1
  and 16, GQA groups 1 and 2: an empty row, a row ending on a tile edge,
  one ending inside a range, a full one; the one-layer cache also at Smax
  100 (not a multiple of the kernel's 64-position tile), K and V separate
  tensors; in bf16 and fp16 against the port's plain versions at
  TOLERANCES["attention_bf16"] / ["attention_fp16"] (only where p is
  rounded differs).
- ``decode_splits`` over a contiguous cache's Smax: ranges of whole
  64-position tiles, the last cut at Smax, that cover every position
  exactly once.
- Both reads take ``paged_path``'s design; CPU tensors count no launch and
  no path.
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_bhsd as jax_bhsd
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_stacked as jax_stacked
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, L, LAYER = 4, 4, 16, 2, 1
# kind: (the read, Smax); the ring's Smax is a multiple of 128
KINDS = {"bhsd": ("bhsd", 128), "bhsd100": ("bhsd", 100),
         "ring": ("ring", 128)}


def _lens(sq, smax):
    # an empty row, a row ending on a tile edge, one ending inside a
    # range, a full one
    return np.array([0, 64 - sq, 23, smax - sq], np.int32)


@functools.lru_cache(maxsize=None)
def _inputs(kind, sq, group):
    """qt [B, H, Sq, D]; the one-layer cache's kt and vt [B, Hk, Smax, D]
    (two tensors) or the ring [L, 2, B, Hk, Smax, D]; lens."""
    read, smax = KINDS[kind]
    rng = np.random.default_rng(sq + 10 * group + smax)
    qt = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    hk = H // group
    if read == "bhsd":
        kv = tuple(rng.standard_normal((B, hk, smax, D)).astype(np.float32)
                   for _ in range(2))
    else:
        kv = (rng.standard_normal((L, 2, B, hk, smax, D)).astype(
            np.float32),)
    return qt, kv, _lens(sq, smax)


@functools.lru_cache(maxsize=None)
def _jax_want(kind, sq, group):
    qt, kv, lens = _inputs(kind, sq, group)
    if KINDS[kind][0] == "bhsd":
        return np.asarray(jax_bhsd(*map(jnp.asarray, (qt, *kv, lens))))
    return np.asarray(jax_stacked(jnp.asarray(qt), jnp.asarray(kv[0]), LAYER,
                                  jnp.asarray(lens)))


def _torch_args(kind, sq, group, dtype=torch.float32):
    qt, kv, lens = _inputs(kind, sq, group)
    qt = torch.from_numpy(qt).to(dtype)
    kv = tuple(torch.from_numpy(a).to(dtype) for a in kv)
    lens = torch.from_numpy(lens)
    if KINDS[kind][0] == "bhsd":
        return (qt, *kv, lens)
    return (qt, kv[0], LAYER, lens)


_SPLIT_REF = {"bhsd": da.decode_attention_bhsd_split_reference,
              "ring": da.decode_attention_stacked_split_reference}
_PLAIN = {"bhsd": da.decode_attention_bhsd_reference,
          "ring": da.decode_attention_stacked_reference}
_WRAPPER = {"bhsd": da.decode_attention_bhsd,
            "ring": da.decode_attention_stacked}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("sq", [1, 16])
@pytest.mark.parametrize("group", [1, 2])
def test_fp_split_reference_matches_jax(kind, splits, sq, group):
    read = KINDS[kind][0]
    got = _SPLIT_REF[read](*_torch_args(kind, sq, group), splits=splits)
    assert got.shape == (B, H, sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_want(kind, sq, group),
                               **TOLERANCES["attention_fp32"])
    # the empty row attends its own new tokens; nothing is all-zero
    assert np.abs(got.numpy()[0]).sum() > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("dtype, tname", [
    (torch.bfloat16, "attention_bf16"), (torch.float16, "attention_fp16")])
def test_fp_split_reference_in_16_bits(kind, splits, dtype, tname):
    read = KINDS[kind][0]
    args = _torch_args(kind, 16, 2, dtype)
    got = _SPLIT_REF[read](*args, splits=splits)
    want = _PLAIN[read](*args)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[tname])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fp_split_reference_with_empty_ranges(kind):
    """Every row at lens 0 attends its first position only: with S = 8
    ranges, all but the first are empty and add nothing to the merge."""
    read = KINDS[kind][0]
    args = list(_torch_args(kind, 1, 1))
    args[-1] = torch.zeros(B, dtype=torch.int32)
    got = _SPLIT_REF[read](*args, splits=8)
    torch.testing.assert_close(got, _PLAIN[read](*args),
                               **TOLERANCES["attention_fp32"])


def test_ring_split_reference_reads_its_layer():
    """The ring's split reference is the one-layer cache's over layer
    ``layer``'s K and V planes, and no other layer's."""
    qt, ring, layer, lens = _torch_args("ring", 16, 2)
    got = da.decode_attention_stacked_split_reference(qt, ring, layer, lens,
                                                      splits=3)
    want = da.decode_attention_bhsd_split_reference(
        qt, ring[layer, 0].clone(), ring[layer, 1].clone(), lens, splits=3)
    assert torch.equal(got, want)
    other = ring.clone()
    other[1 - layer] = 0
    assert torch.equal(da.decode_attention_stacked_split_reference(
        qt, other, layer, lens, splits=3), got)


@pytest.mark.parametrize("b, hk, smax, n_sm", [
    (8, 12, 1024, 132),        # phase 3e's cache and the ring's main shape
    (8, 12, 1000, 132),        # not a tile multiple: a ragged last tile
    (8, 12, 32, 132),          # less than a tile
    (8, 12, 100, 132),
    (4, 4, 128, 132),          # the ring's smallest
    (1, 8, 4096, 132),         # one long row
    (2, 6, 4096, 132),
    (22, 48, 1024, 132),       # 1056 blocks: a wave already
    (8, 12, 1000, 16),         # a small card
])
def test_decode_splits_cover_a_contiguous_cache(b, hk, smax, n_sm):
    s, span = da.decode_splits(b, hk, smax, n_sm)
    assert span % 64 == 0 and 1 <= s == -(-smax // span)
    covered = [p for i in range(s)
               for p in range(i * span, min((i + 1) * span, smax))]
    assert covered == list(range(smax))           # each once, in order
    assert (s - 1) * span < smax                  # no range wholly past it
    wave = da._WAVE_BLOCKS_PER_SM * n_sm
    if b * hk >= wave:
        assert s == 1
    if s > 1:
        assert span >= da._MIN_SPLIT_POSITIONS


def test_decode_splits_at_the_main_shapes():
    """B 8, Hk 12 on 132 SMs: phase 3e's one-layer cache and the fp ring
    (Smax 1024) take eight ranges of 128, as the int8 ring does; a cache
    of 1000 at most seven (none under 128 positions), six of 192, the
    last cut at 1000; one of 32 a single range."""
    assert da.decode_splits(8, 12, 1024, 132) == (8, 128)
    assert da.decode_splits(8, 12, 1000, 132) == (6, 192)
    assert da.decode_splits(8, 12, 32, 132) == (1, 64)
    assert da.decode_splits(8, 12, 128, 132) == (1, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [16, 36, 64, 128])
def test_fp_design_rule(dtype, d):
    """The two reads' design is paged_path's: split_kv for bf16 / fp16 at
    D a multiple of 8, per_head otherwise; on a CPU tensor one range over
    all positions (any Smax)."""
    want = ("split_kv" if dtype != torch.float32 and d % 8 == 0
            else "per_head")
    assert da.paged_path(dtype, d) == want
    qt = torch.zeros(2, 4, 1, d, dtype=dtype)
    assert da._range_splits(qt, 2, 1000) == (want, 1, 1000)
    for name in ("decode_attention_bhsd", "decode_attention_stacked"):
        assert set(da.PATH_LAUNCHES[name]) == {"split_kv", "per_head"}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch(kind, dtype):
    read = KINDS[kind][0]
    args = _torch_args(kind, 16, 2, dtype)
    before = copy.deepcopy((da.LAUNCHES, da.PATH_LAUNCHES))
    got = _WRAPPER[read](*args)
    assert torch.equal(got, _PLAIN[read](*args))
    assert (da.LAUNCHES, da.PATH_LAUNCHES) == before
