"""The fused write+attend kernels over the dense ring on the split-KV decode
design, on the CPU: ``decode_attention_stacked_write`` and
``decode_attention_stacked_i8_write``, whose bf16 / fp16 launches run
``csrc/split_decode.cuh`` in its write mode on the card (chip_smoke.py
holds the kernels to the plain versions there, the ring byte for byte).

- ``decode_attention_stacked_write_split_reference`` and
  ``decode_attention_stacked_i8_write_split_reference``, the plain
  emulation of the write mode's arithmetic (exclusive ranges below
  lens[b], the new column seeded into range 0, partials merged in split
  order, the row landed in place), against JAX's
  ``decode_attention_stacked_write`` and ``decode_attention_stacked_i8_write``
  in interpret mode, fp32, TOLERANCES["attention_fp32"], for S = 1, 2, 3,
  5 and 8 and GQA groups 1 and 2, over lens 0, 63, 64 (either side of a
  range edge), 100 (inside a range), Smax - 1 and Smax (the dropped
  write); the ring after the call equal to JAX's bit for bit (int8: the
  rows; the scales, amax / 127 by true division as the engine's recipe
  and the kernels compute it, within TOLERANCES["kv_int8_scales"] of
  JAX's, whose CPU division multiplies by 1 / 127, and bit for bit the
  port's plain write's), an all-zero new row among them (scale 0).
- The same in bf16 and fp16 against the port's plain versions at
  TOLERANCES["attention_bf16"] / ["attention_fp16"] (only where p is
  rounded differs), the rings byte-equal.
- The designated range seeds even where the prefix is empty: every row at
  lens 0 returns the new token's V (int8: round(v_scale) * v_int).
- Both writes take ``paged_path``'s design; CPU tensors count no launch
  and no path.
"""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_stacked_i8_write as jax_i8_write
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_stacked_write as jax_write
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, L, LAYER, SMAX = 6, 4, 16, 2, 1, 128
# either side of a range edge, inside a range, the last free position and
# a full row (the dropped write)
LENS = np.array([0, 63, 64, 100, SMAX - 1, SMAX], np.int32)
FLAVORS = ("fp", "i8")
_WRITE = {"fp": da.decode_attention_stacked_write,
          "i8": da.decode_attention_stacked_i8_write}
_PLAIN = {"fp": da.decode_attention_stacked_write_reference,
          "i8": da.decode_attention_stacked_i8_write_reference}
_SPLIT_REF = {"fp": da.decode_attention_stacked_write_split_reference,
              "i8": da.decode_attention_stacked_i8_write_split_reference}


@functools.lru_cache(maxsize=None)
def _inputs(flavor, group):
    """qt [B, H, 1, D], kv_new [2, B, Hk, 1, D] fp32 (row 2's V all zero),
    and the ring [L, 2, B, Hk, Smax, D] (int8: with fp32 scales [L, 2, B,
    Hk, 1, Smax])."""
    rng = np.random.default_rng(group + 10 * (flavor == "i8"))
    hk = H // group
    qt = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kv_new = rng.standard_normal((2, B, hk, 1, D)).astype(np.float32)
    kv_new[1, 2] = 0.0
    shape = (L, 2, B, hk, SMAX, D)
    if flavor == "fp":
        return qt, kv_new, (rng.standard_normal(shape).astype(np.float32),)
    ring = rng.integers(-127, 128, shape).astype(np.int8)
    sc = rng.uniform(0.002, 0.05, shape[:4] + (1, SMAX)).astype(np.float32)
    return qt, kv_new, (ring, sc)


@functools.lru_cache(maxsize=None)
def _jax_want(flavor, group):
    """JAX's (ring after the call, [scales after the call,] attention)."""
    qt, kv_new, ring = _inputs(flavor, group)
    fn = jax_write if flavor == "fp" else jax_i8_write
    return tuple(np.asarray(a) for a in fn(
        *map(jnp.asarray, (qt, kv_new, *ring)), LAYER, jnp.asarray(LENS)))


def _torch_args(flavor, group, dtype=torch.float32, lens=LENS):
    """The wrappers' arguments, the ring copied (the writes land in
    place): qt and (fp) kv_new and the ring in ``dtype``."""
    qt, kv_new, ring = _inputs(flavor, group)
    kv = torch.from_numpy(kv_new)
    ring = [torch.from_numpy(a.copy()) for a in ring]
    if flavor == "fp":
        kv, ring = kv.to(dtype), [ring[0].to(dtype)]
    return (torch.from_numpy(qt).to(dtype), kv, *ring, LAYER,
            torch.from_numpy(np.asarray(lens, np.int32)))


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("group", [1, 2])
def test_write_split_reference_matches_jax(flavor, splits, group):
    args = _torch_args(flavor, group)
    *rings, got = _SPLIT_REF[flavor](*args, splits=splits)
    assert rings[0] is args[2]                    # landed in place
    assert got.shape == (B, H, 1, D) and got.dtype == torch.float32
    *want_rings, want = _jax_want(flavor, group)
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    assert rings[0].numpy().tobytes() == want_rings[0].tobytes()
    if flavor == "i8":
        # the scales: the port's true division amax / 127 (the engine's
        # recipe, the kernels'), bit for bit its plain write's; XLA's CPU
        # multiplies by 1 / 127, an ulp away on some rows
        np.testing.assert_allclose(rings[1].numpy(), want_rings[1],
                                   **TOLERANCES["kv_int8_scales"])
        plain = _PLAIN[flavor](*_torch_args(flavor, group))
        assert torch.equal(rings[1].view(torch.int32),
                           plain[1].view(torch.int32))
    changed = (rings[0].numpy() != _inputs(flavor, group)[2][0]).any(
        axis=(0, 1, 3, 5))                        # [B, Smax]
    assert not changed[-1].any()                  # the full row dropped
    for b, n in enumerate(LENS[:-1]):             # the others at lens[b]
        assert np.flatnonzero(changed[b]).tolist() == [n]


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("dtype, tname", [
    (torch.bfloat16, "attention_bf16"), (torch.float16, "attention_fp16")])
def test_write_split_reference_in_16_bits(flavor, splits, dtype, tname):
    args = _torch_args(flavor, 2, dtype)
    other = [a.clone() if torch.is_tensor(a) else a for a in args]
    *rings, got = _SPLIT_REF[flavor](*args, splits=splits)
    *want_rings, want = _PLAIN[flavor](*other)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[tname])
    for r, w in zip(rings, want_rings):
        assert torch.equal(r.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("splits", [1, 8])
def test_designated_range_seeds_an_empty_prefix(flavor, splits):
    """Every row at lens 0: each range is empty but the first, which holds
    only the new column, so each query head returns its KV head's new V
    exactly (int8: the V row's scale rounded to the query dtype times its
    codes), and the new rows land at position 0."""
    from paddle_tpu_torch.inference.generation import _absmax_int8
    args = _torch_args(flavor, 2, lens=np.zeros(B))
    kv_new = args[1]
    *rings, got = _SPLIT_REF[flavor](*args, splits=splits)
    if flavor == "fp":
        v, landed = kv_new[1], rings[0][LAYER, :, :, :, 0]
        assert torch.equal(landed, kv_new[:, :, :, 0])
    else:
        codes, sc = _absmax_int8(kv_new, -1)
        v = codes[1].float() * sc[1]
        assert torch.equal(rings[0][LAYER, :, :, :, 0], codes[:, :, :, 0])
        assert torch.equal(rings[1][LAYER, :, :, :, 0, 0], sc[:, :, :, 0, 0])
    want = v.repeat_interleave(2, dim=1)          # [B, H, 1, D]
    assert torch.equal(got, want)
    assert got[0].abs().sum() > 0
    torch.testing.assert_close(
        got, _PLAIN[flavor](*_torch_args(flavor, 2, lens=np.zeros(B)))[-1],
        **TOLERANCES["attention_fp32"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [16, 36, 64, 128])
def test_write_design_rule(dtype, d):
    """The two writes' design is paged_path's: split_kv for bf16 / fp16 at
    D a multiple of 8, per_head otherwise; on a CPU tensor one range over
    all positions."""
    want = ("split_kv" if dtype != torch.float32 and d % 8 == 0
            else "per_head")
    assert da.paged_path(dtype, d) == want
    qt = torch.zeros(2, 4, 1, d, dtype=dtype)
    assert da._range_splits(qt, 2, 1024) == (want, 1, 1024)
    for name in _WRITE.values():
        assert set(da.PATH_LAUNCHES[name.__name__]) == {"split_kv",
                                                        "per_head"}


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch(flavor, dtype):
    args = _torch_args(flavor, 2, dtype)
    other = [a.clone() if torch.is_tensor(a) else a for a in args]
    before = copy.deepcopy((da.LAUNCHES, da.PATH_LAUNCHES))
    *rings, got = _WRITE[flavor](*args)
    *want_rings, want = _PLAIN[flavor](*other)
    assert torch.equal(got, want)
    assert all(torch.equal(r, w) for r, w in zip(rings, want_rings))
    assert (da.LAUNCHES, da.PATH_LAUNCHES) == before
