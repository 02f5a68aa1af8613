"""The fp flat stream on the split-KV design and RMSNorm's row-block
design, on the CPU: the plain version of the flat kernel's split
arithmetic against the JAX package, and the rules that pick both kernels'
designs, ranges and dgamma partials. chip_smoke.py holds the kernels to
the plain versions on the card.

- ``decode_attention_paged_flat_split_reference``, the plain
  split-and-merge arithmetic of the flat mode of split_decode.cuh's fp
  flavor, against JAX's ``decode_attention_paged_flat`` in interpret mode,
  fp32, TOLERANCES["attention_fp32"], for S = 1, 2, 3 and 5, Bt 16 at GQA
  group 2 and Bt 64 at group 1: a pad chunk, rows past a chunk's count, a
  chunk at base 0, one ending on a block edge and a sentinel inside a
  slot's table; rows that attend nothing exactly 0; in bf16 and fp16
  against the port's plain version at TOLERANCES["attention_bf16"] /
  ["attention_fp16"] (only where p is rounded differs), S = 5.
- The fp flat stream's design and ranges: ``paged_path`` (split for bf16
  and fp16 at D a multiple of 8, per head for fp32 and other D),
  ``decode_splits`` over T / 8 chunks covering every position once, S = 1
  when the chunks' blocks fill a wave.
- RMSNorm: ``rms_norm_path`` (the row-block design for bf16 at LLaMA-2
  7B's D 4096, the per-warp one where D does not fill 128-512 whole
  16-byte vectors or a tensor is not 16-byte aligned), the row-block
  bound against csrc/row_block.cuh's, ``rms_norm_blocks`` and
  ``rms_bwd_partials`` covering every row exactly once for N 1, 7, 4096
  and 4097 at 132 SMs. The plain versions against JAX's kernels are
  tests/test_torch_rms_norm.py's.
- CPU tensors count no launch and no path.
"""
import copy
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged_flat as jax_flat
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import layer_norm as ln

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

H, D, L, LAYER, N_POS = 4, 16, 2, 1, 192
# (slot, base, count) per chunk: one at base 0, one past its count, one
# ending on a block edge (64), a pad chunk, one over slot 2's unmapped
# entry (position 70), short and full chunks deep in their slots
CHUNKS = [(0, 0, 8), (0, 8, 5), (1, 56, 8), (2, 0, 0), (2, 70, 3),
          (1, 130, 2), (0, 180, 8)]
PADS = [8 * i + r for i, (_, _, n) in enumerate(CHUNKS) for r in range(n, 8)]


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
    pool = rng.standard_normal((L, 2, nb, hk, bt, D)).astype(np.float32)
    cslot, cbase, cn = (np.array(col, np.int32) for col in zip(*CHUNKS))
    return q, pool, tables, cslot, cbase, cn


@functools.lru_cache(maxsize=None)
def _jax_flat(bt, group):
    return np.asarray(jax_flat(*map(jnp.asarray, _flat_inputs(bt, group)),
                               LAYER))


def _flat_args(bt, group, dtype=torch.float32):
    q, pool, *rest = map(torch.from_numpy, _flat_inputs(bt, group))
    return (q.to(dtype), pool.to(dtype), *rest, LAYER)


# each case loops over the split counts; the two cover Bt 16 and 64,
# groups 1 and 2
@pytest.mark.parametrize("bt, group", [(16, 2), (64, 1)])
def test_flat_split_reference_matches_jax(bt, group):
    want = _jax_flat(bt, group)
    for splits in (1, 2, 3, 5):
        got = da.decode_attention_paged_flat_split_reference(
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
def test_flat_split_reference_in_16_bits(dtype, tname):
    args = _flat_args(64, 2, dtype)
    want = da.decode_attention_paged_flat_reference(*args)
    got = da.decode_attention_paged_flat_split_reference(*args, splits=5)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[tname])
    assert not got[PADS].any()


def test_flat_design_and_ranges():
    """The fp flat stream takes paged_path's design, its ranges
    decode_splits' over T / 8 chunks (one range on a CPU tensor or the
    per-head design); the ranges cover every position of a slot's table
    once, and S is 1 where the chunks' blocks already fill a wave."""
    assert set(da.PATH_LAUNCHES["decode_attention_paged_flat"]) == {
        "split_kv", "per_head"}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in (40, 64, 100):
            want = ("split_kv" if dtype != torch.float32 and d % 8 == 0
                    else "per_head")
            assert da.paged_path(dtype, d) == want
            q = torch.zeros(16, 8, 12, d, dtype=dtype)  # T = 128 as chunks
            assert da._range_splits(q, 12, 1024) == (want, 1, 1024)
    for chunks, hk, n_pos in ((16, 12, 1024), (2, 4, 2048), (10, 1, 4096),
                              (1, 2, 64), (7, 3, 1000)):
        s, span = da.decode_splits(chunks, hk, n_pos, 132)
        assert span % 64 == 0 and s == -(-n_pos // span)
        covered = [p for i in range(s)
                   for p in range(i * span, min((i + 1) * span, n_pos))]
        assert covered == list(range(n_pos))
    # the main flat shape: 16 chunks x 12 heads, six ranges of 192; 88
    # chunks x 12 heads fill a wave of 8 blocks on each of 132 SMs
    assert da.decode_splits(16, 12, 1024, 132) == (6, 192)
    assert da.decode_splits(88, 12, 1024, 132) == (1, 1024)


# ------------------------------------------------------------------ RMSNorm
@pytest.mark.parametrize("dtype, d, aligned, want", [
    (torch.bfloat16, 4096, True, "row_block"),   # LLaMA-2 7B
    (torch.float16, 4096, True, "row_block"),
    (torch.bfloat16, 1024, True, "row_block"),   # 128 vectors
    (torch.float32, 2048, True, "row_block"),    # 512 vectors
    (torch.bfloat16, 4096, False, "per_warp"),   # a misaligned tensor
    (torch.float32, 4096, True, "per_warp"),     # 1024 vectors
    (torch.bfloat16, 4097, True, "per_warp"),    # not whole vectors
    (torch.bfloat16, 5120, True, "per_warp"),    # 640 vectors
    (torch.bfloat16, 64, True, "per_warp"),
    (torch.bfloat16, 16384, True, "per_warp"),
])
def test_rms_norm_path(dtype, d, aligned, want):
    assert ln.rms_norm_path(dtype, d, aligned) == want


def test_row_block_bound_matches_the_kernel():
    """The rule's widest row is the kernel's: kMaxNv vectors a thread of
    kThreads (csrc/row_block.cuh)."""
    text = (_build.CSRC / "row_block.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kThreads|kMaxNv) = (\d+);", text)}
    assert ln._ROW_BLOCK_VECTORS[1] == consts["kThreads"] * consts["kMaxNv"]


@pytest.mark.parametrize("n", [1, 7, 4096, 4097])
def test_rms_partials_cover_every_row_once(n):
    """Each design's blocks: the row-block grid is never more than the
    rows and fills _ROW_BLOCKS_PER_SM blocks an SM when it can; every row
    lies in exactly one dgamma partial, one partial a block."""
    for path in ("row_block", "per_warp"):
        blocks = ln.rms_norm_blocks("rms_norm_bwd", n, path, 132)
        parts = ln.rms_bwd_partials(n, path, 132)
        assert len(parts) == blocks >= 1
        assert sorted(r for p in parts for r in p) == list(range(n))
        assert all(len(p) for p in parts)
    for name in ("rms_norm_fwd", "rms_norm_bwd"):
        assert ln.rms_norm_blocks(name, n, "row_block", 132) == min(
            n, ln._ROW_BLOCKS_PER_SM[name] * 132)
    assert ln.rms_norm_blocks("rms_norm_fwd", n, "per_warp", 132) == \
        -(-n // 8)
    assert ln.rms_norm_blocks("rms_norm_bwd", n, "per_warp", 132) == \
        -(-n // ln.ROWS_PER_PARTIAL)


def test_cpu_tensors_count_no_launch():
    """The wrappers compute the plain versions on CPU tensors: no launch
    and no design is counted."""
    before = copy.deepcopy((da.LAUNCHES, da.PATH_LAUNCHES, ln.LAUNCHES,
                            ln.PATH_LAUNCHES))
    args = _flat_args(64, 1, torch.bfloat16)
    da.decode_attention_paged_flat(*args)
    x = torch.ones(7, 4096, dtype=torch.bfloat16)
    gamma = torch.ones(4096, dtype=torch.bfloat16)
    y, rstd = ln.rms_norm_fwd(x, gamma)
    ln.rms_norm_bwd(x, gamma, rstd, y)
    assert (da.LAUNCHES, da.PATH_LAUNCHES, ln.LAUNCHES,
            ln.PATH_LAUNCHES) == before
