"""LayerNorm backward's row-warp design, on the CPU: the rule that picks
the design, its grid and partials, and the plain version of its partial
arithmetic against the JAX package. chip_smoke.py holds the kernel to the
plain versions on the card.

- ``layer_norm_path``: the row-warp design for bf16 and fp16 at GPT-2's
  D 768 when every tensor is 16-byte aligned; the per-warp one when one
  is not, at D 64 and 97, and past the range (bf16 D 1600, fp32 D 768);
  its bounds against csrc/layer_norm_bwd.cu's constants.
- ``layer_norm_blocks`` and ``ln_bwd_partials``: every row in exactly
  one partial for N 1, 7, 33, 8192 and 8193 at 132 SMs, on both designs.
- ``layer_norm_bwd_row_warp_reference``, dgamma and dbeta summed partial
  by partial in the kernel's order in fp32, against ``jax.grad`` through
  ``paddle_tpu.ops.pallas.layer_norm.layer_norm`` (interpret mode off-TPU,
  so JAX's ``_ln_vjp_bwd``), TOLERANCES["layer_norm_fp32"], N 1, 7 and 33,
  D 64 and 768, on 132 SMs and on one (several rows a warp).
- CPU tensors count no launch and no path.
"""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import layer_norm as jax_ln
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import layer_norm as ln

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["layer_norm_fp32"]


@pytest.mark.parametrize("dtype, d, aligned, want", [
    (torch.bfloat16, 768, True, "row_warp"),     # GPT-2, three vectors a lane
    (torch.float16, 768, True, "row_warp"),
    (torch.bfloat16, 256, True, "row_warp"),     # 32 vectors: a full warp
    (torch.bfloat16, 1024, True, "row_warp"),    # four vectors a lane
    (torch.float32, 512, True, "row_warp"),
    (torch.bfloat16, 768, False, "per_warp"),    # a misaligned tensor
    (torch.float16, 768, False, "per_warp"),
    (torch.bfloat16, 64, True, "per_warp"),      # 8 vectors
    (torch.bfloat16, 97, True, "per_warp"),      # not whole vectors
    (torch.float32, 97, True, "per_warp"),
    (torch.bfloat16, 248, True, "per_warp"),     # 31 vectors
    (torch.bfloat16, 1600, True, "per_warp"),    # past the range
    (torch.float32, 768, True, "per_warp"),      # 192 vectors
])
def test_layer_norm_path(dtype, d, aligned, want):
    assert ln.layer_norm_path(dtype, d, aligned) == want


def test_row_warp_bounds_match_the_kernel():
    """The rule's widest row, the warps a block and the partials' sum
    warps are the kernel's: kMaxLaneNv vectors a lane of 32, kWarps,
    kSumWarps (csrc/layer_norm_bwd.cu)."""
    text = (_build.CSRC / "layer_norm_bwd.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kWarps|kMaxLaneNv|kSumWarps|kRows) = (\d+);",
        text)}
    assert ln._ROW_WARP_VECTORS == (32, 32 * consts["kMaxLaneNv"])
    assert ln._ROW_WARPS == consts["kWarps"]
    assert ln._SUM_WARPS == consts["kSumWarps"]
    assert ln.ROWS_PER_PARTIAL == consts["kRows"]


@pytest.mark.parametrize("n", [1, 7, 33, 8192, 8193])
def test_ln_partials_cover_every_row_once(n):
    """Each design's blocks: the row-warp grid never has a block without
    a row and fills _ROW_BLOCKS_PER_SM blocks an SM when it can; every row
    lies in exactly one partial, one partial a block, a warp's rows in
    its walk order."""
    w = ln._ROW_WARPS
    for path in ("row_warp", "per_warp"):
        blocks = ln.layer_norm_blocks(n, path, 132)
        parts = ln.ln_bwd_partials(n, path, 132)
        assert len(parts) == blocks >= 1
        assert sorted(r for p in parts for r in p) == list(range(n))
        assert all(len(p) for p in parts)
    blocks = ln.layer_norm_blocks(n, "row_warp", 132)
    assert blocks == min(-(-n // w),
                         ln._ROW_BLOCKS_PER_SM["layer_norm_bwd"] * 132)
    first = ln.ln_bwd_partials(n, "row_warp", 132)[0]
    assert first[:len(range(0, n, blocks * w))] == list(
        range(0, n, blocks * w))
    assert ln.layer_norm_blocks(n, "per_warp", 132) == \
        -(-n // ln.ROWS_PER_PARTIAL)


def _inputs(seed, n, d):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return x, gamma, beta, dy


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("n", [1, 7, 33])
def test_row_warp_reference_matches_jax(n, d):
    """The row-warp design's partial-order arithmetic (on 132 SMs and on
    one, where a warp walks several rows and one block holds every
    partial) against JAX's gradient of its Pallas LayerNorm."""
    x, gamma, beta, dy = _inputs(n * 1000 + d, n, d)

    def loss(x, g, b):
        return jnp.sum(jax_ln.layer_norm(x, g, b, 1e-5) * jnp.asarray(dy))
    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (x, gamma, beta)))
    xt, gt, bt, dyt = map(torch.from_numpy, (x, gamma, beta, dy))
    _, mean, rstd = ln.layer_norm_fwd_reference(xt, gt, bt, 1e-5)
    for n_sm in (132, 1):
        got = ln.layer_norm_bwd_row_warp_reference(xt, gt, mean, rstd, dyt,
                                                   n_sm)
        for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{name} n_sm={n_sm}", **TOL)


def test_row_warp_reference_order():
    """The partial-order sums equal the plain sums to fp32 rounding on
    several grids, dx is the plain version's, and 16-bit inputs give
    gradients in their dtype."""
    x, gamma, beta, dy = _inputs(3, 300, 256)
    xt, gt, bt, dyt = map(torch.from_numpy, (x, gamma, beta, dy))
    _, mean, rstd = ln.layer_norm_fwd_reference(xt, gt, bt)
    plain = ln.layer_norm_bwd_reference(xt, gt, mean, rstd, dyt)
    for n_sm in (1, 3, 132):
        got = ln.layer_norm_bwd_row_warp_reference(xt, gt, mean, rstd, dyt,
                                                   n_sm)
        assert torch.equal(got[0], plain[0])
        for g, w in zip(got[1:], plain[1:]):
            torch.testing.assert_close(g, w, **TOL)
    got16 = ln.layer_norm_bwd_row_warp_reference(
        xt.bfloat16(), gt.bfloat16(), mean, rstd, dyt.bfloat16(), 2)
    assert all(t.dtype == torch.bfloat16 for t in got16)


def test_cpu_tensors_count_no_launch():
    """The wrappers compute the plain versions on CPU tensors: no launch
    and no design is counted, through the functions and autograd."""
    before = copy.deepcopy((ln.LAUNCHES, ln.PATH_LAUNCHES))
    x, gamma, beta, dy = (torch.from_numpy(a).bfloat16()
                          for a in _inputs(4, 7, 768))
    y, mean, rstd = ln.layer_norm_fwd(x, gamma, beta)
    got = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    want = ln.layer_norm_bwd_reference(x, gamma, mean, rstd, dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xg = x.float().requires_grad_()
    ln.layer_norm(xg, gamma.float(), beta.float()).sum().backward()
    assert (ln.LAUNCHES, ln.PATH_LAUNCHES) == before
