"""The port's kernel table and the flash kernels' design dispatch, on the CPU.

- Every entry of ``ops/_build._ENTRY`` names an ``extern "C"`` function
  of its library's ``.cu`` with exactly as many parameters as its ctypes
  ``argtypes``: a missing argtype would cut a pointer on the card without
  an error.
- ``flash_attention.kernel_path``, the flash and ring chunk wrappers'
  one statement of the design rule (the C entry points run the design it
  names or fail), sends bf16 and fp16 at D 64 and 128 to the tensor-core
  kernels and everything else to the fp32-core ones.
- CPU tensors take the plain versions: no launch and no path is counted.
- ``fused_ffn.kernel_path``, the fused FFN wrappers' statement of the
  same rule, sends bf16 and fp16 to the tensor-core forward, dx and dW
  kernels and fp32 to the fp32-core ones; ``_launch`` refuses any other
  path before it touches a device; the tensor-core blocks' columns, the
  forward's and dx's F ranges and the dW kernel's row ranges follow their
  stated rules.
- ``decode_attention.paged_path`` and the paged kernel's split rule are
  tested in ``test_torch_split_decode.py``.
"""
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ffn as ffn
from paddle_tpu_torch.ops import ring_chunk_attention as rca

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)


def _c_params(source, symbol):
    """The parameter list of ``extern "C" int symbol(...)`` in a .cu."""
    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + re.escape(symbol) + r"\((.*?)\)\s*\{",
                  text, re.S)
    assert m, f"{source} defines no extern \"C\" int {symbol}(...)"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(_build._ENTRY))
def test_entry_matches_its_c_function(name):
    symbol, argtypes = _build._ENTRY[name]
    source = _build.SOURCES[_build._LIBRARY.get(name, name)]
    params = _c_params(source, symbol)
    assert len(params) == len(argtypes), (name, params, argtypes)
    for param, argtype in zip(params, argtypes):
        pointer = "*" in param
        assert pointer == (argtype is _build._P), (name, param, argtype)


def test_every_library_has_an_entry():
    assert set(_build.SOURCES) <= set(_build._ENTRY)
    assert set(_build._LIBRARY.values()) <= set(_build.SOURCES)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [32, 48, 64, 96, 128, 256])
def test_kernel_path(dtype, d):
    want = ("tc" if dtype != torch.float32 and d in (64, 128)
            else "fp32_cores")
    assert fa.kernel_path(dtype, d) == want


def _flash_inputs(dtype, d, sq=37, sk=70, group=2):
    rng = np.random.default_rng(d)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, sq, d)))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 4 // group, sk, d)))
            .to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_cpu_tensors_count_no_launch(dtype, d):
    q, k, v, do = _flash_inputs(dtype, d)
    before = [dict(c) for c in (fa.LAUNCHES, fa.PATH_LAUNCHES, rca.LAUNCHES,
                                rca.PATH_LAUNCHES)]
    o, lse = fa.flash_attention_fwd(q, k, v, True, None, 0.1, 5)
    fa.flash_attention_bwd(q, k, v, o, lse, do, True, None, 0.1, 5)
    o, lse = rca.ring_chunk_attention_fwd(q, k, v, 3)
    delta = (do.float() * o.float()).sum(-1)
    rca.ring_chunk_attention_bwd_dkv(q, k, v, do, lse, delta, 3)
    rca.ring_chunk_attention_bwd_dq(q, k, v, do, lse, delta, 3)
    after = [dict(c) for c in (fa.LAUNCHES, fa.PATH_LAUNCHES, rca.LAUNCHES,
                               rca.PATH_LAUNCHES)]
    assert after == before


# ---------------------------------------------------------------- fused FFN
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("k,f", [(128, 256), (768, 3072), (1024, 2816)])
def test_ffn_kernel_path(dtype, k, f):
    want = "fp32_cores" if dtype == torch.float32 else "tc"
    assert ffn.kernel_path(dtype, k, f) == want


def _ffn_inputs(dtype, m=24, k=128, f=256):
    rng = np.random.default_rng(m + k)
    x, g = (torch.from_numpy(rng.standard_normal((m, k))).to(dtype)
            for _ in range(2))
    w1 = torch.from_numpy(rng.standard_normal((k, f)) / k ** 0.5).to(dtype)
    w2 = torch.from_numpy(rng.standard_normal((f, k)) / f ** 0.5).to(dtype)
    b1 = torch.from_numpy(0.1 * rng.standard_normal(f)).to(dtype)
    b2 = torch.from_numpy(0.1 * rng.standard_normal(k)).to(dtype)
    return x, g, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_ffn_cpu_tensors_count_no_launch(dtype):
    x, g, w1, b1, w2, b2 = _ffn_inputs(dtype)
    before = [dict(c) for c in (ffn.LAUNCHES, ffn.PATH_LAUNCHES)]
    ffn.fused_ffn_fwd(x, w1, b1, w2, b2)
    ffn.fused_ffn_bwd_dx(x, g, w1, b1, w2)
    ffn.fused_ffn_bwd_dw(x, g, w1, b1, w2, "gelu")
    xr = x.clone().requires_grad_()
    ffn.fused_ffn(xr, w1, b1, w2, b2).float().sum().backward()
    assert [dict(c) for c in (ffn.LAUNCHES, ffn.PATH_LAUNCHES)] == before


@pytest.mark.parametrize("path", ["wmma", "TC", "fp32"])
def test_ffn_launch_refuses_an_unknown_path(path):
    x, g, w1, b1, w2, _ = _ffn_inputs(torch.bfloat16)
    dx = torch.empty_like(x)
    before = [dict(c) for c in (ffn.LAUNCHES, ffn.PATH_LAUNCHES)]
    with pytest.raises(ValueError, match="unknown kernel path"):
        ffn._launch("fused_ffn_bwd_dx", [x, g, w1, b1, w2, dx],
                    (24, 128, 256, 128), "gelu_tanh", x.dtype, path)
    assert [dict(c) for c in (ffn.LAUNCHES, ffn.PATH_LAUNCHES)] == before


@pytest.mark.parametrize("k,want", [(128, 128), (256, 256), (384, 128),
                                    (768, 256), (1024, 256)])
def test_ffn_tc_block_columns(k, want):
    # a tensor-core block's columns divide K and are at most 256 (two
    # m64n128 accumulators a warpgroup)
    assert ffn._tc_cols(k) == want and k % want == 0


@pytest.mark.parametrize("clusters,most,slots", [(64, 4, 39), (48, 8, 39),
                                                 (48, 8, 44), (1, 4, 39),
                                                 (8, 4, 39), (144, 3, 66)])
def test_ffn_split_rule(clusters, most, slots):
    # the fewest ranges whose clusters fill _TC_FILL of the card's
    # cluster slots in whole waves, else the best fill (the fewest ranges
    # on a tie)
    s = ffn._fill_splits(clusters, most, slots)

    def fill(n):
        return clusters * n / (-(-clusters * n // slots) * slots)
    counts = range(1, most + 1)
    good = [n for n in counts if fill(n) >= ffn._TC_FILL]
    if good:
        assert s == good[0]
    else:
        best = max(fill(n) for n in counts)
        assert s == min(n for n in counts if fill(n) == best)


def test_ffn_splits_at_gpt2_training_shape():
    # 39 clusters of three blocks on an H100 (its occupancy query): dx's
    # 64 row blocks in 3 F ranges, dW's 48 F tiles in 4 row ranges
    assert ffn._dx_splits_tc(8192, 768, 3072, 256, 39) == 3
    assert ffn._dw_splits_tc(8192, 768, 3072, 256, 39) == 4
    # no more ranges than 64-row steps (dW) or F tiles (dx)
    assert ffn._dw_splits_tc(8, 768, 3072, 256, 39) == 1
    assert ffn._dx_splits_tc(8, 128, 128, 128, 39) == 2


def test_ffn_fwd_splits():
    # the forward's clusters are dx's (one 128-row block's columns): 64
    # row blocks fill a wave of 39 cluster slots, so one range; fewer
    # clusters than slots take _fill_splits' count, no more ranges than
    # F tiles of 128
    assert ffn._fwd_splits_tc(8192, 768, 3072, 256, 39) == 1
    assert ffn._fwd_splits_tc(4992, 768, 3072, 256, 39) == 1
    assert ffn._fwd_splits_tc(4864, 768, 3072, 256, 39) == \
        ffn._fill_splits(38, 4, 39)
    assert ffn._fwd_splits_tc(8, 128, 128, 128, 39) == 1
    assert ffn._fwd_splits_tc(8, 128, 256, 128, 39) == 2
    assert ffn._fwd_splits_tc(136, 768, 3072, 256, 39) == 4
    for m, k, f in ((136, 768, 3072), (8192, 1024, 2816), (8, 128, 256)):
        s = ffn._fwd_splits_tc(m, k, f, ffn._tc_cols(k), 39)
        assert 1 <= s <= min(ffn._DX_TC_MAX_SPLITS, f // 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffn_forward_path_on_cpu_counts_nothing(dtype):
    x, _, w1, b1, w2, b2 = _ffn_inputs(dtype, m=8)
    before = [dict(c) for c in (ffn.LAUNCHES, ffn.PATH_LAUNCHES)]
    got = ffn.fused_ffn_fwd(x, w1, b1, w2, b2, "gelu")
    assert torch.equal(got, ffn.fused_ffn_fwd_reference(x, w1, b1, w2, b2,
                                                        "gelu"))
    assert [dict(c) for c in (ffn.LAUNCHES, ffn.PATH_LAUNCHES)] == before
