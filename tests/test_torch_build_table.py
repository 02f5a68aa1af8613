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
"""
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ring_chunk_attention as rca


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
