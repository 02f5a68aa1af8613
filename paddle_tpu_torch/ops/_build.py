"""Builds the port's CUDA kernels into plain-C shared libraries.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into ``paddle_tpu_torch/_build/lib<name>-<hash>.so`` the first time it is
needed, and loaded with ``ctypes``. The file name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel is rebuilt and a stale library is never loaded. The build needs the CUDA toolkit (``nvcc`` on ``PATH`` or
under ``/usr/local/cuda``) and nothing else: no ``ninja``, no PyTorch
headers. A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = {"decode_attention_paged": "decode_attention_paged.cu",
           "decode_attention_paged_flat": "decode_attention_paged_flat.cu",
           "flash_attention_fwd": "flash_attention_fwd.cu",
           "decode_attention_paged_i8": "decode_attention_paged_i8.cu",
           "decode_attention_paged_flat_i8":
               "decode_attention_paged_flat_i8.cu",
           "fused_dequant_matmul": "fused_dequant_matmul.cu",
           "decode_attention_stacked": "decode_attention_stacked.cu",
           "decode_attention_stacked_i8": "decode_attention_stacked_i8.cu",
           "decode_attention_stacked_write":
               "decode_attention_stacked_write.cu",
           "decode_attention_stacked_i8_write":
               "decode_attention_stacked_i8_write.cu",
           "flash_attention_bwd_dkv": "flash_attention_bwd_dkv.cu",
           "flash_attention_bwd_dq": "flash_attention_bwd_dq.cu",
           "layer_norm_fwd": "layer_norm_fwd.cu",
           "layer_norm_bwd": "layer_norm_bwd.cu",
           "fused_ffn_fwd": "fused_ffn_fwd.cu",
           "fused_ffn_bwd_dx": "fused_ffn_bwd_dx.cu",
           "fused_ffn_bwd_dw": "fused_ffn_bwd_dw.cu",
           "decode_attention_bhsd": "decode_attention_bhsd.cu",
           "rms_norm_fwd": "rms_norm_fwd.cu",
           "rms_norm_bwd": "rms_norm_bwd.cu",
           "ring_chunk_attention_fwd": "ring_chunk_attention_fwd.cu",
           "ring_chunk_attention_bwd_dkv":
               "ring_chunk_attention_bwd_dkv.cu",
           "ring_chunk_attention_bwd_dq": "ring_chunk_attention_bwd_dq.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# argtypes of each library's entry point: every pointer and the stream
# go as c_void_p (a plain int would be cut to 32 bits); dropout's seed
# words and threshold as c_uint32
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint32
# the attention kernels' dropout arguments: on/off, seed low and high
# words, keep threshold, 1 / (1 - p)
_DROP = [_I, _U, _U, _U, _F]
_ENTRY = {
    # the paged kernel: pointers (the split workspace last), B, H, Sq, D,
    # NB, Hk, Bt, nblk, the layer, the splits and table blocks a split,
    # the scale, the dtype code and the design (paged_path's)
    "decode_attention_paged": (
        "paddle_decode_attention_paged",
        [_P] * 6 + [_I] * 11 + [_F, _I, _I, _P]),
    # the flat streams: pointers (the split workspace last), the shape
    # ints, the layer, the splits and positions a split, the scale, the
    # dtype code and the design (paged_path's)
    "decode_attention_paged_flat": (
        "paddle_decode_attention_paged_flat",
        [_P] * 8 + [_I] * 11 + [_F, _I, _I, _P]),
    "flash_attention_fwd": (
        "paddle_flash_attention_fwd",
        [_P] * 5 + [_I] * 7 + [_F, _I, _I] + _DROP + [_P]),
    # the int8 reads: pointers (the split workspace last), the shape ints,
    # the layer, the splits and positions a split, the scale, the dtype
    # code and the design (paged_path's)
    "decode_attention_paged_i8": (
        "paddle_decode_attention_paged_i8",
        [_P] * 7 + [_I] * 11 + [_F, _I, _I, _P]),
    "decode_attention_paged_flat_i8": (
        "paddle_decode_attention_paged_flat_i8",
        [_P] * 9 + [_I] * 11 + [_F, _I, _I, _P]),
    # the dequant-matmul: pointers (the fma design's split workspace before
    # the output), M, K2, O, the orientation, the rows a block, the splits
    # and packed rows a split, the activation and output dtype codes and
    # the design (dequant_path's)
    "fused_dequant_matmul": (
        "paddle_fused_dequant_matmul",
        [_P] * 5 + [_I] * 10 + [_P]),
    # the fp ring: pointers (the split workspace last), the shape ints,
    # the layer, the splits and positions a split, the scale, the dtype
    # code and the design (paged_path's)
    "decode_attention_stacked": (
        "paddle_decode_attention_stacked",
        [_P] * 5 + [_I] * 9 + [_F, _I, _I, _P]),
    "decode_attention_stacked_i8": (
        "paddle_decode_attention_stacked_i8",
        [_P] * 6 + [_I] * 9 + [_F, _I, _I, _P]),
    # the fused writes: pointers (the split workspace last), the shape
    # ints, the layer, the splits and positions a split, the scale, the
    # dtype code and the design (paged_path's)
    "decode_attention_stacked_write": (
        "paddle_decode_attention_stacked_write",
        [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P]),
    "decode_attention_stacked_i8_write": (
        "paddle_decode_attention_stacked_i8_write",
        [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P]),
    "flash_attention_bwd_dkv": (
        "paddle_flash_attention_bwd_dkv",
        [_P] * 8 + [_I] * 7 + [_F, _I, _I] + _DROP + [_P]),
    "flash_attention_bwd_dq": (
        "paddle_flash_attention_bwd_dq",
        [_P] * 7 + [_I] * 7 + [_F, _I, _I] + _DROP + [_P]),
    "layer_norm_fwd": (
        "paddle_layer_norm_fwd", [_P] * 6 + [_I, _I, _F, _I, _P]),
    # the LayerNorm backward: pointers, N, D, the dtype code, the design
    # and its block count (layer_norm.layer_norm_path, layer_norm_blocks)
    "layer_norm_bwd": (
        "paddle_layer_norm_bwd", [_P] * 8 + [_I] * 5 + [_P]),
    # the fused FFN: pointers, then M, K, F, the block's K columns (BN),
    # the F or row ranges, the activation and the dtype codes, the design
    # (1 = tensor cores)
    "fused_ffn_fwd": (
        "paddle_fused_ffn_fwd", [_P] * 6 + [_I] * 8 + [_P]),
    "fused_ffn_bwd_dx": (
        "paddle_fused_ffn_bwd_dx", [_P] * 6 + [_I] * 8 + [_P]),
    "fused_ffn_bwd_dw": (
        "paddle_fused_ffn_bwd_dw", [_P] * 8 + [_I] * 8 + [_P]),
    # the one-layer cache: pointers (the split workspace last), the shape
    # ints, the splits and positions a split, the scale, the dtype code and
    # the design (paged_path's)
    "decode_attention_bhsd": (
        "paddle_decode_attention_bhsd",
        [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P]),
    # RMSNorm: pointers, N, D (the forward's eps), the dtype code, the
    # design and its block count (layer_norm.rms_norm_path, rms_norm_blocks)
    "rms_norm_fwd": (
        "paddle_rms_norm_fwd", [_P] * 4 + [_I, _I, _F, _I, _I, _I, _P]),
    "rms_norm_bwd": (
        "paddle_rms_norm_bwd", [_P] * 7 + [_I] * 5 + [_P]),
    # the ring chunk: pointers, B, H, Hk, Sq, Sk, D, the diagonal offset,
    # the scale, the dtype code and the design (1 = tensor cores)
    "ring_chunk_attention_fwd": (
        "paddle_ring_chunk_attention_fwd",
        [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P]),
    "ring_chunk_attention_bwd_dkv": (
        "paddle_ring_chunk_attention_bwd_dkv",
        [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P]),
    "ring_chunk_attention_bwd_dq": (
        "paddle_ring_chunk_attention_bwd_dq",
        [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P]),
    # a second entry of flash_attention_fwd's library: the keep bits its
    # dropout draws, for checks against the plain version
    "flash_dropout_mask": (
        "paddle_flash_dropout_mask", [_P] + [_I] * 4 + [_U] * 3 + [_P]),
    # second entries of the fused FFN libraries: how many of their
    # tensor-core clusters the card holds (K, BN, the dtype code)
    "fused_ffn_fwd_slots": ("paddle_fused_ffn_fwd_slots", [_I] * 3),
    "fused_ffn_bwd_dx_slots": ("paddle_fused_ffn_bwd_dx_slots", [_I] * 3),
    "fused_ffn_bwd_dw_slots": ("paddle_fused_ffn_bwd_dw_slots", [_I] * 3),
}
# entries that live in another entry's library
_LIBRARY = {"flash_dropout_mask": "flash_attention_fwd",
            "fused_ffn_fwd_slots": "fused_ffn_fwd",
            "fused_ffn_bwd_dx_slots": "fused_ffn_bwd_dx",
            "fused_ffn_bwd_dw_slots": "fused_ffn_bwd_dw"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together. Returns ``{name: compiler log}`` for the
    kernels compiled by this call (ptxas register and shared-memory
    report); raises RuntimeError naming the kernel on a failed build."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The kernel's C entry point, building its library first if needed."""
    lib_name = _LIBRARY.get(name, name)
    build_all([lib_name])
    lib = ctypes.CDLL(str(_lib_path(lib_name)))
    symbol, argtypes = _ENTRY[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
