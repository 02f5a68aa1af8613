"""Times the norm kernels' two designs on the card, at the training
shapes, to choose the grids of their one-pass designs.

    python -m paddle_tpu_torch.profile_rms_norm [--norm rms|layer]

``--norm rms`` (the default): RMSNorm at LLaMA-2 7B's [4096, 4096] bf16
(phase 3f's), eps 1e-5: the per-warp design, the row-block design at
each of 1, 2, 3, 4, 6 and 8 blocks an SM
(``layer_norm._ROW_BLOCKS_PER_SM``, forward and backward alike), a
device copy of x (the bytes of the forward at the card's achievable
rate) and ATen's fused RMSNorm forward and backward.

``--norm layer``: the LayerNorm backward at GPT-2's [8192, 768] bf16
(phase 3c's): the per-warp design, the row-warp design at each of 1, 2,
3 and 4 blocks an SM (``_ROW_BLOCKS_PER_SM["layer_norm_bwd"]``; past one
the further blocks wait for registers), torch.add of x and dy (the
backward's bytes, two rows read and one written, at an elementwise
kernel's rate) and ATen's LayerNorm backward.

The launches are cycled over 8 inputs (past the 50 MB L2), each timed as
a CUDA-graph replay of 200 launches between two events, after one
untimed run that brings the card's clocks up. Prints the card and one
JSON object of ms; needs one card, imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from .ops import layer_norm as ln

N = D = 4096
# GPT-2's training rows (B 8 x S 1024) and width
LN_N, LN_D = 8192, 768
COPIES, REPS = 8, 200


def time_ms(fn):
    """Device ms per call: REPS calls of ``fn(i)`` captured in one CUDA
    graph and replayed between two events."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(REPS):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--norm", choices=("rms", "layer"), default="rms")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_rms_norm: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = (rms_sweep if args.norm == "rms" else layer_sweep)(gen)
    print(card)
    print(json.dumps(result))
    return 0


def rms_sweep(gen):
    n, d, eps = N, D, 1e-5
    xs, dys = ([torch.randn((n, d), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(COPIES)] for _ in range(2))
    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    rstds = [ln.rms_norm_fwd_reference(x, gamma, eps)[1] for x in xs]
    aten = [torch.ops.aten._fused_rms_norm(x, [d], gamma, eps)[1]
            for x in xs]
    y = torch.empty_like(xs[0])

    def fwd(i):
        return ln.rms_norm_fwd(xs[i % COPIES], gamma, eps)

    def bwd(i):
        return ln.rms_norm_bwd(xs[i % COPIES], gamma, rstds[i % COPIES],
                               dys[i % COPIES])

    time_ms(lambda i: y.copy_(xs[i % COPIES]))   # the card's clocks up
    ms = {}
    saved = ln.rms_norm_path, dict(ln._ROW_BLOCKS_PER_SM)
    try:
        ln.rms_norm_path = lambda *a: "per_warp"
        ms["per_warp"] = {"fwd": time_ms(fwd), "bwd": time_ms(bwd)}
        ln.rms_norm_path = lambda *a: "row_block"
        for k in (1, 2, 3, 4, 6, 8):
            ln._ROW_BLOCKS_PER_SM.update(rms_norm_fwd=k, rms_norm_bwd=k)
            ms[f"row_block x{k}"] = {"fwd": time_ms(fwd),
                                     "bwd": time_ms(bwd)}
    finally:
        ln.rms_norm_path = saved[0]
        ln._ROW_BLOCKS_PER_SM.update(saved[1])
    ms["copy x"] = time_ms(lambda i: y.copy_(xs[i % COPIES]))
    ms["aten"] = {
        "fwd": time_ms(lambda i: F.rms_norm(xs[i % COPIES], (d,), gamma,
                                            eps)),
        "bwd": time_ms(lambda i: torch.ops.aten._fused_rms_norm_backward(
            dys[i % COPIES], xs[i % COPIES], [d], aten[i % COPIES], gamma,
            [True, True]))}
    return {"norm": "rms", "rows": n, "dim": d, "dtype": "bfloat16",
            "ms": ms}


def layer_sweep(gen):
    n, d = LN_N, LN_D
    xs, dys = ([torch.randn((n, d), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(COPIES)] for _ in range(2))
    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    beta = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    stats = [ln.layer_norm_fwd_reference(x, gamma, beta)[1:] for x in xs]
    aten = [torch.ops.aten.native_layer_norm(x, [d], gamma, beta, 1e-5)[1:]
            for x in xs]
    out = torch.empty_like(xs[0])

    def bwd(i):
        return ln.layer_norm_bwd(xs[i % COPIES], gamma, *stats[i % COPIES],
                                 dys[i % COPIES])

    def add(i):
        return torch.add(xs[i % COPIES], dys[i % COPIES], out=out)

    time_ms(add)                                 # the card's clocks up
    ms = {}
    saved = ln.layer_norm_path, ln._ROW_BLOCKS_PER_SM["layer_norm_bwd"]
    try:
        ln.layer_norm_path = lambda *a: "per_warp"
        ms["per_warp"] = time_ms(bwd)
        ln.layer_norm_path = lambda *a: "row_warp"
        for k in (1, 2, 3, 4):
            ln._ROW_BLOCKS_PER_SM["layer_norm_bwd"] = k
            ms[f"row_warp x{k}"] = time_ms(bwd)
    finally:
        ln.layer_norm_path = saved[0]
        ln._ROW_BLOCKS_PER_SM["layer_norm_bwd"] = saved[1]
    ms["add x, dy"] = time_ms(add)
    ms["aten"] = time_ms(lambda i: torch.ops.aten.native_layer_norm_backward(
        dys[i % COPIES], xs[i % COPIES], [d], *aten[i % COPIES], gamma, beta,
        [True, True, True]))
    return {"norm": "layer", "rows": n, "dim": d, "dtype": "bfloat16",
            "ms": ms}


if __name__ == "__main__":
    sys.exit(main())
