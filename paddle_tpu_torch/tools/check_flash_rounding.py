"""Whether the flash kernels' gaps to their plain versions at the training
shapes are bf16 rounding flips, and whether ``rounding_bound`` still
refuses a kernel that skips a tile.

    python -m paddle_tpu_torch.tools.check_flash_rounding [--draws N]
        [--seed S] [--out PATH]

On the card, for ``--draws`` draws of random bf16 inputs at each main
flash shape of training (LLaMA-2 7B's causal [1, 32, 4096, 128] at
dropout 0, GPT-2's causal [8, 12, 1024, 64] at 0.1, BERT-base's
non-causal [16, 12, 512, 64] at 0.1 and 0; LLaMA's at four times the
draws), the forward kernel and the dK/dV and dQ kernels (from the
kernel's o and lse) against their plain versions. Each output is held two
ways: to the rms-only bound (``TOLERANCES``' atol times the plain
output's rms plus rtol times the element) and to
``flash_attention.rounding_bound`` (that plus one bf16 unit times the
element's terms).

At each element of dv, dk or dq past the rms-only bound it looks for a
witness. It takes the operands that the plain version rounds to bf16 for
that element's row (p m down a key's column for dv, ds for dk and dq) and
keeps those whose fp32 value lies within 2^-10 of a bf16 unit from a
rounding midpoint. It flips subsets of the ten that move the row most to
the other neighbour and recomputes the row in fp64. The subset that
brings the whole row (D elements sharing one rounding of each operand)
nearest the kernel's row is reported, with how many of its D elements
then equal the kernel's bf16 values.

Then, on the first draw of each shape, it removes each 64-row tile's terms
from the plain o, dv, dk and dq in turn (a kernel that skipped that query
or key tile) and counts the tiles that ``rounding_bound`` fails to refuse,
which must be none. Writes one JSON object to ``--out`` and prints a
summary; exits 1 when a tile goes unrefused. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import TOLERANCES
from ..ops import _build
from ..ops import flash_attention as fa

# (B, H, S, D, dropout, causal, draws relative to --draws)
CASES = ((1, 32, 4096, 128, 0.0, True, 4), (8, 12, 1024, 64, 0.1, True, 1),
         (16, 12, 512, 64, 0.1, False, 1), (16, 12, 512, 64, 0.0, False, 1))
TILE = 64
MIDPOINT = 2.0 ** -10   # a candidate's distance from a midpoint, in units
FLIPS = 10              # candidates tried in subsets (2^10 subsets)
OUTPUTS = ("o", "dq", "dk", "dv")


def randn(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def plain_operands(q, k, v, o, lse, do, causal, p, seed):
    """The plain backward's fp32 operands before their rounding to bf16,
    as ``_bwd_plain`` computes them: (p m, ds), each [B, H, Sq, Sk]."""
    scale = q.shape[-1] ** -0.5
    s, mask = fa._scores(q, k, fa._diagonal(causal, q.shape[2], k.shape[2]),
                         scale)
    pr = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    del s
    dm = fa._keep_scale(q, k, p, seed)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    if dm is not None:
        dp = dp * dm
    ds = pr * (dp - delta) * scale
    del dp
    return (pr if dm is None else pr * dm), ds


def witness(a32, rows, kernel_row, plain_row, rms):
    """The element's row is sum_n bf16(a32[n]) rows[n, :]. Flip subsets of
    the near-midpoint operands to their other bf16 neighbour and return
    the best subset's report (None when no operand lies near a
    midpoint). Runs on the host."""
    a32, rows, kernel_row, plain_row = (
        t.detach().cpu() for t in (a32, rows, kernel_row, plain_row))
    ab = a32.contiguous().to(torch.bfloat16)
    a, lo = a32.double(), ab.double()
    # the other bf16 neighbour of a: one step of the bits away from zero
    # when a lies past its rounding, else one step toward zero
    bits = ab.view(torch.int16).int()
    step = torch.where(a.abs() > lo.abs(), bits + 1, bits - 1)
    other = step.to(torch.int16).view(torch.bfloat16).double()
    unit = (other - lo).abs()
    mid = (lo + other) / 2
    near = ((a - mid).abs() <= MIDPOINT * unit) & (ab != 0)
    idx = near.nonzero().flatten()
    if idx.numel() == 0:
        return None
    r = rows.double()
    delta = (other - lo)[idx, None] * r[idx]
    top = delta.abs().amax(1).argsort(descending=True)[:FLIPS]
    idx, delta = idx[top], delta[top]
    base = (lo[:, None] * r).sum(0)
    kern = kernel_row.double()
    best = None
    for n in range(len(idx) + 1):
        for sub in itertools.combinations(range(len(idx)), n):
            row = base + delta[list(sub)].sum(0) if sub else base
            gap = (row.to(torch.bfloat16).double() - kern).abs().max().item()
            if best is None or gap < best[0]:
                best = (gap, sub, row)
    gap, sub, row = best
    return {
        "near_midpoint": int(near.sum()),
        "flipped": [{"index": int(idx[i]), "fp32": float(a32[idx[i]]),
                     "plain_bf16": float(lo[idx[i]]),
                     "flipped_to": float(other[idx[i]]),
                     "from_midpoint_units": float(
                         (a[idx[i]] - mid[idx[i]]).abs()
                         / unit[idx[i]])} for i in sub],
        "row_gap_rms_before": (plain_row.double() - kern).abs().max().item()
        / rms,
        "row_gap_rms_after": gap / rms,
        "row_equal_after": int((row.to(torch.bfloat16).double() == kern
                                ).sum()),
        "row_equal_before": int((plain_row.double() == kern).sum()),
        "row_len": int(kern.numel()),
    }


def hold(got, want, terms, tname):
    """(err in rms units, elements past the rms-only bound, worst share of
    rounding_bound)."""
    tol = TOLERANCES[tname]
    w = want.float()
    rms = w.pow(2).mean().sqrt().item()
    diff = (got.float() - w).abs()
    past = diff > tol["atol"] * rms + tol["rtol"] * w.abs()
    share = (diff / fa.rounding_bound(want, terms, **tol)).max().item()
    return diff.max().item() / rms, past, share, rms


def tile_drops(q, k, v, do, outs, terms, pd, ds):
    """Per output, the tiles whose removal from the plain output
    rounding_bound does not refuse."""
    sq, sk = q.shape[2], k.shape[2]
    o, dq, dk, dv = outs
    pb, dsb = pd.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    missed = {name: [] for name in OUTPUTS}
    for name, want, t, n, part in (
            ("o", o, terms[0], sk, lambda r: torch.einsum(
                "bhqk,bhkd->bhqd", pb[..., r], v[:, :, r].float())),
            ("dq", dq, terms[1], sk, lambda r: torch.einsum(
                "bhqk,bhkd->bhqd", dsb[..., r], k[:, :, r].float())),
            ("dk", dk, terms[2], sq, lambda r: torch.einsum(
                "bhqk,bhqd->bhkd", dsb[:, :, r], q[:, :, r].float())),
            ("dv", dv, terms[3], sq, lambda r: torch.einsum(
                "bhqk,bhqd->bhkd", pb[:, :, r], do[:, :, r].float()))):
        bound = fa.rounding_bound(want, t, **TOLERANCES[
            "attention_bf16" if name == "o" else "attention_grad_bf16"])
        for t0 in range(0, n, TILE):
            r = slice(t0, min(t0 + TILE, n))
            mut = (want.float() - part(r)).to(want.dtype).float()
            if not ((mut - want.float()).abs() > bound).any():
                missed[name].append(t0 // TILE)
    return missed


def run_case(gen, case, draws, log):
    b, h, s, d, p, causal, _ = case
    label = f"[{b}, {h}, {s}, {d}] p={p} causal={int(causal)}"
    out = {"shape": [b, h, s, d], "dropout": p, "causal": causal,
           "draws": []}
    for n in range(draws):
        q, k, v, do = (randn(gen, (b, h, s, d)) for _ in range(4))
        seed = int(torch.randint(0, 1 << 62, (1,), generator=gen,
                                 device="cuda").item())
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, p, seed)
        o_ref, _ = fa.flash_attention_reference(q, k, v, causal, None, p,
                                                seed)
        got = (o, *fa.flash_attention_bwd(q, k, v, o, lse, do, causal, None,
                                          p, seed))
        want = (o_ref, *fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal, None, p, seed))
        terms = fa.rounding_terms(q, k, v, o, lse, do, causal, None, p, seed)
        draw = {"outputs": {}}
        ops = None
        for i, name in enumerate(OUTPUTS):
            tname = "attention_bf16" if name == "o" else "attention_grad_bf16"
            err, past, share, rms = hold(got[i], want[i], terms[i], tname)
            rec = {"err_rms": err, "past_rms_bound": int(past.sum()),
                   "share_of_rounding_bound": share, "witnesses": []}
            if past.any() and name != "o":
                if ops is None:
                    ops = plain_operands(q, k, v, o, lse, do, causal, p,
                                         seed)
                pd, ds = ops
                for flat in past.flatten().nonzero().flatten()[:4].tolist():
                    bi, hi, ri, di = np.unravel_index(flat, got[i].shape)
                    if name == "dv":
                        a32, rows = pd[bi, hi, :, ri], do[bi, hi]
                    elif name == "dk":
                        a32, rows = ds[bi, hi, :, ri], q[bi, hi]
                    else:
                        a32, rows = ds[bi, hi, ri, :], k[bi, hi]
                    wit = witness(a32, rows.float(),
                                  got[i][bi, hi, ri].float(),
                                  want[i][bi, hi, ri].float(), rms)
                    rec["witnesses"].append({
                        "at": [int(bi), int(hi), int(ri), int(di)],
                        "kernel": float(got[i][bi, hi, ri, di]),
                        "plain": float(want[i][bi, hi, ri, di]),
                        "terms": float(terms[i][bi, hi, ri, di]),
                        "flip": wit})
            draw["outputs"][name] = rec
        if n == 0:
            if ops is None:
                ops = plain_operands(q, k, v, o, lse, do, causal, p, seed)
            draw["unrefused_tiles"] = tile_drops(q, k, v, do, want, terms,
                                                 *ops)
        out["draws"].append(draw)
        summary = {nm: (f"{r['err_rms']:.3f}/{r['past_rms_bound']}/"
                        f"{r['share_of_rounding_bound']:.3f}")
                   for nm, r in draw["outputs"].items()}
        log(f"{label} draw {n}: err rms / past rms bound / share {summary}"
            + (f"; unrefused tiles {draw['unrefused_tiles']}"
               if n == 0 else ""))
        del q, k, v, do, o, lse, o_ref, got, want, terms, ops
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/flash_rounding.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_flash_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    def log(msg):
        print(msg, flush=True)
    _build.build_all(["flash_attention_fwd", "flash_attention_bwd_dkv",
                      "flash_attention_bwd_dq"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    cases = [run_case(gen, c, args.draws * c[-1], log) for c in CASES]
    past = [(c["shape"], n, name, r) for c in cases
            for n, dr in enumerate(c["draws"])
            for name, r in dr["outputs"].items() if r["past_rms_bound"]]
    unrefused = {str(c["shape"]) + f" p={c['dropout']}":
                 c["draws"][0]["unrefused_tiles"] for c in cases}
    result = {"device": torch.cuda.get_device_name(0),
              "seconds": time.perf_counter() - t0,
              "outputs_past_rms_bound": len(past),
              "outputs_past_rounding_bound": sum(
                  r["share_of_rounding_bound"] > 1 for c in cases
                  for dr in c["draws"] for r in dr["outputs"].values()),
              "unrefused_tiles": unrefused, "cases": cases}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    log(json.dumps({k: v for k, v in result.items() if k != "cases"}))
    for shape, n, name, r in past:
        log(f"past the rms bound: {shape} draw {n} {name}: "
            + json.dumps(r["witnesses"]))
    missed = any(t for per in unrefused.values() for t in per.values())
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
