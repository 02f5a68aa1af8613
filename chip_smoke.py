#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:
  1. print the card, build every kernel from the sources in this checkout;
  2. each kernel against its plain PyTorch version on the card (bf16 and
     fp32 with TF32 off; ragged lengths, sentinel table entries, GQA,
     several block sizes, a layer index > 0);
  3. the serving engine at GPT-2-124M width (E=768, H=12, FF=3072, L=12,
     V=50304, pre-LN, gelu, bf16, random weights from --seed) serves 16
     greedy requests through the paged pool and the token-budget
     scheduler; kernel launch counts are zeroed just before and read
     just after, and both kernel forms (Sq=16 block, Sq=1 decode) must
     have run;
  4. the same engine at L=2, fp32, on the card and on the CPU (plain
     attention there): greedy tokens must be identical;
  5. kernel timing at the engine's decode shape beside its bound, the
     plain version and SDPA on a pre-gathered dense view.
The last two lines are the card from nvidia-smi and
{"ok": true, "device": {...}}. Needs one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference import FusedDecoder, ServingEngine
from paddle_tpu_torch.inference.paged_kv import BlockPool
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.profile_serving import E, FF, H, V, gpt2_workload
from paddle_tpu_torch.weights import from_jax_state, random_state

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak
BF16_FLOPS_PER_S = 989e12


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def attention_case(rng, *, b, h, hk, sq, d, bt, nblk, n_layers,
                   layer, lens, dtype, sentinel_inside=False):
    """Random q, pool and tables: each row maps the blocks its lens + sq
    positions need (in shuffled order) and holds the sentinel NB past
    them; with sentinel_inside, row 1 also leaves one needed entry
    unmapped, which reads block NB - 1."""
    nb = b * nblk + 1
    perm = rng.permutation(nb)
    tables = np.full((b, nblk), nb, np.int32)
    k = 0
    for r in range(b):
        need = min((lens[r] + sq - 1) // bt + 1, nblk)
        tables[r, :need] = perm[k:k + need]
        k += need
    if sentinel_inside:
        tables[1, 0] = nb
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    qt = torch.randn((b, h, sq, d), generator=gen, device=dev)
    pool = torch.randn((n_layers, 2, nb, hk, bt, d), generator=gen,
                       device=dev)
    return (qt.to(dtype), pool.to(dtype), torch.from_numpy(tables).to(dev),
            layer, torch.tensor(lens, dtype=torch.int32, device=dev))


def phase_kernels(rng):
    log("== phase 2: kernel vs plain version on the card")
    worst = {}
    for dtype, tname in ((torch.bfloat16, "attention_bf16"),
                         (torch.float32, "attention_fp32")):
        for sq in (1, 16):
            for group in (1, 2):
                for bt in (16, 64):
                    # lens: empty row, row ending exactly on a block edge,
                    # ragged rows
                    lens = [0, 3 * bt - sq, 5 * bt + 7, 2 * bt + 1]
                    args = attention_case(
                        rng, b=4, h=4, hk=4 // group, sq=sq, d=64,
                        bt=bt, nblk=8, n_layers=2, layer=1, lens=lens,
                        dtype=dtype, sentinel_inside=True)
                    got = da.decode_attention_paged(*args)
                    want = da.decode_attention_paged_reference(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    tol = TOLERANCES[tname]
                    ok = torch.allclose(got.float(), want.float(), **tol)
                    log(f"  {str(dtype):15s} Sq={sq:2d} group={group} "
                        f"Bt={bt:2d}: max_abs_err={err:.3e} "
                        f"(atol={tol['atol']}, rtol={tol['rtol']}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit("kernel disagrees with its plain "
                                         "version")
                    worst[tname] = max(worst.get(tname, 0.0), err)
    return worst


def serve(eng, reqs):
    """Submit (prompt, max_new) pairs, run to the end; returns
    ({rid: tokens}, steps, seconds)."""
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    steps = 0
    t0 = time.perf_counter()
    while eng.has_work:
        eng.step()
        steps += 1
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {r: eng.results[r]["tokens"] for r in rids}, steps, dt


def phase_engine(seed):
    log("== phase 3: ServingEngine at GPT-2-124M width, bf16, L=12")
    fresh, reqs = gpt2_workload(seed)
    forms = collections.Counter()
    kernel = da.decode_attention_paged

    def spy(qt, *a, **k):
        forms[qt.shape[2]] += 1
        return kernel(qt, *a, **k)
    torch.cuda.reset_peak_memory_stats()
    da.decode_attention_paged = spy
    for name in da.LAUNCHES:
        da.LAUNCHES[name] = 0
    try:
        out, steps, dt = serve(fresh, reqs)
    finally:
        da.decode_attention_paged = kernel
    launches = dict(da.LAUNCHES)
    m = fresh.metrics()
    for (p, want), (rid, toks) in zip(reqs, out.items()):
        if len(toks) != want:
            raise SystemExit(f"request {rid} emitted {len(toks)} of {want}")
    if m["kv_blocks_used"] + m["kv_blocks_free"] != m["kv_blocks_total"]:
        raise SystemExit(f"kv block accounting broke: {m}")
    if not forms.get(16) or not forms.get(1):
        raise SystemExit(f"kernel forms launched: {dict(forms)}; need "
                         "both Sq=16 and Sq=1")
    if not launches["decode_attention_paged"]:
        raise SystemExit("decode_attention_paged never launched")
    n_prompt = sum(len(p) for p, _ in reqs)
    n_new = sum(w for _, w in reqs)
    log(f"  {len(reqs)} requests, {n_prompt} prompt tokens, {n_new} "
        f"generated, {steps} steps in {dt:.3f} s")
    log(f"  generated tokens/s {n_new / dt:.1f}; engine tokens_per_sec "
        f"{m['tokens_per_sec']}; mean step {1e3 * dt / steps:.2f} ms")
    log(f"  TTFT p50 {m['ttft_p50_s']:.4f} s, p99 {m['ttft_p99_s']:.4f} s; "
        f"latency p50 {m['latency_p50_s']:.4f} s")
    log(f"  budget steps {m['budget_steps']}, utilization "
        f"{m['budget_utilization']}, kernel forms {dict(forms)}, "
        f"launches {launches}")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return launches


def first_gap_margin(mods_cpu, prompt, prefix):
    """Top-2 logit margin of the CPU model after prompt + prefix (the
    context at the first differing token), through a fresh pool."""
    ctx = np.concatenate([prompt, np.asarray(prefix, np.int64)])
    dec = FusedDecoder(*mods_cpu, max_seq_len=len(ctx) + 1, device="cpu")
    pool = BlockPool(dec.smax // 64, 64, dec.smax)
    caches = dec.init_paged_cache(pool)
    caches["tbl"] = torch.arange(pool.num_blocks, dtype=torch.int32)[None]
    toks = torch.from_numpy(ctx)[None]
    for c0 in range(0, toks.shape[1], 128):   # the kernel's Sq limit
        part = toks[:, c0:c0 + 128]
        x = dec.spec_hidden(dec._stacked(), caches, part,
                            torch.full((1,), c0, dtype=torch.int64),
                            torch.ones_like(part, dtype=torch.bool))
    top = dec.head_logits(x[:, -1]).float().topk(2).values[0]
    return float(top[0] - top[1])


def phase_parity(seed):
    log("== phase 4: card vs CPU at L=2, full width, fp32 (TF32 off)")
    rng = np.random.default_rng(seed + 1)
    state = random_state(rng, E, H, FF, 2, V)
    reqs = [(rng.integers(0, V, int(rng.integers(20, 201))),
             int(rng.integers(12, 25))) for _ in range(6)]
    outs = {}
    for dev in ("cuda", "cpu"):
        mods = from_jax_state(*state, device=dev, dtype=torch.float32)
        eng = ServingEngine(*mods, num_slots=8, max_seq_len=1024,
                            device=dev)
        t0 = time.perf_counter()
        outs[dev] = list(serve(eng, reqs)[0].values())
        log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        if not np.array_equal(a, b):
            j = int(np.argmax(a != b)) if len(a) == len(b) else min(
                len(a), len(b))
            mods = from_jax_state(*state, device="cpu", dtype=torch.float32)
            margin = first_gap_margin(mods, reqs[i][0], b[:j])
            raise SystemExit(
                f"request {i}: card and CPU tokens differ at index {j} "
                f"({a[j:j + 4]} vs {b[j:j + 4]}); CPU top-2 logit margin "
                f"there {margin:.3e}")
    log(f"  {len(reqs)} requests, {sum(len(t) for t in outs['cpu'])} "
        "tokens: identical")


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing(seed):
    log("== phase 5: kernel timing at the engine's decode shape "
        "(B=8, H=12, D=64, Bt=64, bf16)")
    rng = np.random.default_rng(seed + 2)
    b, h, d, bt, nblk, n_layers = 8, H, E // H, 64, 32, 12
    rows = []
    for ln in (512, 1024):
        for sq in (1, 16):
            args = attention_case(rng, b=b, h=h, hk=h, sq=sq, d=d,
                                  bt=bt, nblk=nblk, n_layers=n_layers,
                                  layer=0, lens=[ln] * b,
                                  dtype=torch.bfloat16)
            qt, pool, tables, _, lens = args
            # cycle the layer so each launch reads blocks another layer
            # left cold (12 layers of KV exceed the 50 MB L2)
            def run_kernel(i=0):
                return da.decode_attention_paged(qt, pool, tables,
                                                 i % n_layers, lens)

            def run_plain(i=0):
                return da.decode_attention_paged_reference(
                    qt, pool, tables, i % n_layers, lens)
            got = da.decode_attention_paged(*args).float()
            want = da.decode_attention_paged_reference(*args).float()
            err = (got - want).abs().max().item()
            tol = TOLERANCES["attention_bf16"]
            if not torch.allclose(got, want, **tol):
                raise SystemExit(
                    f"kernel disagrees with its plain version at cache_lens "
                    f"{ln}, Sq {sq}: max_abs_err {err:.3e} (atol "
                    f"{tol['atol']}, rtol {tol['rtol']})")
            ms = time_ms(run_kernel, 200)
            plain_ms = time_ms(run_plain, 20)
            # SDPA over the row's gathered prefix, gather not timed
            s = ln + sq
            kv = pool[:, :, tables[0, :(s - 1) // bt + 1].long()]
            kv = kv.permute(0, 1, 3, 2, 4, 5).reshape(
                n_layers, 2, h, -1, d)[..., :s, :].unsqueeze(2).expand(
                -1, -1, b, -1, -1, -1).contiguous()
            mask = (torch.arange(s, device="cuda")[None, :]
                    <= ln + torch.arange(sq, device="cuda")[:, None])

            def run_sdpa(i=0):
                kk = kv[i % n_layers]
                return F.scaled_dot_product_attention(
                    qt, kk[0], kk[1], attn_mask=mask)
            library_ms = time_ms(run_sdpa, 200)
            elt = 2
            nbytes = (b * h * s * d * 2 * elt          # K and V read once
                      + 2 * b * h * sq * d * elt       # q in, out
                      + tables.numel() * 4 + b * 4)
            flops = 4 * d * b * h * sum(ln + r + 1 for r in range(sq))
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / BF16_FLOPS_PER_S)
            row = {"cache_lens": ln, "sq": sq, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                >= flops / BF16_FLOPS_PER_S
                                else "operations"),
                   "library_ms": library_ms}
            log("  " + json.dumps(row))
            rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: card and kernel build")
    card = card_line()
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"  built {sorted(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log(f"  [{name}] {ln.strip()}")

    rng = np.random.default_rng(args.seed)
    worst = phase_kernels(rng)
    launches = phase_engine(args.seed)
    phase_parity(args.seed)
    rows = phase_timing(args.seed)

    main_row = next(r for r in rows if r["cache_lens"] == 1024
                    and r["sq"] == 1)
    # the error over every main-path shape, each checked in phase 5
    main_row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    log(f"  worst phase-2 errors: {worst}")
    kernels = [{
        "name": "decode_attention_paged", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/decode_attention_paged.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:1027",
        "launches": launches["decode_attention_paged"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
