#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:
  1. print the card, build every kernel from the sources in this checkout
     (all nvcc processes started together);
  2. each kernel against its plain PyTorch version on the card (bf16 and
     fp32 with TF32 off): the paged kernel over ragged lengths, sentinel
     table entries, GQA, several block sizes and a layer index > 0; the
     flat kernel over pad chunks, unaligned chunk bases straddling a
     block edge and an unmapped entry; flash attention causal and not,
     sq < sk, GQA, S in {37, 255, 1000}, D in {64, 128}, lse included;
  3. the serving engine at GPT-2-124M width (E=768, H=12, FF=3072, L=12,
     V=50304, pre-LN, gelu, bf16, random weights from --seed) serves the
     same 16 greedy requests under each scheduler: the row-layout token
     budget, the flat token budget and the phase scheduler's bulk
     prefill. Kernel launch counts are zeroed just before each run and
     read just after; the row run must launch both paged forms (Sq=16
     block, Sq=1 decode), the flat run the flat and the paged kernel, the
     phase run flash attention and the paged kernel;
  4. the same engine at L=2, fp32, under the three schedulers on the card
     and the row scheduler on the CPU (plain attention there): greedy
     tokens must be identical;
  5. each kernel timed at the shapes its path gives it, beside its bound,
     its plain version and one PyTorch call (SDPA) computing the same.
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
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.profile_serving import (E, FF, H, SCHEDULERS, V,
                                              gpt2_workload)
from paddle_tpu_torch.weights import from_jax_state, random_state

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak
BF16_FLOPS_PER_S = 989e12
# (slot, base, count) per flat chunk: aligned, partial, an unaligned base
# straddling a block edge, a pad chunk, one over an unmapped entry (slot
# 2, position 21), deep chunks
FLAT_CASE = [(0, 0, 8), (0, 8, 5), (1, 13, 8), (2, 0, 0), (2, 21, 3),
             (1, 448, 8), (1, 456, 8), (0, 900, 2)]


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
    log("== phase 2: kernels vs plain versions on the card")
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
                    check(f"paged {str(dtype):15s} Sq={sq:2d} "
                          f"group={group} Bt={bt:2d}", got, want, tname,
                          worst)
    for dtype, tname in ((torch.bfloat16, "attention_bf16"),
                         (torch.float32, "attention_fp32")):
        for group in (1, 2):
            for bt in (16, 64):
                args = flat_case(rng, FLAT_CASE, h=4, hk=4 // group, d=64,
                                 bt=bt, nblk=1024 // bt, n_layers=2,
                                 layer=1, dtype=dtype, unmapped=(2, 21))
                got = da.decode_attention_paged_flat(*args)
                want = da.decode_attention_paged_flat_reference(*args)
                check(f"flat  {str(dtype):15s} group={group} Bt={bt:2d}",
                      got, want, tname, worst)
                pads = [8 * i + r for i, (_, _, n) in enumerate(FLAT_CASE)
                        for r in range(n, 8)]
                if got[pads].any():
                    raise SystemExit("flat kernel: pad rows are not 0")
        for d in (64, 128):
            for s, sk, group, causal in ((37, 37, 1, True),
                                         (255, 255, 2, True),
                                         (1000, 1000, 1, True),
                                         (255, 255, 1, False),
                                         (37, 1000, 2, True),
                                         (255, 1000, 1, False)):
                q, k, v = (randn(rng, (1, hh, n, d), dtype)
                           for hh, n in ((4, s), (4 // group, sk),
                                         (4 // group, sk)))
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
                o_ref, lse_ref = fa.flash_attention_reference(q, k, v,
                                                              causal)
                name = (f"flash {str(dtype):15s} D={d} Sq={s} Sk={sk} "
                        f"group={group} causal={int(causal)}")
                check(name, o, o_ref, tname, worst)
                check(name + " lse", lse, lse_ref, tname, worst)
    return worst


def check(name, got, want, tname, worst):
    """Fail unless got matches want within TOLERANCES[tname]."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOLERANCES[tname]
    ok = torch.allclose(got.float(), want.float(), **tol)
    log(f"  {name}: max_abs_err={err:.3e} (atol={tol['atol']}, "
        f"rtol={tol['rtol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    worst[tname] = max(worst.get(tname, 0.0), err)


def randn(rng, shape, dtype):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 31)))
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def flat_case(rng, chunks, *, h, hk, d, bt, nblk, n_layers, layer, dtype,
              unmapped=None):
    """Random q [8 * len(chunks), H, D], pool and tables for the flat
    kernel: every slot maps the blocks its chunks reach, in shuffled
    order; ``unmapped`` = (slot, position) leaves that entry at the
    sentinel, which reads block NB - 1."""
    nslots = max(c[0] for c in chunks) + 1
    top = [0] * nslots
    for s, base, n in chunks:
        top[s] = max(top[s], base + max(n, 1))
    nb = nslots * nblk + 1
    perm = rng.permutation(nb)
    tables = np.full((nslots, nblk), nb, np.int32)
    k = 0
    for s in range(nslots):
        need = min(-(-top[s] // bt), nblk)
        tables[s, :need] = perm[k:k + need]
        k += need
    if unmapped is not None:
        tables[unmapped[0], unmapped[1] // bt] = nb
    meta = (torch.tensor(col, dtype=torch.int32, device="cuda")
            for col in zip(*chunks))
    return (randn(rng, (8 * len(chunks), h, d), dtype),
            randn(rng, (n_layers, 2, nb, hk, bt, d), dtype),
            torch.from_numpy(tables).cuda(), *meta, layer)


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
    log("== phase 3: ServingEngine at GPT-2-124M width, bf16, L=12, under "
        "the row, flat and phase schedulers")
    launches = {}
    for name, kwargs in SCHEDULERS.items():
        launches[name] = serve_counted(seed, name, kwargs)
    need = {"row": ("decode_attention_paged",),
            "flat": ("decode_attention_paged_flat", "decode_attention_paged"),
            "phase": ("flash_attention_fwd", "decode_attention_paged")}
    for name, kernels in need.items():
        for k in kernels:
            if not launches[name][k]:
                raise SystemExit(f"the {name} run never launched {k}: "
                                 f"{launches[name]}")
    return launches


def reset_launches():
    for counts in (da.LAUNCHES, fa.LAUNCHES):
        for k in counts:
            counts[k] = 0


def serve_counted(seed, name, kwargs):
    """Serve gpt2_workload under one scheduler with every launch count
    zeroed just before and read just after; returns the counts."""
    fresh, reqs = gpt2_workload(seed, **kwargs)
    forms = collections.Counter()
    kernel = da.decode_attention_paged

    def spy(qt, *a, **k):
        forms[qt.shape[2]] += 1
        return kernel(qt, *a, **k)
    torch.cuda.reset_peak_memory_stats()
    da.decode_attention_paged = spy
    reset_launches()
    try:
        out, steps, dt = serve(fresh, reqs)
    finally:
        da.decode_attention_paged = kernel
    launches = {**da.LAUNCHES, **fa.LAUNCHES}
    m = fresh.metrics()
    for (p, want), (rid, toks) in zip(reqs, out.items()):
        if len(toks) != want:
            raise SystemExit(f"{name}: request {rid} emitted {len(toks)} of "
                             f"{want}")
    if m["kv_blocks_used"] + m["kv_blocks_free"] != m["kv_blocks_total"] \
            or m["kv_blocks_used"]:
        raise SystemExit(f"{name}: kv block accounting broke: {m}")
    if name == "row" and (not forms.get(16) or not forms.get(1)):
        raise SystemExit(f"kernel forms launched: {dict(forms)}; need "
                         "both Sq=16 and Sq=1")
    n_prompt = sum(len(p) for p, _ in reqs)
    n_new = sum(w for _, w in reqs)
    log(f"  [{name}] {len(reqs)} requests, {n_prompt} prompt tokens, "
        f"{n_new} generated, {steps} steps in {dt:.3f} s")
    log(f"  [{name}] generated tokens/s {n_new / dt:.1f}; engine "
        f"tokens_per_sec {m['tokens_per_sec']}; mean step "
        f"{1e3 * dt / steps:.2f} ms")
    log(f"  [{name}] TTFT p50 {m['ttft_p50_s']:.4f} s, p99 "
        f"{m['ttft_p99_s']:.4f} s; latency p50 {m['latency_p50_s']:.4f} s")
    log(f"  [{name}] budget steps {m['budget_steps']}, utilization "
        f"{m['budget_utilization']}, padding {m['budget_padding_tokens']}, "
        f"paged kernel forms {dict(forms)}, launches {launches}")
    log(f"  [{name}] max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
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
    log("== phase 4: card (row, flat, phase) vs CPU (row) at L=2, full "
        "width, fp32 (TF32 off)")
    rng = np.random.default_rng(seed + 1)
    state = random_state(rng, E, H, FF, 2, V)
    reqs = [(rng.integers(0, V, int(rng.integers(20, 201))),
             int(rng.integers(12, 25))) for _ in range(6)]
    outs = {}
    for dev, name, kwargs in ([("cuda", n, kw)
                               for n, kw in SCHEDULERS.items()]
                              + [("cpu", "row", {})]):
        mods = from_jax_state(*state, device=dev, dtype=torch.float32)
        eng = ServingEngine(*mods, num_slots=8, max_seq_len=1024,
                            device=dev, **kwargs)
        t0 = time.perf_counter()
        outs[dev, name] = list(serve(eng, reqs)[0].values())
        log(f"  {dev} {name}: {time.perf_counter() - t0:.2f} s")
    want = outs["cpu", "row"]
    for name in SCHEDULERS:
        for i, (a, b) in enumerate(zip(outs["cuda", name], want)):
            if np.array_equal(a, b):
                continue
            j = int(np.argmax(a != b)) if len(a) == len(b) else min(
                len(a), len(b))
            mods = from_jax_state(*state, device="cpu", dtype=torch.float32)
            margin = first_gap_margin(mods, reqs[i][0], b[:j])
            raise SystemExit(
                f"request {i}: card ({name}) and CPU (row) tokens differ at "
                f"index {j} ({a[j:j + 4]} vs {b[j:j + 4]}); CPU top-2 "
                f"logit margin there {margin:.3e}")
    log(f"  {len(reqs)} requests, {sum(len(t) for t in want)} tokens: "
        "identical across row, flat and phase on the card and row on the "
        "CPU")


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


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the bf16 tensor rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed_row(label, run_kernel, run_plain, run_library, nbytes, flops,
              reps):
    """Check the kernel against its plain version at this shape (bf16
    tolerance), then time kernel, plain version and library call."""
    got, want = run_kernel(), run_plain()
    if isinstance(got, tuple):               # flash: (o, lse)
        got, want = got[0], want[0]
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = TOLERANCES["attention_bf16"]
    if not torch.allclose(got, want, **tol):
        raise SystemExit(
            f"kernel disagrees with its plain version at {label}: "
            f"max_abs_err {err:.3e} (atol {tol['atol']}, rtol "
            f"{tol['rtol']})")
    bound_ms, bound_by = bound(nbytes, flops)
    row = {**label, "max_abs_err": err, "ms": time_ms(run_kernel, reps),
           "plain_ms": time_ms(run_plain, max(reps // 10, 5)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(run_library, reps)}
    log("  " + json.dumps(row))
    return row


def time_flat(rng):
    """The flat kernel at the flat engine's segment shape: H=12, D=64,
    Bt=64, bf16, a 64-token segment at base 0 (slot 0) and one at base
    448 (slot 1), 16 chunks; the library call is SDPA over each
    segment's slot gathered into a dense view (gather not timed)."""
    # 48 layers: the blocks the launches cycle through exceed the L2
    h, d, bt, n_layers, seg = H, E // H, 64, 48, 64
    bases = (0, 448)
    chunks = [(s, base + 8 * i, 8) for s, base in enumerate(bases)
              for i in range(seg // 8)]
    q, pool, tables, cslot, cbase, cn, _ = flat_case(
        rng, chunks, h=h, hk=h, d=d, bt=bt, nblk=1024 // bt,
        n_layers=n_layers, layer=0, dtype=torch.bfloat16)
    # cycle the layer so each launch reads blocks another layer left cold

    def run_kernel(i=0):
        return da.decode_attention_paged_flat(q, pool, tables, cslot, cbase,
                                              cn, i % n_layers)

    def run_plain(i=0):
        return da.decode_attention_paged_flat_reference(
            q, pool, tables, cslot, cbase, cn, i % n_layers)
    s_max = bases[-1] + seg
    nb = pool.shape[2]
    kv = pool[:, :, tables[:, :s_max // bt].long().clamp(max=nb - 1)]
    kv = kv.permute(0, 1, 2, 4, 3, 5, 6).reshape(
        n_layers, 2, len(bases), h, s_max, d).contiguous()
    qs = q.reshape(len(bases), seg, h, d).transpose(1, 2)
    base_t = torch.tensor(bases, device="cuda")[:, None, None, None]
    mask = (torch.arange(s_max, device="cuda")[None, None, None, :]
            <= base_t + torch.arange(seg, device="cuda")[:, None])

    def run_sdpa(i=0):
        kk = kv[i % n_layers]
        return F.scaled_dot_product_attention(qs, kk[0], kk[1],
                                              attn_mask=mask)
    elt = 2
    n_pos = sum(base + seg for base in bases)      # each slot's prefix once
    nbytes = (n_pos * h * d * 2 * elt + 2 * q.numel() * elt
              + tables.numel() * 4 + 3 * cslot.numel() * 4)
    flops = 4 * d * h * sum(base + r + 1 for base in bases
                            for r in range(seg))
    return [timed_row({"bases": list(bases), "segment": seg}, run_kernel,
                      run_plain, run_sdpa, nbytes, flops, 200)]


def time_flash(rng):
    """Flash attention forward at the bulk prefill's shapes: [1, sb, 12,
    64] causal bf16 for each power-of-two bucket sb; the library call is
    SDPA with is_causal=True."""
    h, d = H, E // H
    rows = []
    for sb in (128, 256, 512, 1024):
        q, k, v = (randn(rng, (1, h, sb, d), torch.bfloat16)
                   for _ in range(3))

        def run_kernel(i=0, q=q, k=k, v=v):
            return fa.flash_attention_fwd(q, k, v, causal=True)

        def run_plain(i=0, q=q, k=k, v=v):
            return fa.flash_attention_reference(q, k, v, True)

        def run_sdpa(i=0, q=q, k=k, v=v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        nbytes = 4 * q.numel() * 2 + sb * h * 4     # q, k, v, o; lse
        flops = 4 * d * h * sb * (sb + 1) // 2
        rows.append(timed_row({"sb": sb}, run_kernel, run_plain, run_sdpa,
                              nbytes, flops, 100))
    return rows


def phase_timing(seed):
    log("== phase 5: kernel timing at the shapes of each path (H=12, "
        "D=64, bf16)")
    rng = np.random.default_rng(seed + 2)
    log("  decode_attention_paged at the decode shape (B=8, Bt=64)")
    rows = {"decode_attention_paged": time_paged(rng)}
    log("  decode_attention_paged_flat at the flat segment shape")
    rows["decode_attention_paged_flat"] = time_flat(rng)
    log("  flash_attention_fwd at the bulk prefill buckets")
    rows["flash_attention_fwd"] = time_flash(rng)
    return rows


def time_paged(rng):
    """The paged kernel at the decode shape (B=8, Bt=64, all rows at
    cache_lens 512 or 1024, Sq 1 or 16); the library call is SDPA over
    the row's prefix gathered into a dense view (gather not timed)."""
    b, h, d, bt, nblk, n_layers = 8, H, E // H, 64, 32, 12
    rows = []
    for ln in (512, 1024):
        for sq in (1, 16):
            qt, pool, tables, _, lens = attention_case(
                rng, b=b, h=h, hk=h, sq=sq, d=d, bt=bt, nblk=nblk,
                n_layers=n_layers, layer=0, lens=[ln] * b,
                dtype=torch.bfloat16)
            # cycle the layer so each launch reads blocks another layer
            # left cold (12 layers of KV exceed the 50 MB L2)

            def run_kernel(i=0):
                return da.decode_attention_paged(qt, pool, tables,
                                                 i % n_layers, lens)

            def run_plain(i=0):
                return da.decode_attention_paged_reference(
                    qt, pool, tables, i % n_layers, lens)
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
            elt = 2
            nbytes = (b * h * s * d * 2 * elt          # K and V read once
                      + 2 * b * h * sq * d * elt       # q in, out
                      + tables.numel() * 4 + b * 4)
            flops = 4 * d * b * h * sum(ln + r + 1 for r in range(sq))
            rows.append(timed_row({"cache_lens": ln, "sq": sq}, run_kernel,
                                  run_plain, run_sdpa, nbytes, flops, 200))
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

    log(f"  worst phase-2 errors: {worst}")
    # per kernel: the phase-3 run of its own path, the phase-5 shape its
    # engine spends most time at, and the worst error over its phase-5
    # shapes (each checked there)
    table = (("decode_attention_paged", "row", 1027,
              lambda r: r["cache_lens"] == 1024 and r["sq"] == 1),
             ("decode_attention_paged_flat", "flat", 1276, lambda r: True),
             ("flash_attention_fwd", "phase", 222,
              lambda r: r["sb"] == 512))
    kernels = []
    for name, path, line, is_main in table:
        main_row = next(r for r in rows[name] if is_main(r))
        src = ("flash_attention.py" if name == "flash_attention_fwd"
               else "decode_attention.py")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/csrc/{_build.SOURCES[name]}",
            "replaces": f"paddle_tpu/ops/pallas/{src}:{line}",
            "launches": launches[path][name],
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
