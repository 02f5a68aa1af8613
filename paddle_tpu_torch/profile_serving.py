"""Where the serving engine's time goes on the card.

    python -m paddle_tpu_torch.profile_serving [--seed N]
        [--scheduler row|flat|phase] [--kv-quant none|int8]
        [--weight-quant none|int8|int4] [--paged 1|0] [--sampled 0|1]
        [--rotary 0|1] [--mix gpt2|prefix|spec] [--prefix-cache-blocks N]
        [--spec-k K]

Serves ``gpt2_workload``, the request mix that ``chip_smoke.py`` phase
3 also serves, under ``torch.profiler`` and the chosen scheduler (the
row-layout token budget by default, ``flat_budget=True``, or the phase
scheduler ``token_budget=0``) and quantization (fp by default; the
``kv_quant`` and ``weight_quant`` options of ``ServingEngine``) over
the paged pool or, with ``--paged 0``, the dense ring; greedy, or with
``--sampled 1`` sampled as ``chip_smoke.py`` phase 3's sampled runs
(``SAMPLED``: top_k 50, top_p 0.95, temperature 0.8, every request at
repetition penalty 1.2), with ``--rotary 1`` rotary embeddings. ``--mix
prefix`` serves ``MIXES["prefix"]`` instead (a shared template, for
``--prefix-cache-blocks``), ``--mix spec`` ``MIXES["spec"]`` (prompts
that repeat a pattern, for ``--spec-k``). Prints one JSON object: wall
time, the union of the device's kernel intervals (busy) and the idle
share, device time by kernel name, host time by dispatch kind (budget /
decode), and the engine's metrics. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import sys
import time

import numpy as np
import torch

from .core.rng import seed
from .inference import ServingEngine
from .weights import from_jax_state, random_state

# GPT-2-124M widths (bench_serving.py's full-size serving model)
E, H, FF, L, V = 768, 12, 3072, 12, 50304
# scheduler name -> ServingEngine keyword arguments
SCHEDULERS = {"row": {}, "flat": {"flat_budget": True},
              "phase": {"token_budget": 0}}
# the sampled mix's ServingEngine keyword arguments; its requests are
# submitted at repetition_penalty 1.2
SAMPLED = {"do_sample": True, "top_k": 50, "top_p": 0.95,
           "temperature": 0.8, "enable_repetition_penalty": True}


def _gpt2_mix(rng):
    # prompts of 32-512 tokens, 32-128 new tokens
    return [(rng.integers(0, V, int(rng.integers(32, 513))),
             int(rng.integers(32, 129))) for _ in range(16)]


def _prefix_mix(rng):
    # one shared 256-token template (four 64-token blocks) and 32-64 own
    # tokens a prompt, 32 new tokens
    tmpl = rng.integers(0, V, 256)
    return [(np.concatenate([tmpl, rng.integers(0, V,
                                                int(rng.integers(32, 65)))]),
             32) for _ in range(16)]


def _spec_mix(rng):
    # each prompt one block of CYCLE ids in their cycle's order from a
    # random offset, 64-128 tokens (a 16-token pattern repeated), 64 new
    return [(CYCLE * int(rng.integers(0, V // CYCLE))
             + (int(rng.integers(0, CYCLE))
                + np.arange(int(rng.integers(64, 129)))) % CYCLE, 64)
            for _ in range(16)]


CYCLE = 16


def cycle_head(state, period=CYCLE, scale=8.0):
    """``random_state``'s (fmt, embed, head) with the embedding scaled by
    ``scale`` and the LM head set to its rows shifted by one inside each
    block of ``period`` token ids: pre-LN layers add terms of a fixed size
    to the residual stream, so the last hidden state stays close to its
    token's (scaled) embedding and the model mostly emits the block's
    next id; a prompt that walks the block's cycle then gives the n-gram
    drafter proposals the model accepts (the spec mix's model)."""
    fmt, embed, head = state
    w = embed["weight"] * np.float32(scale)
    ids = np.arange(w.shape[0])
    pred = ids // period * period + (ids - 1) % period
    return (fmt, {**embed, "weight": w},
            {**head, "weight": np.ascontiguousarray(w[pred].T)})


# request mix name -> 16 greedy (prompt, max_new) pairs drawn from a rng
MIXES = {"gpt2": _gpt2_mix, "prefix": _prefix_mix, "spec": _spec_mix}


@functools.lru_cache(maxsize=1)
def _random_model(seed):
    """The numpy state random weights from ``seed`` take, and the
    generator's state after drawing them (the requests are drawn from
    there); kept for the process's next workload of the same seed."""
    rng = np.random.default_rng(seed)
    return random_state(rng, E, H, FF, L, V), rng.bit_generator.state


def gpt2_workload(seed, *, mix="gpt2", **engine_kwargs):
    """Returns ``(engine, reqs)``: a fresh ``ServingEngine(num_slots=8,
    max_seq_len=1024, **engine_kwargs)`` over a GPT-2-124M-width bf16
    model on the card (random weights from ``seed``), and the 16 greedy
    ``(prompt, max_new)`` pairs of ``MIXES[mix]``: by default prompts of
    32-512 tokens and 32-128 new tokens. One warm-up request (cuBLAS
    handles, allocator pools) was served on another engine of the same
    configuration over the same weights first. The spec mix's model has
    ``cycle_head``'s head. ``engine_kwargs`` selects
    the scheduler, e.g. ``flat_budget=True`` or ``token_budget=0``, the
    quantization, e.g. ``kv_quant="int8", weight_quant="int4"``, and the
    options, e.g. ``prefix_cache_blocks=64`` or ``spec_k=4``."""
    state, after = _random_model(seed)
    rng = np.random.default_rng()
    rng.bit_generator.state = after
    mods = from_jax_state(*(cycle_head(state) if mix == "spec" else state),
                          dtype=torch.bfloat16)
    warm = ServingEngine(*mods, num_slots=8, max_seq_len=1024,
                         **engine_kwargs)
    warm.submit(rng.integers(0, V, 40), max_new_tokens=4)
    warm.run()
    reqs = MIXES[mix](rng)
    return ServingEngine(*mods, num_slots=8, max_seq_len=1024,
                         **engine_kwargs), reqs


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, end_max = 0.0, None
    for start, end in sorted(intervals):
        if end_max is None or start > end_max:
            total += end - start
            end_max = end
        elif end > end_max:
            total += end - end_max
            end_max = end
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", choices=sorted(SCHEDULERS),
                    default="row")
    ap.add_argument("--kv-quant", choices=("none", "int8"), default="none")
    ap.add_argument("--weight-quant", choices=("none", "int8", "int4"),
                    default="none")
    ap.add_argument("--paged", type=int, choices=(0, 1), default=1,
                    help="0: the dense KV ring (ServingEngine(paged=False))")
    ap.add_argument("--sampled", type=int, choices=(0, 1), default=0,
                    help="1: sample as SAMPLED says")
    ap.add_argument("--rotary", type=int, choices=(0, 1), default=0,
                    help="1: rotary embeddings (use_rotary=True)")
    ap.add_argument("--mix", choices=sorted(MIXES), default="gpt2")
    ap.add_argument("--prefix-cache-blocks", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: needs a CUDA card", file=sys.stderr)
        return 2
    eng, reqs = gpt2_workload(args.seed, **SCHEDULERS[args.scheduler],
                              kv_quant=args.kv_quant,
                              weight_quant=args.weight_quant,
                              paged=bool(args.paged),
                              use_rotary=bool(args.rotary),
                              prefix_cache_blocks=args.prefix_cache_blocks,
                              spec_k=args.spec_k, mix=args.mix,
                              **(SAMPLED if args.sampled else {}))
    seed(args.seed)              # the sampled requests' seeds
    for prompt, max_new in reqs:
        eng.submit(prompt, max_new_tokens=max_new,
                   **({"repetition_penalty": 1.2} if args.sampled else {}))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        intervals.append((ev.time_range.start, ev.time_range.end))
        by_kernel[ev.name][0] += dur
        by_kernel[ev.name][1] += 1
    busy_s = busy_us(intervals) * 1e-6
    host = collections.defaultdict(lambda: [0.0, 0])
    for st in eng.telemetry.steps:
        host[st["kind"]][0] += st["dur_s"]
        host[st["kind"]][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "layers": L,
        "scheduler": args.scheduler, "kv_quant": args.kv_quant,
        "weight_quant": args.weight_quant, "paged": bool(args.paged),
        "sampled": bool(args.sampled), "rotary": bool(args.rotary),
        "mix": args.mix, "prefix_cache_blocks": args.prefix_cache_blocks,
        "spec_k": args.spec_k,
        "steps": steps, "wall_s": wall_s, "device_busy_s": busy_s,
        "device_idle_share": (1 - busy_s / wall_s) if wall_s else None,
        "kernel_events": len(intervals),
        "device_time_by_kernel": [
            {"name": name[:90], "s": us * 1e-6, "launches": n}
            for name, (us, n) in top],
        "host_time_by_dispatch": {k: {"s": s, "dispatches": n}
                                  for k, (s, n) in host.items()},
        "metrics": {k: eng.metrics()[k] for k in (
            "tokens_emitted", "tokens_per_sec", "budget_steps",
            "ttft_p50_s", "ttft_p99_s", "latency_p50_s", "prefix_hit_rate",
            "prefill_tokens_saved", "draft_proposed", "draft_accepted",
            "acceptance_rate")},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
