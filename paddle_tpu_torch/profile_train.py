"""Where a training step's time goes on the card.

    python -m paddle_tpu_torch.profile_train [--model gpt2|llama|bert]
        [--seed N] [--steps N] [--warmup N] [--fused-ffn] [--bench-step]
        [--timed-steps N] [--level os|os_g|p_g_os|none]

Trains ``gpt2_train_workload``, the configuration that ``chip_smoke.py``
phase 3c also trains (GPT-2 124M as ``bench.py``'s ``bench_gpt2`` runs it:
B=8, S=1024, bf16 parameters with fp32 AdamW masters, dropout 0.1), or
with ``--fused-ffn`` phase 3d's (the same under ``FUSED_FFN_FLAGS``: the
MLP through the fused FFN kernels, forward and backward), or with
``--model llama`` phase 3f's ``llama_train_workload`` (configs[2]'s
step: LLaMA-2 7B's widths at 4 layers, B=1, S=4096, bf16 with fp32
AdamW masters, fleet's model-parallel layers, through ``fleet.init`` and
``group_sharded_parallel(level="p_g_os")`` over the process group, or
at ``--level``'s level, or with ``--level none`` unwrapped), or
with ``--model bert`` phase 3i's ``bert_train_workload`` (BERT-base
pretraining as ``bench.py``'s ``bench_bert`` runs it, under AMP O2 and
``group_sharded_parallel(level="os_g")`` over the process group, or at
``--level``'s level, or with ``--level none`` the plain O2 step; with a
schedule and a clip, or with ``--bench-step`` under bench_bert's own
constant lr and no clip), for ``--warmup`` steps, then
``--timed-steps`` more timed without the profiler (each synchronized),
then ``--steps`` more under ``torch.profiler``. Prints one JSON object:
the timed steps' wall times and their median, ``max_memory_allocated``;
per profiled step its wall time, the union of the device's kernel
intervals inside it (busy) and the idle share; then, over the profiled
steps, device time and launches per step by kernel name, and the host's
self time and calls per step by operator (the 25 largest).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from . import amp
from .models.bert import BertForPretraining, bert_base
from .models.gpt import gpt2_124m
from .models.llama import LlamaConfig, LlamaForCausalLM
from .nn import ClipGradByGlobalNorm
from .optimizer import AdamW
from .optimizer.lr import LinearWarmup, LRScheduler, PolynomialDecay
from .profile_serving import busy_us

# bench_gpt2's headline configuration (bench.py:463)
BATCH, SEQ, VOCAB_SAMPLED, LR = 8, 1024, 50000, 1e-4
# LLaMA-2 7B's published widths (Meta's Llama-2-7b config.json; the JAX
# llama2_7b) cut to 4 layers so that bf16 weights and grads, fp32 masters
# and both AdamW moments (16 bytes a parameter, 1.07 B parameters) fit one
# 80 GB card beside the activations; one sequence of LLaMA-2's context
LLAMA_CONFIG = {"vocab_size": 32000, "hidden_size": 4096, "num_layers": 4,
                "num_heads": 32, "intermediate_size": 11008,
                "max_position": 4096, "rms_eps": 1e-5}
LLAMA_BATCH, LLAMA_SEQ = 1, 4096
# bench_bert's configuration (bench.py:544-615): BERT-base with the
# vocabulary padded to 30720 (ids and labels drawn from the real 30522),
# B=16, S=512, 15% MLM labels, AdamW at lr 1e-4 under AMP O2 (bf16).
# The schedule is BERT's (linear warmup, then linear decay; Devlin et al.
# 2019, PaddleNLP's run_pretrain.py) with its lengths cut to a run of a
# dozen steps, so that the warmup ends and the decay shows inside it
BERT_VOCAB, BERT_VOCAB_SAMPLED, BERT_BATCH, BERT_SEQ = 30720, 30522, 16, 512
BERT_WARMUP_STEPS, BERT_DECAY_STEPS, BERT_MLM_SHARE = 4, 100, 0.15
BERT_AMP_LEVEL = "O2"
# the environment under which GPTMLP runs the fused FFN kernels, forward
# and backward (read at each forward and backward)
FUSED_FFN_FLAGS = {"PADDLE_TPU_FUSED_FFN": "1",
                   "PADDLE_TPU_FUSED_FFN_BWD": "1"}


def gpt2_train_workload(seed, device=None):
    """Returns ``(model, opt, x, y)``: GPT-2 124M (L=12, E=768, H=12,
    V=50304, dropout 0.1) with random weights from ``seed`` on ``device``
    (default the card) in bf16; AdamW at lr 1e-4 (weight_decay 0.01) with
    fp32 masters; and one batch of token ids [8, 1024] drawn below 50000
    and its next-token labels, as bench_gpt2 draws them."""
    model = gpt2_124m(device=device, seed=seed)
    model.to(torch.bfloat16)
    opt = AdamW(LR, parameters=model.named_parameters(),
                multi_precision=True)
    ids = np.random.default_rng(seed).integers(0, VOCAB_SAMPLED,
                                               (BATCH, SEQ + 1))
    dev = model.gpt.wte.weight.device
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    return model, opt, x, y


def llama_train_workload(seed, device=None, *, level="p_g_os"):
    """Returns ``(model, opt, x, y)``: configs[2]'s step as bench_llama
    builds it (bench.py:641-652). ``fleet.init`` over the process group
    (one process alone: a group of one, NCCL on the card) with every
    degree 1 (configs[2]'s mp 2 x pp 2 needs four cards, ROADMAP item
    12); ``LlamaForCausalLM(LLAMA_CONFIG)`` with ``tensor_parallel=True``
    (fleet's model-parallel layers and ``ParallelCrossEntropy``, as
    ``llama2_7b`` and bench_llama build it) with random weights from
    ``seed`` on ``device`` (default the card) in bf16; AdamW at lr 1e-4
    (weight_decay 0.01) with fp32 masters; then
    ``group_sharded_parallel(level=level)`` (default "p_g_os", stage 3),
    ``fleet.distributed_model`` and ``fleet.distributed_optimizer``;
    ``level`` None leaves out the fleet and the wrappers (the unwrapped
    step). And one batch of token ids [1, 4096] drawn below 32000 and
    its next-token labels."""
    if level is not None:
        from .distributed import fleet
        from .distributed.sharding import group_sharded_parallel
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                                   "pp_degree": 1, "sharding_degree": 1,
                                   "sep_degree": 1}
        fleet.init(is_collective=True, strategy=strategy, device=device)
    model = LlamaForCausalLM(LlamaConfig(**LLAMA_CONFIG), device=device,
                             seed=seed)
    model.to(torch.bfloat16)
    opt = AdamW(LR, parameters=model.named_parameters(),
                multi_precision=True)
    dev = model.llama.embed_tokens.weight.device
    if level is not None:
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    ids = np.random.default_rng(seed).integers(
        0, LLAMA_CONFIG["vocab_size"], (LLAMA_BATCH, LLAMA_SEQ + 1))
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    return model, opt, x, y


def bert_schedule(lr=LR):
    """LinearWarmup from 0 to ``lr`` over BERT_WARMUP_STEPS, then
    PolynomialDecay (power 1) to 0 over BERT_DECAY_STEPS."""
    return LinearWarmup(PolynomialDecay(lr, BERT_DECAY_STEPS, end_lr=0.0),
                        BERT_WARMUP_STEPS, 0.0, lr)


def bert_batch(seed, batch, seq, vocab, device):
    """(ids [B, S], labels) drawn from ``seed``, as bench_bert draws them:
    ids below ``vocab``; labels the model's keywords ``masked_lm_labels``
    ([B, S], each position its own id with probability BERT_MLM_SHARE,
    else -100) and ``next_sentence_labels`` ([B])."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    labels = np.where(rng.random((batch, seq)) < BERT_MLM_SHARE, ids, -100)
    nsp = rng.integers(0, 2, (batch,))
    return (torch.from_numpy(ids).to(device),
            {"masked_lm_labels": torch.from_numpy(labels).to(device),
             "next_sentence_labels": torch.from_numpy(nsp).to(device)})


def bert_train_workload(seed, device=None, dtype="bfloat16", *,
                        bench_step=False, level="os_g"):
    """Returns ``(model, opt, x, y)``: configs[1]'s data-parallel stage-2
    step. ``fleet.init`` over the process group (one process alone: a
    group of one, NCCL on the card) with every process in the sharding
    group (ZeRO-2 data parallelism: each consumes its own rows);
    ``BertForPretraining(bert_base(vocab_size=30720))`` (dropout 0.1)
    with random weights from ``seed`` on ``device`` (default the card),
    cast by ``amp.decorate(level="O2", dtype=dtype)`` with fp32 AdamW
    masters, then ``group_sharded_parallel(level="os_g")`` (bench_bert's
    order, bench.py:566-572), ``fleet.distributed_model`` and
    ``fleet.distributed_optimizer``; AdamW (weight_decay 0.01) under
    ``bert_schedule()`` with ``ClipGradByGlobalNorm(1.0)``, or with
    ``bench_step`` bench_bert's own AdamW (a constant lr 1e-4, no clip);
    ``level`` None leaves out the GroupSharded wrapper and the fleet
    wrappers (the plain O2 step, ``BENCH_BERT_PLAIN=1``'s); and this
    process's rows (``parallel.shard_batch``) of one batch
    ``bert_batch`` [16, 512] with its MLM and NSP labels. Train it with
    ``train_step(..., amp_level=BERT_AMP_LEVEL)``."""
    import torch.distributed as dist

    from .distributed import fleet
    from .distributed.sharding import group_sharded_parallel
    from .parallel import shard_batch
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": world,
                               "sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device=device)
    model = BertForPretraining(bert_base(vocab_size=BERT_VOCAB),
                               device=device, seed=seed)
    if bench_step:
        opt = AdamW(LR, parameters=model.named_parameters())
    else:
        opt = AdamW(bert_schedule(), parameters=model.named_parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    dev = model.mlm_bias.device
    if level is not None:
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    x, y = bert_batch(seed, BERT_BATCH, BERT_SEQ, BERT_VOCAB_SAMPLED, dev)
    return model, opt, shard_batch(x), {k: shard_batch(v)
                                        for k, v in y.items()}


def train_loss(model, x, y, amp_level=None, amp_dtype="bfloat16"):
    """The model's loss on ids ``x`` with labels ``y`` (a dict of the
    model's label keywords, else its ``labels``), under ``amp.auto_cast(
    level=amp_level, dtype=amp_dtype)`` when ``amp_level`` is given."""
    with amp.auto_cast(enable=amp_level is not None,
                       level=amp_level or "O1", dtype=amp_dtype):
        return model(x, **y) if isinstance(y, dict) else model(x, labels=y)


def advance_schedule(opt):
    """Step the learning-rate scheduler that ``opt`` holds, if it holds
    one (the schedule moves once a step, after the update)."""
    if isinstance(opt._learning_rate, LRScheduler):
        opt._learning_rate.step()


def train_step(model, opt, x, y, *, amp_level=None):
    """One step: ``train_loss``, backward, the optimizer, clear the grads,
    ``advance_schedule``. Returns the loss (a device scalar)."""
    loss = train_loss(model, x, y, amp_level)
    loss.backward()
    opt.step()
    opt.clear_grad()
    advance_schedule(opt)
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("gpt2", "llama", "bert"),
                    default="gpt2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--fused-ffn", action="store_true",
                    help="train with FUSED_FFN_FLAGS set")
    ap.add_argument("--bench-step", action="store_true",
                    help="with --model bert: bench_bert's own optimizer "
                    "(a constant lr, no clip)")
    ap.add_argument("--timed-steps", type=int, default=10,
                    help="steps timed without the profiler first (each "
                    "synchronized), for the median step")
    ap.add_argument("--level", choices=("os", "os_g", "p_g_os", "none"),
                    default=None,
                    help="the GroupSharded level (bert: default os_g; "
                    "llama: default p_g_os), or none for the unwrapped "
                    "step")
    args = ap.parse_args(argv)
    default = "p_g_os" if args.model == "llama" else "os_g"
    args.level = args.level or default
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 2
    if args.fused_ffn:
        os.environ.update(FUSED_FFN_FLAGS)
    step = train_step
    level = None if args.level == "none" else args.level
    if args.model == "llama":
        model, opt, x, y = llama_train_workload(args.seed, level=level)
        config = {**LLAMA_CONFIG, "batch": LLAMA_BATCH, "seq": LLAMA_SEQ,
                  "dtype": "bfloat16", "masters": "fp32",
                  "level": level}
    elif args.model == "bert":
        model, opt, x, y = bert_train_workload(
            args.seed, bench_step=args.bench_step, level=level)
        step = functools.partial(train_step, amp_level=BERT_AMP_LEVEL)
        config = {"vocab_size": BERT_VOCAB, "batch": BERT_BATCH,
                  "seq": BERT_SEQ, "layers": 12, "amp": "O2 bfloat16",
                  "masters": "fp32", "dropout": 0.1,
                  "schedule": None if args.bench_step else [
                      BERT_WARMUP_STEPS, BERT_DECAY_STEPS],
                  "clip": None if args.bench_step else 1.0,
                  "level": level}
    else:
        model, opt, x, y = gpt2_train_workload(args.seed)
        config = {"batch": BATCH, "seq": SEQ, "layers": 12,
                  "dtype": "bfloat16", "masters": "fp32", "dropout": 0.1,
                  "fused_ffn": args.fused_ffn}
    for _ in range(args.warmup):
        step(model, opt, x, y)
    torch.cuda.synchronize()
    timed = []
    for _ in range(args.timed_steps):
        t0 = time.perf_counter()
        step(model, opt, x, y).item()       # synchronizes
        timed.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    losses = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps):
            with torch.profiler.record_function(f"train_step_{i}"):
                losses.append(step(model, opt, x, y).item())
                torch.cuda.synchronize()
    windows, kernels = [], []
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        cuda = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.name.startswith("train_step_"):
            # a step's host range; its copy on the device timeline (a
            # user annotation, not a kernel) is left out
            if not cuda:
                windows.append(rng)
        elif cuda:
            kernels.append((ev.name, *rng))
    windows.sort()
    steps = []
    for start, end in windows:
        inside = [(s, e) for _, s, e in kernels if start <= s < end]
        wall = (end - start) * 1e-6
        busy = busy_us(inside) * 1e-6
        steps.append({"wall_s": wall, "device_busy_s": busy,
                      "device_idle_share": 1 - busy / wall,
                      "kernel_events": len(inside)})
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in kernels:
        by_kernel[name][0] += e - s
        by_kernel[name][1] += 1
    n = max(len(windows), 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "model": args.model, "config": config,
        "timed_step_s": timed,
        "median_timed_step_s": float(np.median(timed)) if timed else None,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "losses": losses, "steps": steps,
        "device_time_per_step_by_kernel": [
            {"name": name[:90], "s": us * 1e-6 / n, "launches": cnt / n}
            for name, (us, cnt) in top],
        "host_self_time_per_step_by_op": [
            {"name": ev.key[:90], "s": ev.self_cpu_time_total * 1e-6 / n,
             "calls": ev.count / n}
            for ev in sorted(prof.key_averages(),
                             key=lambda ev: -ev.self_cpu_time_total)[:25]],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
