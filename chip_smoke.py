#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, in order; any failure exits non-zero:
  1. print the card, build every kernel from the sources in this checkout
     (all nvcc processes started together);
  2. each kernel against its plain PyTorch version on the card (bf16 and
     fp32 with TF32 off): the paged kernel and its int8 flavor over ragged
     lengths, sentinel table entries, GQA, several block sizes and a
     layer index > 0; the paged kernel again over long rows that its split
     design cuts into several ranges (nblk 64, lens 0, 1, 4000 and 2047,
     Sq 1, 16 and 128, GQA groups 1, 2 and 4, D 64 and 128, Bt 16 and 64,
     bf16, fp16 and fp32, a sentinel inside a table), every bf16 and fp16
     launch on the split path (decode_attention.PATH_LAUNCHES); its int8
     flavor and the int8 dense ring's kernel over the same split design
     (the pool at nblk 64, lens 0, 1, 4000 and 2047, a sentinel inside a
     table, Bt 16 and 64; the ring at Smax 128, 1024 and 4096, lens 0,
     mid-tile, Smax - Sq and past the middle; both over Sq 1, 16 and 128,
     GQA groups 1, 2 and 4, D 40, 64 and 128, bf16, fp16 and fp32), each
     kernel's launches by design counted: bf16 and fp16 split, fp32 per
     head; the fp dense ring's kernel and decode_attention_bhsd over the
     same split design (the ring at Smax 128, 1024 and 4096; the one-layer
     cache at Smax 32, 1000 and 1024 with K and V separate tensors; Sq 1,
     16 and 128, GQA groups 1, 2 and 4, D 64 and 128, bf16, fp16 and
     fp32), bf16 and fp16 split, fp32 per head; the fp and int8 rings'
     fused write kernels over the same split design in its write mode
     (split_write_kernels: B 7 at lens 0, 63, 64, span - 1, span, Smax - 1
     and Smax, Smax 128, 1024 and 4096, GQA groups 1, 2 and 4, D 64 and
     128, bf16, fp16 and fp32; the ring and the int8 scales after each call
     byte-equal to the plain write's), bf16 and fp16 split, fp32 per
     head; the flat
     kernel and its int8 flavor over pad
     chunks, unaligned chunk bases straddling a block edge and an
     unmapped entry, and both again over 2048-position slot tables that
     their split design cuts into ranges (flat_split_kernels: GQA groups
     1, 2 and 4, D 40, 64 and 128, Bt 16 and 64, bf16, fp16 and fp32; pad
     rows and the pad chunk exactly 0), bf16 and fp16 split, fp32 per
     head; flash attention causal and not, sq < sk, GQA, S in
     {37, 255, 1000}, D in {64, 128}, lse included; the int4 dequant-
     matmul (dequant_kernels) at M in {1, 8, 16, 17, 37, 128, 512} for
     each of GPT-2's four (K, O), the transposed qkv view included, and
     two shapes its tensor-core design does not take, bf16, fp16 and fp32,
     bf16 to an fp32 output, each launch on the design dequant_path gives
     it (bf16 / fp16 aligned: tensor_core; else fma); the dense-ring
     kernels (stacked,
     stacked_i8 at Smax 128 and 1024, Sq 1, 16 and 128, GQA groups 1 and
     2; the fused write kernels at lens 0, mid-tile, Smax - 1 and Smax,
     their ring and scales after the call byte-equal to the plain
     write's); the training kernels (the dropout keep bits byte-equal to
     the plain version's, from the mask kernel and as the forward, dK/dV
     and dQ kernels draw them in their tiles; flash forward with dropout
     and the dK/dV and dQ kernels, bf16, fp16 and fp32, causal and not,
     Sq = Sk, Sq < Sk and Sq > Sk, GQA, D 64 and 128, dropout 0 and 0.1,
     and at the main shapes, LLaMA's [1, 32, 4096, 128] causal at dropout
     0 and GPT-2's [8, 12, 1024, 64] causal at 0.1, there o and the
     gradients over the reference's rms; lse to attention_lse; the
     backward fed the kernel's o and lse and then the plain forward's);
     the fused FFN forward, dx and dW kernels
     (fp32, bf16 and fp16, both activations, (K, F) in (128, 256), (768, 3072)
     and (1024, 2816), M 8, 136 and 8192; out, dx, dW1, dW2 and db1 each);
     decode_attention_bhsd in both layouts (B 1 and 8, H 12, Hk 12 and 6,
     D 64 and 128, Sq 1, 4 and 128, Smax 32, 1000 and 1024, lens 0,
     mid-tile and Smax - Sq); the RMSNorm forward and backward kernels (D
     64, 97, 128, 1024, 2048, 4096, 4097, 5120, 8192 and 16384, N 1, 7,
     33, 4096 and 4097, fp32, bf16 and fp16, eps 1e-5 and 1e-6; y, rstd,
     dx and dgamma each, dx and dgamma bit-equal on a second launch; each
     launch on the design rms_norm_path gives it, row-block or per-warp);
     the LayerNorm forward and backward kernels (D 64, 97, 256, 768, 1024
     and 1600, N 1, 7, 33, 8192 and 8193, fp32, bf16 and fp16; y, mean,
     rstd, dx, dgamma and dbeta each, the backward's bit-equal on a second
     launch; each backward launch on the design layer_norm_path gives it,
     row-warp or per-warp); the ring chunk forward, dK/dV and dQ kernels
     (fp32, bf16 and fp16, D 64 and 128, H 8 over Hk 8 and 2, Sq = Sk in {37, 256, 1024} and 100 x
     257, offsets Sk, Sk - 1, 0, -17, -Sq and -Sq - 5; o, lse, dq, dk and
     dv from cotangents of o and lse, fully masked launches exactly zero);
     the sampler (sampler_checks): threefry words and _sample_rows tokens
     against known answers made with JAX (KNOWN_WORDS, KNOWN_TOKENS), the
     card's threefry words and uniforms at [8, V] byte-equal to the CPU's
     (fp32, bf16, fp16; one key a row and one over the batch) and its
     _sample_rows / _sample_next tokens equal to the CPU's over four
     (top_k, top_p, temperature), with and without the repetition
     penalty, and the card operations and ms of one call of each sampler
     piece at [8, V] bf16; bf16 top-p masks (top_p 0.95 and 0.9) at [8, V]
     equal to the CPU's (ROADMAP Queue 3 J's denominator).
     --kernels-only stops here (exit 0, no result line);
  3. the serving engine at GPT-2-124M width (E=768, H=12, FF=3072, L=12,
     V=50304, pre-LN, gelu, bf16, random weights from --seed) serves the
     same 16 greedy requests under each scheduler: the row-layout token
     budget, the flat token budget and the phase scheduler's bulk
     prefill, each fp and with kv_quant="int8", weight_quant="int4", and
     the row budget with weight_quant="int8"; then over the dense ring
     (paged=False) under each scheduler, fp, and the row budget with
     kv_quant="int8". Kernel launch counts are zeroed just before each
     run and read just after; the row runs must launch both forms of
     their read kernel (Sq=16 block, Sq=1 decode), the flat runs the flat
     and the paged kernel (a ring: the stacked kernel; its segments are
     torch ops), the phase runs flash attention and the read kernel — on
     an int8 cache always the int8 flavors and never an fp attention
     kernel, over a ring never a paged kernel and vice versa — and every
     int4 run the dequant-matmul; every decode_attention_paged,
     decode_attention_paged_i8, decode_attention_paged_flat,
     decode_attention_paged_flat_i8,
     decode_attention_stacked and decode_attention_stacked_i8 launch takes
     the split design (decode_attention.PATH_LAUNCHES) and every
     fused_dequant_matmul launch the tensor-core one
     (fused_dequant_matmul.PATH_LAUNCHES). The pool,
     ring and weight bytes are read from the arrays. Then sampled runs
     (SAMPLED: top_k 50, top_p 0.95, temperature 0.8,
     enable_repetition_penalty, every request at penalty 1.2) under each
     scheduler and one rotary row run (sampled too), with the same
     launch checks; then the options (OPTIONS), each beside the same
     mix without it: prefix caching (prefix_cache_blocks=64) on a mix of
     16 prompts sharing a 256-token template under row and phase, and
     speculative decoding (spec_k=4) on 16 prompts walking a 16-id cycle
     of profile_serving.cycle_head's model under row, flat and phase
     (hit rate, tokens saved, drafts, acceptance, tokens/s and TTFT
     printed; a phase verify pass must read K + 1 = 5 positions, a row
     chain a C = 16 block); then the slot lifecycle's mixes (LIFECYCLE):
     qos under row fp and flat kv8 (eight low-class requests fill the
     slots, then eight high-class ones preempt them to the host one a
     step and the low ones resume; the preempted and resumed counts, the
     parked bytes at their peak, the high class's TTFT p50 / p99 beside
     the same burst without the fill, and one parked 1024-position slot's
     host round trip, each way, best of 3), and handoff under flat fp and
     row kv8 (a role="prefill" engine streams each prompt's full blocks
     to a role="decode" engine while it prefills, then ships the held
     slot's tail: blocks shipped and streamed, export_slot and
     import_slot ms a request), each with the launch checks above;
  3a. the serving cluster (serving_cluster) at the same width and bf16,
     on cycle_head's model (random weights from --seed: at this depth the
     random head's bf16 greedy picks follow the batch's composition, the
     cycle head's hold), phase 3's 16 greedy requests: one row engine
     alone (8 slots, prefix_cache_blocks=64), one with telemetry_ring=0
     and one more with the ring on (the same launches and tokens; host
     ms a step on, off, on); two
     such engines as threaded LocalReplicas behind Router and Gateway on
     127.0.0.1 (a free port), the requests over HTTP at once, half JSON
     and half SSE: tokens equal the engine alone's, each replica launches
     the row kernel, every launch on the split design; after a
     reset_metrics and four more requests every counter of
     COUNTER_FOLD_KEYS in /metrics equals its replica's metrics() plus the
     folded base; the same mix with replica0 killed at its 12th step
     (failover, tokens equal, each moved trace id at attempt 1 on replica0
     and 2 on replica1); a prefill/decode pair shaped as the cluster's
     __main__ shapes roles (16 handoffs, shipped = adopted, no decode-side
     prefill, the flat kernel on the split design, tokens equal); every
     snapshot within schema v8, every engine's Chrome export and the
     merged cluster trace valid (written to a temporary directory in
     the working directory and removed); tokens/s, TTFT
     p50 / p99 against the engine alone, the gateway's HTTP latency p50,
     each beside the card;
  3b. generate_fused (FusedDecoder.generate) at the same width, L=12: 8
     rows of 256-token prompts, 128 new tokens, max_seq_len=1024, fp and
     kv_quant="int8", each with cache_write_kernel off and on; every
     run launches exactly its one ring kernel 12 times per hidden pass,
     the fp and int8 reads and fused writes on the split design; then
     sampled with repetition_penalty 1.2, num_beams=4 (32 ring rows) and
     bulk_prefill=True (12 flash launches on the tensor cores, then
     12 a decode step); twice on one PrefixCache (the second call adopts
     192 of each row's 256 prompt positions, launches 12 per remaining
     hidden pass and gives the first call's tokens), and spec_k=4 beside
     plain greedy on the cycle model;
  3c. GPT-2 124M training as bench.py's bench_gpt2 runs it
     (profile_train.gpt2_train_workload: B=8, S=1024, bf16 parameters
     with fp32 AdamW masters, dropout 0.1, lr 1e-4): 2 warm-up steps, then
     10 timed on one repeated batch; the losses must be finite and fall,
     and each step must launch exactly 12 flash forward, 12 dK/dV, 12 dQ,
     25 LayerNorm forward and 25 LayerNorm backward kernels and no other
     kernel of the port, every flash launch on the tensor-core path
     (flash_attention.PATH_LAUNCHES) and every LayerNorm backward launch
     on the row-warp design (layer_norm.PATH_LAUNCHES);
  3d. the same training under PADDLE_TPU_FUSED_FFN=1 and
     PADDLE_TPU_FUSED_FFN_BWD=1: each step must also launch exactly 12
     fused FFN forward, 12 dx and 12 dW kernels, every one on the
     tensor-core path (fused_ffn.PATH_LAUNCHES); its step time and
     peak memory are printed beside 3c's;
  3e. FusedMultiTransformer at the same width (L=12, gelu, pre-LN, bf16,
     random weights) over per-layer caches [2, 8, 12, 1024, 64]: a
     128-token chunk at time_step 0, then 127 one-token steps, each call
     launching exactly 12 decode_attention_bhsd and no other attention
     kernel, every one on the split design, outputs finite; then one
     FusedFeedForward forward and backward under the fused FFN flags,
     launching each fused FFN kernel once, all three on the tensor-core
     path;
  3f. LLaMA training at LLaMA-2-7B width (profile_train.
     llama_train_workload: hidden 4096, 32 heads, head_dim 128,
     intermediate 11008, vocab 32000, rms_eps 1e-5, L=4,
     tensor_parallel=True; B=1, S=4096; bf16 with fp32 AdamW masters, lr
     1e-4): 2 warm-up steps, then 10 timed on one repeated batch; the
     losses must be finite and fall, and each step must launch exactly 9
     RMSNorm forward, 9 RMSNorm backward, 4 flash forward, 4 dK/dV and 4
     dQ kernels and no other kernel of the port, the flash ones on the
     tensor-core path and the RMSNorm ones on the row-block design;
  3g. ring attention at LLaMA-2-7B attention width ([1, 4096, 32, 128]
     bf16, random q, k, v from --seed): the ring's schedule for n ranks in
     one process (one card cannot hold two NCCL ranks) at n = 2 and 4
     causal and n = 4 not, forward and backward with remat; each run
     launches exactly 2n^2 ring chunk forward, n^2 dK/dV and n^2 dQ kernels
     and no other kernel of the port, all on the tensor-core path
     (ring_chunk_attention.PATH_LAUNCHES), and matches the dense plain
     attention over the whole sequence and the flash kernels; its wall,
     the flash kernels' and SDPA's over the whole sequence and its peak
     memory are printed;
  4. the same engine at L=2, fp32, under the three schedulers on the card
     and the row scheduler on the CPU (plain versions there), fp and with
     kv_quant="int8", weight_quant="int4", and the row scheduler with
     weight_quant="int8" on both: greedy tokens must be identical within
     each flavor (under an int8 pool the card's phase scheduler against
     the CPU's phase scheduler: its bulk prefill attends exact K/V); the
     dense engines (row, flat, phase fp; row int8 ring) against the
     CPU's dense row engine of the same flavor; sampled with the
     repetition penalty, rotary (sampled) and head_quant="int8" under
     each scheduler against the CPU's row engine (request seeds from
     trng.seed(seed)); prefix caching (4 slots, a shared template) and
     spec_k=4 (greedy, the unscaled cycle model) per scheduler, pool and
     ring, against the CPU's row engine, and sampled spec_k=4 against
     the CPU's engine of the same scheduler, hit and draft counters
     equal; generate_fused fp and int8 ring,
     cache_write_kernel off and on, sampled with a penalty, rotary,
     the int8 head, a second call adopting from a PrefixCache and
     spec_k=4 greedy and sampled, against the CPU's; the slot lifecycle
     (parity_lifecycle: 4 slots, max_pending 3, a fake clock; a
     preemption to the host and its resume, a copy-on-write fork, a
     high-class preemption, max_pending shedding, an export, a deadline)
     under each scheduler, fp, kv8 and sampled with a penalty: states,
     counters and tokens equal to the CPU's run of the same scheduler,
     the card's exported state continued on a second card engine and on
     the CPU as the CPU's own; on a mismatch the
     CPU's top-2
     margin there (of the filtered logits plus the draw's gumbel noise
     when sampled); every
     card launch of a two-design kernel there (the reads and the fused
     writes) on the per-head design (fp32 queries), every dequant-matmul
     launch on the fma one; GPT-2
     training at L=2, B=2, S=128, fp32, dropout 0, 3 AdamW steps, without
     and with the fused FFN: losses, step-1 gradients and step-3
     parameters against the CPU's; FusedMultiTransformer at L=2, fp32: a
     16-token chunk then 8 steps, outputs and caches after every call
     against the CPU's, each launch on the per-head design; LLaMA
     training at phase 3f's widths, L=1, B=1, S=128, fp32, 3 AdamW steps:
     logits, losses, step-1 gradients and step-3 parameters against the
     CPU's; the ring at n = 4 over [2, 256,
     4, 64] with 2 KV heads, fp32: the card's kernels against the CPU's
     composite and plain versions, output and gradients;
  5. each kernel timed at the shapes its path gives it, beside its bound,
     its plain version and one PyTorch call (SDPA forward or backward,
     ATen's LayerNorm forward or backward, F.rms_norm's forward or
     autograd's backward of it, or a matmul on a weight dequantized once)
     computing the same; for the fused FFN three calls (addmm, gelu,
     addmm), and for dx and dW autograd's backward of them for x and for
     (W1, b1, W2), in CUDA graphs; for the flash and ring chunk
     kernels the fastest of SDPA's backends and ATen's flash backward,
     in CUDA graphs as the kernels are; the flash kernels also at phase
     3f's [1, 32, 4096, 128]; the decode reads over a contiguous cache
     (the fp and int8 ring, the one-layer cache) at lens 1023 with Sq 1
     and at 512 with Sq 1 and 16; the ring chunk kernels at phase 3g's
     chunk
     [1, 32, 1024, 128], offsets full and 0, held there as phase 2 holds
     the main flash shapes; the fp flat stream and the RMSNorm kernels
     also on their earlier designs (per head, per warp) on the same
     inputs, and so is the LayerNorm backward (per warp).
The last two lines are the card from nvidia-smi and
{"ok": true, "device": {...}}. Needs one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.incubate.nn import FusedFeedForward
from paddle_tpu_torch.inference import (AdmissionFull, FusedDecoder,
                                        PrefixCache, ServingEngine)
from paddle_tpu_torch.inference.generation import (_absmax_int4,
                                                   _absmax_int8,
                                                   _filter_logits,
                                                   _host_seed, _pack_int4,
                                                   _penalize_slots,
                                                   _presence_from,
                                                   _sample_next,
                                                   _sample_rows,
                                                   generate_fused)
from paddle_tpu_torch.inference import telemetry as tele
from paddle_tpu_torch.inference.paged_kv import BlockPool
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_dequant_matmul as fdm
from paddle_tpu_torch.ops import fused_ffn as ffn
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import ring_chunk_attention as rca
from paddle_tpu_torch.models.gpt import gpt2_124m
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving_cluster import (Gateway, LocalReplica, Router,
                                              export_cluster_trace)
from paddle_tpu_torch.parallel import context_parallel as cpar
from paddle_tpu_torch.profile_serving import (CYCLE, E, FF, H, MIXES,
                                              PRIORITIES, SAMPLED,
                                              SCHEDULERS, V, _random_model,
                                              cycle_head, gpt2_workload)
from paddle_tpu_torch.profile_train import (BATCH, FUSED_FFN_FLAGS,
                                            LLAMA_BATCH, LLAMA_CONFIG,
                                            LLAMA_SEQ, SEQ,
                                            gpt2_train_workload,
                                            llama_train_workload, train_step)
from paddle_tpu_torch.weights import from_jax_state, random_state

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak
BF16_FLOPS_PER_S = 989e12
# (slot, base, count) per flat chunk: aligned, partial, an unaligned base
# straddling a block edge, a pad chunk, one over an unmapped entry (slot
# 2, position 21), deep chunks
FLAT_CASE = [(0, 0, 8), (0, 8, 5), (1, 13, 8), (2, 0, 0), (2, 21, 3),
             (1, 448, 8), (1, 456, 8), (0, 900, 2)]
# quantized flavors served beside the fp one
QUANT = {"kv8-w4": {"kv_quant": "int8", "weight_quant": "int4"},
         "w8": {"weight_quant": "int8"}}
# the engine over the dense ring: run name -> (scheduler, keyword args)
DENSE = {"row-dense": ("row", {"paged": False}),
         "flat-dense": ("flat", {"paged": False}),
         "phase-dense": ("phase", {"paged": False}),
         "row-dense-kv8": ("row", {"paged": False, "kv_quant": "int8"})}
# the engine's sampled runs take SAMPLED (every request submitted with
# repetition_penalty 1.2); generate takes its sampling options
SAMPLE = {k: v for k, v in SAMPLED.items() if k != "enable_repetition_penalty"}
# one-shot generate_fused: run name -> (FusedDecoder keyword args,
# generate keyword args)
GENERATE = {"gen": ({}, {}), "gen-kw": ({"cache_write_kernel": True}, {}),
            "gen-kv8": ({"kv_quant": "int8"}, {}),
            "gen-kv8-kw": ({"kv_quant": "int8", "cache_write_kernel": True},
                           {}),
            "gen-sampled": ({}, {**SAMPLE, "repetition_penalty": 1.2}),
            "gen-beam4": ({}, {"num_beams": 4}),
            "gen-bulk": ({"bulk_prefill": True}, {})}
# known answers, made with the JAX package on the CPU (jax 0.9.0,
# jax_threefry_partitionable on; the card's machine has no JAX): the
# words of jax._src.prng.threefry2x32_p under key (0x12345678,
# 0x9ABCDEF0) at counters (0, i), i = 0..7; and the tokens of
# jax.jit(generation._sample_rows) on (np.random.default_rng(2024)
# .standard_normal((4, 1000)) * 3).astype(np.float32), in fp32 and cast
# to bf16, seeds [11, 22, 33, 44], nt [0, 1, 2, 3]: top_k 50, top_p 0.9,
# temperature 0.8, then top_k 0, top_p 1.0, temperature 1.0
KNOWN_WORDS = ([3978822521, 2085429205, 1630462717, 763154297, 3821564514,
                545324050, 864517526, 984784270],
               [2696639427, 1499321931, 2825784901, 2793666216, 4170576086,
                3839459904, 2075419323, 334005006])
KNOWN_TOKENS = {torch.float32: ([279, 585, 905, 214], [153, 946, 905, 214]),
                torch.bfloat16: ([715, 389, 998, 904],
                                 [715, 389, 998, 904])}
# GPT-2's four layer matmuls: name -> (K, O)
MATMULS = {"qkv": (E, 3 * E), "lin": (E, E), "f1": (E, FF), "f2": (FF, E)}


T0 = time.perf_counter()


def log(msg=""):
    if msg.startswith("=="):              # phase headers carry the clock
        msg += f"  [{time.perf_counter() - T0:.1f} s]"
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
                    label = (f"{str(dtype):15s} Sq={sq:2d} group={group} "
                             f"Bt={bt:2d}")
                    check(f"paged    {label}", got, want, tname, worst)
                    qargs = (args[0], *quantize_pool(args[1]), *args[2:])
                    check(f"paged_i8 {label}",
                          da.decode_attention_paged_i8(*qargs),
                          da.decode_attention_paged_i8_reference(*qargs),
                          tname, worst)
    for dtype, tname in ((torch.bfloat16, "attention_bf16"),
                         (torch.float32, "attention_fp32")):
        for group in (1, 2):
            for bt in (16, 64):
                args = flat_case(rng, FLAT_CASE, h=4, hk=4 // group, d=64,
                                 bt=bt, nblk=1024 // bt, n_layers=2,
                                 layer=1, dtype=dtype, unmapped=(2, 21))
                label = f"{str(dtype):15s} group={group} Bt={bt:2d}"
                qargs = (args[0], *quantize_pool(args[1]), *args[2:])
                pads = [8 * i + r for i, (_, _, n) in enumerate(FLAT_CASE)
                        for r in range(n, 8)]
                for kname, kernel, plain, kargs in (
                        ("flat   ", da.decode_attention_paged_flat,
                         da.decode_attention_paged_flat_reference, args),
                        ("flat_i8", da.decode_attention_paged_flat_i8,
                         da.decode_attention_paged_flat_i8_reference,
                         qargs)):
                    got = kernel(*kargs)
                    check(f"{kname} {label}", got, plain(*kargs), tname,
                          worst)
                    if got[pads].any():
                        raise SystemExit(f"{kname} kernel: pad rows are "
                                         "not 0")
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
    dequant_kernels(rng, worst)
    split_kernels(rng, worst)
    split_i8_kernels(rng, worst)
    flat_split_kernels(rng, worst, quant=False)
    flat_split_kernels(rng, worst, quant=True)
    split_fp_contiguous_kernels(rng, worst)
    split_write_kernels(rng, worst)
    stacked_kernels(rng, worst)
    training_kernels(rng, worst)
    ffn_kernels(rng, worst)
    bhsd_kernels(rng, worst)
    rms_kernels(rng, worst)
    ln_kernels(rng, worst)
    ring_kernels(rng, worst)
    sampler_checks(rng)
    return worst


def gumbel_margin(logits, key, row=None):
    """Top-2 margin of logits plus the gumbel noise ``key`` draws over
    them (one key per row, [B, 2], or one over the batch, [2]; ``row``
    (b, i): logits [1, V] are row i of a [b, V] draw under one key): how
    far the sampled token was from its runner-up."""
    shape = logits.shape if row is None else (row[0], logits.shape[-1])
    g = trng.gumbel(key.to(logits.device), shape, logits.dtype)
    if row is not None:
        g = g[row[1]:row[1] + 1]
    top = (g + logits).float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched that are not views: each
    puts at most one kernel on the card."""
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def device_ops(fn):
    """(card events torch.profiler records for one call of ``fn``, the
    ATen operations it dispatches that are not views)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with _OpCount() as ops:
        fn()
    return (sum(ev.device_type == torch.autograd.DeviceType.CUDA
                for ev in prof.events()), ops.n)


def sampler_checks(rng):
    """The sampler (``core.rng`` and ``_sample_rows`` / ``_sample_next``)
    on the card: the known answers; the threefry words and the uniforms
    of fp32, bf16 and fp16 draws at GPT-2's vocab byte-equal to the
    CPU's; the sampled tokens equal to the CPU's over several (top_k,
    top_p, temperature), with the repetition penalty; and the card
    operations a sampled step's sampler adds."""
    log("  sampler: known answers, then the card against the CPU at "
        f"[8, {V}]")
    dev = torch.device("cuda")
    words = trng.threefry2x32(
        torch.tensor(0x12345678, device=dev),
        torch.tensor(0x9ABCDEF0, device=dev),
        torch.zeros(8, dtype=torch.int64, device=dev),
        torch.arange(8, device=dev))
    if tuple(w.tolist() for w in words) != KNOWN_WORDS:
        raise SystemExit(f"threefry words on the card {words}, JAX's "
                         f"{KNOWN_WORDS}")
    lg = (np.random.default_rng(2024).standard_normal((4, 1000))
          * 3).astype(np.float32)
    seeds = torch.tensor([11, 22, 33, 44], device=dev)
    nt = torch.tensor([0, 1, 2, 3], device=dev)
    for dtype, want in KNOWN_TOKENS.items():
        x = torch.from_numpy(lg).to(device=dev, dtype=dtype)
        got = (_sample_rows(x, True, 50, 0.9, 0.8, seeds, nt).tolist(),
               _sample_rows(x, True, 0, 1.0, 1.0, seeds, nt).tolist())
        if got != want:
            raise SystemExit(f"_sample_rows {dtype} on the card {got}, "
                             f"JAX's {want}")
    b = 8
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31, b))
    nt = torch.from_numpy(rng.integers(0, 500, b))
    keys = trng.fold_in(trng.prng_key(seeds), nt)
    pres = torch.from_numpy(rng.random((b, V)) < 0.01)
    pen = torch.from_numpy(rng.uniform(1.0, 1.5, b).astype(np.float32))
    eos = torch.full((b,), -1)
    draws = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        tiny = torch.finfo(dtype).tiny
        for key in (keys, keys[0]):
            shape = (b, V)
            width = {torch.float32: 32, torch.bfloat16: 8,
                     torch.float16: 16}[dtype]
            same_bytes(f"threefry words {dtype} key {tuple(key.shape)}",
                       trng.random_bits(key.to(dev), width, shape).cpu(),
                       trng.random_bits(key, width, shape), quiet=True)
            same_bytes(f"uniforms {dtype} key {tuple(key.shape)}",
                       trng.uniform(key.to(dev), shape, dtype, tiny,
                                    1.0).cpu(),
                       trng.uniform(key, shape, dtype, tiny, 1.0),
                       quiet=True)
        x = (torch.from_numpy(rng.standard_normal((b, V)).astype(
            np.float32)) * 3).to(dtype)
        for flt in ((50, 0.95, 0.8), (0, 0.9, 1.0), (0, 1.0, 0.7),
                    (200, 1.0, 1.0)):
            for with_pen in (False, True):
                args = (x, pres, pen) if with_pen else (x, None, pen)

                def sample(dev_):
                    lx, p_, r_ = (a if a is None else a.to(dev_)
                                  for a in args)
                    lx = _penalize_slots(lx, p_, r_, nt.to(dev_),
                                         nt.to(dev_), eos.to(dev_))
                    return (_sample_rows(lx, True, *flt, seeds.to(dev_),
                                         nt.to(dev_)).cpu(),
                            _sample_next(lx, True, *flt,
                                         keys[0].to(dev_)).cpu(), lx)
                got_r, got_n, _ = sample(dev)
                want_r, want_n, lx = sample("cpu")
                draws += 2 * b
                if not (torch.equal(got_r, want_r)
                        and torch.equal(got_n, want_n)):
                    f = _filter_logits(lx, True, *flt)
                    raise SystemExit(
                        f"sampled tokens {dtype} {flt} penalty={with_pen}: "
                        f"card {got_r.tolist()} / {got_n.tolist()}, CPU "
                        f"{want_r.tolist()} / {want_n.tolist()}; the CPU's "
                        "top-2 margins of filtered logits plus gumbel "
                        f"{gumbel_margin(f, keys):.3e} (rows), "
                        f"{gumbel_margin(f, keys[0]):.3e} (one key)")
    log(f"  sampler: words and uniforms byte-equal, {draws} sampled tokens "
        "equal to the CPU's, known answers equal to JAX's")
    # ROADMAP Queue 3 J: the bf16 top-p denominator sums the fp32
    # exponentials; the card's masks against the CPU's
    xj = (torch.from_numpy(np.random.default_rng(2025).standard_normal(
        (b, V)).astype(np.float32)) * 3).to(torch.bfloat16)
    neg = torch.tensor(-1e30).to(torch.bfloat16)
    for top_p in (0.95, 0.9):
        got = _filter_logits(xj.to(dev), True, 0, top_p, 0.8).cpu() == neg
        want = _filter_logits(xj, True, 0, top_p, 0.8) == neg
        if not torch.equal(got, want):
            rows = (got != want).any(-1).nonzero().flatten().tolist()
            raise SystemExit(f"bf16 top-p {top_p} masks at [{b}, {V}]: "
                             f"rows {rows} differ from the CPU's")
        log(f"  bf16 top-p {top_p} masks at [{b}, {V}] equal to the CPU's "
            f"({(~got).sum(-1).tolist()} tokens kept a row)")
    x = (torch.randn((b, V), device=dev) * 3).to(torch.bfloat16)
    d_seeds, d_nt, d_pres, d_pen = (a.to(dev) for a in (seeds, nt, pres,
                                                        pen))
    d_eos = eos.to(dev)
    steps = {
        "argmax (greedy)": lambda: _sample_rows(x, False, 0, 1.0, 1.0,
                                                d_seeds, d_nt),
        "_penalize_slots, no presence": lambda: _penalize_slots(
            x, None, d_pen, d_nt, d_nt, d_eos),
        "_penalize_slots with presence": lambda: _penalize_slots(
            x, d_pres, d_pen, d_nt, d_nt, d_eos),
        "_sample_rows top_k 50": lambda: _sample_rows(
            x, True, 50, 1.0, 0.8, d_seeds, d_nt),
        "_sample_rows top_k 50 top_p 0.95": lambda: _sample_rows(
            x, True, 50, 0.95, 0.8, d_seeds, d_nt)}
    for name, fn in steps.items():
        events, ops = device_ops(fn)
        log(f"  sampler ops at [8, {V}] bf16, {name}: {events} card events "
            f"(torch.profiler), {ops} ATen operations not views, "
            f"{time_loop_ms(lambda i=0: fn(), 20):.4f} ms a call (host "
            "included)")


def split_kernels(rng, worst):
    """The paged kernel over long rows that its split design cuts into
    several ranges (nblk 64: 8 ranges at Bt 16, 32 at Bt 64, for the B *
    Hk = 4-16 blocks on 132 SMs), a sentinel inside row 1's table, against
    the plain version; every bf16 and fp16 launch on the split path."""
    reset_launches()
    for dtype, tname in ((torch.bfloat16, "attention_bf16"),
                         (torch.float16, "attention_fp16"),
                         (torch.float32, "attention_fp32")):
        for sq in (1, 16, 128):
            for group in (1, 2, 4):
                for d in (64, 128):
                    for bt in (16, 64):
                        args = attention_case(
                            rng, b=4, h=4, hk=4 // group, sq=sq, d=d, bt=bt,
                            nblk=64, n_layers=2, layer=1,
                            lens=[0, 1, 4000, 2047], dtype=dtype,
                            sentinel_inside=True)
                        check(f"paged split {str(dtype):14s} Sq={sq:3d} "
                              f"group={group} D={d:3d} Bt={bt:2d}",
                              da.decode_attention_paged(*args),
                              da.decode_attention_paged_reference(*args),
                              tname, worst, quiet=True)
    check_paths("paged split cases", {"decode_attention_paged": 2 * 36},
                {"decode_attention_paged": 36})


SPLIT_I8_DTYPES = ((torch.bfloat16, "attention_bf16"),
                   (torch.float16, "attention_fp16"),
                   (torch.float32, "attention_fp32"))
SPLIT_I8_DIMS = (40, 64, 128)     # 40: 8-byte int8 rows (D % 16 != 0)


def split_i8_kernels(rng, worst):
    """The int8 pool's and the int8 ring's kernels over long rows that
    their split design cuts into ranges of 64-position tiles, against the
    plain versions: the pool at nblk 64 (lens 0, 1, 4000 and 2047, a
    sentinel inside row 1's table, Bt 16 and 64), the ring at Smax 128,
    1024 and 4096 (lens 0, mid-tile, Smax - Sq and past the middle); Sq 1,
    16 and 128, GQA groups 1, 2 and 4, D 40, 64 and 128. Every bf16 and
    fp16 launch on the split path, every fp32 one on the per-head one."""
    reset_launches()
    n = 0
    for dtype, tname in SPLIT_I8_DTYPES:
        for sq in (1, 16, 128):
            for group in (1, 2, 4):
                for d in SPLIT_I8_DIMS:
                    for bt in (16, 64):
                        args = attention_case(
                            rng, b=4, h=4, hk=4 // group, sq=sq, d=d, bt=bt,
                            nblk=64, n_layers=2, layer=1,
                            lens=[0, 1, 4000, 2047], dtype=dtype,
                            sentinel_inside=True)
                        qargs = (args[0], *quantize_pool(args[1]), *args[2:])
                        check(f"paged_i8 split {str(dtype):14s} Sq={sq:3d} "
                              f"group={group} D={d:3d} Bt={bt:2d}",
                              da.decode_attention_paged_i8(*qargs),
                              da.decode_attention_paged_i8_reference(*qargs),
                              tname, worst, quiet=True)
                    for smax in (128, 1024, 4096):
                        ring = randn(rng, (2, 2, 4, 4 // group, smax, d),
                                     dtype)
                        kv8, sc = quantize_pool(ring)
                        qt = randn(rng, (4, 4, sq, d), dtype)
                        lens = torch.tensor(
                            [0, 37, smax - sq, smax // 2 + 5],
                            dtype=torch.int32, device="cuda")
                        check(f"stacked_i8 split {str(dtype):14s} "
                              f"Smax={smax:4d} Sq={sq:3d} group={group} "
                              f"D={d:3d}",
                              da.decode_attention_stacked_i8(qt, kv8, sc, 1,
                                                             lens),
                              da.decode_attention_stacked_i8_reference(
                                  qt, kv8, sc, 1, lens), tname, worst,
                              quiet=True)
                    n += 1
    n_fp = n // len(SPLIT_I8_DTYPES)        # the fp32 (per-head) share
    split = {"decode_attention_paged_i8": 2 * (n - n_fp),
             "decode_attention_stacked_i8": 3 * (n - n_fp)}
    per_head = {"decode_attention_paged_i8": 2 * n_fp,
                "decode_attention_stacked_i8": 3 * n_fp}
    log(f"  int8 split cases: worst {dict(worst)}")
    check_paths("int8 split cases", split, per_head)


# the flat split cases: FLAT_CASE plus a chunk across the middle of a
# 2048-position table and one ending on its last block edge
FLAT_SPLIT_CASE = FLAT_CASE + [(1, 1020, 8), (0, 2040, 8)]


def flat_split_kernels(rng, worst, quant):
    """The flat stream's kernel over the fp pool (``quant``: its int8
    flavor) over 2048-position slot tables that its split design cuts
    into ranges of 64-position tiles (decode_splits over the 10 chunks),
    against the plain version: FLAT_SPLIT_CASE (pad rows, a pad chunk,
    unaligned bases straddling a block edge, an unmapped entry, deep
    chunks), GQA groups 1, 2 and 4, D 40, 64 and 128, Bt 16 and 64; rows
    past a chunk's count and the pad chunk exactly 0. Every bf16 and fp16
    launch on the split path, every fp32 one on the per-head one."""
    reset_launches()
    n = collections.Counter()
    pads = [8 * i + r for i, (_, _, c) in enumerate(FLAT_SPLIT_CASE)
            for r in range(c, 8)]
    name = "decode_attention_paged_flat" + ("_i8" if quant else "")
    kernel, plain = getattr(da, name), getattr(da, name + "_reference")
    label0 = "flat_i8" if quant else "flat"
    for dtype, tname in SPLIT_I8_DTYPES:
        for group in (1, 2, 4):
            for d in SPLIT_I8_DIMS:
                for bt in (16, 64):
                    args = flat_case(rng, FLAT_SPLIT_CASE, h=4, hk=4 // group,
                                     d=d, bt=bt, nblk=2048 // bt, n_layers=2,
                                     layer=1, dtype=dtype, unmapped=(2, 21))
                    if quant:
                        args = (args[0], *quantize_pool(args[1]), *args[2:])
                    got = kernel(*args)
                    label = (f"{label0} split {str(dtype):14s} group={group} "
                             f"D={d:3d} Bt={bt:2d}")
                    check(label, got, plain(*args), tname, worst, quiet=True)
                    if got[pads].any():
                        raise SystemExit(f"{label}: pad rows are not 0")
                    n[dtype] += 1
    log(f"  {label0} split cases: {sum(n.values())}, pad rows exactly 0; "
        f"worst {dict(worst)}")
    check_paths(f"{label0} split cases",
                {name: n[torch.bfloat16] + n[torch.float16]},
                {name: n[torch.float32]})


# the dequant cases: GPT-2's four (K, O, transposed), two shapes the
# tensor-core design does not take (O % 16 != 0 contiguous, K/2 % 16 != 0
# transposed), and the row counts of decode, the budgets and bulk prefill
DEQUANT_SHAPES = {**{name: (k, o, name == "qkv")
                     for name, (k, o) in MATMULS.items()},
                  "odd": (168, 200, False), "odd_t": (168, 200, True)}
DEQUANT_ROWS = (1, 8, 16, 17, 37, 128, 512)


def dequant_kernels(rng, worst):
    """The int4 dequant-matmul against its plain version: bf16, fp16 and
    fp32 activations at DEQUANT_ROWS for each of DEQUANT_SHAPES, and
    out_dtype=torch.float32 from bf16 at M 8 and 512 for GPT-2's four;
    every launch on the design dequant_path gives it (bf16 / fp16 at the
    aligned shapes: tensor_core; the rest fma)."""
    reset_launches()
    want = collections.Counter()
    for name, (k, o, transposed) in DEQUANT_SHAPES.items():
        wp, s = packed_weight(rng, k, o, transposed=transposed)
        for dtype, tname in ((torch.bfloat16, "matmul_bf16"),
                             (torch.float16, "matmul_bf16"),
                             (torch.float32, "matmul_fp32")):
            path = fdm.dequant_path(dtype, k, o, int(transposed))
            for m in DEQUANT_ROWS:
                a = randn(rng, (m, k), dtype)
                check(f"dequant_matmul {str(dtype):14s} {name:5s} K={k} "
                      f"O={o} M={m:3d} ({path})",
                      fdm.fused_dequant_matmul(a, wp, s),
                      fdm.fused_dequant_matmul_reference(a, wp, s), tname,
                      worst, quiet=True)
                want[path] += 1
        if name in MATMULS:
            for m in (8, 512):
                a = randn(rng, (m, k), torch.bfloat16)
                got = fdm.fused_dequant_matmul(a, wp, s,
                                               out_dtype=torch.float32)
                if got.dtype != torch.float32:
                    raise SystemExit(f"dequant_matmul {name}: out_dtype "
                                     f"fp32 gave {got.dtype}")
                check(f"dequant_matmul bf16 -> fp32 {name} M={m}", got,
                      fdm.fused_dequant_matmul_reference(
                          a, wp, s, out_dtype=torch.float32),
                      "matmul_bf16", worst, quiet=True)
                want["tensor_core"] += 1
    got = dict(fdm.PATH_LAUNCHES["fused_dequant_matmul"])
    log(f"  dequant cases: launches by path {got}; worst {dict(worst)}")
    if got != {p: want[p] for p in got}:
        raise SystemExit(f"dequant cases: launches by path {got}, want "
                         f"{dict(want)}")


def check_dequant_path(label, path):
    """Fail unless every launch of the dequant-matmul since the counts
    were reset took the design ``path`` (fdm.PATH_LAUNCHES)."""
    got = dict(fdm.PATH_LAUNCHES["fused_dequant_matmul"])
    n = fdm.LAUNCHES["fused_dequant_matmul"]
    log(f"  {label}: fused_dequant_matmul launches by path {got}")
    if got != {p: n if p == path else 0 for p in got}:
        raise SystemExit(f"{label}: fused_dequant_matmul launched {got} by "
                         f"path; every one of {n} must take {path}")


def split_fp_contiguous_kernels(rng, worst):
    """The fp ring's and the one-layer cache's kernels over rows that
    their split design cuts into ranges of 64-position tiles, against the
    plain versions: the ring at Smax 128, 1024 and 4096 (lens 0, mid-tile,
    Smax - Sq and past the middle), the one-layer cache at Smax 32, 1000
    (not a tile multiple) and 1024 with K and V separate tensors (lens 0,
    mid-tile, Smax - Sq and the middle; Sq <= Smax); Sq 1, 16 and 128, GQA
    groups 1, 2 and 4, D 64 and 128. Every bf16 and fp16 launch on the
    split path, every fp32 one on the per-head one."""
    reset_launches()
    n = collections.Counter()
    for dtype, tname in SPLIT_I8_DTYPES:
        for sq in (1, 16, 128):
            for group in (1, 2, 4):
                for d in (64, 128):
                    label = (f"{str(dtype):14s} Sq={sq:3d} group={group} "
                             f"D={d:3d}")
                    qt = randn(rng, (4, 4, sq, d), dtype)
                    for smax in (128, 1024, 4096):
                        ring = randn(rng, (2, 2, 4, 4 // group, smax, d),
                                     dtype)
                        lens = torch.tensor(
                            [0, 37, smax - sq, smax // 2 + 5],
                            dtype=torch.int32, device="cuda")
                        check(f"stacked split {label} Smax={smax:4d}",
                              da.decode_attention_stacked(qt, ring, 1, lens),
                              da.decode_attention_stacked_reference(
                                  qt, ring, 1, lens), tname, worst,
                              quiet=True)
                        n["decode_attention_stacked", dtype] += 1
                    for smax in (32, 1000, 1024):
                        if sq > smax:
                            continue
                        k, v = (randn(rng, (4, 4 // group, smax, d), dtype)
                                for _ in range(2))
                        top = smax - sq
                        lens = torch.tensor([0, min(37, top), top, top // 2],
                                            dtype=torch.int32, device="cuda")
                        check(f"bhsd split {label} Smax={smax:4d}",
                              da.decode_attention_bhsd(qt, k, v, lens),
                              da.decode_attention_bhsd_reference(qt, k, v,
                                                                 lens),
                              tname, worst, quiet=True)
                        n["decode_attention_bhsd", dtype] += 1
    names = ("decode_attention_stacked", "decode_attention_bhsd")
    split = {k: n[k, torch.bfloat16] + n[k, torch.float16] for k in names}
    per_head = {k: n[k, torch.float32] for k in names}
    log(f"  fp contiguous split cases: worst {dict(worst)}")
    check_paths("fp contiguous split cases", split, per_head)


def split_write_kernels(rng, worst):
    """The fp ring's and the int8 ring's fused write kernels over rows
    that their split design cuts into exclusive ranges (below lens[b]) of
    64-position tiles, against the plain versions: B = 7 rows at lens 0,
    63, 64, span - 1, span (either side of the first range's end, span
    decode_splits'), Smax - 1 and Smax (the dropped write), Smax 128, 1024
    and 4096, GQA groups 1, 2 and 4, D 64 and 128. After every call the
    ring, and the int8 ring's scales, hold the plain write's bytes. Every
    bf16 and fp16 launch on the split path, every fp32 one on the per-head
    one."""
    reset_launches()
    n = collections.Counter()
    b, h, layer = 7, 4, 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, tname in SPLIT_I8_DTYPES:
        for group in (1, 2, 4):
            hk = h // group
            for d in (64, 128):
                qt = randn(rng, (b, h, 1, d), dtype)
                kv_new = randn(rng, (2, b, hk, 1, d), torch.float32)
                for smax in (128, 1024, 4096):
                    span = da.decode_splits(b, hk, smax, n_sm)[1]
                    lens = torch.tensor(
                        [0, 63, 64, span - 1, span, smax - 1, smax],
                        dtype=torch.int32, device="cuda")
                    label = (f"{str(dtype):14s} Smax={smax:4d} span={span:4d} "
                             f"group={group} D={d:3d}")
                    ring = randn(rng, (2, 2, b, hk, smax, d), dtype)
                    kv8, sc = quantize_pool(ring)
                    rings = (ring, ring.clone())
                    _, got = da.decode_attention_stacked_write(
                        qt, kv_new, rings[0], layer, lens)
                    _, want = da.decode_attention_stacked_write_reference(
                        qt, kv_new, rings[1], layer, lens)
                    check(f"stacked_write split {label}", got, want, tname,
                          worst, quiet=True)
                    same_bytes(f"stacked_write split {label} ring", *rings,
                               quiet=True)
                    i8s = ((kv8, sc), (kv8.clone(), sc.clone()))
                    *_, got = da.decode_attention_stacked_i8_write(
                        qt, kv_new, *i8s[0], layer, lens)
                    *_, want = da.decode_attention_stacked_i8_write_reference(
                        qt, kv_new, *i8s[1], layer, lens)
                    check(f"stacked_i8_write split {label}", got, want,
                          tname, worst, quiet=True)
                    same_bytes(f"stacked_i8_write split {label} ring",
                               i8s[0][0], i8s[1][0], quiet=True)
                    same_bytes(f"stacked_i8_write split {label} scales",
                               i8s[0][1], i8s[1][1], quiet=True)
                    n[dtype] += 1
    names = ("decode_attention_stacked_write",
             "decode_attention_stacked_i8_write")
    n_split = n[torch.bfloat16] + n[torch.float16]
    log(f"  split write cases: {sum(n.values())} a kernel, rings and scales "
        f"byte-equal to the plain writes; worst {dict(worst)}")
    check_paths("split write cases", {k: n_split for k in names},
                {k: n[torch.float32] for k in names})


def check_all_per_head(label):
    """Fail unless every launch of the two-design decode kernels since
    the counts were reset took the per-head design, and every launch of
    the dequant-matmul the fma one (fp32 queries and activations)."""
    ran = {k: da.LAUNCHES[k] for k in da.PATH_LAUNCHES if da.LAUNCHES[k]}
    check_paths(label, {k: 0 for k in ran}, ran)
    check_dequant_path(label, "fma")


def check_paths(label, split, per_head=None):
    """Fail unless the decode kernels named in ``split`` ({name: n}) made
    exactly n launches on the split design since the counts were reset,
    and exactly ``per_head`` ({name: n}, else none) on the per-head one
    (decode_attention.PATH_LAUNCHES)."""
    per_head = per_head or {}
    for name, n in split.items():
        got = dict(da.PATH_LAUNCHES[name])
        want = {"split_kv": n, "per_head": per_head.get(name, 0)}
        log(f"  {label}: {name} launches by path {got}")
        if got != want:
            raise SystemExit(f"{label}: {name} launched {got} by path, "
                             f"want {want}")


# RMSNorm widths: small, the row-block design's narrowest (bf16 1024),
# fp32's widest there (2048), LLaMA-2 7B's, 13B's, 65B's and the gate's
# largest; 97 and 4097 take the kernels' scalar path (not a multiple of a
# vector) and the per-warp design
RMS_DIMS = (64, 97, 128, 1024, 2048, 4096, 4097, 5120, 8192, 16384)
RMS_ROWS = (1, 7, 33, 4096, 4097)


def rms_kernels(rng, worst):
    """The RMSNorm forward and backward kernels against their plain
    versions at RMS_DIMS and RMS_ROWS, fp32, bf16 and fp16, eps 1e-5 and
    1e-6 in turn: y, rstd, dx and dgamma each; the backward twice on the
    same inputs, its dx and dgamma bit-equal between the two launches
    (dgamma's partials are summed in a fixed order, no atomics). Each
    launch on the design rms_norm_path gives its shape
    (layer_norm.PATH_LAUNCHES)."""
    reset_launches()
    want_paths = {k: collections.Counter() for k in RMS_KERNELS}
    for dtype, tname in ((torch.float32, "layer_norm_fp32"),
                         (torch.bfloat16, "layer_norm_bf16"),
                         (torch.float16, "layer_norm_fp16")):
        for d in RMS_DIMS:
            path = ln.rms_norm_path(dtype, d)
            for i, n in enumerate(RMS_ROWS):
                eps = (1e-5, 1e-6)[i % 2]
                x, dy = (randn(rng, (n, d), dtype) for _ in range(2))
                gamma = (1 + 0.1 * randn(rng, (d,), torch.float32)).to(dtype)
                name = (f"rms_norm {str(dtype):14s} N={n:4d} D={d:5d} "
                        f"eps={eps} {path}")
                y, rstd = ln.rms_norm_fwd(x, gamma, eps)
                want = ln.rms_norm_fwd_reference(x, gamma, eps)
                for part, g, w in zip(("y", "rstd"), (y, rstd), want):
                    check(f"{name} {part}", g, w, tname, worst, quiet=True)
                got = ln.rms_norm_bwd(x, gamma, rstd, dy)
                want = ln.rms_norm_bwd_reference(x, gamma, rstd, dy)
                for part, g, w in zip(("dx", "dgamma"), got, want):
                    check(f"{name} {part}", g, w, tname, worst, quiet=True)
                again = ln.rms_norm_bwd(x, gamma, rstd, dy)
                for part, g, w in zip(("dx", "dgamma"), got, again):
                    same_bytes(f"{name} {part} on a second launch", g, w,
                               quiet=True)
                want_paths["rms_norm_fwd"][path] += 1
                want_paths["rms_norm_bwd"][path] += 2
    log(f"  RMSNorm cases: {len(RMS_DIMS) * len(RMS_ROWS) * 3}, dx and "
        f"dgamma bit-equal on a second launch; worst {dict(worst)}")
    check_norm_paths("RMSNorm cases", want_paths)


# LayerNorm widths: small, not a whole number of vectors (the per-warp
# design), the row-warp design's narrowest in bf16 (256), GPT-2's 768
# (124M), 1024 (medium) and 1600 (XL), the last two per warp
LN_DIMS = (64, 97, 256, 768, 1024, 1600)
LN_ROWS = (1, 7, 33, 8192, 8193)


def ln_kernels(rng, worst):
    """The LayerNorm forward and backward kernels against their plain
    versions at LN_DIMS and LN_ROWS, fp32, bf16 and fp16: y, mean, rstd,
    dx, dgamma and dbeta each; the backward twice on the same inputs, its
    outputs bit-equal between the two launches (dgamma's and dbeta's
    partials are summed in a fixed order, no atomics). Each backward
    launch on the design layer_norm_path gives its shape
    (layer_norm.PATH_LAUNCHES)."""
    reset_launches()
    want_paths = collections.Counter()
    for dtype, tname in ((torch.float32, "layer_norm_fp32"),
                         (torch.bfloat16, "layer_norm_bf16"),
                         (torch.float16, "layer_norm_fp16")):
        for d in LN_DIMS:
            path = ln.layer_norm_path(dtype, d)
            for n in LN_ROWS:
                x, dy = (randn(rng, (n, d), dtype) for _ in range(2))
                gamma = (1 + 0.1 * randn(rng, (d,), torch.float32)).to(dtype)
                beta = (0.1 * randn(rng, (d,), torch.float32)).to(dtype)
                name = f"layer_norm {str(dtype):14s} N={n:4d} D={d:4d} {path}"
                y, mean, rstd = ln.layer_norm_fwd(x, gamma, beta)
                want = ln.layer_norm_fwd_reference(x, gamma, beta)
                for part, g, w in zip(("y", "mean", "rstd"),
                                      (y, mean, rstd), want):
                    check(f"{name} {part}", g, w, tname, worst, quiet=True)
                got = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
                want = ln.layer_norm_bwd_reference(x, gamma, mean, rstd, dy)
                again = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
                for part, g, w, a in zip(("dx", "dgamma", "dbeta"), got,
                                         want, again):
                    check(f"{name} {part}", g, w, tname, worst, quiet=True)
                    same_bytes(f"{name} {part} on a second launch", g, a,
                               quiet=True)
                want_paths[path] += 2
    log(f"  LayerNorm cases: {len(LN_DIMS) * len(LN_ROWS) * 3}, dx, dgamma "
        f"and dbeta bit-equal on a second launch; worst {dict(worst)}")
    check_norm_paths("LayerNorm cases", {"layer_norm_bwd": want_paths})


# the RMSNorm kernels, each with two designs (layer_norm.PATH_LAUNCHES)
RMS_KERNELS = ("rms_norm_fwd", "rms_norm_bwd")


def check_norm_paths(label, want):
    """Fail unless the norm kernels named in ``want`` ({name: {path: n}})
    made exactly those launches by design since the counts were reset
    (layer_norm.PATH_LAUNCHES)."""
    for name, paths in want.items():
        got = dict(ln.PATH_LAUNCHES[name])
        full = {p: paths.get(p, 0) for p in got}
        log(f"  {label}: {name} launches by path {got}")
        if got != full:
            raise SystemExit(f"{label}: {name} launched {got} by path, "
                             f"want {full}")


# the ring chunk kernels' (Sq, Sk): ragged, one tile, the LLaMA ring's
# chunk (S = 4096 over n = 4) and Sq != Sk
RING_SHAPES = ((37, 37), (256, 256), (1024, 1024), (100, 257))


def ring_kernels(rng, worst):
    """The ring chunk kernels against their plain versions: fp32, bf16
    and fp16; D 64 and 128; H 8 over Hk 8 and 2; RING_SHAPES; offsets Sk
    (full), Sk - 1, 0, -17, -Sq and -Sq - 5 (fully masked). The forward's
    o and lse, then dq, dk and dv from random cotangents of both (dlse !=
    0) and the kernel's o and lse; fully masked launches exactly o = 0,
    lse = -1e30 and zero gradients. One log line per shape, the worst
    error of each output over its offsets."""
    for dtype, tname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"),
                         (torch.float16, "fp16")):
        for d in (64, 128):
            for hk in (8, 2):
                for sq, sk in RING_SHAPES:
                    q, do = (randn(rng, (1, 8, sq, d), dtype)
                             for _ in range(2))
                    k, v = (randn(rng, (1, hk, sk, d), dtype)
                            for _ in range(2))
                    dlse = randn(rng, (1, 8, sq), torch.float32)
                    label = (f"ring_chunk {str(dtype):14s} D={d} H=8 "
                             f"Hk={hk} Sq={sq} Sk={sk}")
                    errs = {}
                    for off in (sk, sk - 1, 0, -17, -sq, -sq - 5):
                        o, lse = rca.ring_chunk_attention_fwd(q, k, v, off)
                        want = rca.ring_chunk_attention_reference(q, k, v,
                                                                  off)
                        delta = (do.float() * o.float()).sum(-1) - dlse
                        got = (o, lse, rca.ring_chunk_attention_bwd_dq(
                            q, k, v, do, lse, delta, off),
                            *rca.ring_chunk_attention_bwd_dkv(
                                q, k, v, do, lse, delta, off))
                        want = (*want, *rca.ring_chunk_attention_bwd_reference(
                            q, k, v, o, lse, do, dlse, off))
                        for part, g, w in zip(("o", "lse", "dq", "dk", "dv"),
                                              got, want):
                            tol = ("attention_" if part in ("o", "lse") else
                                   "attention_grad_") + tname
                            errs[part] = max(errs.get(part, 0.0), check(
                                f"{label} offset={off} {part}", g, w, tol,
                                worst, quiet=True))
                            if not torch.isfinite(g).all():
                                raise SystemExit(f"{label} offset={off} "
                                                 f"{part}: not finite")
                        zero = not any(x.any() for x in (o, *got[2:]))
                        if off <= -sq and not (zero and torch.equal(
                                lse, torch.full_like(lse, -1e30))):
                            raise SystemExit(
                                f"{label} offset={off}: a fully masked "
                                "launch must give o = 0, lse = -1e30 and "
                                "zero gradients")
                    log(f"  {label}: worst over the offsets "
                        f"{ {p: f'{e:.3e}' for p, e in errs.items()} } ok")


# the fused FFN's (K, F): a small one, GPT-2's and a LLaMA-like 2816
FFN_SHAPES = ((128, 256), (768, 3072), (1024, 2816))


def ffn_inputs(rng, m, k, f, dtype):
    """x, g [M, K] normal; W1 [K, F] and W2 [F, K] scaled by 1/sqrt(fan
    in); biases 0.1 normal: (x, g, w1, b1, w2, b2) in dtype."""
    x, g = (randn(rng, (m, k), dtype) for _ in range(2))
    w1 = (randn(rng, (k, f), torch.float32) / k ** 0.5).to(dtype)
    w2 = (randn(rng, (f, k), torch.float32) / f ** 0.5).to(dtype)
    b1 = (0.1 * randn(rng, (f,), torch.float32)).to(dtype)
    b2 = (0.1 * randn(rng, (k,), torch.float32)).to(dtype)
    return x, g, w1, b1, w2, b2


def ffn_kernels(rng, worst):
    """The three fused FFN kernels against their plain versions at
    FFN_SHAPES, M 8, 136 and 8192, both activations, fp32, bf16 and fp16:
    the output, dx, dW1, dW2 and db1 each (16-bit dW1 and dW2 to their
    own tolerance: sums over M of a factor rounded to the dtype; fp16,
    with 3 more mantissa bits than bf16, to bf16's tolerances)."""
    for dtype, tname, wname in (
            (torch.float32, "ffn_fp32_large", "ffn_fp32_large"),
            (torch.bfloat16, "ffn_bf16", "ffn_wgrad_bf16"),
            (torch.float16, "ffn_bf16", "ffn_wgrad_bf16")):
        for k, f in FFN_SHAPES:
            for m in (8, 136, 8192):
                x, g, w1, b1, w2, b2 = ffn_inputs(rng, m, k, f, dtype)
                for act in ("gelu_tanh", "gelu"):
                    name = (f"fused_ffn {str(dtype):14s} M={m:4d} K={k:4d} "
                            f"F={f} {act:9s}")
                    check(f"{name} out", ffn.fused_ffn_fwd(x, w1, b1, w2, b2,
                                                           act),
                          ffn.fused_ffn_fwd_reference(x, w1, b1, w2, b2, act),
                          tname, worst)
                    check(f"{name} dx", ffn.fused_ffn_bwd_dx(x, g, w1, b1, w2,
                                                             act),
                          ffn.fused_ffn_bwd_dx_reference(x, g, w1, b1, w2,
                                                         act), tname, worst)
                    got = ffn.fused_ffn_bwd_dw(x, g, w1, b1, w2, act)
                    want = ffn.fused_ffn_bwd_dw_reference(x, g, w1, b1, w2,
                                                          act)
                    for part, a, b, tn in zip(("dW1", "dW2", "db1"), got,
                                              want, (wname, wname, tname)):
                        check(f"{name} {part}", a, b, tn, worst)


def bhsd_kernels(rng, worst):
    """decode_attention_bhsd against its plain version, in both layouts
    (``decode_attention_bhsd`` and ``decode_attention``): B 1 and 8, H
    12, Hk 12 and 6, D 64 and 128, Sq 1, 4 and 128, Smax 32, 1000 (not a
    tile multiple) and 1024, lens 0, mid-tile and Smax - Sq."""
    h = 12
    for dtype, tname in ((torch.bfloat16, "attention_bf16"),
                         (torch.float32, "attention_fp32")):
        for b in (1, 8):
            for hk in (12, 6):
                for d in (64, 128):
                    for smax in (32, 1000, 1024):
                        k, v = (randn(rng, (b, hk, smax, d), dtype)
                                for _ in range(2))
                        for sq in (1, 4, 128):
                            if sq > smax:
                                continue
                            top = smax - sq
                            lens = ([top] if b == 1 else
                                    [0, min(13, top), top, top // 2] * 2)
                            lens = torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
                            qt = randn(rng, (b, h, sq, d), dtype)
                            label = (f"bhsd {str(dtype):14s} B={b} Hk={hk:2d} "
                                     f"D={d:3d} Smax={smax:4d} Sq={sq:3d}")
                            want = da.decode_attention_bhsd_reference(
                                qt, k, v, lens)
                            check(label, da.decode_attention_bhsd(
                                qt, k, v, lens), want, tname, worst)
                            got = da.decode_attention(
                                qt.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), lens)
                            check(label + " [B, S, H, D]",
                                  got.transpose(1, 2), want, tname, worst)


# flash attention cases of the training kernels: (B, H, Hk, Sq, Sk, D,
# causal) — Sq = Sk, Sq < Sk and Sq > Sk (rows that see no key), GQA,
# ragged tiles, D 64 and 128, GPT-2's [1, 12, 1024, 64]
FLASH_BWD_CASES = [(2, 4, 4, 37, 37, 64, True), (1, 4, 2, 255, 255, 64, True),
                   (1, 4, 4, 200, 333, 64, False),
                   (1, 4, 2, 100, 257, 128, True),
                   (1, 4, 4, 300, 129, 64, True),
                   (1, 12, 12, 1024, 1024, 64, True)]


# (D, Sq, Sk) of dropout_in_tiles: Sq and Sk at most D, ragged and whole
# 64-key tiles, Sq off and on a multiple of the four rows of one draw
DROPOUT_TILE_CASES = ((64, 37, 64), (64, 64, 29), (128, 100, 128),
                      (128, 128, 100))


def dropout_in_tiles(rng):
    """The keep bits as the flash kernels draw them inside their tiles,
    byte for byte against dropout_keep (bf16, not causal, B 2, H 3, p 0.1
    and 0.5, DROPOUT_TILE_CASES). An identity operand makes each draw an
    output element that is zero exactly where its key is dropped: the
    forward with v = I[:Sk] gives o[i, j] = p m / l; dK/dV with q = dO =
    I[:Sq] and delta = 0 gives dv[j, i] = p m and dk[j, i] = p m dP scale;
    dQ with k = I[:Sk] and delta = 0 gives dq[i, j] = p m dP scale (p > 0
    and dP almost surely nonzero for random inputs)."""
    b, h = 2, 3
    for d, sq, sk in DROPOUT_TILE_CASES:
        eye = torch.eye(d, dtype=torch.bfloat16, device="cuda")

        def ident(n):
            return eye[:n].expand(b, h, n, d).contiguous()
        q, do = (randn(rng, (b, h, sq, d), torch.bfloat16) for _ in range(2))
        k, v = (randn(rng, (b, h, sk, d), torch.bfloat16) for _ in range(2))
        zero = torch.zeros((b, h, sq), dtype=torch.float32, device="cuda")
        for p in (0.1, 0.5):
            seed = int(rng.integers(1 << 63))
            keep = fa.dropout_keep(seed, b, h, sq, sk, p, "cpu").cuda()
            label = f"[{b}, {h}, {sq}, {sk}] D={d} p={p}"
            o, _ = fa.flash_attention_fwd(q, k, ident(sk), False, None, p,
                                          seed)
            same_bytes(f"dropout bits in the forward's tiles {label}",
                       o[..., :sk] != 0, keep)
            _, lse = fa.flash_attention_fwd(ident(sq), k, v, False, None, p,
                                            seed)
            dk, dv = fa.flash_attention_bwd_dkv(
                ident(sq), k, v, ident(sq), lse, zero, False, None, p, seed)
            same_bytes(f"dropout bits in dK/dV's tiles (dv) {label}",
                       (dv[..., :sq] != 0).transpose(-1, -2), keep)
            same_bytes(f"dropout bits in dK/dV's tiles (dk) {label}",
                       (dk[..., :sq] != 0).transpose(-1, -2), keep)
            _, lse = fa.flash_attention_fwd(q, ident(sk), v, False, None, p,
                                            seed)
            dq = fa.flash_attention_bwd_dq(q, ident(sk), v, do, lse, zero,
                                           False, None, p, seed)
            same_bytes(f"dropout bits in dQ's tiles {label}",
                       dq[..., :sk] != 0, keep)


# the main paths' flash shapes (B, H, S, D, dropout), causal: LLaMA's at
# phase 3f and GPT-2's training at phase 3c
FLASH_MAIN_CASES = ((1, 32, 4096, 128, 0.0), (8, 12, 1024, 64, 0.1))


def training_kernels(rng, worst):
    """The training path's kernels against their plain versions: the
    dropout keep bits byte-equal to the plain version's, from the mask
    kernel and from inside the flash kernels' tiles (dropout_in_tiles);
    flash forward (with dropout) and the dK/dV and dQ kernels at
    FLASH_BWD_CASES, bf16, fp16 and fp32, dropout 0 and 0.1 (one seed for
    forward and backward), then bf16 at FLASH_MAIN_CASES. lse is held to
    attention_lse (fp32 in every dtype); the backward is fed the kernel's
    o and lse, then the plain forward's, both sides the same each time. At
    FLASH_MAIN_CASES o and the gradients are held relative to the
    reference's rms (check_scaled)."""
    for b, h, sq, sk, p in ((2, 4, 37, 70, 0.1), (1, 12, 1024, 1024, 0.1),
                            (1, 3, 5, 9, 0.5)):
        seed = int(rng.integers(1 << 63))
        same_bytes(f"dropout keep bits [{b}, {h}, {sq}, {sk}] p={p}",
                   fa.dropout_keep(seed, b, h, sq, sk, p, "cuda"),
                   fa.dropout_keep(seed, b, h, sq, sk, p, "cpu").cuda())
    dropout_in_tiles(rng)
    cases = [(dtype, tname, case, p, check) for dtype, tname in (
        (torch.bfloat16, "bf16"), (torch.float16, "fp16"),
        (torch.float32, "fp32")) for case in FLASH_BWD_CASES
        for p in (0.0, 0.1)]
    cases += [(torch.bfloat16, "bf16", (b, h, h, s, s, d, True), p,
               check_scaled) for b, h, s, d, p in FLASH_MAIN_CASES]
    for dtype, tname, (b, h, hk, sq, sk, d, causal), p, held in cases:
        q, do = (randn(rng, (b, h, sq, d), dtype) for _ in range(2))
        k, v = (randn(rng, (b, hk, sk, d), dtype) for _ in range(2))
        seed = int(rng.integers(1 << 63))
        name = (f"flash {str(dtype):15s} B={b} H={h} Hk={hk} Sq={sq} "
                f"Sk={sk} D={d} causal={int(causal)} p={p} "
                f"({fa.kernel_path(dtype, d)})")
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, p, seed)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, None,
                                                      p, seed)
        held(name + " o", o, o_ref, "attention_" + tname, worst)
        check(name + " lse", lse, lse_ref, "attention_lse", worst)
        for what, fo, flse in (("", o, lse), (" from plain o, lse", o_ref,
                                               lse_ref)):
            got = fa.flash_attention_bwd(q, k, v, fo, flse, do, causal, None,
                                         p, seed)
            want = fa.flash_attention_bwd_reference(q, k, v, fo, flse, do,
                                                    causal, None, p, seed)
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                held(f"{name} {gname}{what}", g, w, "attention_grad_" + tname,
                     worst)
            del got, want
        del q, k, v, do, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()


def stacked_kernels(rng, worst):
    """The four dense-ring kernels against their plain versions: reads at
    Smax 128 and 1024, Sq 1, 16 and 128, GQA groups 1 and 2, lens at 0,
    mid-tile, Smax - Sq and past the middle; the write kernels at lens 0,
    mid-tile, Smax - 1 and Smax (the dropped write), with the ring and
    scales after the call byte-equal to the plain write's."""
    b, h, d, n_layers, layer = 4, 4, 64, 2, 1
    for dtype, tname in ((torch.bfloat16, "attention_bf16"),
                         (torch.float32, "attention_fp32")):
        for smax in (128, 1024):
            for group in (1, 2):
                hk = h // group
                ring = randn(rng, (n_layers, 2, b, hk, smax, d), dtype)
                kv8, sc = _absmax_int8(ring, -1)
                sc = sc.transpose(-1, -2).contiguous()
                for sq in (1, 16, 128):
                    qt = randn(rng, (b, h, sq, d), dtype)
                    lens = torch.tensor([0, 37, smax - sq, smax // 2 + 5],
                                        dtype=torch.int32, device="cuda")
                    label = (f"{str(dtype):15s} Smax={smax:4d} Sq={sq:3d} "
                             f"group={group}")
                    check(f"stacked          {label}",
                          da.decode_attention_stacked(qt, ring, layer, lens),
                          da.decode_attention_stacked_reference(
                              qt, ring, layer, lens), tname, worst)
                    check(f"stacked_i8       {label}",
                          da.decode_attention_stacked_i8(qt, kv8, sc, layer,
                                                         lens),
                          da.decode_attention_stacked_i8_reference(
                              qt, kv8, sc, layer, lens), tname, worst)
                qt = randn(rng, (b, h, 1, d), dtype)
                kv_new = randn(rng, (2, b, hk, 1, d), torch.float32)
                lens = torch.tensor([0, 37, smax - 1, smax],
                                    dtype=torch.int32, device="cuda")
                label = f"{str(dtype):15s} Smax={smax:4d} group={group}"
                rings = [ring.clone() for _ in range(2)]
                _, got = da.decode_attention_stacked_write(
                    qt, kv_new, rings[0], layer, lens)
                _, want = da.decode_attention_stacked_write_reference(
                    qt, kv_new, rings[1], layer, lens)
                check(f"stacked_write    {label}", got, want, tname, worst)
                same_bytes(f"stacked_write    {label} ring", *rings)
                i8s = [(kv8.clone(), sc.clone()) for _ in range(2)]
                *_, got = da.decode_attention_stacked_i8_write(
                    qt, kv_new, *i8s[0], layer, lens)
                *_, want = da.decode_attention_stacked_i8_write_reference(
                    qt, kv_new, *i8s[1], layer, lens)
                check(f"stacked_i8_write {label}", got, want, tname, worst)
                same_bytes(f"stacked_i8_write {label} ring", i8s[0][0],
                           i8s[1][0])
                same_bytes(f"stacked_i8_write {label} scales", i8s[0][1],
                           i8s[1][1])
                if torch.equal(rings[0], ring) or not torch.equal(
                        rings[0][:, :, 3], ring[:, :, 3]):
                    raise SystemExit(f"stacked_write {label}: rows 0-2 must "
                                     "land and the full row 3 must drop")


def same_bytes(name, got, want, quiet=False):
    """Fail unless the two tensors hold the same bytes (``quiet``: logged
    only on a failure)."""
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise SystemExit(f"{name}: the bytes differ")
    if not quiet:
        log(f"  {name}: byte-equal ok")


def quantize_pool(pool):
    """An fp pool's int8 flavor by the engine's write recipe: int8 codes
    and per-position scales [L, 2, NB, Hk, 1, Bt]."""
    kv, sc = _absmax_int8(pool, -1)
    return kv, sc.transpose(-1, -2).contiguous()


def packed_weight(rng, k, o, transposed):
    """A random [K, O] weight quantized and packed to int4 as the stack
    does: contiguous [K/2, O] (lin, f1, f2), or for qkv the transpose of
    a packed [O, K/2], which is the view qkv_of hands the kernel.
    Returns (packed, scales [1, O])."""
    w = randn(rng, (o, k) if transposed else (k, o), torch.float32) / k ** .5
    if transposed:
        q, s = _absmax_int4(w, -1)
        return _pack_int4(q, -1).T, s.T.contiguous()
    q, s = _absmax_int4(w, 0)
    return _pack_int4(q, 0), s


def check(name, got, want, tname, worst, quiet=False):
    """Fail unless got matches want within TOLERANCES[tname]; returns the
    largest absolute error (``quiet``: logged only on a failure)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOLERANCES[tname]
    ok = torch.allclose(got.float(), want.float(), **tol)
    if not (quiet and ok):
        log(f"  {name}: max_abs_err={err:.3e} (atol={tol['atol']}, "
            f"rtol={tol['rtol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        a, b = got.float().flatten(), want.float().flatten()
        excess = (a - b).abs() - (tol["atol"] + tol["rtol"] * b.abs())
        i = int(excess.argmax())
        log(f"  {name}: {int((excess > 0).sum())} of {b.numel()} elements "
            f"outside; the worst at flat index {i}: got {a[i].item():.6e}, "
            f"want {b[i].item():.6e}")
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    worst[tname] = max(worst.get(tname, 0.0), err)
    return err


def check_scaled(name, got, want, tname, worst, quiet=False):
    """check() with both sides over the reference's rms: at the main
    shapes o and the gradients lie far below 1 (o of random inputs over
    thousands of keys is about 0.03), where TOLERANCES' atol alone would
    pass a kernel that dropped a key tile. The worst relative error goes
    under ``tname + "/rms"``."""
    rms = want.float().pow(2).mean().sqrt().item()
    if not rms > 0:
        raise SystemExit(f"{name}: the reference is zero")
    seen = {}
    err = check(f"{name} (over rms {rms:.3e})", got.float() / rms,
                want.float() / rms, tname, seen, quiet)
    worst[tname + "/rms"] = max(worst.get(tname + "/rms", 0.0), err)
    return err


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


def serve(eng, reqs, **submit_kw):
    """Submit (prompt, max_new) pairs, run to the end; returns
    ({rid: tokens}, steps, seconds)."""
    rids = [eng.submit(p, max_new_tokens=m, **submit_kw) for p, m in reqs]
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
        "the row, flat and phase schedulers, fp and quantized")
    runs = {}
    for flavor in ("", "-kv8-w4"):
        for sched, kwargs in SCHEDULERS.items():
            runs[sched + flavor] = serve_counted(
                seed, sched + flavor,
                {**kwargs, **QUANT.get(flavor[1:], {})})
    runs["row-w8"] = serve_counted(seed, "row-w8", QUANT["w8"])
    for name, (sched, kwargs) in DENSE.items():
        runs[name] = serve_counted(seed, name,
                                   {**SCHEDULERS[sched], **kwargs})
    t0 = time.perf_counter()
    for sched, kwargs in SCHEDULERS.items():
        runs[sched + "-sampled"] = serve_counted(
            seed, sched + "-sampled", {**kwargs, **SAMPLED})
    runs["row-rotary"] = serve_counted(seed, "row-rotary",
                                       {"use_rotary": True, **SAMPLED})
    log(f"  the sampled and rotary runs: {time.perf_counter() - t0:.1f} s")
    runs.update(option_runs(seed))
    runs.update(lifecycle_runs(seed))
    for name, run in runs.items():
        kv8, w4, dense = "kv8" in name, "w4" in name, "dense" in name
        read = ("decode_attention_stacked" if dense
                else "decode_attention_paged") + ("_i8" if kv8 else "")
        need = {"row": [read],
                # a ring's flat segments are torch ops (JAX: XLA ops)
                "flat": [read] if dense else [
                    read.replace("paged", "paged_flat"), read],
                "phase": ["flash_attention_fwd", read]}[name.split("-")[0]]
        need += ["fused_dequant_matmul"] if w4 else []
        # a pool never runs a ring kernel nor a ring a pool kernel, an
        # int8 cache never an fp attention kernel, and the engine never
        # the fused write kernels
        banned = [k for k in da.LAUNCHES
                  if ("stacked" in k) != dense or (kv8 and "_i8" not in k)
                  or "write" in k]
        got = run["launches"]
        if not all(got[k] for k in need) or any(got[k] for k in banned):
            raise SystemExit(f"the {name} run must launch {need} and none "
                             f"of {banned}: {got}")
    check_bytes(runs)
    return {name: run["launches"] for name, run in runs.items()}


# this slice's options in phase 3: name -> (scheduler, request mix, the
# option's engine keyword arguments); each is served with the option off
# too ("-off"), in the same call
OPTIONS = {"row-prefix": ("row", "prefix", {"prefix_cache_blocks": 64}),
           "phase-prefix": ("phase", "prefix", {"prefix_cache_blocks": 64}),
           "row-spec": ("row", "spec", {"spec_k": 4}),
           "flat-spec": ("flat", "spec", {"spec_k": 4}),
           "phase-spec": ("phase", "spec", {"spec_k": 4})}


def option_runs(seed):
    """Prefix caching and speculative decoding at phase 3's width: each
    OPTIONS mix served with its option and without, the same launch and
    design checks as the other runs, and the option's counters, tokens/s
    and TTFT beside the run without it."""
    t0 = time.perf_counter()
    runs = {}
    for name, (sched, mix, opt) in OPTIONS.items():
        for off in (True, False):
            key = name + ("-off" if off else "")
            runs[key] = serve_counted(seed, key, {
                **SCHEDULERS[sched], **({} if off else opt)}, mix=mix)
        on, base = runs[name], runs[name + "-off"]
        m, mo = on["metrics"], base["metrics"]
        same = np.mean([np.array_equal(a, b)
                        for a, b in zip(on["tokens"], base["tokens"])])
        log(f"  [{name}] against the same mix without the option: "
            f"generated tokens/s {on['tokens_per_s']:.1f} / "
            f"{base['tokens_per_s']:.1f} "
            f"({on['tokens_per_s'] / base['tokens_per_s']:.3f}x), TTFT p50 "
            f"{m['ttft_p50_s']:.4f} / {mo['ttft_p50_s']:.4f} s, p99 "
            f"{m['ttft_p99_s']:.4f} / {mo['ttft_p99_s']:.4f} s; "
            f"requests with the same tokens {same:.3f} (bf16)")
        if "prefix" in name and not m["prefix_hits"]:
            raise SystemExit(f"[{name}] no prefix hit: {m}")
        if "spec" in name:
            forms = on["forms"]
            # a phase-scheduler verify pass reads K+1 = 5 positions a row
            if sched == "phase" and m["draft_proposed"] and not forms.get(5):
                raise SystemExit(f"[{name}] verified drafts without a "
                                 f"K+1 block: forms {forms}")
            if sched == "row" and not forms.get(16):
                raise SystemExit(f"[{name}] no budget chain block: forms "
                                 f"{forms}")
    log(f"  the option runs: {time.perf_counter() - t0:.1f} s")
    return runs


def check_bytes(runs):
    """The pool and stacked-weight bytes of the quantized runs against
    the fp run's, each exactly what the shapes give."""
    f = runs["row"]
    pos = 12 * 2 * (8 * 1024 // 64) * H * 64      # L, kv, NB, H, Bt
    d = E // H
    bias_ln = 12 * 2 * (3 * E + E + FF + E + 4 * E)  # bf16 biases, LN
    mats = 12 * (3 * E * E + E * E + E * FF + FF * E)
    scales = 12 * 4 * (3 * E + E + FF + E)           # fp32 [L, 1, O]
    want = {("row", "pool"): pos * d * 2,
            ("row-kv8-w4", "pool"): pos * (d + 4),
            ("row", "stack"): bias_ln + 2 * mats,
            ("row-w8", "stack"): bias_ln + mats + scales,
            ("row-kv8-w4", "stack"): bias_ln + mats // 2 + scales,
            # the ring holds B x Smax positions, as many as the pool
            ("row-dense", "pool"): pos * d * 2,
            ("row-dense-kv8", "pool"): pos * (d + 4)}
    for (name, what), n in want.items():
        got = runs[name][what + "_bytes"]
        if got != n:
            raise SystemExit(f"{name} {what} bytes {got}, the shapes give "
                             f"{n}")
        log(f"  {name} {what} bytes {got} ({got / f[what + '_bytes']:.4f}"
            " of the fp run's)")


# the slot lifecycle's mixes in phase 3: name -> (scheduler, mix, flavor);
# between them the paged kernels of rows 1-4 (fp and int8, row and flat)
# run on slots that were preempted, resumed, staged and imported
LIFECYCLE = {"row-qos": ("row", "qos", {}),
             "flat-qos-kv8": ("flat", "qos", {"kv_quant": "int8"}),
             "flat-handoff": ("flat", "handoff", {}),
             "row-handoff-kv8": ("row", "handoff", {"kv_quant": "int8"})}


def kv_payload_bytes(blocks):
    """Host bytes of a migration payload's blocks (K/V and scales)."""
    return sum(a.nbytes for blk in blocks for a in blk.values())


def lifecycle_runs(seed):
    """The qos and handoff mixes (LIFECYCLE), launches counted from zero
    before each run and read after it."""
    t0 = time.perf_counter()
    runs = {}
    for name, (sched, mix, flavor) in LIFECYCLE.items():
        kwargs = {**SCHEDULERS[sched], **flavor}
        runs[name] = (serve_qos if mix == "qos" else serve_handoff)(
            seed, name, kwargs)
        got = runs[name]["launches"]
        log(f"  [{name}] launches {dict((k, v) for k, v in got.items() if v)}")
    log(f"  the lifecycle runs: {time.perf_counter() - t0:.1f} s")
    return runs


def request_lengths(name, eng, rids, reqs):
    for rid, (_, want) in zip(rids, reqs):
        got = len(eng.results[rid]["tokens"])
        if got != want:
            raise SystemExit(f"{name}: request {rid} emitted {got} of "
                             f"{want}")


def serve_qos(seed, name, kwargs):
    """The qos mix: its eight low-class requests fill the eight slots and
    decode, then its eight high-class ones arrive in one burst; each step
    the blocked high head preempts the youngest running low request to
    the host, and the low ones resume as the high ones finish. Beside it
    the same burst on an engine without the fill (the high class's TTFT
    with and without it), then the host round trip of one parked slot of
    1024 positions (16 blocks), timed each way."""
    eng, reqs = gpt2_workload(seed, mix="qos", **kwargs)
    low = [r for r, c in zip(reqs, PRIORITIES["qos"]) if c == "low"]
    high = [r for r, c in zip(reqs, PRIORITIES["qos"]) if c == "high"]
    reset_launches()
    t0 = time.perf_counter()
    low_rids = [eng.submit(p, max_new_tokens=m, priority="low")
                for p, m in low]
    while any(eng.poll(r)["n_tokens"] == 0 for r in low_rids):
        eng.step()
    high_rids = [eng.submit(p, max_new_tokens=m, priority="high")
                 for p, m in high]
    parked_peak = steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        parked_peak = max(parked_peak, sum(kv_payload_bytes(st["kv"])
                                           for st in eng._parked.values()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    request_lengths(name, eng, low_rids + high_rids, low + high)
    m = eng.metrics()
    if not m["requests_preempted"] or \
            m["requests_resumed"] != m["requests_preempted"]:
        raise SystemExit(f"{name}: the burst must preempt and every "
                         f"preempted request resume: {m}")
    ttft = [eng.results[r]["ttft_s"] for r in high_rids]
    alone, _ = gpt2_workload(seed, mix="qos", **kwargs)
    a_rids = [alone.submit(p, max_new_tokens=m, priority="high")
              for p, m in high]
    alone.run()
    ttft_alone = [alone.results[r]["ttft_s"] for r in a_rids]
    log(f"  [{name}] 8 low requests filling the 8 slots, then 8 high: "
        f"{steps} steps, {dt:.3f} s; preempted {m['requests_preempted']}, "
        f"resumed {m['requests_resumed']}, parked peak {parked_peak} bytes")
    log(f"  [{name}] high-class TTFT p50 {np.percentile(ttft, 50):.4f} s, "
        f"p99 {np.percentile(ttft, 99):.4f} s; the same burst without the "
        f"low fill p50 {np.percentile(ttft_alone, 50):.4f} s, p99 "
        f"{np.percentile(ttft_alone, 99):.4f} s")
    # one slot's host round trip: 1000 prompt positions and the first
    # token's fill 16 blocks of 64 (1024 positions)
    rng = np.random.default_rng(seed + 9)
    rid = eng.submit(rng.integers(0, V, 1000), max_new_tokens=24)
    while eng.poll(rid)["n_tokens"] == 0:
        eng.step()
    outs, ins = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.preempt_to_host(rid)          # ends in the device-to-host copy
        outs.append(time.perf_counter() - t)
        nbytes = kv_payload_bytes(eng._parked[rid]["kv"])
        n_blocks = len(eng._parked[rid]["kv"])
        t = time.perf_counter()
        eng.resume_from_host(rid)
        torch.cuda.synchronize()
        ins.append(time.perf_counter() - t)
    eng.run()
    if len(eng.results[rid]["tokens"]) != 24:
        raise SystemExit(f"{name}: the round-tripped request emitted "
                         f"{len(eng.results[rid]['tokens'])} of 24")
    out_s, in_s = min(outs), min(ins)
    log(f"  [{name}] one parked slot ({n_blocks} blocks, {nbytes} bytes): "
        f"preempt_to_host {1e3 * out_s:.3f} ms ({nbytes / out_s / 1e6:.1f} "
        f"MB/s), resume_from_host {1e3 * in_s:.3f} ms "
        f"({nbytes / in_s / 1e6:.1f} MB/s), round trip "
        f"{nbytes / (out_s + in_s) / 1e6:.1f} MB/s (best of 3)")
    return {"launches": launches, "metrics": m, "parked_peak": parked_peak,
            "ttft_high": ttft, "ttft_alone": ttft_alone,
            "round_trip_s": (out_s, in_s), "round_trip_bytes": nbytes}


def serve_handoff(seed, name, kwargs):
    """The handoff mix through a role="prefill" engine and a role="decode"
    engine on the one card: while each prompt streams through prefill its
    full blocks go over (export_kv_prefix -> stage_kv_blocks); once it is
    held prefilled, export_slot(skip_blocks=) ships the tail and
    import_slot(staged=) lands it on a free decode slot."""
    pre, reqs = gpt2_workload(seed, mix="handoff", role="prefill", **kwargs)
    d = pre.dec
    dec = ServingEngine(d.fmt, d.embed, d.head, num_slots=8,
                        max_seq_len=1024, role="decode", **kwargs)
    reset_launches()
    t0 = time.perf_counter()
    rids = [pre.submit(p, max_new_tokens=m) for p, m in reqs]
    cursor = dict.fromkeys(rids, 0)
    pending, ready, moved = list(rids), {}, {}
    export_s, import_s, streamed = [], [], 0
    while pending or ready or dec.has_work:
        if pre.has_work:
            pre.step()
        for rid in list(pending):
            if pre._req_index[rid].slot is None:
                continue                   # still queued
            try:
                blocks, n_full = pre.export_kv_prefix(rid, cursor[rid])
                if blocks:
                    dec.stage_kv_blocks(rid, blocks)
                    cursor[rid] = n_full
                    streamed += len(blocks)
            except AdmissionFull:
                pass                       # ships with the tail instead
            if pre.poll(rid)["state"] == "prefilled":
                t = time.perf_counter()
                ready[rid] = pre.export_slot(rid, skip_blocks=cursor[rid])
                export_s.append(time.perf_counter() - t)
                pending.remove(rid)
        for rid, state in list(ready.items()):
            t = time.perf_counter()
            try:
                moved[rid] = dec.import_slot(
                    state, staged=rid if rid in dec._staged else None)
            except AdmissionFull:
                continue                   # no decode slot yet
            torch.cuda.synchronize()
            import_s.append(time.perf_counter() - t)
            del ready[rid]
        if dec.has_work:
            dec.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    request_lengths(name, dec, [moved[r] for r in rids], reqs)
    mp, md = pre.metrics(), dec.metrics()
    if mp["kv_blocks_shipped"] != md["kv_blocks_adopted"] or \
            mp["requests_migrated_out"] != len(reqs) or \
            md["requests_migrated_in"] != len(reqs) or pre.pool.used or \
            dec.pool.used:
        raise SystemExit(f"{name}: the handoff lost blocks or requests: "
                         f"{mp} {md}")
    log(f"  [{name}] {len(reqs)} requests prefilled on the prefill engine "
        f"and decoded on the decode engine in {dt:.3f} s: "
        f"{mp['kv_blocks_shipped']} blocks shipped, {streamed} of them "
        f"streamed during prefill; per request export_slot "
        f"{1e3 * np.mean(export_s):.3f} ms, import_slot "
        f"{1e3 * np.mean(import_s):.3f} ms (mean; max "
        f"{1e3 * max(export_s):.3f} / {1e3 * max(import_s):.3f} ms)")
    return {"launches": launches, "metrics": (mp, md),
            "tokens": [dec.results[moved[r]]["tokens"] for r in rids],
            "export_s": export_s, "import_s": import_s}


# phase 3a: the serving cluster. Every wait on the cluster is bounded.
CLUSTER_WAIT_S = 600
# each replica's shape in the mixed cluster (the one engine alone too)
CLUSTER_ENGINE = {"num_slots": 8, "max_seq_len": 1024,
                  "prefix_cache_blocks": 64}


def cluster_mods(seed):
    """A replica's own modules: the phase-3 weights from ``seed`` with
    ``cycle_head``'s embedding and LM head (the spec mix's model), copied
    to the card for this replica alone (two driver threads share no
    tensor). With phase 3's random head, bf16 greedy decoding at this
    depth is chaotic: one context's logits through two batch
    compositions differ by tens (std 11), so no two layouts' tokens
    agree for long; the cycle head's margins hold, so tokens can be held
    equal across layouts."""
    return from_jax_state(*cycle_head(_random_model(seed)[0]),
                          dtype=torch.bfloat16)


def cluster_requests(seed):
    """phase 3's 16 greedy requests (``gpt2_workload``'s gpt2 mix: the
    same draws after the weights and the warm-up request)."""
    rng = np.random.default_rng()
    rng.bit_generator.state = _random_model(seed)[1]
    rng.integers(0, V, 40)
    return MIXES["gpt2"](rng)


def http_completion(port, body, trace_id):
    """One POST /v1/completions, JSON or (``body["stream"]``) SSE, over
    its own socket: returns (tokens, seconds to the first token, seconds
    to the end) as the client sees them."""
    payload = json.dumps(body).encode()
    s = socket.create_connection(("127.0.0.1", port),
                                 timeout=CLUSTER_WAIT_S)
    t0 = time.perf_counter()
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\nX-Request-Id: "
              + trace_id.encode() + b"\r\nContent-Length: %d\r\n\r\n%s"
              % (len(payload), payload))
    buf, toks, t_first = b"", [], None
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
        if body.get("stream") and b"\r\n\r\n" in buf:
            # SSE: each complete "data: {...}" line as it arrives
            head, _, rest = buf.partition(b"\r\n\r\n")
            *lines, tail = rest.split(b"\n")
            for line in lines:
                line = line.strip()
                if line.startswith(b"data: ") and line != b"data: [DONE]":
                    toks += json.loads(line[6:])["choices"][0]["tokens"]
                    if toks and t_first is None:
                        t_first = time.perf_counter() - t0
            buf = head + b"\r\n\r\n" + tail
    s.close()
    total = time.perf_counter() - t0
    head, _, rest = buf.partition(b"\r\n\r\n")
    if b" 200 " not in head.split(b"\r\n")[0]:
        raise SystemExit(f"cluster: {trace_id} answered {head[:200]!r}")
    if not body.get("stream"):
        return json.loads(rest)["choices"][0]["tokens"], total, total
    return toks, t_first, total


def http_burst(port, reqs, tag):
    """The requests all at once from one client thread each, even ones
    as JSON and odd ones as SSE, trace ids ``tag-i``; returns the
    per-request (tokens, ttft, seconds) and the burst's wall time."""
    import concurrent.futures

    def one(i):
        p, m = reqs[i]
        body = {"prompt": [int(t) for t in p], "max_tokens": int(m),
                "stream": bool(i % 2)}
        return http_completion(port, body, f"{tag}-{i}")
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
        t0 = time.perf_counter()
        outs = list(ex.map(one, range(len(reqs)), timeout=CLUSTER_WAIT_S))
    return outs, time.perf_counter() - t0


def thread_launches(attr):
    """Count ``da.<attr>``'s launches by calling thread (a replica's
    driver thread is ``replica-<name>``); returns (counts, restore)."""
    import threading
    kernel = getattr(da, attr)
    counts = collections.Counter()

    def spy(*a, **k):
        counts[threading.current_thread().name] += 1
        return kernel(*a, **k)
    setattr(da, attr, spy)
    return counts, lambda: setattr(da, attr, kernel)


def same_tokens(label, got, want):
    """Fail unless every request's tokens equal the engine alone's."""
    bad = [(i, len(g), len(w), next((j for j, (a, b) in enumerate(
        zip(g, w)) if a != b), min(len(g), len(w))))
        for i, (g, w) in enumerate(zip(got, want)) if list(g) != list(w)]
    log(f"  [{label}] {len(got) - len(bad)} of {len(got)} requests' tokens "
        "equal the engine alone's" + (f"; differing (request, got, want, "
                                       f"first index): {bad}" if bad else ""))
    if bad or len(got) != len(want):
        raise SystemExit(f"{label}: tokens differ from the engine alone's")


def check_snapshot(label, snap):
    keys = set(snap) - {"replica"}
    if snap["schema_version"] != 8 or not (
            tele.SNAPSHOT_REQUIRED_KEYS <= keys <= tele.SNAPSHOT_REQUIRED_KEYS
            | tele.SNAPSHOT_OPTIONAL_KEYS):
        raise SystemExit(f"{label}: snapshot keys {sorted(keys)} outside "
                         "schema v8")
    json.dumps(snap)


def check_exposition(label, text, replicas):
    """Every counter of COUNTER_FOLD_KEYS in the gateway's /metrics
    equals its replica's metrics() plus the folded base."""
    samples = tele.parse_prometheus(text)
    for rep in replicas:
        m, base = rep.engine.metrics(), rep.engine._prom_base
        for k in tele.COUNTER_FOLD_KEYS:
            name = tele.PROMETHEUS_NAMES[k][0]
            fam, _, rest = name.partition("{")
            key = (f'{fam}{{replica="{rep.name}",{rest}' if rest
                   else f'{name}{{replica="{rep.name}"}}')
            if abs(samples[key] - (base.get(k, 0) + m[k])) > 1e-6:
                raise SystemExit(f"{label}: {key} = {samples[key]} but "
                                 f"metrics() + base = {base.get(k, 0)} + "
                                 f"{m[k]}")
    log(f"  [{label}] /metrics: {len(samples)} samples; every counter of "
        f"COUNTER_FOLD_KEYS ({len(tele.COUNTER_FOLD_KEYS)}) equals each "
        "replica's metrics() plus its folded base")


def fetch(port, path):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port,
                                   timeout=CLUSTER_WAIT_S)
    c.request("GET", path)
    r = c.getresponse()
    data = r.read().decode()
    c.close()
    if r.status != 200:
        raise SystemExit(f"cluster: GET {path} answered {r.status}")
    return data


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def phase_cluster(seed):
    """The in-process serving cluster at phase 3's width (E=768, H=12,
    FF=3072, L=12, V=50304, bf16, --seed weights) on the one card:
    two mixed replicas behind the router and the gateway; the same mix
    with a replica killed mid-stream; a disaggregated prefill/decode
    pair; the telemetry ring off and on; the telemetry outputs. Returns
    the launch counts of its runs."""
    log("== phase 3a: the serving cluster at GPT-2-124M width, bf16, L=12: "
        "two replicas behind the gateway, a kill mid-stream, a "
        "prefill/decode pair, telemetry off and on")
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="cluster_traces_",
                                     dir=os.getcwd()) as out_dir:
        return cluster_runs(seed, card, out_dir)


def cluster_runs(seed, card, out_dir):
    """phase_cluster's runs; the Chrome traces go under ``out_dir``."""
    runs = {}
    # ---- one engine alone: the reference tokens, TTFT and tokens/s
    reqs = cluster_requests(seed)
    alone = ServingEngine(*cluster_mods(seed), **CLUSTER_ENGINE)
    n_new = sum(m for _, m in reqs)
    reset_launches()
    out, steps_on, dt_alone = serve(alone, reqs)
    runs["cluster-alone"] = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    want = [list(v) for v in out.values()]
    ttft_alone = [alone.results[r]["ttft_s"] for r in out]
    # ---- 4. the ring off, then on again (host ms a step drifts between
    # runs in one process, so the off run sits between two on runs): the
    # same launches and tokens
    per_step = {}
    for name, ring in (("ring-off", 0), ("ring-on", None)):
        eng = ServingEngine(*cluster_mods(seed), telemetry_ring=ring,
                            **CLUSTER_ENGINE)
        reset_launches()
        got, steps, dt = serve(eng, reqs)
        runs[f"cluster-{name}"] = {**da.LAUNCHES, **fa.LAUNCHES,
                                   **fdm.LAUNCHES}
        same_tokens(name, list(got.values()), want)
        if runs[f"cluster-{name}"] != runs["cluster-alone"] or \
                bool(eng.telemetry.steps) != (ring is None):
            raise SystemExit(f"{name} launched {runs[f'cluster-{name}']}, "
                             f"the first run {runs['cluster-alone']}")
        per_step[name] = 1e3 * dt / steps
    log(f"  [telemetry] host ms a step: ring on "
        f"{1e3 * dt_alone / steps_on:.3f}, off {per_step['ring-off']:.3f}, "
        f"on {per_step['ring-on']:.3f} ({steps_on} steps each); launches "
        f"equal: { {k: v for k, v in runs['cluster-alone'].items() if v} }; "
        f"{card}")
    # ---- 1. two mixed replicas behind the router and the gateway
    reps = [LocalReplica(f"replica{i}", ServingEngine(
        *cluster_mods(seed), **CLUSTER_ENGINE)) for i in range(2)]
    gw = Gateway(Router(reps), port=0).start_background()
    counts, restore = thread_launches("decode_attention_paged")
    reset_launches()
    try:
        got, dt = http_burst(gw.port, reqs, "mixed")
    finally:
        restore()
    runs["cluster-mixed"] = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    per_rep = {r.name: counts[f"replica-{r.name}"] for r in reps}
    log(f"  [mixed] decode_attention_paged launches by replica {per_rep}")
    if not all(per_rep.values()) or sum(per_rep.values()) != \
            da.LAUNCHES["decode_attention_paged"]:
        raise SystemExit(f"mixed: every replica must launch the row "
                         f"kernel: {per_rep}, {dict(counts)}")
    check_paths("[mixed]", {"decode_attention_paged":
                            da.LAUNCHES["decode_attention_paged"]})
    same_tokens("mixed", [g[0] for g in got], want)
    ttft = [v["ttft_s"] for r in reps for v in r.engine.results.values()]
    http_s = [e["dur_s"] for e in gw.http_log
              if e["path"] == "/v1/completions"]
    sse_ttft = [g[1] for i, g in enumerate(got) if i % 2]
    log(f"  [mixed] 2 replicas: {n_new / dt:.1f} generated tokens/s "
        f"({dt:.3f} s) against {n_new / dt_alone:.1f} for one engine alone "
        f"({dt_alone:.3f} s); engine TTFT p50 {percentile(ttft, 50):.4f} s, "
        f"p99 {percentile(ttft, 99):.4f} s against alone "
        f"{percentile(ttft_alone, 50):.4f} / {percentile(ttft_alone, 99):.4f}"
        f" s; SSE client TTFT p50 {percentile(sse_ttft, 50):.4f} s; gateway "
        f"HTTP latency p50 {percentile(http_s, 50):.4f} s; step EWMA "
        f"{[round(r.snapshot()['health']['step_ewma_s'], 6) for r in reps]}"
        f" s; {card}")
    # the exposition after a reset_metrics and four more requests
    for r in reps:
        with r._lock:
            r.engine.reset_metrics()
    http_burst(gw.port, reqs[:4], "after-reset")
    check_exposition("mixed", fetch(gw.port, "/metrics"), reps)
    for r in reps:
        check_snapshot(r.name, r.snapshot())
        tele.validate_chrome_trace(tele.export_chrome_tracing(
            r.engine, os.path.join(out_dir, f"mixed-{r.name}.json")))
    gw.stop()
    for r in reps:
        r.close()
    # ---- 2. the same mix with a replica killed mid-stream
    steps = {"n": 0}

    def killer(rep):
        steps["n"] += 1
        if steps["n"] == 12:
            rep.kill()

    reps = [LocalReplica("replica0", ServingEngine(
                *cluster_mods(seed), **CLUSTER_ENGINE), step_hook=killer),
            LocalReplica("replica1", ServingEngine(
                *cluster_mods(seed), **CLUSTER_ENGINE))]
    router = Router(reps)
    gw = Gateway(router, port=0, hb_s=0.05).start_background()
    reset_launches()
    got, dt = http_burst(gw.port, reqs, "kill")
    runs["cluster-kill"] = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    same_tokens("kill", [g[0] for g in got], want)
    if router.failovers_total < 1 or list(router.dead) != ["replica0"]:
        raise SystemExit(f"kill: failovers {router.failovers_total}, dead "
                         f"{list(router.dead)}")
    moved = sorted({e["trace_id"] for e in router.audit
                    if e["reason"] == "failover"})
    dumps = {r.name: r.trace_dump() for r in reps}
    for tid in moved:
        att = {n: [s["attempt"] for s in d["spans"] if s["trace_id"] == tid]
               for n, d in dumps.items()}
        if 1 not in att["replica0"] or 2 not in att["replica1"]:
            raise SystemExit(f"kill: trace {tid} attempts {att}")
    path = export_cluster_trace(gw, os.path.join(out_dir, "kill.json"))
    doc = tele.validate_chrome_trace(path)
    log(f"  [kill] replica0 killed at its 12th working step: "
        f"{router.failovers_total} failovers, trace ids kept with attempt "
        f"1 -> 2: {moved}; {n_new / dt:.1f} generated tokens/s; merged "
        f"cluster trace {len(doc['traceEvents'])} events, valid; {card}")
    gw.stop()
    for r in reps:
        r.close()
    # ---- 3. a disaggregated pair, shaped as the cluster's __main__ shapes
    # its roles (prefill: half the slots, one wide flat budget, one decode
    # step; decode: twice the slots, a small budget)
    slots, cap = CLUSTER_ENGINE["num_slots"], 64
    pre = ServingEngine(*cluster_mods(seed), role="prefill",
                        num_slots=slots // 2, flat_budget=True,
                        token_budget=4 * cap, decode_chunk=1,
                        max_seq_len=1024, prefix_cache_blocks=64)
    dec = ServingEngine(*cluster_mods(seed), role="decode",
                        num_slots=2 * slots, token_budget=2 * slots,
                        max_seq_len=1024, prefix_cache_blocks=64)
    reps = [LocalReplica("pf0", pre, threaded=False),
            LocalReplica("dc0", dec, threaded=False)]
    router = Router(reps, snap_max_age_s=0.0)
    reset_launches()
    t0 = time.perf_counter()
    gids = [router.submit([int(t) for t in p], max_new_tokens=int(m))
            for p, m in reqs]
    toks = {g: [] for g in gids}
    done = dict.fromkeys(gids, False)
    while not all(done.values()):
        if time.perf_counter() - t0 > CLUSTER_WAIT_S:
            raise SystemExit("disaggregated: the pair stalled")
        for r in reps:
            r.pump()
        for g in gids:
            if not done[g]:
                new, done[g], _ = router.harvest(g, len(toks[g]))
                toks[g] += new
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    runs["cluster-disagg"] = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    mp, md = pre.metrics(), dec.metrics()
    flat = da.LAUNCHES["decode_attention_paged_flat"]
    if mp["kv_blocks_shipped"] != md["kv_blocks_adopted"] or \
            md["prefill_tokens_computed"] or not flat or \
            router.handoffs_total != len(reqs):
        raise SystemExit(f"disaggregated: shipped {mp['kv_blocks_shipped']}"
                         f", adopted {md['kv_blocks_adopted']}, decode-side "
                         f"prefill {md['prefill_tokens_computed']}, flat "
                         f"launches {flat}, handoffs "
                         f"{router.handoffs_total}")
    check_paths("[disaggregated]", {"decode_attention_paged_flat": flat})
    same_tokens("disaggregated", [toks[g] for g in gids], want)
    for r in reps:
        check_snapshot(r.name, r.snapshot())
        tele.validate_chrome_trace(tele.export_chrome_tracing(
            r.engine, os.path.join(out_dir, f"disagg-{r.name}.json")))
    log(f"  [disaggregated] {len(reqs)} handoffs, {mp['kv_blocks_shipped']} "
        f"blocks shipped = adopted, no prefill on the decode side, "
        f"{flat} flat launches on the prefill side; {n_new / dt:.1f} "
        f"generated tokens/s ({dt:.3f} s); {card}")
    for name, got in runs.items():
        log(f"  [{name}] launches "
            f"{ {k: v for k, v in got.items() if v} }")
    return runs


def phase_generate(seed):
    log("== phase 3b: generate_fused at GPT-2-124M width, bf16, L=12: B=8, "
        "256-token prompts, 128 new tokens, max_seq_len=1024, fp and "
        "kv_quant='int8', cache_write_kernel off and on; sampled (top_k "
        "50, top_p 0.95, temperature 0.8, repetition_penalty 1.2), "
        "num_beams=4 and bulk_prefill=True")
    rng = np.random.default_rng(seed + 3)
    state = random_state(rng, E, H, FF, 12, V)
    mods = from_jax_state(*state, dtype=torch.bfloat16)
    ids = rng.integers(0, V, (8, 256))
    prompt, new = ids.shape[1], 128
    # warm-up: cuBLAS handles, allocator pools
    generate_fused(mods[0], ids[:, :4], *mods[1:], max_new_tokens=2)
    launches, walls = {}, {}
    for name, (ctor, kwargs) in GENERATE.items():
        dec = FusedDecoder(*mods, 1024, **ctor)
        trng.seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = dec.generate(ids, max_new_tokens=new, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: v for k, v in {**da.LAUNCHES, **fa.LAUNCHES}.items() if v}
        peak = torch.cuda.max_memory_allocated()
        ring_b = sum(a.nbytes for a in dec.ring_caches(
            dec.init_cache(ids.shape[0])).values())
        kernel = ("decode_attention_stacked" + ("_i8" if "kv8" in name
                                                else "")
                  + ("_write" if "kw" in name else ""))
        # one launch per layer of each of the prompt + new - 1 hidden
        # passes, and no other attention kernel; bulk prefill: one flash
        # launch per layer for the prompt, then new - 1 hidden passes
        want = {kernel: 12 * (prompt + new - 1)}
        if ctor.get("bulk_prefill"):
            want = {kernel: 12 * (new - 1), "flash_attention_fwd": 12}
        if tuple(out.shape) != (8, prompt + new) or got != want:
            raise SystemExit(f"[{name}] output {tuple(out.shape)}, "
                             f"launches {got}: want (8, {prompt + new}) "
                             f"and {want}")
        if not np.array_equal(out[:, :prompt].numpy(), ids) or \
                out.min() < 0 or out.max() >= V:
            raise SystemExit(f"[{name}] output does not start with the "
                             "prompt or holds a token outside the vocab")
        if kernel in da.PATH_LAUNCHES:    # a two-design kernel: split
            check_paths(f"[{name}]", {kernel: want[kernel]})
        if "flash_attention_fwd" in want:
            check_tensor_core_path(f"[{name}] flash", fa,
                                   ("flash_attention_fwd",))
        log(f"  [{name}] {out.shape[0]} x ({prompt} + {new}) tokens in "
            f"{dt:.3f} s: generated tokens/s {8 * new / dt:.1f}, hidden "
            f"passes/s {(prompt + new - 1) / dt:.1f}; max_memory_allocated "
            f"{peak} bytes, ring {ring_b} bytes; launches {got}")
        launches[name] = {**da.LAUNCHES, **fa.LAUNCHES}
        walls[name] = dt
    launches.update(generate_options(mods, ids, new, walls["gen"], state,
                                     seed))
    return launches


def generate_options(mods, ids, new, gen_wall, state, seed):
    """Phase 3b's options: ``generate`` twice on one PrefixCache of
    64-token blocks (the first call publishes every row's four prompt
    blocks, the second adopts three, since a prompt token is always
    prefilled, and computes the same tokens), then spec_k=4 beside plain
    greedy on the spec mix's model (``cycle_head``) with prompts walking
    its 16-id cycles (each verify pass one ring launch a layer at K + 1 =
    5 positions). Returns their launch counts."""
    prompt = ids.shape[1]
    kernel = "decode_attention_stacked"
    dec = FusedDecoder(*mods, 1024)
    nl = dec.fmt.num_layers
    pc = PrefixCache(64, 64)
    launches, outs = {}, []
    for i, adopted in enumerate((0, prompt - 64)):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dec.generate(ids, max_new_tokens=new, prefix_cache=pc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: v for k, v in {**da.LAUNCHES, **fa.LAUNCHES}.items() if v}
        want = {kernel: nl * (prompt - adopted + new - 1)}
        if got != want:
            raise SystemExit(f"[gen-prefix call {i + 1}] launches {got}, "
                             f"want {want}")
        check_paths(f"[gen-prefix call {i + 1}]", want)
        log(f"  [gen-prefix call {i + 1}] {adopted} of {prompt} prompt "
            f"positions adopted a row; {dt:.3f} s ({dt / gen_wall:.3f}x "
            f"the plain run), generated tokens/s {8 * new / dt:.1f}")
        outs.append(out)
        launches[f"gen-prefix-{i + 1}"] = dict(da.LAUNCHES)
    st = pc.store.stats()
    if not torch.equal(outs[0], outs[1]) or st["match_hits"] != 8 or \
            st["committed_blocks"] != 32:
        raise SystemExit(f"[gen-prefix] the adopting call's tokens differ "
                         f"or the store disagrees: {st}")
    log(f"  [gen-prefix] the second call's tokens equal the first's; store "
        f"{st}")
    dec = FusedDecoder(*from_jax_state(*cycle_head(state),
                                       dtype=torch.bfloat16), 1024)
    r = np.random.default_rng(seed + 4)
    cyc = (CYCLE * r.integers(0, V // CYCLE, (8, 1))
           + (r.integers(0, CYCLE, (8, 1)) + np.arange(prompt)) % CYCLE)
    runs = {}
    for name, kw in (("gen-cycle", {}), ("gen-spec", {"spec_k": 4})):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dec.generate(cyc, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0, out)
        n = da.LAUNCHES[kernel]
        passes = n // nl - prompt
        if tuple(out.shape) != (8, prompt + new) or n % nl or passes < 1 \
                or not np.array_equal(out[:, :prompt].numpy(), cyc):
            raise SystemExit(f"[{name}] output {tuple(out.shape)}, {n} "
                             f"launches of {kernel}")
        check_paths(f"[{name}]", {kernel: n})
        launches[name] = dict(da.LAUNCHES)
    (dt0, out0), (dt, out) = runs["gen-cycle"], runs["gen-spec"]
    same = float((out == out0).all(1).float().mean())
    log(f"  [gen-spec] spec_k=4 on the cycle model: {dt:.3f} s against "
        f"plain greedy's {dt0:.3f} ({dt / dt0:.3f}x), generated tokens/s "
        f"{8 * new / dt:.1f} / {8 * new / dt0:.1f}; {passes} verify "
        f"passes for {new - 1} tokens a row after the first "
        f"({(new - 1) / passes:.3f} a pass); rows equal to plain "
        f"greedy's {same:.3f} (bf16)")
    return launches


def reset_launches():
    for counts in (da.LAUNCHES, fa.LAUNCHES, fdm.LAUNCHES, ln.LAUNCHES,
                   ffn.LAUNCHES, rca.LAUNCHES, fa.PATH_LAUNCHES,
                   rca.PATH_LAUNCHES, ffn.PATH_LAUNCHES,
                   *da.PATH_LAUNCHES.values(),
                   *fdm.PATH_LAUNCHES.values(),
                   *ln.PATH_LAUNCHES.values()):
        for k in counts:
            counts[k] = 0


# the fused FFN kernels that take a design from kernel_path
FFN_PATH_KERNELS = ("fused_ffn_fwd", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw")


def check_tensor_core_path(label, module, kernels=None, path="tc"):
    """Fail unless every launch of ``module``'s kernels (those named in
    ``kernels``, else all) since the counts were reset took the design
    ``path`` (the tensor-core one; ``module.PATH_LAUNCHES``)."""
    total = sum(n for k, n in module.LAUNCHES.items()
                if kernels is None or k in kernels)
    paths = dict(module.PATH_LAUNCHES)
    log(f"  {label}: launches by path {paths}")
    if paths != {p: total if p == path else 0 for p in paths}:
        raise SystemExit(f"{label}: {paths} by path for {total} launches; "
                         f"every one must take the {path} path")


def serve_counted(seed, name, kwargs, mix="gpt2"):
    """Serve gpt2_workload (the request mix ``mix``) under one scheduler
    and flavor with every launch count zeroed just before and read just
    after; returns the counts, the pool and stacked-weight bytes, the
    peak memory, the metrics, the tokens, the generated tokens/s and
    the read kernel's launches by query length (``forms``)."""
    fresh, reqs = gpt2_workload(seed, mix=mix, **kwargs)
    forms = collections.Counter()
    dense = kwargs.get("paged") is False
    attr = (("decode_attention_stacked" if dense else "decode_attention_paged")
            + ("_i8" if kwargs.get("kv_quant") == "int8" else ""))
    kernel = getattr(da, attr)

    def spy(qt, *a, **k):
        forms[qt.shape[2]] += 1
        return kernel(qt, *a, **k)
    # a sampling engine's request seeds come from the global key stream
    submit_kw = ({"repetition_penalty": 1.2}
                 if kwargs.get("enable_repetition_penalty") else {})
    trng.seed(seed)
    torch.cuda.reset_peak_memory_stats()
    setattr(da, attr, spy)
    reset_launches()
    try:
        out, steps, dt = serve(fresh, reqs, **submit_kw)
    finally:
        setattr(da, attr, kernel)
    launches = {**da.LAUNCHES, **fa.LAUNCHES, **fdm.LAUNCHES}
    m = fresh.metrics()
    for (p, want), (rid, toks) in zip(reqs, out.items()):
        if len(toks) != want:
            raise SystemExit(f"{name}: request {rid} emitted {len(toks)} of "
                             f"{want}")
    # at the end only the prefix store's pins hold pool blocks
    pinned = m.get("prefix_store", {}).get("blocks_used", 0)
    if not dense and (m["kv_blocks_used"] + m["kv_blocks_free"]
                      != m["kv_blocks_total"]
                      or m["kv_blocks_used"] != pinned):
        raise SystemExit(f"{name}: kv block accounting broke: {m}")
    if name.startswith("row") and "spec" not in name and (
            not forms.get(16) or not forms.get(1)):
        raise SystemExit(f"{attr} forms launched: {dict(forms)}; need "
                         "both Sq=16 and Sq=1")
    if attr in da.PATH_LAUNCHES:      # every launch on the split design
        check_paths(f"[{name}]", {attr: da.LAUNCHES[attr]})
    for flat in ("decode_attention_paged_flat",
                 "decode_attention_paged_flat_i8"):
        if da.LAUNCHES[flat]:         # the flat streams: split too
            check_paths(f"[{name}]", {flat: da.LAUNCHES[flat]})
    if fdm.LAUNCHES["fused_dequant_matmul"]:   # int4: the tensor cores
        check_dequant_path(f"[{name}]", "tensor_core")
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
        f"{attr} forms (Sq: launches) {dict(forms)}, launches {launches}")
    if "prefix_cache_blocks" in kwargs or "spec_k" in kwargs:
        log(f"  [{name}] prefix hits {m['prefix_hits']}, misses "
            f"{m['prefix_misses']}, hit rate {m['prefix_hit_rate']}, prefill "
            f"tokens saved {m['prefill_tokens_saved']}, computed "
            f"{m['prefill_tokens_computed']}; drafts proposed "
            f"{m['draft_proposed']}, accepted {m['draft_accepted']}, "
            f"acceptance rate {m['acceptance_rate']}")
    peak = torch.cuda.max_memory_allocated()
    pool_b = sum(a.nbytes for a in fresh._caches.values())
    stack_b = sum(a.nbytes for a in fresh.dec._stacked().values())
    log(f"  [{name}] max_memory_allocated {peak} bytes, allocated at the "
        f"end {torch.cuda.memory_allocated()} bytes; "
        f"{'ring' if dense else 'pool'} {pool_b} bytes, stacked weights "
        f"{stack_b} bytes")
    return {"launches": launches, "pool_bytes": pool_b,
            "stack_bytes": stack_b, "peak": peak, "metrics": m,
            "tokens": list(out.values()), "tokens_per_s": n_new / dt,
            "forms": dict(forms)}


# per training step: the flash forward and both backward kernels once per
# layer, the LayerNorm kernels once per LayerNorm (two a block and ln_f)
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
                  "flash_attention_bwd_dq": 12, "layer_norm_fwd": 25,
                  "layer_norm_bwd": 25}


# phase 3d's step adds the three fused FFN kernels once per layer
FFN_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, "fused_ffn_fwd": 12,
                      "fused_ffn_bwd_dx": 12, "fused_ffn_bwd_dw": 12}


# phase 3f's step at L layers: the RMSNorm kernels once per RMSNorm (two a
# block and the final norm), the flash forward and both backward kernels
# once per layer, and no LayerNorm or fused FFN kernel
LLAMA_LAYERS = LLAMA_CONFIG["num_layers"]
LLAMA_TRAIN_LAUNCHES = {"rms_norm_fwd": 2 * LLAMA_LAYERS + 1,
                        "rms_norm_bwd": 2 * LLAMA_LAYERS + 1,
                        "flash_attention_fwd": LLAMA_LAYERS,
                        "flash_attention_bwd_dkv": LLAMA_LAYERS,
                        "flash_attention_bwd_dq": LLAMA_LAYERS}


@contextlib.contextmanager
def forced(module, attr, value):
    """``module.attr`` replaced by ``value`` inside (a design rule forced
    to a kernel's earlier design, to time it beside the new one)."""
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


@contextlib.contextmanager
def environ(flags):
    """The environment variables ``flags`` set inside, restored after."""
    old = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def all_launches():
    return {**fa.LAUNCHES, **ln.LAUNCHES, **da.LAUNCHES, **fdm.LAUNCHES,
            **ffn.LAUNCHES, **rca.LAUNCHES}


def train_run(build, seed, steps, warmup, per_step):
    """Train the workload ``build(seed)`` returns (``(model, opt, x, y)``):
    ``warmup`` steps, then ``steps`` timed with every launch count zeroed
    just before and read just after; fail unless they are exactly
    ``per_step`` a step and the losses are finite and fall. Returns
    (launches, median step s, peak bytes)."""
    model, opt, x, y = build(seed)
    warm = [train_step(model, opt, x, y).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, x, y).item())   # synchronizes
        times.append(time.perf_counter() - t0)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * steps for k, n in per_step.items()}
    got = {k: v for k, v in launches.items() if v}
    log(f"  warm-up losses {warm}; losses {losses}")
    med = float(np.median(times))
    log(f"  step ms {[round(1e3 * t, 3) for t in times]}; median "
        f"{1e3 * med:.3f} ms, tokens/s {x.numel() / med:.1f}; "
        f"max_memory_allocated {peak} bytes")
    log(f"  launches over {steps} steps {got}; per step "
        f"{ {k: v / steps for k, v in got.items()} }")
    if got != want:
        raise SystemExit(f"training launches {got}, want exactly {want}")
    check_tensor_core_path("flash attention", fa)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0] \
            or not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise SystemExit(f"training losses must be finite and decrease over "
                         f"the repeated batch: {losses}")
    return launches, med, peak


def phase_train(seed, steps=10, warmup=2):
    log(f"== phase 3c: GPT-2 124M training (L=12, E=768, H=12, V=50304) "
        f"B={BATCH} S={SEQ}, bf16 with fp32 AdamW masters, dropout 0.1, lr "
        f"1e-4; {warmup} warm-up steps, then {steps} timed on one repeated "
        "batch")
    run = train_run(gpt2_train_workload, seed, steps, warmup, TRAIN_LAUNCHES)
    check_ln_row_warp("GPT-2 training", run[0])
    return run


def check_ln_row_warp(label, launches):
    """Every LayerNorm backward launch of a GPT-2 training run (bf16 at D
    768) on the row-warp design."""
    check_norm_paths(label, {
        "layer_norm_bwd": {"row_warp": launches["layer_norm_bwd"]}})


def phase_train_ffn(seed, base, steps=10, warmup=2):
    log("== phase 3d: phase 3c's training with PADDLE_TPU_FUSED_FFN=1 and "
        "PADDLE_TPU_FUSED_FFN_BWD=1 (GPTMLP through the fused FFN kernels)")
    with environ(FUSED_FFN_FLAGS):
        launches, med, peak = train_run(gpt2_train_workload, seed, steps,
                                        warmup, FFN_TRAIN_LAUNCHES)
    check_tensor_core_path("fused FFN", ffn, FFN_PATH_KERNELS)
    check_ln_row_warp("GPT-2 training, fused FFN", launches)
    _, base_med, base_peak = base
    log(f"  fused FFN vs 3c: median step {1e3 * med:.3f} / "
        f"{1e3 * base_med:.3f} ms ({med / base_med:.3f}x), tokens/s "
        f"{BATCH * SEQ / med:.1f} / {BATCH * SEQ / base_med:.1f}; peak "
        f"{peak} / {base_peak} bytes ({peak - base_peak:+d})")
    return launches, med, peak


def phase_train_llama(seed, steps=10, warmup=2):
    log(f"== phase 3f: LLaMA training at LLaMA-2-7B width "
        f"({LLAMA_CONFIG}, tensor_parallel=True) B={LLAMA_BATCH} "
        f"S={LLAMA_SEQ}, bf16 with fp32 AdamW masters, lr 1e-4; {warmup} "
        f"warm-up steps, then {steps} timed on one repeated batch")
    log(f"  card: {card_line()}")
    launches = train_run(llama_train_workload, seed, steps, warmup,
                         LLAMA_TRAIN_LAUNCHES)[0]
    # every bf16 RMSNorm launch at D 4096 on the row-block design
    check_norm_paths("LLaMA training", {
        k: {"row_block": launches[k]} for k in RMS_KERNELS})
    torch.cuda.empty_cache()
    return launches


def ring_launches(n):
    """One forward and backward of the ring over n ranks with remat: the
    chunk forward n^2 times and again in the backward's recompute, each
    backward kernel n^2 times, and no other kernel of the port."""
    return {"ring_chunk_attention_fwd": 2 * n * n,
            "ring_chunk_attention_bwd_dkv": n * n,
            "ring_chunk_attention_bwd_dq": n * n}


def ring_run(q, k, v, do, n, causal):
    """One forward and backward of ``_ring_attention_serial`` over n ranks
    (remat) with every launch count zeroed just before and read just
    after; fail unless they are exactly ``ring_launches(n)``. Returns (o,
    (dq, dk, dv), forward ms, backward ms, peak bytes, launches); the times
    are CUDA events around each half, host included."""
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    events[0].record()
    o = cpar._ring_attention_serial(qg, kg, vg, n, causal)
    events[1].record()
    o.backward(do)
    events[2].record()
    torch.cuda.synchronize()
    launches = {k_: c for k_, c in all_launches().items() if c}
    if launches != ring_launches(n):
        raise SystemExit(f"ring n={n} causal={causal}: launched {launches}, "
                         f"want exactly {ring_launches(n)}")
    check_tensor_core_path(f"ring n={n} causal={int(causal)}", rca)
    return (o.detach(), (qg.grad, kg.grad, vg.grad),
            events[0].elapsed_time(events[1]),
            events[1].elapsed_time(events[2]),
            torch.cuda.max_memory_allocated(), launches)


def phase_ring(seed, reps=3):
    """Phase 3g: the ring's schedule for n ranks in one process (one card
    cannot hold two NCCL ranks) at LLaMA-2-7B attention width."""
    heads = LLAMA_CONFIG["num_heads"]
    b, s, d = LLAMA_BATCH, LLAMA_SEQ, LLAMA_CONFIG["hidden_size"] // heads
    log(f"== phase 3g: ring attention (_ring_attention_serial, remat) at "
        f"LLaMA-2-7B attention width [B={b}, S={s}, H={heads}, D={d}] bf16: "
        "n = 2 and 4 causal, n = 4 not causal; against the dense plain "
        "attention and the flash kernels over the whole sequence")
    log(f"  card: {card_line()}")
    rng = np.random.default_rng(seed + 11)
    q, k, v, do = (randn(rng, (b, s, heads, d), torch.bfloat16)
                   for _ in range(4))
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    main = None
    for causal in (True, False):
        # the whole sequence, [B, H, S, D]: the plain version (dense fp32
        # scores, 2.1 GB) and the flash kernels
        o_p, lse_p = fa.flash_attention_reference(qt, kt, vt, causal)
        plain = (o_p, *fa.flash_attention_bwd_reference(qt, kt, vt, o_p,
                                                        lse_p, dot, causal))
        del lse_p
        o_f, lse_f = fa.flash_attention_fwd(qt, kt, vt, causal)
        flash = (o_f, *fa.flash_attention_bwd(qt, kt, vt, o_f, lse_f, dot,
                                              causal))
        whole = {
            "flash fwd": time_loop_ms(
                lambda i=0: fa.flash_attention_fwd(qt, kt, vt, causal), reps),
            "flash bwd": time_loop_ms(
                lambda i=0: fa.flash_attention_bwd(qt, kt, vt, o_f, lse_f,
                                                   dot, causal), reps)}
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        whole["SDPA fwd"] = time_loop_ms(
            lambda i=0: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
            reps)
        whole["SDPA bwd"] = time_loop_ms(lambda i=0: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), reps)
        del out, qg, kg, vg
        for n in ((2, 4) if causal else (4,)):
            label = f"ring n={n} causal={int(causal)}"
            runs = [ring_run(q, k, v, do, n, causal) for _ in range(reps)]
            o, grads, _, _, peak, launches = runs[0]
            got = (o.transpose(1, 2), *(g.transpose(1, 2) for g in grads))
            for ref_name, ref in (("plain", plain), ("flash", flash)):
                for part, g, w in zip(("o", "dq", "dk", "dv"), got, ref):
                    check(f"{label} {part} vs the {ref_name} attention", g,
                          w, "attention_bf16" if part == "o"
                          else "attention_grad_bf16", {})
            fwd_ms = float(np.median([r[2] for r in runs]))
            bwd_ms = float(np.median([r[3] for r in runs]))
            log(f"  {label}: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} "
                f"ms (median of {reps}, CUDA events, host included); "
                f"whole sequence, loops of {reps} between events: "
                + ", ".join(f"{k_} {t:.3f} ms" for k_, t in whole.items())
                + f"; ring peak max_memory_allocated {peak} bytes; "
                f"launches {launches}")
            if causal and n == 4:
                main = launches
            del runs, o, grads, got
        del plain, flash, o_f, lse_f
    torch.cuda.empty_cache()
    return main


def phase_fmt(seed, steps=127, chunk=128, b=8, smax=1024, n_layers=12):
    log(f"== phase 3e: FusedMultiTransformer at GPT-2-124M width (E={E}, "
        f"H={H}, FF={FF}, L={n_layers}, gelu, pre-LN, bf16, random weights): "
        f"B={b}, a {chunk}-token chunk at time_step 0, then {steps} "
        f"one-token steps over caches [2, {b}, {H}, {smax}, {E // H}]; then "
        "one FusedFeedForward forward and backward with the fused FFN flags")
    state = random_state(np.random.default_rng(seed + 6), E, H, FF,
                         n_layers, 8)
    fmt, _, _ = from_jax_state(*state, dtype=torch.bfloat16)
    caches = [torch.zeros((2, b, H, smax, E // H), dtype=torch.bfloat16,
                          device="cuda") for _ in range(n_layers)]
    xs = randn(np.random.default_rng(seed + 7), (b, chunk + steps, E),
               torch.bfloat16)
    attention = [k for k in all_launches() if "attention" in k]
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    reset_launches()
    torch.cuda.synchronize()
    times = []
    with torch.no_grad():
        for i in range(steps + 1):
            ts, n = (0, chunk) if i == 0 else (chunk + i - 1, 1)
            before = all_launches()
            t0 = time.perf_counter()
            out, caches = fmt(xs[:, ts:ts + n], caches=caches, time_step=ts)
            finite &= torch.isfinite(out).all()
            if i in (0, steps):
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = all_launches()
            got = {k: after[k] - before[k] for k in attention
                   if after[k] != before[k]}
            if got != {"decode_attention_bhsd": n_layers}:
                raise SystemExit(f"FusedMultiTransformer call {i} launched "
                                 f"{got}, want exactly {n_layers} "
                                 "decode_attention_bhsd")
    torch.cuda.synchronize()
    decode_s = sum(times[1:])
    launches = all_launches()
    check_paths("[fmt]", {"decode_attention_bhsd": n_layers * (steps + 1)})
    if not bool(finite) or not all(bool(torch.isfinite(c).all())
                                   for c in caches):
        raise SystemExit("FusedMultiTransformer: non-finite outputs or "
                         "caches")
    log(f"  chunk (time_step 0, S={chunk}) {1e3 * times[0]:.3f} ms; "
        f"{steps} decode steps in {decode_s:.4f} s, "
        f"{1e3 * decode_s / steps:.3f} ms a step (host clock, the last "
        f"synchronized); launches {launches}")
    ff = FusedFeedForward(E, FF, dropout_rate=0.0, activation="gelu",
                          normalize_before=True, dtype=torch.bfloat16,
                          seed=seed)
    x = randn(np.random.default_rng(seed + 8), (b, chunk, E),
              torch.bfloat16).requires_grad_()
    reset_launches()
    with environ(FUSED_FFN_FLAGS):
        y = ff(x)
        y.backward(torch.ones_like(y))
    got = {k: v for k, v in ffn.LAUNCHES.items() if v}
    # pre-LN leaves ln2 unused, as in the JAX layer
    grads = [x.grad] + [p.grad for n, p in ff.named_parameters()
                        if not n.startswith("ln2")]
    log(f"  FusedFeedForward [{b}, {chunk}, {E}] forward + backward: fused "
        f"FFN launches {got}")
    if got != {k: 1 for k in ffn.LAUNCHES}:
        raise SystemExit(f"FusedFeedForward launched {got}, want each fused "
                         "FFN kernel once")
    check_tensor_core_path("FusedFeedForward", ffn,
                           FFN_PATH_KERNELS)
    if not torch.isfinite(y).all() or not all(
            g is not None and bool(torch.isfinite(g).all()) for g in grads):
        raise SystemExit("FusedFeedForward: non-finite output or gradients")
    return launches


def phase_train_parity(seed, build=None, batch=2, seq=128, steps=3,
                       lr=1e-3, label="train", kernels=(), logits=False):
    """The model ``build(device=, seed=)`` makes (default: GPT-2 124M
    widths at L=2, dropout 0), fp32 (TF32 off): the same weights and batch
    of ids below the model's vocabulary trained 3 AdamW steps on the card
    and on the CPU (plain versions there), the card's run launching each of
    ``kernels``; with ``logits`` the first forward's logits within
    TOLERANCES["logits_fp32"]; losses and step-1 gradients within
    TOLERANCES["train_loss_fp32"] and ["train_grads_fp32"], step-3
    parameters within ["train_params_fp32"] but for the share of
    elements that ["train_params_outliers"] allows."""
    build = build or functools.partial(gpt2_124m, num_layers=2, dropout=0.0)
    cpu_model = build(device="cpu", seed=seed)
    ids = np.random.default_rng(seed + 4).integers(
        0, cpu_model.config.vocab_size, (batch, seq + 1))
    state = cpu_model.state_dict()
    runs = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            model = cpu_model
        else:
            model = build(device=dev, seed=seed)
            model.load_state_dict(state)
        opt = AdamW(lr, parameters=model.named_parameters())
        x, y = (torch.from_numpy(a).to(dev) for a in (ids[:, :-1],
                                                      ids[:, 1:]))
        reset_launches()
        t0 = time.perf_counter()
        first = None
        if logits:
            with torch.no_grad():
                first = model(x).cpu()
        losses, grads = [], None
        for i in range(steps):
            loss = model(x, labels=y)
            loss.backward()
            if i == 0:
                grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs[dev] = (losses, grads, {n: p.detach().cpu() for n, p in
                                     model.named_parameters()}, first)
        log(f"  [{label}] {dev}: {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s, losses {losses}")
        if dev == "cuda" and not all(all_launches()[k] for k in kernels):
            raise SystemExit(f"[{label}] the card's run launched "
                             f"{all_launches()}, want each of {kernels}")
        del model, opt
    if logits:
        got, want = runs["cuda"][3], runs["cpu"][3]
        tol = TOLERANCES["logits_fp32"]
        ok = torch.allclose(got, want, **tol)
        log(f"  [{label}] logits {tuple(got.shape)} card vs CPU: worst "
            f"{(got - want).abs().max().item():.3e} (atol {tol['atol']}, "
            f"rtol {tol['rtol']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[{label}] logits on the card and the CPU "
                             "differ")
    (lc, gc, pc, _), (lh, gh, ph, _) = runs["cuda"], runs["cpu"]
    for what, got, want, tname in (
            ("losses", {"loss": torch.tensor(lc)},
             {"loss": torch.tensor(lh)}, "train_loss_fp32"),
            ("step-1 gradients", gc, gh, "train_grads_fp32")):
        tol = TOLERANCES[tname]
        worst = max(((got[n] - want[n]).abs().max().item(), n) for n in want)
        bad = [n for n in want if not torch.allclose(got[n], want[n], **tol)]
        log(f"  [{label}] {what} card vs CPU: worst {worst[0]:.3e} at "
            f"{worst[1]} (atol {tol['atol']}, rtol {tol['rtol']}) "
            f"{'ok' if not bad else 'FAIL ' + str(bad)}")
        if bad:
            raise SystemExit(f"training on the card and the CPU differ: "
                             f"{what} {bad}")
    tol, out = TOLERANCES["train_params_fp32"], TOLERANCES[
        "train_params_outliers"]
    outside = {n: int((~torch.isclose(pc[n], ph[n], **tol)).sum())
               for n in ph}
    n_out, n_all = sum(outside.values()), sum(t.numel() for t in ph.values())
    worst = max(((pc[n] - ph[n]).abs().max().item(), n) for n in ph)
    cap = out["per_step_lr"] * lr * steps
    ok = n_out <= out["share"] * n_all and worst[0] <= cap
    log(f"  [{label}] step-3 parameters card vs CPU: {n_out} of {n_all} "
        f"elements outside atol {tol['atol']}, rtol {tol['rtol']} (share "
        f"{n_out / n_all:.2e}, allowed {out['share']}): "
        f"{ {n: k for n, k in outside.items() if k} }; worst {worst[0]:.3e} "
        f"at {worst[1]} (cap {cap:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("training on the card and the CPU differ: step-3 "
                         "parameters")


# the decoder's own options among a phase-4 flavor's keyword args
DECODER_KW = ("kv_quant", "weight_quant", "use_rotary", "head_quant")


def first_gap_margin(mods_cpu, prompt, prefix, key=None, flavor=None,
                     pen=1.2, row=None):
    """Top-2 margin of the CPU model (built as ``flavor`` says) after
    prompt + prefix (the context at the first differing token), through
    a fresh pool; for a sampled flavor (``key``: the draw's key, ``row``
    as ``gumbel_margin`` takes it) the margin of the filtered (and, with
    a repetition penalty, penalized) logits plus the draw's gumbel
    noise."""
    flavor = flavor or {}
    ctx = np.concatenate([prompt, np.asarray(prefix, np.int64)])
    dec = FusedDecoder(*mods_cpu, max_seq_len=len(ctx) + 1, device="cpu",
                       **{k: v for k, v in flavor.items() if k in DECODER_KW})
    pool = BlockPool(dec.smax // 64, 64, dec.smax)
    caches = dec.init_paged_cache(pool)
    caches["tbl"] = torch.arange(pool.num_blocks, dtype=torch.int32)[None]
    toks = torch.from_numpy(ctx)[None]
    for c0 in range(0, toks.shape[1], 128):   # the kernel's Sq limit
        part = toks[:, c0:c0 + 128]
        x = dec.spec_hidden(dec._stacked(), caches, part,
                            torch.full((1,), c0, dtype=torch.int64),
                            torch.ones_like(part, dtype=torch.bool))
    logits = dec.head_logits(x[:, -1]).float()
    if key is None:
        top = logits.topk(2).values[0]
        return float(top[0] - top[1])
    if flavor.get("enable_repetition_penalty") or \
            flavor.get("repetition_penalty", 1.0) != 1.0:
        logits = _penalize_slots(logits, _presence_from(toks, V),
                                 torch.full((1,), pen), torch.zeros(1),
                                 torch.zeros(1), torch.full((1,), -1))
    flt = tuple(flavor[k] for k in ("top_k", "top_p", "temperature"))
    return gumbel_margin(_filter_logits(logits, True, *flt), key, row)


def generate_keys(seed, max_new):
    """The keys of generate's sampled draws after ``trng.seed(seed)``
    without eos: the head step's ``next_key()``, then each chunk of the
    ladder (64, halved to fit) ``split(next_key(), chunk)``."""
    trng.seed(seed)
    keys, remaining = [trng.next_key()], max_new - 1
    while remaining > 0:
        chunk = 64
        while chunk > remaining:
            chunk //= 2
        keys.extend(trng.split(trng.next_key(), chunk))
        remaining -= chunk
    return keys


def request_keys(seed, n):
    """The seeds a sampling engine's n requests draw at submit after
    ``trng.seed(seed)``, as a function of (request, token index) ->
    the key of that draw."""
    trng.seed(seed)
    seeds = [_host_seed(trng.next_key()) for _ in range(n)]
    return lambda i, j: trng.fold_in(trng.prng_key(seeds[i]), j)


def phase_parity(seed):
    log("== phase 4: card vs CPU (row) at L=2, full width, fp32 (TF32 "
        "off), per flavor; then GPT-2 training, 3 AdamW steps, without and "
        "with the fused FFN; then FusedMultiTransformer's cache decode; "
        "then LLaMA training at LLaMA-2-7B width, L=1, B=1, S=128, 3 AdamW "
        "steps")
    rng = np.random.default_rng(seed + 1)
    state = random_state(rng, E, H, FF, 2, V)
    reqs = [(rng.integers(0, V, int(rng.integers(20, 201))),
             int(rng.integers(12, 25))) for _ in range(6)]
    flavors = {"fp": ({}, list(SCHEDULERS)),
               "kv8-w4": (QUANT["kv8-w4"], list(SCHEDULERS)),
               "w8": (QUANT["w8"], ["row"]),
               "dense": ({"paged": False}, list(SCHEDULERS)),
               "dense-kv8": ({"paged": False, "kv_quant": "int8"}, ["row"]),
               "sampled": (SAMPLED, list(SCHEDULERS)),
               "rotary": ({"use_rotary": True, **SAMPLED}, list(SCHEDULERS)),
               "head8": ({"head_quant": "int8"}, list(SCHEDULERS))}
    # this slice's options, on requests that share a template (prefix
    # caching; four slots, so the budget schedulers' second gang hits) or
    # walk a cycle of the spec mix's model (speculative decoding): greedy,
    # each scheduler's tokens against the CPU's row run (and the row run's
    # counters against the CPU's), the dense engines against the pool's
    # CPU run (their tokens and counters are the same); sampled
    # speculation draws its acceptance on the host in an order of each
    # scheduler's own, so each is held with its counters to the CPU's run
    # of the same scheduler
    opt_reqs = option_requests(seed)
    spec = {"spec_k": 4, "decode_chunk": 2}
    prefix = {"prefix_cache_blocks": 32, "num_slots": 4}
    options = {"prefix": (prefix, list(SCHEDULERS)),
               "prefix-dense": ({**prefix, "paged": False}, ["row", "phase"]),
               "spec": (spec, list(SCHEDULERS)),
               "spec-dense": ({**spec, "paged": False}, ["row"]),
               "spec-sampled": ({**spec, **SAMPLED}, list(SCHEDULERS))}
    flavors.update(options)
    cpu_runs = {}
    for fname, (flavor, scheds) in flavors.items():
        # an int8 pool makes the phase scheduler a computation of its own:
        # its bulk prefill attends the prompt over exact K/V and quantizes
        # only what it writes, where the budget schedulers' prefill chunks
        # attend the int8 pool, so the card's phase run is held to the
        # CPU's phase run (the JAX engine's design; tests hold both to it)
        kv8 = flavor.get("kv_quant") == "int8"
        oracle = {n: "phase" if kv8 and n == "phase" else "row"
                  for n in scheds}
        if fname in options and flavor.get("do_sample"):
            oracle = {n: n for n in scheds}
        cpu = sorted(set(oracle.values()), reverse=True)
        f_reqs = opt_reqs[fname.split("-")[0]] if fname in options else reqs
        # at L=2 the embedding needs no scaling for the cycle to lead, and
        # unscaled the drafts are rejected often enough to take both ways
        f_state = (cycle_head(state, scale=1.0) if fname.startswith("spec")
                   else state)
        counters = {}
        outs = {}
        if fname in options and fname.endswith("-dense"):
            outs, counters = (dict(d) for d in cpu_runs[fname[:-6]])
            cpu = []
        for dev, name in ([("cuda", n) for n in scheds]
                          + [("cpu", n) for n in cpu]):
            mods = from_jax_state(*f_state, device=dev, dtype=torch.float32)
            eng = ServingEngine(*mods, device=dev, **{
                "num_slots": 8, "max_seq_len": 1024, **SCHEDULERS[name],
                **flavor})
            reset_launches()
            trng.seed(seed)
            t0 = time.perf_counter()
            outs[dev, name] = list(serve(
                eng, f_reqs, **({"repetition_penalty": 1.2} if flavor.get(
                    "enable_repetition_penalty") else {}))[0].values())
            m = eng.metrics()
            counters[dev, name] = {k: m[k] for k in OPTION_COUNTERS}
            log(f"  [{fname}] {dev} {name}: {time.perf_counter() - t0:.2f} s"
                + (f"; {counters[dev, name]}" if fname in options else ""))
            if dev == "cuda":             # fp32 queries: the per-head design
                check_all_per_head(f"[{fname}] {name}")
        cpu_runs[fname] = (outs, counters)
        for name in scheds:
            want = outs["cpu", oracle[name]]
            if fname in options and oracle[name] == name and \
                    counters["cuda", name] != counters["cpu", name]:
                raise SystemExit(f"[{fname}] {name}: card counters "
                                 f"{counters['cuda', name]}, CPU's "
                                 f"{counters['cpu', name]}")
            for i, (a, b) in enumerate(zip(outs["cuda", name], want)):
                if np.array_equal(a, b):
                    continue
                j = int(np.argmax(a != b)) if len(a) == len(b) else min(
                    len(a), len(b))
                mods = from_jax_state(*f_state, device="cpu",
                                      dtype=torch.float32)
                if flavor.get("spec_k") and flavor.get("do_sample"):
                    raise SystemExit(
                        f"[{fname}] request {i}: card ({name}) and CPU "
                        f"tokens differ at index {j} ({a[j:j + 4]} vs "
                        f"{b[j:j + 4]}); the host's acceptance draws")
                key = (request_keys(seed, len(f_reqs))(i, j)
                       if flavor.get("do_sample") else None)
                margin = first_gap_margin(mods, f_reqs[i][0], b[:j], key,
                                          flavor)
                what = ("filtered logits plus gumbel" if key is not None
                        else "logits")
                raise SystemExit(
                    f"[{fname}] request {i}: card ({name}) and CPU "
                    f"({oracle[name]}) tokens differ at index {j} "
                    f"({a[j:j + 4]} vs {b[j:j + 4]}); CPU top-2 margin of "
                    f"the {what} there {margin:.3e}")
        log(f"  [{fname}] {len(f_reqs)} requests, "
            f"{sum(len(t) for t in outs['cpu', 'row'])} tokens: each of "
            f"{', '.join(scheds)} on the card identical to "
            f"{' / '.join(sorted(set(oracle.values()), reverse=True))} on "
            "the CPU")
    parity_lifecycle(state, seed)
    parity_generate(state, rng, seed)
    phase_train_parity(seed)
    with environ(FUSED_FFN_FLAGS):
        phase_train_parity(seed, label="train-ffn", kernels=tuple(
            ffn.LAUNCHES))
    parity_fmt(seed)
    phase_train_parity(seed, build=llama_one_layer, batch=1,
                       label="train-llama",
                       kernels=tuple(LLAMA_TRAIN_LAUNCHES), logits=True)
    parity_ring(seed)


class FakeClock:
    """An engine clock that moves 0.1 ms a call, and as far as a script
    jumps it (deadlines under test)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-4
        return self.t


# what phase 4's lifecycle script holds equal between the card and the CPU
LIFECYCLE_COUNTERS = (
    "requests_finished", "requests_admitted", "requests_forked",
    "requests_rejected", "requests_expired", "requests_migrated_in",
    "requests_migrated_out", "requests_preempted", "requests_resumed",
    "requests_parked", "kv_blocks_shipped", "kv_blocks_adopted",
    "kv_cow_copies", "kv_blocks_used", "tokens_emitted", "decode_steps",
    "budget_steps", "tokens_emitted_high", "tokens_emitted_normal",
    "tokens_emitted_low")
# the lifecycle script's flavors: the paged pool fp and int8, greedy, and
# fp sampled with the repetition penalty (the presence rebuilt at resume
# and import)
LIFECYCLE_FLAVORS = {"fp": {}, "kv8": {"kv_quant": "int8"},
                     "sampled": SAMPLED}


def lifecycle_script(eng, clock, reqs, pen):
    """Phase 4's slot lifecycle on one engine (4 slots, max_pending 3):
    a low request preempted to the host (mid-prefill under a budget) and
    resumed, a fork whose twins copy the block they share on write, a
    high request that preempts the youngest low one, max_pending
    shedding, a running request exported, and a deadline that expires a
    parked or running request under the fake clock. Returns what it saw
    (states, counters, every result) and the exported state."""
    kw = {"repetition_penalty": 1.2} if pen else {}
    seen = []

    def state(rid):
        return (eng.poll(rid) or {}).get("state")

    a = eng.submit(reqs[0][0], reqs[0][1], priority="low", **kw)
    b = eng.submit(reqs[1][0], reqs[1][1], priority="low", deadline_s=50.0,
                   **kw)
    c = eng.submit(reqs[2][0], reqs[2][1], **kw)
    eng.step()
    if state(b) == "running":
        eng.preempt_to_host(b)
    eng.step()
    eng.step()
    f = eng.fork_slot(a) if state(a) == "running" else None
    eng.step()
    eng.step()
    h = eng.submit(reqs[3][0], reqs[3][1], priority="high", **kw)
    eng.step()
    seen.append(("states", [state(r) for r in (a, b, c, f, h)]))
    queued = 0
    try:
        for p, m in reqs[4:8]:            # one more than max_pending
            eng.submit(p, m, **kw)
            queued += 1
        seen.append(("shed", False, queued))
    except AdmissionFull:
        seen.append(("shed", True, queued))
    moved = next((r for r in (c, h) if state(r) == "running"), None)
    exported = eng.export_slot(moved) if moved is not None else None
    clock.t += 60.0                       # b's deadline has passed
    eng.step()
    seen.append(("states", [state(r) for r in (a, b, c, f, h)]))
    eng.run()
    m = eng.metrics()
    seen.append(("counters", {k: m[k] for k in LIFECYCLE_COUNTERS}))
    seen.append(("results", {r: (v["tokens"].tolist(), v["expired"])
                             for r, v in eng.results.items()}))
    return seen, exported


def parity_lifecycle(state, seed):
    """The lifecycle script per flavor and scheduler on the card and on
    the CPU (the same scheduler: the events follow its steps): what each
    saw equal; the card's exported state imported into a second card
    engine and into a CPU engine, and the CPU's into a second CPU engine,
    the three continuations equal."""
    rng = np.random.default_rng(seed + 11)
    reqs = [(rng.integers(0, V, n), m) for n, m in
            ((40, 20), (150, 60), (30, 18), (25, 8), (20, 6), (35, 6),
             (10, 4), (15, 4))]
    t0 = time.perf_counter()
    for fname, flavor in LIFECYCLE_FLAVORS.items():
        for sched in SCHEDULERS:
            kwargs = {"num_slots": 4, "max_seq_len": 256, "max_pending": 3,
                      **SCHEDULERS[sched], **flavor}
            seen, cont = {}, {}
            for dev in ("cuda", "cpu"):
                mods = from_jax_state(*state, device=dev,
                                      dtype=torch.float32)
                clock = FakeClock()
                eng = ServingEngine(*mods, device=dev, clock=clock, **kwargs)
                reset_launches()
                trng.seed(seed)
                seen[dev], exported = lifecycle_script(
                    eng, clock, reqs, "enable_repetition_penalty" in flavor)
                if exported is None:
                    raise SystemExit(f"[lifecycle-{fname}] {sched}: nothing "
                                     f"running to export: {seen[dev]}")
                targets = [dev] if dev == "cpu" else ["cuda", "cpu"]
                for tdev in targets:
                    other = ServingEngine(
                        *(mods if tdev == dev else from_jax_state(
                            *state, device=tdev, dtype=torch.float32)),
                        device=tdev, **kwargs)
                    rid = other.import_slot(exported)
                    other.run()
                    cont[dev, tdev] = other.results[rid]["tokens"].tolist()
                if dev == "cuda":             # fp32: the per-head design
                    check_all_per_head(f"[lifecycle-{fname}] {sched}")
            c = dict(seen["cuda"][-2][1])
            if seen["cuda"] != seen["cpu"] or \
                    len(set(map(tuple, cont.values()))) != 1:
                raise SystemExit(
                    f"[lifecycle-{fname}] {sched}: the card saw "
                    f"{seen['cuda']}, the CPU {seen['cpu']}; continuations "
                    f"after export {cont}")
            if not (c["requests_preempted"] and c["requests_resumed"]
                    and c["requests_forked"] and c["kv_cow_copies"]
                    and c["requests_expired"] and c["requests_rejected"]
                    and c["requests_migrated_out"]):
                raise SystemExit(f"[lifecycle-{fname}] {sched}: a piece of "
                                 f"the lifecycle did not happen: {c}")
            log(f"  [lifecycle-{fname}] {sched}: the card equal to the CPU "
                f"(states, counters, tokens; {c}); the card's state "
                "continued on a second card engine and on the CPU as the "
                "CPU's own")
    log(f"  the lifecycle parity: {time.perf_counter() - t0:.1f} s")


# what phase 4 holds equal between the card and the CPU for the options
OPTION_COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens_saved",
                   "draft_proposed", "draft_accepted")


def option_requests(seed):
    """Phase 4's requests for the options, at L=2: six that share a
    128-token template (two 64-token blocks) and six whose prompts walk a
    16-id cycle of the spec mix's model (``cycle_head``)."""
    rng = np.random.default_rng(seed + 6)
    tmpl = rng.integers(0, V, 128)
    prefix = [(np.concatenate([tmpl, rng.integers(0, V, n)]), 12)
              for n in (8, 20, 33, 5, 14, 40)]
    spec = [(CYCLE * int(rng.integers(0, V // CYCLE))
             + (int(rng.integers(0, CYCLE)) + np.arange(n)) % CYCLE, 24)
            for n in (40, 64, 90, 33, 70, 50)]
    return {"prefix": prefix, "spec": spec}


def parity_ring(seed, n=4, b=2, s=256, h=4, hk=2, d=64):
    """``_ring_attention_serial`` over n ranks, causal, fp32 (TF32 off) at
    [B, S, H, D] with GQA: the card's kernels against the CPU's composite
    and the CPU's plain kernel versions (PADDLE_TPU_RING_KERNEL_CPU=1);
    outputs within TOLERANCES["attention_fp32"], gradients of sum(o * g)
    within ["attention_grad_fp32"]."""
    rng = np.random.default_rng(seed + 12)
    q, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, s, hk, d)).astype(np.float32)
            for _ in range(2))
    runs = {}
    for name, dev, flags in (("card", "cuda", {}),
                             ("cpu composite", "cpu", {}),
                             ("cpu plain", "cpu",
                              {"PADDLE_TPU_RING_KERNEL_CPU": "1"})):
        qt, kt, vt = (torch.from_numpy(x).to(dev).requires_grad_()
                      for x in (q, k, v))
        reset_launches()
        with environ(flags):
            o = cpar._ring_attention_serial(qt, kt, vt, n, causal=True)
            (o * torch.from_numpy(g).to(dev)).sum().backward()
        runs[name] = [x.detach().cpu() for x in (o, qt.grad, kt.grad,
                                                   vt.grad)]
        if dev == "cuda" and {k_: c for k_, c in all_launches().items()
                              if c} != ring_launches(n):
            raise SystemExit(f"[ring parity] the card launched "
                             f"{all_launches()}, want {ring_launches(n)}")
    for ref in ("cpu composite", "cpu plain"):
        for part, got, want in zip(("o", "dq", "dk", "dv"), runs["card"],
                                   runs[ref]):
            tname = "attention_fp32" if part == "o" else "attention_grad_fp32"
            tol = TOLERANCES[tname]
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **tol)
            log(f"  [ring parity] n={n} fp32 [{b}, {s}, {h}, {d}] Hk={hk} "
                f"{part}: card vs {ref} {err:.3e} ({tname}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"[ring parity] {part}: the card and the "
                                 f"{ref} differ")


def llama_one_layer(device, seed):
    """Phase 3f's LLaMA at one layer, fp32: phase 4's parity model."""
    return LlamaForCausalLM(LlamaConfig(**{**LLAMA_CONFIG, "num_layers": 1}),
                            device=device, seed=seed)


def parity_fmt(seed, b=2, chunk=16, steps=8, smax=256, n_layers=2):
    """FusedMultiTransformer at GPT-2-124M width, L=2, fp32, on the card
    and on the CPU (plain versions there) from the same weights, inputs
    and zeroed caches [2, B, H, Smax, D]: a 16-token chunk at time_step 0,
    then 8 one-token steps; every step's output and caches within
    TOLERANCES["logits_fp32"], and the card launching L
    decode_attention_bhsd a call."""
    state = random_state(np.random.default_rng(seed + 9), E, H, FF,
                         n_layers, 8)
    xs = np.random.default_rng(seed + 10).standard_normal(
        (b, chunk + steps, E)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        fmt, _, _ = from_jax_state(*state, device=dev)
        caches = [torch.zeros((2, b, H, smax, E // H), device=dev)
                  for _ in range(n_layers)]
        x = torch.from_numpy(xs).to(dev)
        reset_launches()
        seq = []
        with torch.no_grad():
            for i in range(steps + 1):
                ts, n = (0, chunk) if i == 0 else (chunk + i - 1, 1)
                out, caches = fmt(x[:, ts:ts + n], caches=caches,
                                  time_step=ts)
                # copies: on the CPU .cpu() would alias the caches, which
                # the next step updates in place
                seq.append([t.cpu().clone() for t in (out, *caches)])
        runs[dev] = seq
        if dev == "cuda":
            check_paths("[fmt] fp32", {"decode_attention_bhsd": 0},
                        {"decode_attention_bhsd": n_layers * (steps + 1)})
    tol = TOLERANCES["logits_fp32"]
    worst = 0.0
    for i, (got, want) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for name, g, w in zip(["out"] + [f"cache {j}" for j in
                                         range(n_layers)], got, want):
            worst = max(worst, (g - w).abs().max().item())
            if not torch.allclose(g, w, **tol):
                raise SystemExit(f"[fmt] step {i} {name}: card and CPU "
                                 "differ beyond logits_fp32")
    log(f"  [fmt] L={n_layers} fp32, a {chunk}-token chunk then {steps} "
        f"steps: outputs and caches card vs CPU worst {worst:.3e} (atol "
        f"{tol['atol']}, rtol {tol['rtol']}) ok")


def parity_generate(state, rng, seed):
    """generate over the ring: fp and kv_quant="int8", the card's tokens
    with cache_write_kernel off and on against the CPU's (write, then
    read) of the same flavor; then sampled with a repetition penalty,
    rotary (sampled) and the int8 head, the card's against the CPU's;
    then this slice's options: a second call adopting from the first's
    PrefixCache, and spec_k=4 greedy and sampled on prompts that repeat
    a pattern."""
    ids = rng.integers(0, V, (4, 48))
    sampled = {**SAMPLE, "repetition_penalty": 1.2}
    runs = [("fp", {}, {}, (False, True)),
            ("kv8", {"kv_quant": "int8"}, {}, (False, True)),
            ("sampled", {}, sampled, (False,)),
            ("rotary", {"use_rotary": True}, sampled, (False,)),
            ("head8", {"head_quant": "int8"}, {}, (False,)),
            ("prefix", {}, {"prefix_cache": None}, (False,)),
            ("spec", {}, {"spec_k": 4}, (False,)),
            ("spec-sampled", {}, {**sampled, "spec_k": 4}, (False,))]
    r = np.random.default_rng(seed + 7)
    spec_ids = (CYCLE * r.integers(0, V // CYCLE, (4, 1))
                + (r.integers(0, CYCLE, (4, 1)) + np.arange(48)) % CYCLE)
    for fname, flavor, gen_kw, writes in runs:
        outs = {}
        f_ids = spec_ids if "spec" in fname else ids
        f_state = cycle_head(state, scale=1.0) if "spec" in fname else state
        for dev, kw in [("cuda", w) for w in writes] + [("cpu", False)]:
            mods = from_jax_state(*f_state, device=dev, dtype=torch.float32)
            calls = [dict(gen_kw)]
            if "prefix_cache" in gen_kw:
                # the second call adopts two of each row's three blocks
                pc = PrefixCache(16, 16)
                calls = [{"prefix_cache": pc}] * 2
            reset_launches()
            trng.seed(seed)
            t0 = time.perf_counter()
            for call_kw in calls:
                outs[dev, kw] = generate_fused(
                    mods[0], f_ids, *mods[1:], max_new_tokens=24,
                    max_seq_len=1024, cache_write_kernel=kw, device=dev,
                    **flavor, **call_kw).numpy()[:, 48:]
            if "prefix_cache" in gen_kw and \
                    pc.store.stats()["match_hits"] != len(f_ids):
                raise SystemExit(f"[generate {fname}] {dev}: the second "
                                 f"call did not adopt: {pc.store.stats()}")
            log(f"  [generate {fname}] {dev} cache_write_kernel={kw}: "
                f"{time.perf_counter() - t0:.2f} s")
            if dev == "cuda":
                check_all_per_head(f"[generate {fname}] write={int(kw)}")
        want = outs["cpu", False]
        for kw in writes:
            got = outs["cuda", kw]
            if np.array_equal(got, want):
                continue
            i = int(np.argmax((got != want).any(axis=1)))
            j = int(np.argmax(got[i] != want[i]))
            mods = from_jax_state(*f_state, device="cpu", dtype=torch.float32)
            if gen_kw.get("spec_k") and gen_kw.get("do_sample"):
                raise SystemExit(
                    f"[generate {fname}] row {i}: card and CPU tokens "
                    f"differ at index {j} ({got[i, j:j + 4]} vs "
                    f"{want[i, j:j + 4]}); the host's acceptance draws")
            key = (generate_keys(seed, 24)[j] if gen_kw.get("do_sample")
                   else None)
            margin = first_gap_margin(mods, f_ids[i], want[i, :j], key,
                                      {**flavor, **gen_kw},
                                      row=(f_ids.shape[0], i))
            raise SystemExit(
                f"[generate {fname}] row {i}: card (cache_write_kernel="
                f"{kw}) and CPU tokens differ at index {j} "
                f"({got[i, j:j + 4]} vs {want[i, j:j + 4]}); CPU top-2 "
                f"margin there {margin:.3e}")
        log(f"  [generate {fname}] {want.size} tokens: the card's "
            f"(cache_write_kernel {'off and on' if len(writes) > 1 else 'off'}"
            ") identical to the CPU's")


def time_ms(fn, reps):
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed between two events, so the host's time between launches
    (longer than a short kernel) is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
              reps, tname="attention_bf16"):
    """Check the kernel against its plain version at this shape (bf16
    tolerance), then time kernel, plain version and library call (a
    callable, or {name: timer} of which the fastest counts, its name
    under "library")."""
    got, want = run_kernel(), run_plain()
    if isinstance(got, tuple):               # flash: (o, lse)
        got, want = got[0], want[0]
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = TOLERANCES[tname]
    if not torch.allclose(got, want, **tol):
        raise SystemExit(
            f"kernel disagrees with its plain version at {label}: "
            f"max_abs_err {err:.3e} (atol {tol['atol']}, rtol "
            f"{tol['rtol']})")
    bound_ms, bound_by = bound(nbytes, flops)
    row = {**label, "max_abs_err": err, "ms": time_ms(run_kernel, reps),
           "plain_ms": time_ms(run_plain, max(reps // 10, 5)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if isinstance(run_library, dict):
        row["library_ms"], row["library"] = fastest_ms(run_library)
    else:
        row["library_ms"] = (None if run_library is None
                             else time_ms(run_library, reps))
    log("  " + json.dumps(row))
    return row


def fastest_ms(timers):
    """(ms, name) of the fastest of ``timers`` ({name: () -> ms}); a call
    that refuses these inputs (an SDPA backend that does not support them)
    is logged and left out."""
    best = (None, None)
    for name, timer in timers.items():
        try:
            ms = timer()
        except RuntimeError as e:
            torch.cuda.synchronize()
            log(f"    library {name}: not timed "
                f"({str(e).strip().splitlines()[0][:160]})")
            continue
        log(f"    library {name}: {ms:.4f} ms")
        if best[0] is None or ms < best[0]:
            best = (ms, name)
    if best[0] is None:
        raise SystemExit(f"no library call ran: {list(timers)}")
    return best


def time_grad_ms(forward, inputs, grad, reps):
    """Device ms of one backward through autograd of ``forward(*inputs)``
    (every input's gradient), replayed from a CUDA graph as time_ms does:
    the forward runs once on the capture's stream, so the backward it
    records runs there too."""
    xs = [x.detach().requires_grad_() for x in inputs]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward(*xs)
        torch.autograd.grad(out, xs, grad, retain_graph=True)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            torch.autograd.grad(out, xs, grad, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sdpa_timers(q, k, v, do, causal, p, reps):
    """The PyTorch calls that compute the flash kernels' function on the
    same [B, H, S, D] inputs (Sq = Sk, where SDPA's top-left causal mask is
    the kernels' bottom-right one), as timers for fastest_ms, each replayed
    from a CUDA graph as the kernels are: (forward, backward). Forward:
    SDPA under its default dispatch and under each of its flash, cuDNN and
    memory-efficient backends. Backward (none when ``do`` is None): ATen's
    flash backward called directly, and SDPA's backward through autograd
    under the default dispatch and the cuDNN backend (all three
    gradients)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    backends = (("default", None), ("flash", SDPBackend.FLASH_ATTENTION),
                ("cudnn", SDPBackend.CUDNN_ATTENTION),
                ("efficient", SDPBackend.EFFICIENT_ATTENTION))

    def sdpa(backend):
        def run(q, k, v):
            with (contextlib.nullcontext() if backend is None
                  else sdpa_kernel(backend)):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, dropout_p=p)
        return run
    fwd = {f"sdpa {name}": functools.partial(
        time_ms, lambda i=0, run=sdpa(backend): run(q, k, v), reps)
        for name, backend in backends}
    if do is None:
        return fwd, {}
    flash = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, p, causal)
    flash_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    bwd = {"aten flash backward": functools.partial(
        time_ms, lambda i=0: flash_bwd(do, q, k, v, *flash[:6], p, causal,
                                       *flash[6:8]), reps)}
    for name, backend in backends[:3:2]:
        bwd[f"sdpa {name} backward (autograd)"] = functools.partial(
            time_grad_ms, sdpa(backend), (q, k, v), do, reps)
    return fwd, bwd


def time_flat(rng, quant=False):
    """The flat kernel (``quant``: its int8 flavor) at the flat engine's
    segment shape: H=12, D=64, Bt=64, bf16, a 64-token segment at base 0
    (slot 0) and one at base 448 (slot 1), 16 chunks; the library call
    is SDPA over each segment's slot gathered (and dequantized) into a
    dense bf16 view (gather not timed)."""
    # 48 layers: the blocks the launches cycle through exceed the L2
    h, d, bt, n_layers, seg = H, E // H, 64, 48, 64
    bases = (0, 448)
    chunks = [(s, base + 8 * i, 8) for s, base in enumerate(bases)
              for i in range(seg // 8)]
    q, pool, tables, cslot, cbase, cn, _ = flat_case(
        rng, chunks, h=h, hk=h, d=d, bt=bt, nblk=1024 // bt,
        n_layers=n_layers, layer=0, dtype=torch.bfloat16)
    # cycle the layer so each launch reads blocks another layer left cold
    if quant:
        kv8, sc = quantize_pool(pool)
        pool = (kv8.float() * sc.transpose(-1, -2)).to(pool.dtype)
        kernel = functools.partial(da.decode_attention_paged_flat_i8, q, kv8,
                                   sc)
        plain = functools.partial(
            da.decode_attention_paged_flat_i8_reference, q, kv8, sc)
    else:
        kernel = functools.partial(da.decode_attention_paged_flat, q, pool)
        plain = functools.partial(da.decode_attention_paged_flat_reference,
                                  q, pool)

    def run_kernel(i=0):
        return kernel(tables, cslot, cbase, cn, i % n_layers)

    def run_plain(i=0):
        return plain(tables, cslot, cbase, cn, i % n_layers)
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
    per_pos = 2 * (d + 4) if quant else 2 * d * elt   # K and V (+ scales)
    nbytes = (n_pos * h * per_pos + 2 * q.numel() * elt
              + tables.numel() * 4 + 3 * cslot.numel() * 4)
    flops = 4 * d * h * sum(base + r + 1 for base in bases
                            for r in range(seg))
    row = timed_row({"bases": list(bases), "segment": seg}, run_kernel,
                    run_plain, run_sdpa, nbytes, flops, 200)
    # the kernel's earlier design, the per-head one, on the same inputs
    with forced(da, "paged_path", lambda dtype, d: "per_head"):
        row["per_head_ms"] = time_ms(run_kernel, 200)
    log(f"  per-head design beside it: {row['per_head_ms']:.5f} ms")
    return [row]


def time_flash(rng):
    """Flash attention forward at the bulk prefill's shapes: [1, sb, 12,
    64] causal bf16 for each power-of-two bucket sb; the library call is
    the fastest SDPA forward (sdpa_timers)."""
    h, d = H, E // H
    rows = []
    for sb in (128, 256, 512, 1024):
        q, k, v = (randn(rng, (1, h, sb, d), torch.bfloat16)
                   for _ in range(3))

        def run_kernel(i=0, q=q, k=k, v=v):
            return fa.flash_attention_fwd(q, k, v, causal=True)

        def run_plain(i=0, q=q, k=k, v=v):
            return fa.flash_attention_reference(q, k, v, True)

        nbytes = 4 * q.numel() * 2 + sb * h * 4     # q, k, v, o; lse
        flops = 4 * d * h * sb * (sb + 1) // 2
        rows.append(timed_row({"sb": sb}, run_kernel, run_plain,
                              sdpa_timers(q, k, v, None, True, 0.0, 100)[0],
                              nbytes, flops, 100))
    return rows


def phase_timing(seed):
    log("== phase 5: kernel timing at the shapes of each path (H=12, "
        "D=64, bf16; then phase 3f's RMSNorm and flash shapes)")
    rng = np.random.default_rng(seed + 2)
    log("  decode_attention_paged at the decode shape (B=8, Bt=64)")
    rows = {"decode_attention_paged": time_paged(rng)}
    log("  decode_attention_paged_flat at the flat segment shape")
    rows["decode_attention_paged_flat"] = time_flat(rng)
    log("  flash_attention_fwd at the bulk prefill buckets")
    rows["flash_attention_fwd"] = time_flash(rng)
    log("  decode_attention_paged_i8 at the decode shape (B=8, Bt=64)")
    rows["decode_attention_paged_i8"] = time_paged(rng, quant=True)
    log("  decode_attention_paged_flat_i8 at the flat segment shape")
    rows["decode_attention_paged_flat_i8"] = time_flat(rng, quant=True)
    log("  fused_dequant_matmul at decode (M=8), the row block (M=128) and "
        "bulk prefill (M=512)")
    rows["fused_dequant_matmul"] = time_dequant_matmul(rng)
    for quant in (False, True):
        for write in (False, True):
            name = ("decode_attention_stacked" + ("_i8" if quant else "")
                    + ("_write" if write else ""))
            log(f"  {name} at the ring's decode shape (B=8, Smax=1024)")
            rows[name] = time_stacked(rng, quant, write)
    log(f"  flash attention forward and backward at the training shape "
        f"[{BATCH}, {H}, {SEQ}, {E // H}] causal, dropout 0 and 0.1")
    rows.update(time_flash_train(rng))
    log(f"  layer_norm_fwd and layer_norm_bwd at [{BATCH * SEQ}, {E}]")
    rows.update(time_layer_norm(rng))
    log(f"  the fused FFN kernels at the training shape M={BATCH * SEQ}, "
        f"K={E}, F={FF}, gelu_tanh")
    rows.update(time_ffn(rng))
    log("  decode_attention_bhsd at fused_multi_transformer's decode shape "
        "(B=8, Smax=1024)")
    rows["decode_attention_bhsd"] = time_bhsd(rng)
    n_llama = LLAMA_BATCH * LLAMA_SEQ
    log(f"  rms_norm_fwd and rms_norm_bwd at phase 3f's [{n_llama}, "
        f"{LLAMA_CONFIG['hidden_size']}]")
    rows.update(time_rms_norm(rng))
    heads = LLAMA_CONFIG["num_heads"]
    log(f"  flash attention forward and backward at phase 3f's shape "
        f"[{LLAMA_BATCH}, {heads}, {LLAMA_SEQ}, "
        f"{LLAMA_CONFIG['hidden_size'] // heads}] causal, dropout 0")
    rows.update(time_flash_train(
        rng, (LLAMA_BATCH, heads, LLAMA_SEQ,
              LLAMA_CONFIG["hidden_size"] // heads), (0.0,), "_llama"))
    log(f"  the ring chunk kernels at phase 3g's chunk [{LLAMA_BATCH}, "
        f"{heads}, {LLAMA_SEQ // 4}, {LLAMA_CONFIG['hidden_size'] // heads}] "
        "(S over n = 4), offsets full and 0")
    rows.update(time_ring(rng))
    return rows


def time_ffn(rng, act="gelu_tanh"):
    """The three fused FFN kernels at GPT-2's training shape (M = 8192, K
    = 768, F = 3072) in bf16 (the tensor-core instantiations; the rows),
    then their fp32 instantiations (fp32 cores; logged, and their ms kept
    as fp32_ms in the bf16 rows). The library time is three calls,
    torch.addmm + F.gelu(tanh) + torch.addmm, for the forward; for dx
    autograd's backward of that composite for x alone, for dw the same
    for (W1, b1, W2), each replayed from a CUDA graph (time_grad_ms).
    Bounds: the products of the TPU kernel's algorithm (2, 3 and 4 of 2 M
    K F operations) at the bf16 tensor rate, not this design's
    recompute; dw's time includes summing its row-split partials."""
    rows = time_ffn_dtype(rng, act, torch.bfloat16)
    log("  the fp32 instantiations (fp32 cores; phase 4's) at the same shape")
    fp32 = time_ffn_dtype(rng, act, torch.float32)
    for name, row in fp32.items():
        rows[name][0]["fp32_ms"] = row[0]["ms"]
    return rows


def time_ffn_dtype(rng, act, dtype):
    """The three fused FFN kernels at GPT-2's training shape in ``dtype``,
    each checked against its plain version, then timed beside it and the
    library calls."""
    m, k, f = BATCH * SEQ, E, FF
    x, g, w1, b1, w2, b2 = ffn_inputs(rng, m, k, f, dtype)
    xg, w1g, b1g, w2g, b2g = (a.detach().requires_grad_()
                              for a in (x, w1, b1, w2, b2))

    def composite(a, w1, b1, w2, b2):
        t = F.gelu(torch.addmm(b1, a, w1), approximate="tanh")
        return torch.addmm(b2, t, w2)
    out = composite(xg, w1g, b1g, w2g, b2g)
    fwd_library = time_ms(lambda i=0: composite(x, w1, b1, w2, b2), 20)
    # each backward kernel's yardstick: autograd's backward of the
    # composite for its own gradients, in CUDA graphs
    library = {
        "fused_ffn_fwd": fwd_library,
        "fused_ffn_bwd_dx": time_grad_ms(
            lambda a: composite(a, w1, b1, w2, b2), (x,), g, 20),
        "fused_ffn_bwd_dw": time_grad_ms(
            lambda w1, b1, w2: composite(x, w1, b1, w2, b2), (w1, b1, w2), g,
            20)}
    # the yardstick before PR 10, for continuity: all five gradients, a
    # host loop
    all_grads = time_loop_ms(lambda i=0: torch.autograd.grad(
        out, (xg, w1g, b1g, w2g, b2g), g, retain_graph=True), 20)
    log(f"  {dtype} library: forward {fwd_library:.4f} ms; backward for x "
        f"{library['fused_ffn_bwd_dx']:.4f}, for (W1, b1, W2) "
        f"{library['fused_ffn_bwd_dw']:.4f} (CUDA graphs); all five "
        f"gradients {all_grads:.4f} (host loop)")
    elt, mkf = x.element_size(), m * k * f
    wide = dtype == torch.float32
    rows = {}
    for name, kernel, plain, nbytes, flops, tname in (
            ("fused_ffn_fwd",
             lambda i=0: ffn.fused_ffn_fwd(x, w1, b1, w2, b2, act),
             lambda i=0: ffn.fused_ffn_fwd_reference(x, w1, b1, w2, b2, act),
             (2 * m * k + 2 * k * f + f + k) * elt, 4 * mkf,
             "ffn_fp32_large" if wide else "ffn_bf16"),
            ("fused_ffn_bwd_dx",
             lambda i=0: ffn.fused_ffn_bwd_dx(x, g, w1, b1, w2, act),
             lambda i=0: ffn.fused_ffn_bwd_dx_reference(x, g, w1, b1, w2,
                                                        act),
             (3 * m * k + 2 * k * f + f) * elt, 6 * mkf,
             "ffn_fp32_large" if wide else "ffn_bf16"),
            ("fused_ffn_bwd_dw",
             lambda i=0: ffn.fused_ffn_bwd_dw(x, g, w1, b1, w2, act),
             lambda i=0: ffn.fused_ffn_bwd_dw_reference(x, g, w1, b1, w2,
                                                        act),
             (2 * m * k + 4 * k * f + f) * elt + f * 4, 8 * mkf,
             "ffn_fp32_large" if wide else "ffn_wgrad_bf16")):
        got, want = kernel(), plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        tol = TOLERANCES[tname]
        db1_tol = "ffn_fp32_large" if wide else "ffn_bf16"
        if not all(torch.allclose(a.float(), b.float(), **TOLERANCES[tn])
                   for a, b, tn in zip(got, want, (tname, tname, db1_tol))):
            raise SystemExit(f"{name} disagrees with its plain version at "
                             f"the training shape: max_abs_err {err:.3e} "
                             f"(atol {tol['atol']})")
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"dtype": str(dtype), "m": m, "k": k, "f": f,
               "max_abs_err": err,
               "ms": time_ms(kernel, 5), "plain_ms": time_loop_ms(plain, 3),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library[name]}
        log(f"  {name} " + json.dumps(row))
        rows[name] = [row]
    return rows


def time_bhsd(rng):
    """decode_attention_bhsd at fused_multi_transformer's decode shape:
    B=8, H=12, D=64, Smax=1024, bf16, every row at cache_lens 1023 with
    Sq=1 (the main shape), then at 512 with Sq=1 and Sq=16, the layer
    cycled over 12 caches (past the L2); the library call is SDPA over the
    same positions with the prefix mask (the cache sliced, not copied)."""
    b, h, d, smax, n_layers = 8, H, E // H, 1024, 12
    kv = randn(rng, (n_layers, 2, b, h, smax, d), torch.bfloat16)
    rows = []
    for ln, sq in ((1023, 1), (512, 1), (512, 16)):
        qt = randn(rng, (b, h, sq, d), torch.bfloat16)
        lens = torch.full((b,), ln, dtype=torch.int32, device="cuda")
        s = ln + sq
        mask = (torch.arange(s, device="cuda")[None, :]
                <= ln + torch.arange(sq, device="cuda")[:, None])

        def run_kernel(i=0, qt=qt, lens=lens):
            c = kv[i % n_layers]
            return da.decode_attention_bhsd(qt, c[0], c[1], lens)

        def run_plain(i=0, qt=qt, lens=lens):
            c = kv[i % n_layers]
            return da.decode_attention_bhsd_reference(qt, c[0], c[1], lens)

        def run_sdpa(i=0, qt=qt, s=s, mask=mask):
            c = kv[i % n_layers]
            return F.scaled_dot_product_attention(
                qt, c[0, :, :, :s], c[1, :, :, :s], attn_mask=mask)
        nbytes = b * h * s * 2 * d * 2 + 2 * b * h * sq * d * 2 + b * 4
        flops = 4 * d * b * h * sum(ln + r + 1 for r in range(sq))
        rows.append(timed_row({"cache_lens": ln, "sq": sq}, run_kernel,
                              run_plain, run_sdpa, nbytes, flops, 200))
    return rows


def time_loop_ms(fn, reps):
    """ms per call over ``reps`` calls between two events, host gaps
    included: for calls of a millisecond or more (the plain versions),
    where the gaps are a small share."""
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


def time_flash_train(rng, shape=(BATCH, H, SEQ, E // H), dropouts=(0.0, 0.1),
                     suffix=""):
    """The flash kernels at a training shape [B, H, S, D] (default GPT-2's
    [8, 12, 1024, 64]), causal, bf16, at each of ``dropouts`` (one seed
    for forward and backward): the dK/dV and dQ kernels, each against the
    plain backward (which computes all three gradients) and the fastest
    library backward (all three gradients; sdpa_timers); the forward
    against the plain forward (o and lse) and the fastest SDPA forward.
    Kernels and library calls are CUDA-graph replays. Bounds: each
    kernel's own bytes and products. The rows go under each kernel's name
    plus ``suffix``, the library call's name under "library"."""
    b, h, s, d = shape
    q, k, v, do = (randn(rng, (b, h, s, d), torch.bfloat16)
                   for _ in range(4))
    pairs = b * h * s * (s + 1) // 2        # attended (row, key) pairs
    tile = b * h * s * d * 2                # one bf16 [B, H, S, D]
    rows = {name + suffix: [] for name in (
        "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
        "flash_attention_fwd_train")}
    tol = TOLERANCES["attention_grad_bf16"]
    for p in dropouts:
        seed = int(rng.integers(1 << 63))
        o, lse = fa.flash_attention_fwd(q, k, v, True, None, p, seed)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, True, None, p, seed)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True,
                                                None, p, seed)
        fwd_timers, bwd_timers = sdpa_timers(q, k, v, do, True, p, 20)
        fwd_library_ms, fwd_library = fastest_ms(fwd_timers)
        library_ms, library = fastest_ms(bwd_timers)
        plain_ms = time_loop_ms(lambda i=0: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, True, None, p, seed), 3)
        for name, run, parts, nbytes, flops in (
                ("flash_attention_bwd_dkv",
                 lambda i=0: fa.flash_attention_bwd_dkv(*args), want[1:],
                 6 * tile + 2 * b * h * s * 4, 8 * d * pairs),
                ("flash_attention_bwd_dq",
                 lambda i=0: (fa.flash_attention_bwd_dq(*args),), want[:1],
                 5 * tile + 2 * b * h * s * 4, 6 * d * pairs)):
            got = run()
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, parts))
            if not all(torch.allclose(g.float(), w.float(), **tol)
                       for g, w in zip(got, parts)):
                raise SystemExit(f"{name} disagrees with its plain version at "
                                 f"the training shape, dropout {p}: "
                                 f"max_abs_err {err:.3e}")
            bound_ms, bound_by = bound(nbytes, flops)
            row = {"dropout": p, "max_abs_err": err, "ms": time_ms(run, 20),
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms,
                   "library": library}
            log(f"  {name} {list(shape)} " + json.dumps(row))
            rows[name + suffix].append(row)
        run_fwd = functools.partial(fa.flash_attention_fwd, q, k, v, True,
                                    None, p, seed)
        fwd_ref = fa.flash_attention_reference(q, k, v, True, None, p, seed)
        fwd_tol = TOLERANCES["attention_bf16"]
        got = run_fwd()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, fwd_ref))
        if not all(torch.allclose(g.float(), w.float(), **fwd_tol)
                   for g, w in zip(got, fwd_ref)):
            raise SystemExit(f"flash_attention_fwd disagrees with its plain "
                             f"version at the training shape {list(shape)}, "
                             f"dropout {p}: max_abs_err (o, lse) {err:.3e}")
        bound_ms, bound_by = bound(4 * tile + b * h * s * 4, 4 * d * pairs)
        row = {"dropout": p, "max_abs_err": err,
               "ms": time_ms(lambda i=0: run_fwd(), 20),
               "plain_ms": time_loop_ms(
                   lambda i=0: fa.flash_attention_reference(
                       q, k, v, True, None, p, seed), 3),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": fwd_library_ms, "library": fwd_library}
        log(f"  flash_attention_fwd {list(shape)} " + json.dumps(row))
        rows["flash_attention_fwd_train" + suffix].append(row)
    return rows


def time_ring(rng, n=4):
    """The ring chunk kernels at phase 3g's chunk shape [B, H, S / n, D]
    (LLaMA-2-7B attention, S = 4096, n = 4) in bf16, at the full offset
    (Sk) and on the diagonal (0), with random cotangents of o and lse. The
    forward, dK/dV and dQ kernels in CUDA graphs against their plain
    versions (forward; the whole backward, a loop of 3 between events) and
    the fastest library call (sdpa_timers: not causal at the full offset,
    causal at 0; the library backward takes no lse cotangent, dlse = 0),
    all CUDA-graph replays. First o, lse and the gradients (from the
    kernel's o and lse, then from the plain forward's) are held to their
    plain versions as phase 2 holds FLASH_MAIN_CASES. Bounds: 4,
    8 and 6 D-deep products per attended (row, key) pair over the bf16
    rate, or each input read and output written once."""
    heads = LLAMA_CONFIG["num_heads"]
    b, c, d = LLAMA_BATCH, LLAMA_SEQ // n, LLAMA_CONFIG["hidden_size"] // heads
    q, k, v, do = (randn(rng, (b, heads, c, d), torch.bfloat16)
                   for _ in range(4))
    dlse = randn(rng, (b, heads, c), torch.float32)
    tile, row_b = b * heads * c * d * 2, b * heads * c * 4
    rows = {name: [] for name in rca.LAUNCHES}
    seen = {}
    for off in (c, 0):
        causal = off == 0
        label = f"ring chunk [{b}, {heads}, {c}, {d}] offset={off}"
        pairs = b * heads * (c * (c + 1) // 2 if causal else c * c)
        fwd_timers, bwd_timers = sdpa_timers(q, k, v, do, causal, 0.0, 20)
        o, lse = rca.ring_chunk_attention_fwd(q, k, v, off)
        o_ref, lse_ref = rca.ring_chunk_attention_reference(q, k, v, off)
        check_scaled(f"{label} o", o, o_ref, "attention_bf16", seen)
        check(f"{label} lse", lse, lse_ref, "attention_lse", seen)
        rows["ring_chunk_attention_fwd"].append(timed_row(
            {"offset": off},
            lambda i=0, off=off: rca.ring_chunk_attention_fwd(q, k, v, off),
            lambda i=0, off=off: rca.ring_chunk_attention_reference(q, k, v,
                                                                    off),
            fwd_timers, 4 * tile + row_b, 4 * d * pairs, 20))
        delta = (do.float() * o.float()).sum(-1) - dlse
        want = rca.ring_chunk_attention_bwd_reference(q, k, v, o, lse, do,
                                                      dlse, off)
        delta_ref = (do.float() * o_ref.float()).sum(-1) - dlse
        from_ref = (rca.ring_chunk_attention_bwd_dq(
            q, k, v, do, lse_ref, delta_ref, off),
            *rca.ring_chunk_attention_bwd_dkv(q, k, v, do, lse_ref,
                                              delta_ref, off))
        for j, want_ref in enumerate(rca.ring_chunk_attention_bwd_reference(
                q, k, v, o_ref, lse_ref, do, dlse, off)):
            check_scaled(f"{label} {('dq', 'dk', 'dv')[j]} from plain o, lse",
                         from_ref[j], want_ref, "attention_grad_bf16", seen)
        del from_ref
        plain_ms = time_loop_ms(
            lambda i=0: rca.ring_chunk_attention_bwd_reference(
                q, k, v, o, lse, do, dlse, off), 3)
        library_ms, library = fastest_ms(bwd_timers)
        args = (q, k, v, do, lse, delta, off)
        for name, run, parts, nbytes, flops in (
                ("ring_chunk_attention_bwd_dkv",
                 lambda i=0: rca.ring_chunk_attention_bwd_dkv(*args),
                 (1, 2), 6 * tile + 2 * row_b, 8 * d * pairs),
                ("ring_chunk_attention_bwd_dq",
                 lambda i=0: (rca.ring_chunk_attention_bwd_dq(*args),),
                 (0,), 5 * tile + 2 * row_b, 6 * d * pairs)):
            got = run()
            for g, j in zip(got, parts):
                gname = ("dq", "dk", "dv")[j]
                check_scaled(f"{label} {gname}", g, want[j],
                             "attention_grad_bf16", seen)
            err = max((g.float() - want[j].float()).abs().max().item()
                      for g, j in zip(got, parts))
            bound_ms, bound_by = bound(nbytes, flops)
            row = {"offset": off, "max_abs_err": err, "ms": time_ms(run, 20),
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms,
                   "library": library}
            log(f"  {name} [{b}, {heads}, {c}, {d}] " + json.dumps(row))
            rows[name].append(row)
    return rows


def time_layer_norm(rng):
    """LayerNorm forward and backward at the training shape [8192, 768],
    bf16, the launches cycled over 8 inputs (200 MB, past the L2); the
    library calls are ATen's LayerNorm forward and backward
    (native_layer_norm, native_layer_norm_backward); the backward also on
    its per-warp design."""
    n, d, copies = BATCH * SEQ, E, 8
    xs = [randn(rng, (n, d), torch.bfloat16) for _ in range(copies)]
    dys = [randn(rng, (n, d), torch.bfloat16) for _ in range(copies)]
    gamma = (1 + 0.1 * randn(rng, (d,), torch.float32)).to(torch.bfloat16)
    beta = (0.1 * randn(rng, (d,), torch.float32)).to(torch.bfloat16)
    stats = [ln.layer_norm_fwd(x, gamma, beta)[1:] for x in xs]
    aten = [torch.ops.aten.native_layer_norm(x, [d], gamma, beta, 1e-5)[1:]
            for x in xs]
    row_bytes, vec = n * d * 2, d * 2
    fwd = timed_row(
        {"n": n, "d": d},
        lambda i=0: ln.layer_norm_fwd(xs[i % copies], gamma, beta),
        lambda i=0: ln.layer_norm_fwd_reference(xs[i % copies], gamma, beta),
        lambda i=0: F.layer_norm(xs[i % copies], (d,), gamma, beta),
        2 * row_bytes + 2 * vec + 2 * n * 4, 8 * n * d, 200,
        tname="layer_norm_bf16")
    bwd = timed_row(
        {"n": n, "d": d},
        lambda i=0: ln.layer_norm_bwd(xs[i % copies], gamma,
                                      *stats[i % copies], dys[i % copies]),
        lambda i=0: ln.layer_norm_bwd_reference(
            xs[i % copies], gamma, *stats[i % copies], dys[i % copies]),
        lambda i=0: torch.ops.aten.native_layer_norm_backward(
            dys[i % copies], xs[i % copies], [d], *aten[i % copies], gamma,
            beta, [True, True, True]),
        3 * row_bytes + 3 * vec + 2 * n * 4, 12 * n * d, 200,
        tname="layer_norm_bf16")
    # the backward's earlier design, the per-warp one, on the same inputs
    with forced(ln, "layer_norm_path", lambda *a: "per_warp"):
        bwd["per_warp_ms"] = time_ms(
            lambda i=0: ln.layer_norm_bwd(xs[i % copies], gamma,
                                          *stats[i % copies],
                                          dys[i % copies]), 200)
    log(f"  per-warp design beside it: backward {bwd['per_warp_ms']:.5f} ms")
    return {"layer_norm_fwd": [fwd], "layer_norm_bwd": [bwd]}


def time_rms_norm(rng):
    """RMSNorm forward and backward at phase 3f's shape [4096, 4096], bf16,
    eps 1e-5, the launches cycled over 8 inputs (537 MB, past the L2); the
    library calls are ATen's fused RMSNorm forward and backward
    (F.rms_norm, _fused_rms_norm_backward), both timed in a CUDA graph as
    the kernels are. Bounds: x (and dy) read and y (dx) written once, the
    weight, rstd and dgamma once."""
    n, d, copies = LLAMA_BATCH * LLAMA_SEQ, LLAMA_CONFIG["hidden_size"], 8
    eps = LLAMA_CONFIG["rms_eps"]
    xs = [randn(rng, (n, d), torch.bfloat16) for _ in range(copies)]
    dys = [randn(rng, (n, d), torch.bfloat16) for _ in range(copies)]
    gamma = (1 + 0.1 * randn(rng, (d,), torch.float32)).to(torch.bfloat16)
    rstds = [ln.rms_norm_fwd(x, gamma, eps)[1] for x in xs]
    aten = [torch.ops.aten._fused_rms_norm(x, [d], gamma, eps)[1] for x in xs]
    tensor_b, vec_b = n * d * 2, d * 2
    fwd = timed_row(
        {"n": n, "d": d},
        lambda i=0: ln.rms_norm_fwd(xs[i % copies], gamma, eps),
        lambda i=0: ln.rms_norm_fwd_reference(xs[i % copies], gamma, eps),
        lambda i=0: F.rms_norm(xs[i % copies], (d,), gamma, eps),
        2 * tensor_b + vec_b + n * 4, 4 * n * d, 200,
        tname="layer_norm_bf16")
    bwd = timed_row(
        {"n": n, "d": d},
        lambda i=0: ln.rms_norm_bwd(xs[i % copies], gamma, rstds[i % copies],
                                    dys[i % copies]),
        lambda i=0: ln.rms_norm_bwd_reference(
            xs[i % copies], gamma, rstds[i % copies], dys[i % copies]),
        lambda i=0: torch.ops.aten._fused_rms_norm_backward(
            dys[i % copies], xs[i % copies], [d], aten[i % copies], gamma,
            [True, True]),
        3 * tensor_b + 2 * vec_b + n * 4, 8 * n * d, 200,
        tname="layer_norm_bf16")
    # the kernels' earlier design, the per-warp one, on the same inputs
    with forced(ln, "rms_norm_path", lambda *a: "per_warp"):
        fwd["per_warp_ms"] = time_ms(
            lambda i=0: ln.rms_norm_fwd(xs[i % copies], gamma, eps), 200)
        bwd["per_warp_ms"] = time_ms(
            lambda i=0: ln.rms_norm_bwd(xs[i % copies], gamma,
                                        rstds[i % copies], dys[i % copies]),
            200)
    log(f"  per-warp design beside them: forward {fwd['per_warp_ms']:.5f} "
        f"ms, backward {bwd['per_warp_ms']:.5f} ms")
    return {"rms_norm_fwd": [fwd], "rms_norm_bwd": [bwd]}


def time_stacked(rng, quant, write):
    """A dense-ring kernel (``quant``: the int8 flavor; ``write``: the
    fused write+attend) at generate's decode shape: B=8, H=12, D=64,
    Smax=1024, bf16, the layer cycled over 12 (the rings exceed the L2),
    every row at cache_lens 1023 with Sq=1 (the main shape), then at 512
    with Sq=16 (Sq=1 for the write kernels, which write row 512 on every
    launch); the reads also at 512 with Sq=1 and at 1008 (the ring's last
    16 positions) with Sq=16. The library call is SDPA over the same
    positions (for the
    write kernels the prefix plus the new token) sliced from the ring
    into a contiguous bf16 view, dequantized for int8 (not timed)."""
    b, h, d, smax, n_layers = 8, H, E // H, 1024, 12
    ring = randn(rng, (n_layers, 2, b, h, smax, d), torch.bfloat16)
    cache = (ring,)
    if quant:
        kv8, sc = _absmax_int8(ring, -1)
        cache = (kv8, sc.transpose(-1, -2).contiguous())
        ring = (kv8.float() * sc).to(torch.bfloat16)
    fn = ("decode_attention_stacked" + ("_i8" if quant else "")
          + ("_write" if write else ""))
    kernel, plain = getattr(da, fn), getattr(da, fn + "_reference")
    rows = []
    shapes = [(1023, 1), (512, 1 if write else 16)]
    if not write:
        shapes += [(512, 1), (1008, 16)]
    for ln, sq in shapes:
        qt = randn(rng, (b, h, sq, d), torch.bfloat16)
        lens = torch.full((b,), ln, dtype=torch.int32, device="cuda")
        head = ()
        if write:     # the new K/V arrive in the dtype the wrapper takes
            head = (randn(rng, (2, b, h, 1, d),
                          torch.float32 if quant else torch.bfloat16),)

        def run_kernel(i=0, qt=qt, lens=lens, head=head):
            out = kernel(qt, *head, *cache, i % n_layers, lens)
            return out[-1] if write else out

        def run_plain(i=0, qt=qt, lens=lens, head=head):
            out = plain(qt, *head, *cache, i % n_layers, lens)
            return out[-1] if write else out
        s = ln + sq
        if write:     # the prefix from the ring, the new token from kv_new
            new = head[0].to(torch.bfloat16)
            if quant:
                nq, ns = _absmax_int8(head[0], -1)
                new = (nq.float() * ns).to(torch.bfloat16)
            kv = torch.cat([ring[:, :, :, :, :ln],
                            new[None].expand(n_layers, -1, -1, -1, -1, -1)],
                           dim=4).contiguous()
        else:
            kv = ring[:, :, :, :, :s].contiguous()
        mask = (torch.arange(s, device="cuda")[None, :]
                <= ln + torch.arange(sq, device="cuda")[:, None])

        def run_sdpa(i=0, qt=qt, kv=kv, mask=mask):
            kk = kv[i % n_layers]
            return F.scaled_dot_product_attention(qt, kk[0], kk[1],
                                                  attn_mask=mask)
        per_pos = 2 * (d + 4) if quant else 2 * d * 2   # K and V (+ scales)
        n_read = ln if write else s                     # positions read
        nbytes = (b * h * n_read * per_pos + 2 * b * h * sq * d * 2
                  + b * 4)
        if write:     # kv_new in, the new row (+ scales) out
            nbytes += head[0].numel() * head[0].element_size() \
                + b * h * per_pos
        flops = 4 * d * b * h * sum(ln + r + 1 for r in range(sq))
        rows.append(timed_row({"cache_lens": ln, "sq": sq}, run_kernel,
                              run_plain, run_sdpa, nbytes, flops, 200))
    return rows


def time_dequant_matmul(rng):
    """The int4 dequant-matmul at each of GPT-2's four (K, O) for M in
    {8, 128, 512}, bf16 activations; the launches cycle over enough
    weight copies (about 100 MB) that each finds its weight cold in the
    50 MB L2, as the engine's 12 layers do. The library call is
    torch.matmul on the weight dequantized to bf16 once, outside the
    timing."""
    rows = []
    for name, (k, o) in MATMULS.items():
        n = min(64, -(-100_000_000 // (k * o // 2)))
        ws = [packed_weight(rng, k, o, transposed=name == "qkv")
              for _ in range(n)]
        wd = [(fdm.unpack_int4(wp).float() * s).to(torch.bfloat16)
              for wp, s in ws]
        for m in (8, 128, 512):
            a = randn(rng, (m, k), torch.bfloat16)

            def run_kernel(i=0, a=a):
                return fdm.fused_dequant_matmul(a, *ws[i % n])

            def run_plain(i=0, a=a):
                return fdm.fused_dequant_matmul_reference(a, *ws[i % n])

            def run_matmul(i=0, a=a):
                return a @ wd[i % n]
            nbytes = m * k * 2 + k * o // 2 + o * 4 + m * o * 2
            rows.append(timed_row({"matmul": name, "m": m}, run_kernel,
                                  run_plain, run_matmul, nbytes,
                                  2 * m * k * o, 200, tname="matmul_bf16"))
    return rows


def time_paged(rng, quant=False):
    """The paged kernel (``quant``: its int8 flavor) at the decode shape
    (B=8, Bt=64, all rows at cache_lens 512 or 1024, Sq 1 or 16); the
    library call is SDPA over the row's prefix gathered (and
    dequantized) into a dense bf16 view (gather not timed)."""
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
            if quant:
                kv8, sc = quantize_pool(pool)
                pool = (kv8.float() * sc.transpose(-1, -2)).to(pool.dtype)
                kernel = functools.partial(da.decode_attention_paged_i8, qt,
                                           kv8, sc)
                plain = functools.partial(
                    da.decode_attention_paged_i8_reference, qt, kv8, sc)
            else:
                kernel = functools.partial(da.decode_attention_paged, qt,
                                           pool)
                plain = functools.partial(
                    da.decode_attention_paged_reference, qt, pool)

            def run_kernel(i=0, kernel=kernel):
                return kernel(tables, i % n_layers, lens)

            def run_plain(i=0, plain=plain):
                return plain(tables, i % n_layers, lens)
            s = ln + sq
            kv = pool[:, :, tables[0, :(s - 1) // bt + 1].long()]
            kv = kv.permute(0, 1, 3, 2, 4, 5).reshape(
                n_layers, 2, h, -1, d)[..., :s, :].unsqueeze(2).expand(
                -1, -1, b, -1, -1, -1).contiguous()
            mask = (torch.arange(s, device="cuda")[None, :]
                    <= ln + torch.arange(sq, device="cuda")[:, None])

            def run_sdpa(i=0, kv=kv, mask=mask):
                kk = kv[i % n_layers]
                return F.scaled_dot_product_attention(
                    qt, kk[0], kk[1], attn_mask=mask)
            elt = 2
            per_pos = 2 * (d + 4) if quant else 2 * d * elt  # K, V (+ sc)
            nbytes = (b * h * s * per_pos              # K and V read once
                      + 2 * b * h * sq * d * elt       # q in, out
                      + tables.numel() * 4 + b * 4)
            flops = 4 * d * b * h * sum(ln + r + 1 for r in range(sq))
            rows.append(timed_row({"cache_lens": ln, "sq": sq}, run_kernel,
                                  run_plain, run_sdpa, nbytes, flops, 200))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-2 only: build and check the kernels")
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line \
                    or "Performance Loss" in line:
                log(f"  [{name}] {line.strip()}")

    rng = np.random.default_rng(args.seed)
    worst = phase_kernels(rng)
    if args.kernels_only:
        log(f"  worst phase-2 errors: {worst}; --kernels-only: phases 3-5 "
            "not run")
        return 0
    launches = phase_engine(args.seed)
    launches.update(phase_cluster(args.seed))
    launches.update(phase_generate(args.seed))
    base = phase_train(args.seed)
    launches["train"] = base[0]
    launches["train-ffn"] = phase_train_ffn(args.seed, base)[0]
    launches["fmt"] = phase_fmt(args.seed)
    launches["train-llama"] = phase_train_llama(args.seed)
    launches["ring"] = phase_ring(args.seed)
    phase_parity(args.seed)
    rows = phase_timing(args.seed)

    log(f"  worst phase-2 errors: {worst}")
    log("== done")
    # per kernel: the phase-3 run of its own path, the phase-5 shape its
    # engine spends most time at, and the worst error over its phase-5
    # shapes (each checked there)
    decode = (lambda r: r["cache_lens"] == 1024 and r["sq"] == 1)
    ring_main = (lambda r: r["cache_lens"] == 1023 and r["sq"] == 1)
    table = (("decode_attention_paged", "row", "decode_attention.py:1027",
              decode),
             ("decode_attention_paged_flat", "flat",
              "decode_attention.py:1276", lambda r: True),
             ("flash_attention_fwd", "phase", "flash_attention.py:222",
              lambda r: r["sb"] == 512),
             ("decode_attention_paged_i8", "row-kv8-w4",
              "decode_attention.py:1115", decode),
             ("decode_attention_paged_flat_i8", "flat-kv8-w4",
              "decode_attention.py:1406", lambda r: True),
             ("fused_dequant_matmul", "row-kv8-w4",
              "fused_dequant_matmul.py:126",
              lambda r: r["matmul"] == "f1" and r["m"] == 8),
             ("decode_attention_stacked", "gen", "decode_attention.py:401",
              ring_main),
             ("decode_attention_stacked_i8", "gen-kv8",
              "decode_attention.py:502", ring_main),
             ("decode_attention_stacked_write", "gen-kw",
              "decode_attention.py:669", ring_main),
             ("decode_attention_stacked_i8_write", "gen-kv8-kw",
              "decode_attention.py:843", ring_main),
             # the training kernels: at dropout 0.1, the training default
             ("flash_attention_bwd_dkv", "train", "flash_attention.py:555",
              lambda r: r["dropout"] == 0.1),
             ("flash_attention_bwd_dq", "train", "flash_attention.py:589",
              lambda r: r["dropout"] == 0.1),
             ("layer_norm_fwd", "train", "layer_norm.py:91", lambda r: True),
             ("layer_norm_bwd", "train", "layer_norm.py:129",
              lambda r: True),
             # this slice's: the fused FFN in phase 3d's training, the
             # one-layer decode in phase 3e's FusedMultiTransformer
             ("fused_ffn_fwd", "train-ffn", "fused_ffn.py:90",
              lambda r: True),
             ("fused_ffn_bwd_dx", "train-ffn", "fused_ffn.py:273",
              lambda r: True),
             ("fused_ffn_bwd_dw", "train-ffn", "fused_ffn.py:289",
              lambda r: True),
             ("decode_attention_bhsd", "fmt", "decode_attention.py:230",
              lambda r: True),
             # this slice's: RMSNorm in phase 3f's LLaMA training
             ("rms_norm_fwd", "train-llama", "layer_norm.py:200",
              lambda r: True),
             ("rms_norm_bwd", "train-llama", "layer_norm.py:230",
              lambda r: True),
             # this slice's: the ring chunk in phase 3g's ring (n = 4,
             # causal), timed at the chunk's full offset
             ("ring_chunk_attention_fwd", "ring",
              "ring_chunk_attention.py:240", lambda r: r["offset"] > 0),
             ("ring_chunk_attention_bwd_dkv", "ring",
              "ring_chunk_attention.py:299", lambda r: r["offset"] > 0),
             ("ring_chunk_attention_bwd_dq", "ring",
              "ring_chunk_attention.py:321", lambda r: r["offset"] > 0))
    kernels = []
    for name, path, where, is_main in table:
        main_row = next(r for r in rows[name] if is_main(r))
        # the kernels with two designs: phase 3 held every launch of
        # their runs to the split one (the dequant-matmul's to the tensor
        # cores, RMSNorm's to the row-block one, the LayerNorm backward's
        # to the row-warp one)
        design = ({"design": "split_kv"} if name in da.PATH_LAUNCHES
                  else {"design": "tensor_core"}
                  if name == "fused_dequant_matmul"
                  else {"design": "row_warp"} if name == "layer_norm_bwd"
                  else {"design": "row_block"} if name in ln.PATH_LAUNCHES
                  else {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/csrc/{_build.SOURCES[name]}",
            "replaces": f"paddle_tpu/ops/pallas/{where}",
            "launches": launches[path][name],
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            **design,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
