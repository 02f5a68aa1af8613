"""Continuous-batching serving engine over the paged KV pool or the dense
KV ring.

Counterpart of ``paddle_tpu/inference/serving.py::ServingEngine``,
decoding greedily or sampled (``do_sample`` with ``top_k``, ``top_p`` and
``temperature``; with ``enable_repetition_penalty`` each request's
``repetition_penalty``), over the paged block pool (the default) or, with
``paged=False``, a dense ring of one Smax-position row per slot, under
one of three schedulers:

- the row-layout token budget (the default): admission is bookkeeping
  (an admitted slot enters ``prefilling``); every step packs the decode
  rows (one input token each) and prefill chunks of up to C tokens into
  one [B, C] budget dispatch, which also runs ``decode_chunk - 1``
  trailing decode steps;
- the flat token budget (``flat_budget=True``): the same packing as one
  ragged [T] stream, a B-wide decode region plus prefill segments aligned
  to ``FLAT_CHUNK`` and uncapped by any column count;
- the phase scheduler (``token_budget=0``): admission prefills each new
  request in one causal flash pass over its whole prompt and samples its
  first token in the same step, then the decode chunk runs.

Each scheduler also serves quantized: ``kv_quant="int8"`` (an int8 pool
with per-position scales) and ``weight_quant="int8"|"int4"``, alone or
together, and ``head_quant="int8"`` (see ``generation``); and with
rotary embeddings (``use_rotary``) and any of ``generation.ACTIVATIONS``.

Sampling is scheduling-invariant, as in JAX: a request's n-th token is
drawn under fold_in(PRNGKey(seed), n), its seed drawn at ``submit`` from
the global key stream (``core.rng.next_key``), so every scheduler gives
the same sampled tokens.

Prefix caching (``prefix_cache_blocks=`` on either layout, or a shared
dense ``prefix_cache=``, which makes the engine dense): each admission
looks its prompt up in a radix store of published full blocks; a hit
adopts the chain (paged: its block ids into the slot's table, zero-copy;
dense: copied into the slot's ring row) and prefill starts after it (the
phase scheduler runs a hit's suffix through the masked-scan prefill,
since the bulk flash pass cannot attend an adopted prefix). A prompt
publishes its full blocks when its prefill completes.

Speculative decoding (``spec_k`` K, 0 or a power of two): per-slot
n-gram drafters (``spec_decode``) propose up to K tokens; the budget
schedulers pack them as claims on the step's budget and score them in
the budget cores' chain mode, the phase scheduler in the K+1-position
verify core when at least ``_spec_min_draft`` drafts a row ride along.
The host accepts (greedy exact match, or rejection sampling under a
``np.random.RandomState`` seeded from the key stream at its first use);
greedy tokens equal spec-off's.

Under either budget, a step with only decode rows runs the plain
``decode_chunk``-step scan instead, which moves more tokens. Host state
(lens, counts, block tables) lives in numpy and crosses to the device
once per dispatch. A dense engine has no pool: no block reservation, no
tables, and ``metrics()`` reports the ``kv_blocks_*`` and ``kv_shard_*``
gauges as None.

The slot lifecycle (paged engines; a dense one raises JAX's
ValueErrors): ``fork_slot`` clones a running request onto the same
blocks, and a write into a shared block copies it first
(``_ensure_writable``, ``kv_cow_copies``); ``preempt_to_host`` parks a
running slot's state, KV bytes included, in host memory and
``resume_from_host`` restores it token-identically; ``export_slot`` /
``import_slot`` (and the streamed ``export_kv_prefix`` /
``stage_kv_blocks``) move a live request between engines in JAX's state
format (``MIGRATION_FMT``), so a state crosses frameworks either way;
``role="prefill"`` holds a prompt-complete slot as ``prefilled`` for
that handoff. Requests carry a QoS class (``priority``: strict-priority
queues, a weighted-fair prefill split, a better class preempting a worse
one at most once a step) and a ``deadline_s`` (queued, running and parked
requests expire). An explicitly sized pool (``kv_pool=``,
``kv_pool_blocks=``) and ``max_pending`` shed with ``AdmissionFull``.
``track`` / ``poll`` / ``harvest_new_tokens`` / ``release`` stream a
request's tokens; ``reset_metrics`` starts a new metric window.

Telemetry (``telemetry.py``, JAX's contracts): each request's lifecycle
span and one step-timeline record a dispatch (its kind from
``generation.dispatch_kind``) in bounded rings of ``telemetry_ring``
entries (default 2048; 0 turns them off, the histograms stay on), every
timestamp on the engine's ``clock``; ``telemetry_snapshot()`` is the
cluster router's payload (schema v8), ``metrics_prometheus()`` the text
exposition, ``telemetry.trace_dump`` / ``export_chrome_tracing`` the
traces.

The engine reads no environment variables: JAX's PADDLE_SERVING_SPEC_K
and PADDLE_SERVING_SPEC_MIN_DRAFT take their defaults (0 and 2), its
PADDLE_ROLE, PADDLE_SERVING_KV_BLOCKS and PADDLE_TPU_SERVE_MAX_PENDING
are the constructor's ``role``, ``kv_pool_blocks`` and ``max_pending``,
PADDLE_QOS_SHARES (``"high=4,normal=2,low=1"``) is the keyword
``qos_shares``, and PADDLE_TELEMETRY_RING and the PADDLE_SLO_* objectives
are ``telemetry_ring`` and ``slo`` (``SloPolicy.from_env()`` reads them
for a caller that wants them).
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque

import numpy as np
import torch

from ..ops.decode_attention import FLAT_CHUNK
from ..core.rng import next_key
from ..parallel.serving_mesh import ShardedTensor
from .generation import (FusedDecoder, _absmax_int8, _host_seed,
                         _penalize_slots, _sample_rows, dispatch_kind)
from .paged_kv import BlockPool, PagedPrefixCache
from .prefix_cache import PrefixCache
from .spec_decode import (NGramDrafter, filtered_probs, greedy_accept,
                          propose_claims, rejection_sample,
                          truncate_emitted, validate_spec_k)
from .telemetry import (COUNTER_FOLD_KEYS, DEFAULT_QOS_SHARES, DEFAULT_RING,
                        QOS_CLASSES, QOS_DEFAULT, QOS_RANK, SloPolicy,
                        Telemetry)

__all__ = ["ServingEngine", "ServedRequest", "AdmissionFull",
           "QOS_CLASSES"]

ROLES = ("prefill", "decode", "mixed")


class AdmissionFull(RuntimeError):
    """A request shed at admission: the pending queue is at max_pending,
    an explicitly sized pool cannot commit its blocks, or no slot can take
    a fork, an import or a resume. The caller backs off or goes
    elsewhere."""


class ServedRequest:
    """One request's lifecycle: queued -> running -> finished | expired,
    with the side states preempted (parked on the host), prefilled (held
    by a prefill-role engine) and migrated (exported)."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "min_length", "repetition_penalty", "state", "slot",
                 "tokens", "t_submit", "t_admit", "t_first", "t_done",
                 "deadline_s", "seed", "trace_id", "attempt", "priority")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id,
                 min_length, repetition_penalty, t_submit,
                 deadline_s=None, seed=0, trace_id=None, attempt=1,
                 priority=QOS_DEFAULT):
        self.rid = rid
        self.prompt = prompt                      # np.int64 [S]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.min_length = int(min_length)
        self.repetition_penalty = float(repetition_penalty)
        self.state = "queued"
        self.slot = None
        self.tokens = []
        self.t_submit = t_submit
        self.t_admit = None
        self.t_first = None
        self.t_done = None
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.seed = int(seed)
        self.trace_id = None if trace_id is None else str(trace_id)
        self.attempt = int(attempt)
        self.priority = priority

    @property
    def ttft_s(self):
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def latency_s(self):
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self):
        return {"rid": self.rid, "tokens": np.asarray(self.tokens, np.int32),
                "ttft_s": self.ttft_s, "latency_s": self.latency_s,
                "expired": self.state == "expired"}


class ServingEngine:
    """Slot-based continuous batching over FusedDecoder's step cores::

        eng = ServingEngine(fmt, embed, head, num_slots=8,
                            max_seq_len=1024)          # device="cuda"
        rid = eng.submit(prompt_ids, max_new_tokens=64, eos_token_id=2)
        eng.run()
        out = eng.results[rid]["tokens"]
        eng.metrics()
    """

    def __init__(self, fmt, embed, head, num_slots, max_seq_len,
                 do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
                 decode_chunk=None, use_rotary=False,
                 enable_repetition_penalty=False, clock=None,
                 max_pending=None, prefill_cap=None,
                 prefix_cache_blocks=0, prefix_cache=None, spec_k=None,
                 paged=None, kv_pool=None, kv_pool_blocks=None,
                 token_budget=None, flat_budget=None,
                 telemetry_ring=None, slo=None, role=None,
                 weight_quant=None, kv_quant=None, *, head_quant=None,
                 qos_shares=None, mesh_weights=True, device=None):
        role = "mixed" if role is None else role
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.paged = paged is None or bool(paged)
        if self.paged and prefix_cache is not None:
            # JAX's rule: a shared dense PrefixCache makes the engine
            # dense, and an explicit paged=True with one is refused
            if paged:
                raise ValueError(
                    "a shared dense PrefixCache cannot back a paged "
                    "engine (its blocks live in separate storage; a "
                    "paged engine's prefix blocks ARE kv pool blocks) "
                    "— pass prefix_cache_blocks= instead, or "
                    "paged=False")
            self.paged = False
        self.dec = FusedDecoder(fmt, embed, head, max_seq_len,
                                use_rotary=use_rotary,
                                weight_quant=weight_quant,
                                kv_quant=kv_quant, head_quant=head_quant,
                                mesh_weights=mesh_weights, device=device)
        self._mesh_rules(paged)
        if weight_quant == "int4" and not self.paged:
            # JAX's refusal: int4 packed weights are a paged-serving memory
            # feature; the dense ring costs B x Smax regardless
            raise ValueError(
                "weight_quant='int4' with a dense KV ring: this engine "
                "resolved to the dense layout (paged=False, a shared dense "
                "prefix cache, or an indivisible head count under a mesh) "
                "— int4 packed weights are a paged-serving memory "
                "feature; use paged=True or drop weight_quant")
        self.device = self.dec.device
        self.num_slots = b = int(num_slots)
        self.smax = self.dec.smax
        # "prefill" holds each prompt-complete slot for export_slot;
        # "decode" and "mixed" serve alike (placement is the router's)
        self.role = role
        self.do_sample = bool(do_sample)
        self.top_k, self.top_p = top_k, top_p
        self.temperature = temperature
        self._rep_on = bool(enable_repetition_penalty)
        self.decode_chunk = int(decode_chunk or 4)
        cap = int(prefill_cap if prefill_cap is not None else 64)
        if cap < 1 or cap & (cap - 1):
            raise ValueError(
                f"prefill_cap must be a power of two >= 1, got {cap}")
        self.prefill_cap = cap
        if not self.paged and (kv_pool is not None
                               or kv_pool_blocks is not None):
            raise ValueError(
                "kv_pool/kv_pool_blocks state a paged-pool memory budget, "
                "but this engine resolved to the DENSE layout (paged=False, "
                "a shared dense prefix cache, or an indivisible head count "
                "under an active mp mesh) — refusing to drop the budget "
                "silently")
        # the pool block size IS prefill_cap; the default pool holds
        # B x Smax/Bt blocks, so every admissible request fits and it
        # never sheds; an explicitly sized pool (or a caller's) is a
        # memory budget that submit() sheds against (the kv gate)
        self.pool = None
        self._kv_gate = False
        if self.paged:
            if kv_pool is not None:
                if kv_pool.block_tokens != cap:
                    raise ValueError(
                        f"BlockPool has block_tokens={kv_pool.block_tokens}"
                        f" but prefill_cap={cap} — the pool block, the "
                        "prefix block, and the prefill chunk ladder are ONE "
                        "knob and must agree")
                if kv_pool.used:
                    raise ValueError(
                        "kv_pool already has allocated blocks — one "
                        "BlockPool serves one engine")
                self.pool = kv_pool
            else:
                nb = int(kv_pool_blocks if kv_pool_blocks is not None
                         else b * (self.smax // cap))
                self.pool = BlockPool(nb, cap, self.smax)
            self._kv_gate = kv_pool is not None or kv_pool_blocks is not None
        self._kv_reserved = 0            # running worst case
        self._kv_committed = 0           # queued + running + parked
        if prefix_cache is not None:
            if not isinstance(prefix_cache, PrefixCache):
                raise ValueError(
                    f"prefix_cache= takes a shareable dense PrefixCache"
                    f", got {type(prefix_cache).__name__} — paged "
                    "engines build their own via prefix_cache_blocks=")
            if prefix_cache.block_tokens != cap:
                raise ValueError(
                    f"shared prefix cache has block_tokens="
                    f"{prefix_cache.block_tokens} but prefill_cap={cap} "
                    "— the block and prefill ladders must align")
            self.prefix_cache = prefix_cache
        elif prefix_cache_blocks:
            self.prefix_cache = (
                PagedPrefixCache(int(prefix_cache_blocks), cap, self.pool)
                if self.paged else PrefixCache(int(prefix_cache_blocks),
                                               cap))
        else:
            self.prefix_cache = None
        self.spec_k = k = validate_spec_k(spec_k if spec_k is not None
                                          else 0)
        self._drafters = ([NGramDrafter(k) for _ in range(b)] if k
                          else None)
        # the phase scheduler runs the verify pass only when at least
        # this many drafts an active row ride along (JAX's default)
        self._spec_min_draft = 2.0
        self._spec_rng = None            # first sampled acceptance draws it
        tb = int(token_budget if token_budget is not None
                 else b * max(4 * self.decode_chunk, k + 1))
        if tb < 0:
            raise ValueError(f"token_budget must be >= 0, got {tb}")
        if tb and tb < b:
            raise ValueError(
                f"token_budget={tb} < num_slots={b}: every active decode "
                "row claims one token per step (token_budget=0 selects "
                "the phase scheduler)")
        self.token_budget = tb
        # a row's whole segment (input token and K drafts) fits C columns
        cw = max(-(-tb // b) if tb else 1, k + 1)
        self._budget_cols = 1 << (cw - 1).bit_length()
        self._flat_budget = bool(flat_budget)
        if self._flat_budget and not tb:
            raise ValueError(
                "flat_budget needs the token-budget scheduler "
                "(token_budget > 0): token_budget=0 selects the phase "
                "scheduler, which has no budget step to flatten")
        self.clock = clock or time.perf_counter
        # request spans and the step timeline in bounded rings (0 turns
        # them off); every timestamp is the engine's clock
        self.telemetry = Telemetry(telemetry_ring, clock=self.clock)
        self._slo = slo if slo is not None else SloPolicy()
        # EWMA of the working steps' duration: the replica-local
        # slowness signal of the snapshot's "health" block
        self._step_ewma_s = 0.0
        self._results_cap = self.telemetry.ring or DEFAULT_RING

        if self.paged:
            self._caches = self.dec.init_paged_cache(self.pool)
            self._tables = np.full((b, self.smax // cap),
                                   self.pool.num_blocks, np.int32)
        else:
            self._caches = self.dec.ring_caches(self.dec.init_cache(b))
            self._tables = None
        self._lens = np.zeros(b, np.int64)
        self._active = np.zeros(b, bool)
        self._nt = np.zeros(b, np.int64)
        self._max_nt = np.ones(b, np.int64)
        self._eos = np.full(b, -1, np.int64)
        self._min_len = np.zeros(b, np.int64)
        self._rep_pen = np.ones(b, np.float32)
        self._rseed = np.zeros(b, np.int64)      # per-request sample seed
        self._presence = None                    # [B, V] bool when rep_on
        self._tok = np.zeros(b, np.int64)
        self._pf_left = np.zeros(b, np.int64)
        self._slot_req = [None] * b
        # one FIFO per QoS class, drained best class first; the parking
        # lot maps a preempted rid to its export_slot-format state
        self._queues = {c: deque() for c in QOS_CLASSES}
        self._parked = {}
        self.qos_shares = self._parse_qos_shares(qos_shares or "")
        self.max_pending = int(max_pending or 0)      # 0: unbounded
        self.results = {}
        # every live request by rid, and the streaming cursors; a
        # finished request stays indexed while a cursor holds it
        self._req_index = {}
        self._harvest = {}
        self._staged = {}                # stage tag -> pool block ids
        self._rid = itertools.count()
        self._prom_base = {}             # windows folded by reset_metrics
        self._reset_window()

    def _mesh_rules(self, paged):
        """JAX's rules under an active mp mesh: the pool shards by head, so
        an explicit paged=True with num_heads % mp raises and the default
        falls back to the dense ring with a RuntimeWarning; weights that
        cannot shard (head / FFN axes indivisible) warn."""
        import warnings
        mesh = self.dec._mesh_mp()
        self._pc_mesh_warned = False
        if mesh is None:
            return
        mp = mesh.shape["mp"]
        nh = self.dec.fmt.num_heads
        if self.paged and nh % mp:
            if paged:
                raise ValueError(
                    f"paged=True under an mp={mp} mesh needs "
                    f"num_heads % mp == 0 to shard the pool by "
                    f"head, got num_heads={nh} — use a divisible "
                    "mesh degree or drop paged= to accept the "
                    "dense fallback")
            warnings.warn(
                f"serving: paged KV pool disabled — num_heads="
                f"{nh} is not divisible by the mesh's mp degree "
                f"{mp}, so the head-sharded pool layout is "
                "unavailable; falling back to the dense ring",
                RuntimeWarning, stacklevel=3)
            self.paged = False
        if self.dec.mesh_weights and self.dec._weight_shard_mesh() is None:
            ff = int(self.dec.fmt.ffn1_weights[0].shape[-1])
            warnings.warn(
                f"serving: weight sharding disabled — num_heads="
                f"{nh} / ffn_dim={ff} must both "
                f"divide the mesh's mp degree {mp} to shard the "
                "qkv/proj/FFN stacks; weights stay replicated per "
                "device (init_serving_mesh(mp, num_heads=, ffn_dim=) "
                "rejects this layout up front)",
                RuntimeWarning, stacklevel=3)

    def _reset_window(self):
        """Zero every window counter (construction and reset_metrics)."""
        self._tokens_emitted = 0
        self._busy_s = 0.0
        self._admitted = 0
        self._forked = 0
        self._finished = 0
        self._rejected = 0
        self._expired = 0
        self._migrated_in = 0
        self._migrated_out = 0
        self._kv_blocks_shipped = 0
        self._kv_blocks_adopted = 0
        self._preempted = 0
        self._resumed = 0
        self._class_admitted = {c: 0 for c in QOS_CLASSES}
        self._class_tokens = {c: 0 for c in QOS_CLASSES}
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefill_tokens_saved = 0
        self._prefill_tokens_computed = 0
        self._draft_proposed = 0
        self._draft_accepted = 0
        self._cow_copies = 0
        self._decode_steps = 0
        self._budget_steps = 0
        self._budget_tokens_used = 0
        self._budget_prefill_tokens = 0
        self._budget_decode_tokens = 0
        self._budget_draft_tokens = 0
        self._budget_padding_tokens = 0
        self._slo_ok = 0
        self._slo_violated_queue = 0
        self._slo_violated_service = 0
        self._slo_vq_class = {c: 0 for c in QOS_CLASSES}

    # ------------------------------------------------------------- public
    def submit(self, prompt, max_new_tokens=20, eos_token_id=None,
               min_length=0, repetition_penalty=1.0, deadline_s=None,
               trace_id=None, attempt=1, priority=QOS_DEFAULT):
        """Queue one request; returns its id. prompt + max_new_tokens
        must fit Smax (a slot's lens then never reaches Smax). JAX's
        parameters: ``repetition_penalty`` needs
        ``enable_repetition_penalty=True`` (ValueError without it, as in
        JAX); ``deadline_s`` expires the request that many seconds after
        submit, wherever it is; ``priority`` is its QoS class;
        ``trace_id`` and ``attempt`` are kept on the request. Sheds with
        AdmissionFull at ``max_pending`` queued requests, or when an
        explicitly sized pool cannot commit the request's worst-case
        blocks. A sampling engine draws the request's seed here."""
        ids = np.asarray(prompt, np.int64).reshape(-1)
        if ids.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if ids.size + int(max_new_tokens) > self.smax:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the capacity Smax={self.smax}")
        vocab = self.dec.embed.num_embeddings
        if ids.min() < 0 or ids.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if repetition_penalty != 1.0 and not self._rep_on:
            raise ValueError(
                "repetition_penalty needs enable_repetition_penalty=True "
                "at engine construction")
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        if priority not in QOS_CLASSES:
            raise ValueError(
                f"priority must be one of {QOS_CLASSES}, got {priority!r}")
        if self.max_pending and self._queue_len() >= self.max_pending:
            self._rejected += 1
            if self.telemetry.enabled:
                self.telemetry.req_rejected(self.clock(), trace_id=trace_id,
                                            attempt=attempt)
            raise AdmissionFull(
                f"pending queue full ({self._queue_len()}/"
                f"{self.max_pending}) — request shed at admission")
        if self.paged:
            need = self._blocks_needed(ids.size, max_new_tokens)
            if need > self.pool.num_blocks:
                raise ValueError(
                    f"request needs {need} kv blocks but the pool holds "
                    f"{self.pool.num_blocks} total — it can never be "
                    "admitted (grow kv_pool_blocks or shrink the request)")
            if self._kv_gate and \
                    self._kv_committed + need > self.pool.num_blocks:
                self._rejected += 1
                if self.telemetry.enabled:
                    self.telemetry.req_rejected(self.clock(),
                                                trace_id=trace_id,
                                                attempt=attempt)
                raise AdmissionFull(
                    f"kv pool exhausted ({self._kv_committed}/"
                    f"{self.pool.num_blocks} blocks committed to "
                    f"queued+running requests; this one needs {need}) — "
                    "request shed at admission")
            self._kv_committed += need
        req = ServedRequest(next(self._rid), ids, max_new_tokens,
                            eos_token_id, min_length, repetition_penalty,
                            self.clock(), deadline_s=deadline_s,
                            seed=self._fresh_seed(), trace_id=trace_id,
                            attempt=attempt, priority=priority)
        self._queues[priority].append(req)
        self._req_index[req.rid] = req
        self.telemetry.req_queued(req.rid, req.t_submit,
                                  trace_id=req.trace_id, attempt=req.attempt)
        return req.rid

    def _fresh_seed(self):
        """One per-request sampling seed off the global key stream (a
        greedy engine draws none, so submit order cannot move other
        consumers of the stream)."""
        return _host_seed(next_key()) if self.do_sample else 0

    # ------------------------------------------------- per-class queues
    @staticmethod
    def _parse_qos_shares(spec):
        """Parse ``high=4,normal=2,low=1`` into a share dict; unknown
        classes reject loudly, missing ones keep the default weight."""
        shares = dict(DEFAULT_QOS_SHARES)
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            cls, _, w = part.partition("=")
            if cls not in QOS_CLASSES:
                raise ValueError(
                    f"PADDLE_QOS_SHARES: unknown class {cls!r} "
                    f"(classes: {QOS_CLASSES})")
            w = int(w)
            if w < 1:
                raise ValueError(
                    f"PADDLE_QOS_SHARES: share for {cls!r} must be "
                    f">= 1, got {w}")
            shares[cls] = w
        return shares

    def _queue_len(self):
        return sum(len(q) for q in self._queues.values())

    def _queue_head(self):
        for c in QOS_CLASSES:
            if self._queues[c]:
                return self._queues[c][0]
        return None

    def _queue_popleft(self):
        for c in QOS_CLASSES:
            if self._queues[c]:
                return self._queues[c].popleft()
        raise IndexError("pop from empty queue")

    def queue_depths(self):
        """Pending requests per QoS class."""
        return {c: len(self._queues[c]) for c in QOS_CLASSES}

    @property
    def has_work(self):
        return (bool(self._queue_len()) or bool(self._active.any())
                or bool((self._pf_left > 0).any()) or bool(self._parked))

    @property
    def queue_depth(self):
        return self._queue_len()

    @property
    def occupancy(self):
        return float((self._active | (self._pf_left > 0)).mean())

    @torch.no_grad()
    def step(self):
        """One scheduler iteration. Token budget: admit into free slots as
        bookkeeping, then one budget (or plain decode) dispatch. Phase
        mode (token_budget=0): admission prefills and samples each new
        request's first token, then one decode chunk runs if any slot
        decodes. Returns tokens emitted."""
        t0 = self.clock()
        had_work = self.has_work
        self._expire_deadlines(t0)
        # resume parked requests, or preempt for a better class, before
        # admission sees the slots
        self._qos_schedule()
        if self.token_budget:
            self._admit_chunked()
            emitted = self._budget_step()
        else:
            emitted = len(self._admit())
            # a prefill engine holds its admissions before any decode
            if self.role == "prefill":
                self._hold_prefilled()
            if self._active.any():
                emitted += (self._spec_decode_step() if self.spec_k
                            else self._decode_one_chunk())
        if self.role == "prefill":
            self._hold_prefilled()
        # a deadline that lapsed during the dispatch expires now
        self._expire_deadlines(self.clock())
        dt = self.clock() - t0
        self._busy_s += dt
        self._tokens_emitted += emitted
        if had_work:
            # working steps only: idle ones would dilute the signal
            self._step_ewma_s = (dt if self._step_ewma_s == 0.0
                                 else 0.8 * self._step_ewma_s + 0.2 * dt)
            self.telemetry.observe_step_tokens(emitted)
        return emitted

    def run(self):
        """Drive until the queue and all slots drain."""
        while self.has_work:
            self.step()
        return self.results

    def _hold_prefilled(self):
        """Role "prefill": every slot whose prompt completed (first token
        sampled) is held as ``prefilled``, inactive with its blocks
        resident, until export_slot ships it; it leaves has_work."""
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if (req is not None and req.state == "running"
                    and self._active[s] and not self._pf_left[s]
                    and self._nt[s] >= 1):
                req.state = "prefilled"
                self._active[s] = False
                if self.telemetry.enabled:
                    self.telemetry.req_event(req.rid, "prefill_hold",
                                             self.clock())

    # ------------------------------------------------- streaming harvest
    def _lookup_req(self, rid):
        """(tokens, done, state) for a rid, or None if unknown: a live or
        tracked request reads its record, a finished untracked one the
        bounded results."""
        req = self._req_index.get(rid)
        if req is not None:
            return (req.tokens, req.state in ("finished", "expired"),
                    req.state)
        r = self.results.get(rid)
        if r is not None:
            return (r["tokens"], True,
                    "expired" if r["expired"] else "finished")
        return None

    def track(self, rid):
        """Register an incremental-harvest cursor for ``rid``: its record
        outlives the results cap until the reader drains it. Call before
        the request can finish."""
        if rid in self._harvest:
            return
        if self._lookup_req(rid) is None:
            raise KeyError(
                f"request {rid} is unknown (never submitted, or it "
                "finished and was evicted from the bounded results cap "
                "before track() — register the cursor at submit time)")
        self._harvest[rid] = 0

    def poll(self, rid):
        """Non-destructive status: ``{"rid", "state", "n_tokens",
        "ttft_s", "latency_s"}``, or None for an unknown rid."""
        req = self._req_index.get(rid)
        if req is not None:
            return {"rid": rid, "state": req.state,
                    "n_tokens": len(req.tokens), "ttft_s": req.ttft_s,
                    "latency_s": req.latency_s}
        r = self.results.get(rid)
        if r is None:
            return None
        return {"rid": rid,
                "state": "expired" if r["expired"] else "finished",
                "n_tokens": int(np.asarray(r["tokens"]).size),
                "ttft_s": r["ttft_s"], "latency_s": r["latency_s"]}

    def harvest_new_tokens(self, rid):
        """``(new_tokens, done, state)``: the tokens since the previous
        call (the first registers a cursor at 0). When done, the cursor
        and the retained record go."""
        if rid not in self._harvest:
            self.track(rid)
        got = self._lookup_req(rid)
        if got is None:
            self._harvest.pop(rid, None)
            raise KeyError(
                f"request {rid} was evicted from the results cap before "
                "its first harvest — track() at submit time to pin it")
        tokens, done, state = got
        cur = self._harvest[rid]
        new = [int(t) for t in tokens[cur:]]
        if done:
            self.release(rid)
        else:
            self._harvest[rid] = cur + len(new)
        return new, done, state

    def release(self, rid):
        """Drop a streaming cursor (and the retained record of a finished
        request). Idempotent."""
        self._harvest.pop(rid, None)
        req = self._req_index.get(rid)
        if req is not None and req.state in ("finished", "expired"):
            self._req_index.pop(rid, None)

    def _window_counters(self):
        """The window counters, keyed as metrics() keys them: what
        reset_metrics folds into the exposition's lifetime base."""
        c = {"tokens_emitted": self._tokens_emitted,
             "busy_s": self._busy_s,
             "requests_finished": self._finished,
             "requests_admitted": self._admitted,
             "requests_forked": self._forked,
             "requests_rejected": self._rejected,
             "requests_expired": self._expired,
             "requests_migrated_in": self._migrated_in,
             "requests_migrated_out": self._migrated_out,
             "kv_blocks_shipped": self._kv_blocks_shipped,
             "kv_blocks_adopted": self._kv_blocks_adopted,
             "requests_preempted": self._preempted,
             "requests_resumed": self._resumed}
        for cls in QOS_CLASSES:
            c[f"requests_admitted_{cls}"] = self._class_admitted[cls]
            c[f"tokens_emitted_{cls}"] = self._class_tokens[cls]
        c.update(
            prefix_hits=self._prefix_hits,
            prefix_misses=self._prefix_misses,
            prefill_tokens_saved=self._prefill_tokens_saved,
            prefill_tokens_computed=self._prefill_tokens_computed,
            decode_steps=self._decode_steps,
            draft_proposed=self._draft_proposed,
            draft_accepted=self._draft_accepted,
            kv_cow_copies=self._cow_copies,
            budget_steps=self._budget_steps,
            budget_tokens_used=self._budget_tokens_used,
            budget_prefill_tokens=self._budget_prefill_tokens,
            budget_decode_tokens=self._budget_decode_tokens,
            budget_draft_tokens=self._budget_draft_tokens,
            budget_padding_tokens=self._budget_padding_tokens,
            slo_ok=self._slo_ok,
            slo_violated_queue=self._slo_violated_queue,
            slo_violated_service=self._slo_violated_service)
        return c

    def reset_metrics(self, keep_results=True):
        """Zero the window counters (a benchmark's warmup ends here),
        folding them into the exposition's lifetime base first, and
        start a fresh telemetry window. The fold covers exactly
        ``telemetry.COUNTER_FOLD_KEYS``."""
        window = self._window_counters()
        assert set(window) == set(COUNTER_FOLD_KEYS), (
            "window-counter surface drifted from telemetry."
            f"COUNTER_FOLD_KEYS: {set(window) ^ set(COUNTER_FOLD_KEYS)}")
        for k, v in window.items():
            self._prom_base[k] = self._prom_base.get(k, 0) + v
        self.telemetry.reset()
        self._reset_window()
        if not keep_results:
            self.results = {}

    def metrics(self):
        tele = self.telemetry
        # a dense ring has no pool: its block and shard gauges are None
        pool, paged = self.pool, self.paged
        w_dev, w_repl = self._weight_bytes()
        used, pad = self._budget_tokens_used, self._budget_padding_tokens
        looked = self._prefix_hits + self._prefix_misses
        prop, acc = self._draft_proposed, self._draft_accepted
        m = {
            "tokens_emitted": self._tokens_emitted,
            "busy_s": round(self._busy_s, 4),
            "tokens_per_sec": (
                round(self._tokens_emitted / self._busy_s, 2)
                if self._busy_s > 0
                else (0.0 if self._tokens_emitted else None)),
            "requests_finished": self._finished,
            "requests_admitted": self._admitted,
            "requests_forked": self._forked,
            "requests_rejected": self._rejected,
            "requests_expired": self._expired,
            "requests_migrated_in": self._migrated_in,
            "requests_migrated_out": self._migrated_out,
            "role": self.role,
            "kv_blocks_shipped": self._kv_blocks_shipped,
            "kv_blocks_adopted": self._kv_blocks_adopted,
            "requests_preempted": self._preempted,
            "requests_resumed": self._resumed,
            "requests_parked": len(self._parked),
            **{f"requests_admitted_{c}": self._class_admitted[c]
               for c in QOS_CLASSES},
            **{f"tokens_emitted_{c}": self._class_tokens[c]
               for c in QOS_CLASSES},
            "queue_depth": self.queue_depth,
            "occupancy": self.occupancy,
            "traces": 0,
            "ttft_p50_s": tele.hist_ttft.percentile(50),
            "ttft_p90_s": tele.hist_ttft.percentile(90),
            "ttft_p99_s": tele.hist_ttft.percentile(99),
            "latency_p50_s": tele.hist_latency.percentile(50),
            "latency_p99_s": tele.hist_latency.percentile(99),
            # hits + misses == admitted; saved + computed == the prompt
            # tokens admitted (with a prefix cache)
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_hit_rate": (round(self._prefix_hits / looked, 4)
                                if looked else None),
            "prefill_tokens_saved": self._prefill_tokens_saved,
            "prefill_tokens_computed": self._prefill_tokens_computed,
            # one per-row sample event per admit / decode / verify row
            # step: tokens_emitted == decode_steps + draft_accepted
            "decode_steps": self._decode_steps,
            "draft_proposed": prop, "draft_accepted": acc,
            "acceptance_rate": round(acc / prop, 4) if prop else None,
            "tokens_per_step": (
                round(self._tokens_emitted / self._decode_steps, 4)
                if self._decode_steps else None),
            "kv_blocks_total": pool.num_blocks if paged else None,
            "kv_blocks_used": pool.used if paged else None,
            "kv_blocks_free": pool.free_count if paged else None,
            "kv_cow_copies": self._cow_copies,
            # the pool's shards: count x per-shard bytes == the pool
            "kv_shard_count": self._kv_shard_count(),
            "kv_shard_heads": self._kv_shard_heads(),
            "kv_shard_pool_bytes": self._kv_shard_pool_bytes(),
            # (per_device - replicated) x count + replicated == the
            # dense bytes of the arrays the dispatches read
            "weight_shard_count": self._weight_shard_count(),
            "weight_bytes_per_device": w_dev,
            "weight_bytes_replicated": w_repl,
            "budget_steps": self._budget_steps,
            "budget_tokens_used": used,
            "budget_prefill_tokens": self._budget_prefill_tokens,
            "budget_decode_tokens": self._budget_decode_tokens,
            "budget_draft_tokens": self._budget_draft_tokens,
            "budget_padding_tokens": pad,
            "budget_utilization": (round(used / (used + pad), 4)
                                   if self._budget_steps and used else None),
            "slo_ok": self._slo_ok,
            "slo_violated_queue": self._slo_violated_queue,
            "slo_violated_service": self._slo_violated_service,
            "queue_p50_s": tele.hist_queue.percentile(50),
            "queue_p99_s": tele.hist_queue.percentile(99),
            "service_p50_s": tele.hist_service.percentile(50),
            "service_p99_s": tele.hist_service.percentile(99),
        }
        if self.prefix_cache is not None:
            m["prefix_store"] = self.prefix_cache.store.stats()
        return m

    def metrics_prometheus(self):
        """Prometheus text exposition: every metrics() key under its
        stable name (``telemetry.PROMETHEUS_NAMES``), counters monotonic
        across reset_metrics, the request and handoff histograms, the
        pool and prefix gauges and the runtime section."""
        from .telemetry import render_prometheus
        return render_prometheus(self)

    def telemetry_snapshot(self):
        """The JSON routing payload a cluster router reads per replica
        (``telemetry.snapshot``, schema v8)."""
        from .telemetry import snapshot
        return snapshot(self)

    def _run_dispatch(self, key, fn, args, rows=0, **fields):
        """Every dispatch goes through here: ``fn(*args)`` and, with the
        telemetry ring on, one step-timeline event — its kind from
        ``generation.dispatch_kind(key)``, the dispatch-side elapsed, the
        queue depth and pool blocks in use, and ``fields``, as in JAX.
        ``traces_delta`` stays 0: the port compiles nothing. Returns
        (out, event); the harvest closes the event with
        ``Telemetry.finish_step``."""
        tele = self.telemetry
        if not tele.enabled:
            return fn(*args), None
        t0 = self.clock()
        out = fn(*args)
        t1 = self.clock()
        ev = tele.step_event(
            dispatch_kind(key), t0, t1 - t0, rows=rows,
            queue_depth=self.queue_depth,
            kv_blocks_used=(self.pool.used if self.paged else None),
            **fields)
        return out, ev

    def _kv_shard_count(self):
        """The pool's shards: the mesh's mp degree, 1 for an unsharded
        paged engine, None in dense mode (no pool)."""
        if not self.paged:
            return None
        mesh = self.dec._mesh_mp()
        return mesh.shape["mp"] if mesh is not None else 1

    def _kv_shard_heads(self):
        n = self._kv_shard_count()
        return None if n is None else self.dec.fmt.num_heads // n

    def _kv_shard_pool_bytes(self):
        """A shard's pool bytes (K/V and int8 scales): the pool / count."""
        n = self._kv_shard_count()
        if n is None:
            return None
        return sum(int(a.nbytes) for a in self._caches.values()) // n

    def _weight_arrays(self):
        """The arrays every dispatch reads: the stacked layer weights,
        the embedding and the LM head's (``FusedDecoder._head_arrays``:
        quantized or vocab-sharded as the head step reads them)."""
        dec = self.dec
        return (list(dec._stacked().values())
                + [p.detach() for p in dec.embed.parameters()]
                + list(dec._head_arrays()))

    def _weight_shard_count(self):
        """The weight-shard degree: the mesh's mp when the stacks shard,
        else 1."""
        mesh = self.dec._weight_shard_mesh()
        return mesh.shape["mp"] if mesh is not None else 1

    def _weight_bytes(self):
        """(per_device, replicated) weight bytes: per_device sums each
        array's local shard (the whole array when replicated), replicated
        only the arrays whose shard is the whole array, so (per_device -
        replicated) x ``_weight_shard_count()`` + replicated is the dense
        total."""
        per_dev = repl = 0
        for a in self._weight_arrays():
            shape = tuple(a.shape)
            shard = (a.shard_shape() if isinstance(a, ShardedTensor)
                     else shape)
            b = math.prod(shard) * a.element_size()
            per_dev += b
            if shard == shape:
                repl += b
        return per_dev, repl

    # ------------------------------------------------------- paged plumbing
    def _cache_arg(self):
        # the ring as it is, or the pool plus this dispatch's block tables
        # (host data)
        if not self.paged:
            return self._caches
        return dict(self._caches, tbl=torch.from_numpy(self._tables).to(
            self.device))

    def _reserve(self, req):
        """Reserve the queue head's worst-case pool blocks; False (and no
        reservation) when the pool cannot cover them, or when there is
        no head. A ring reserves nothing: every slot owns Smax
        positions."""
        if req is None:
            return False
        if not self.paged:
            return True
        need = self._blocks_needed(req.prompt.size, req.max_new_tokens)
        if self._kv_reserved + need > self.pool.num_blocks:
            return False
        self._kv_reserved += need
        return True

    def _blocks_needed(self, plen, max_new):
        return -(-(int(plen) + int(max_new)) // self.prefill_cap)

    def _alloc_kv_blocks(self, n):
        got = self.pool.alloc(n)
        store = getattr(self.prefix_cache, "store", None)
        if got is None and hasattr(store, "reclaim"):
            # prefix blocks are cache: evict cold ones under pressure
            store.reclaim(n - self.pool.free_count)
            got = self.pool.alloc(n)
        if got is None:
            raise RuntimeError(
                f"kv block pool over-committed: need {n} blocks, "
                f"{self.pool.free_count} free after reclaim — the "
                "admission-time reservation should make this unreachable")
        return got

    def _budget_pos(self, slot):
        # one past the slot's last possible write position
        return (int(self._lens[slot]) - int(self._nt[slot])
                + int(self._max_nt[slot]))

    def _ensure_writable(self, slot, lo, hi):
        """Before a dispatch writes positions [lo, hi) of the slot (a ring
        has nothing to do): an unmapped block maps, and a SHARED block
        (refcount > 1: a fork twin's, or a prefix block the store or
        another slot holds) is copied into a fresh one first, so a write
        never lands in another's view. Adopted and published blocks lie
        below every write, so only forks copy."""
        hi = min(int(hi), self.smax)
        if hi <= lo or not self.paged:
            return
        row = self._tables[slot]
        nb = self.pool.num_blocks
        bt = self.prefill_cap
        for j in range(int(lo) // bt, (hi - 1) // bt + 1):
            blk = int(row[j])
            if blk == nb:
                row[j] = self._alloc_kv_blocks(1)[0]
            elif int(self.pool.refcounts[blk]) > 1:
                new = self._alloc_kv_blocks(1)[0]
                self.pool.copy_block(self._caches, blk, new)
                row[j] = new
                self.pool.deref([blk])
                self._cow_copies += 1

    def _map_blocks(self, slot, hi):
        """Map pool blocks so the slot's table covers positions [0, hi)."""
        if not self.paged:
            return
        row = self._tables[slot]
        nb = self.pool.num_blocks
        need = [j for j in range(-(-int(hi) // self.prefill_cap))
                if row[j] == nb]
        if need:
            row[need] = self._alloc_kv_blocks(len(need))

    def _free_slot_blocks(self, slot):
        if not self.paged:
            return
        row = self._tables[slot]
        nb = self.pool.num_blocks
        mapped = [int(x) for x in row[row < nb]]
        if mapped:
            self.pool.deref(mapped)
        row[:] = nb

    def _shed(self, msg, t=None, trace_id=None, attempt=1):
        # every rejection shows in requests_rejected and, with the ring
        # on, as a one-event span at ``t`` (now when None)
        self._rejected += 1
        if self.telemetry.enabled:
            self.telemetry.req_rejected(self.clock() if t is None else t,
                                        trace_id=trace_id, attempt=attempt)
        return AdmissionFull(msg)

    def _need_paged(self, what, why=""):
        if not self.paged:
            raise ValueError(f"{what} needs the paged KV cache{why}")

    # ------------------------------------------------------ slot lifecycle
    def fork_slot(self, rid, max_new_tokens=None):
        """Copy-on-write fork of a running request: its decode state into
        a free slot over the same blocks (a reference on each, no data
        moved); the first write into a still-shared block copies that
        block. The child inherits the tokens so far and the budget
        (``max_new_tokens`` overrides the total) and samples from its own
        seed. Returns the child's rid."""
        self._need_paged("fork_slot", " (paged=False disables it)")
        src = None
        for r in self._slot_req:
            if r is not None and r.rid == rid:
                src = r
        if src is None or src.state != "running":
            raise ValueError(f"request {rid} is not running in a slot")
        free = self._free_slots()
        if not free:
            raise self._shed("no free slot to fork into")
        s0, s1 = src.slot, free[0]
        mnt = int(max_new_tokens if max_new_tokens is not None
                  else src.max_new_tokens)
        if src.prompt.size + mnt > self.smax:
            raise ValueError("fork budget exceeds the ring capacity")
        need = self._blocks_needed(src.prompt.size, mnt)
        if self._kv_reserved + need > self.pool.num_blocks:
            raise self._shed(
                f"kv pool exhausted: fork needs {need} blocks, "
                f"{self.pool.num_blocks - self._kv_reserved} unreserved")
        child = ServedRequest(next(self._rid), src.prompt, mnt,
                              src.eos_token_id, src.min_length,
                              src.repetition_penalty, self.clock(),
                              seed=self._fresh_seed(),
                              trace_id=src.trace_id, attempt=src.attempt,
                              priority=src.priority)
        child.state = "running"
        child.slot = s1
        child.t_admit = child.t_submit    # a clone never queues
        child.tokens = list(src.tokens)
        child.t_first = src.t_first
        self._slot_req[s1] = child
        self._req_index[child.rid] = child
        self._kv_reserved += need
        self._kv_committed += need
        # a clone, not an admission: no prefix lookup
        self._forked += 1
        if self.telemetry.enabled:
            self.telemetry.req_queued(child.rid, child.t_submit,
                                      trace_id=child.trace_id,
                                      attempt=child.attempt)
            self.telemetry.req_admitted(child.rid, s1, child.t_submit)
            self.telemetry.req_event(child.rid, "forked", child.t_submit)
        row = self._tables[s0]
        self.pool.ref([int(x) for x in row[row < self.pool.num_blocks]])
        self._tables[s1] = row
        for vec in (self._lens, self._nt, self._eos, self._min_len,
                    self._rep_pen, self._tok, self._pf_left):
            vec[s1] = vec[s0]
        self._max_nt[s1] = mnt
        self._rseed[s1] = child.seed
        self._active[s1] = self._active[s0] and self._nt[s1] < mnt
        if self._drafters is not None:
            self._drafters[s1].reset(src.prompt)
            self._drafters[s1].update(child.tokens)
        if self._rep_on:
            p = self._presence_init()
            p[s1] = p[s0]
        if not self._active[s1] and not self._pf_left[s1]:
            self._finish(child, self.clock())
        return child.rid

    # A live request's whole decode state — its committed KV blocks as
    # host bytes, lens / nt / next input / prefill cursor, its sampling
    # seed and its contract — as a dict that another engine (this port's
    # or the JAX package's) resumes mid-stream. Drafters and the presence
    # row are rebuilt from the tokens. Greedy and plain sampled streams
    # continue token-identically (every draw is fold_in(seed, nt)).
    MIGRATION_FMT = "paddle-slot-v1"

    def _slot_state(self, req):
        """The migration state of ``req`` with no KV yet: a queued
        request's (nothing written), or its slot's."""
        state = {
            "fmt": self.MIGRATION_FMT,
            "prompt": np.asarray(req.prompt, np.int32),
            "tokens": [int(t) for t in req.tokens],
            "max_new_tokens": req.max_new_tokens,
            "eos_token_id": req.eos_token_id,
            "min_length": req.min_length,
            "repetition_penalty": req.repetition_penalty,
            "deadline_s": req.deadline_s,
            "seed": req.seed,
            "trace_id": req.trace_id,
            "attempt": req.attempt,
            "priority": req.priority,
            "prefill_cap": self.prefill_cap,
            "lens": 0, "nt": 0, "tok": 0, "active": False,
            "pf_left": int(req.prompt.size),
            "kv_skip": 0,
            "kv": [],
        }
        s = req.slot
        if s is not None:
            state.update(lens=int(self._lens[s]), nt=int(self._nt[s]),
                         tok=int(self._tok[s]),
                         active=bool(self._active[s]),
                         pf_left=int(self._pf_left[s]))
        return state

    def _release_slot(self, req):
        """Free ``req``'s slot, blocks and running reservation."""
        s = req.slot
        self._kv_reserved -= self._blocks_needed(req.prompt.size,
                                                 req.max_new_tokens)
        self._slot_req[s] = None
        self._active[s] = False
        self._pf_left[s] = 0
        self._free_slot_blocks(s)

    def export_slot(self, rid, skip_blocks=0):
        """Detach request ``rid`` (queued, running, or held
        ``prefilled``) into a migration state dict and free everything it
        held here; it leaves as ``migrated``, with no finish verdict.
        ``skip_blocks`` leaves out the first N blocks, already staged on
        the importer by export_kv_prefix -> stage_kv_blocks. A held
        prefilled slot exports active: its importer decodes it."""
        self._need_paged("export_slot", " (the migration payload is pool "
                         "blocks; paged=False disables it)")
        req = self._req_index.get(rid)
        if req is None or req.state not in ("queued", "running",
                                            "prefilled"):
            raise ValueError(f"request {rid} is not live on this engine")
        now = self.clock()
        skip_blocks = int(skip_blocks)
        state = self._slot_state(req)
        need = self._blocks_needed(req.prompt.size, req.max_new_tokens)
        if req.state == "queued":
            self._queues[req.priority].remove(req)
        else:
            if req.state == "prefilled":
                # held only to park it; later dispatches overwrite an
                # inactive row's token, the request's history keeps it
                state["active"] = True
                if req.tokens:
                    state["tok"] = int(req.tokens[-1])
            total = -(-state["lens"] // self.prefill_cap)
            if not 0 <= skip_blocks <= total:
                raise ValueError(
                    f"skip_blocks={skip_blocks} outside the request's "
                    f"committed block count [0, {total}]")
            state["kv_skip"] = skip_blocks
            row = self._tables[req.slot]
            state["kv"] = self.pool.read_blocks(
                self._caches, [int(row[j]) for j in range(skip_blocks,
                                                          total)])
            self._release_slot(req)
        self._kv_committed -= need
        req.state = "migrated"
        self._req_index.pop(rid, None)
        self._harvest.pop(rid, None)
        self._migrated_out += 1
        if state["kv"]:
            self._kv_blocks_shipped += len(state["kv"])
            self.telemetry.observe_handoff(_kv_payload_bytes(state["kv"]))
        if self.telemetry.enabled:
            self.telemetry.req_event(rid, "migrate_out", now)
        self.telemetry.req_done(rid, "migrated", now)
        return state

    def _check_blocks(self, blocks, what):
        """A payload's blocks against this pool's layout and flavor."""
        kv_shape = self._caches["kv"].shape      # [L, 2, NB, H, Bt, D]
        want = (kv_shape[0], 2, 1, kv_shape[3], kv_shape[4], kv_shape[5])
        for blk in blocks:
            if tuple(blk["kv"].shape) != want:
                raise ValueError(
                    f"{what} kv block shape {tuple(blk['kv'].shape)} does "
                    f"not match this pool's {want} — the engines' "
                    "model/layout configs must agree")
            if ("sc" in self._caches) != ("sc" in blk):
                raise ValueError(
                    f"{what} block cache flavor (int8 scales) does not "
                    "match this engine's")

    def _place(self, req, s, state, ids):
        """Restore a migrated or parked request into slot ``s`` over pool
        blocks ``ids``: the decode vectors, then the drafter and presence
        rebuilt from its tokens."""
        row = self._tables[s]
        row[:] = self.pool.num_blocks
        row[:len(ids)] = ids
        self._lens[s] = int(state["lens"])
        self._nt[s] = int(state["nt"])
        self._tok[s] = int(state["tok"])
        self._max_nt[s] = req.max_new_tokens
        self._eos[s] = (-1 if req.eos_token_id is None
                        else int(req.eos_token_id))
        self._min_len[s] = req.min_length
        self._rep_pen[s] = req.repetition_penalty
        self._rseed[s] = req.seed
        self._active[s] = bool(state["active"])
        self._pf_left[s] = int(state["pf_left"])
        if self._drafters is not None:
            self._drafters[s].reset(req.prompt)
            self._drafters[s].update(req.tokens)
        if self._rep_on:
            p = self._presence_init()[s]
            p.zero_()
            seen = np.concatenate([req.prompt, np.asarray(req.tokens,
                                                          np.int64)])
            p[torch.from_numpy(seen.astype(np.int64)).to(self.device)] = True
        req.slot = s
        self._slot_req[s] = req

    def import_slot(self, state, staged=None):
        """Resume an exported request here (from this port or the JAX
        package): fresh pool blocks take its KV bytes, the decode state
        is restored and the drafter and presence rebuilt. Returns its new
        rid. Sheds with AdmissionFull when no slot or pool headroom can
        take it; a never-prefilled export re-enters the queue. ``staged``
        names a stage_kv_blocks tag that covers exactly the export's
        ``kv_skip`` leading blocks, spliced in without a re-upload (a shed
        import leaves them staged)."""
        self._need_paged("import_slot")
        if not isinstance(state, dict) or \
                state.get("fmt") != self.MIGRATION_FMT:
            raise ValueError(
                f"not a migration state dict (fmt="
                f"{None if not isinstance(state, dict) else state.get('fmt')!r}"
                f", expected {self.MIGRATION_FMT!r})")
        if int(state["prefill_cap"]) != self.prefill_cap:
            raise ValueError(
                f"migration state has prefill_cap={state['prefill_cap']}"
                f" but this engine uses {self.prefill_cap} — the KV "
                "blocks are prefill_cap-sized and cannot be re-chunked")
        prompt = np.asarray(state["prompt"], np.int64).reshape(-1)
        max_new = int(state["max_new_tokens"])
        if prompt.size + max_new > self.smax:
            raise ValueError(
                f"migrated request needs {prompt.size} + {max_new} "
                f"positions but this engine's Smax is {self.smax}")
        lens = int(state["lens"])
        if not 0 <= lens <= prompt.size + max_new:
            raise ValueError(
                f"migration state has lens={lens} outside its own request "
                f"budget [0, {prompt.size} + {max_new}] — corrupt or "
                "mismatched payload")
        blocks = state["kv"]
        kv_skip = int(state.get("kv_skip", 0))
        staged_ids = []
        if staged is not None:
            staged_ids = self._staged.get(staged)
            if staged_ids is None:
                raise ValueError(f"no staged kv blocks under tag {staged!r}")
        if len(staged_ids) != kv_skip:
            raise ValueError(
                f"export skips {kv_skip} leading kv blocks but "
                f"{len(staged_ids)} are staged under {staged!r} — the "
                "streamed prefix must cover the skip exactly")
        total_blocks = -(-lens // self.prefill_cap)
        if kv_skip + len(blocks) != total_blocks:
            raise ValueError(
                f"migration state ships {len(blocks)} kv blocks "
                f"(+{kv_skip} staged) but lens={lens} needs {total_blocks}")
        self._check_blocks(blocks, "migrated")
        now = self.clock()
        need = self._blocks_needed(prompt.size, max_new)
        tokens = [int(t) for t in state["tokens"]]
        req = ServedRequest(next(self._rid), prompt, max_new,
                            state["eos_token_id"], int(state["min_length"]),
                            float(state["repetition_penalty"]), now,
                            deadline_s=state["deadline_s"],
                            seed=int(state["seed"]),
                            trace_id=state["trace_id"],
                            attempt=int(state["attempt"]),
                            priority=state.get("priority", QOS_DEFAULT))
        if not blocks and not staged_ids and not tokens \
                and int(state["nt"]) == 0:
            # never prefilled: a plain (re-)queue, admitted normally later
            if self.max_pending and self._queue_len() >= self.max_pending:
                raise self._shed(
                    f"pending queue full ({self._queue_len()}/"
                    f"{self.max_pending}) — migrated request shed",
                    now, req.trace_id, req.attempt)
            if self._kv_gate and \
                    self._kv_committed + need > self.pool.num_blocks:
                raise self._shed("kv pool exhausted — migrated request "
                                 "shed at import", now, req.trace_id,
                                 req.attempt)
            self._kv_committed += need
            if staged is not None:
                self._staged.pop(staged, None)   # an empty tag, consumed
            self._queues[req.priority].append(req)
            self._req_index[req.rid] = req
            self._migrated_in += 1
            self.telemetry.req_queued(req.rid, now, trace_id=req.trace_id,
                                      attempt=req.attempt)
            if self.telemetry.enabled:
                self.telemetry.req_event(req.rid, "migrate_in", now)
            return req.rid
        free = self._free_slots()
        if not free:
            raise self._shed("no free slot to import the migrated session "
                             "into", now, req.trace_id, req.attempt)
        if self._kv_reserved - len(staged_ids) + need > self.pool.num_blocks:
            # staged blocks hold their own reservation, which folds into
            # the request's: only the difference is checked
            raise self._shed(
                f"kv pool exhausted: migrated session needs {need} "
                f"blocks, {self.pool.num_blocks - self._kv_reserved} "
                "unreserved", now, req.trace_id, req.attempt)
        s = free[0]
        req.state = "running"
        req.t_admit = now                  # no queue time on this engine
        # TTFT belongs to the attempt that produced the first token
        req.tokens = tokens
        if staged_ids:
            del self._staged[staged]
            self._kv_reserved -= len(staged_ids)
        self._kv_committed += need
        self._kv_reserved += need
        new_ids = self._alloc_kv_blocks(len(blocks)) if blocks else []
        self.pool.write_blocks(self._caches, blocks, new_ids)
        self._kv_blocks_adopted += len(blocks)
        self._place(req, s, state, list(staged_ids) + list(new_ids))
        self._req_index[req.rid] = req
        self._migrated_in += 1
        self.telemetry.req_queued(req.rid, now, trace_id=req.trace_id,
                                  attempt=req.attempt)
        self.telemetry.req_admitted(req.rid, s, now)
        if self.telemetry.enabled:
            self.telemetry.req_event(req.rid, "migrate_in", now)
        if not self._active[s] and not self._pf_left[s] and tokens:
            # exported at the exact finish boundary
            self._finish(req, now)
        elif (self.role == "prefill" and self._active[s]
                and not self._pf_left[s] and self._nt[s] >= 1):
            # a prompt-complete session on a prefill engine re-holds
            req.state = "prefilled"
            self._active[s] = False
        return req.rid

    # ------------------------------------------------- streamed KV handoff
    def export_kv_prefix(self, rid, start_block=0, min_blocks=1):
        """The committed FULL blocks [start_block, lens // prefill_cap) of
        a live request, read without detaching it: ``(blocks, n_full)``.
        Fewer than ``min_blocks`` new ones read nothing. The partial tail
        travels with the final export_slot; the caller owns the cursor."""
        self._need_paged("export_kv_prefix")
        req = self._req_index.get(rid)
        if req is None or req.state not in ("running", "prefilled") \
                or req.slot is None:
            raise ValueError(f"request {rid} is not resident in a slot")
        s = req.slot
        n_full = int(self._lens[s]) // self.prefill_cap
        start_block = int(start_block)
        if not 0 <= start_block <= n_full:
            raise ValueError(
                f"start_block={start_block} outside [0, {n_full}]")
        if n_full - start_block < max(1, int(min_blocks)):
            return [], n_full
        row = self._tables[s]
        blocks = self.pool.read_blocks(
            self._caches, [int(row[j]) for j in range(start_block, n_full)])
        if blocks:
            self._kv_blocks_shipped += len(blocks)
            self.telemetry.observe_handoff(_kv_payload_bytes(blocks))
            if self.telemetry.enabled:
                self.telemetry.req_event(rid, "kv_ship", self.clock())
        return blocks, n_full

    def stage_kv_blocks(self, tag, blocks):
        """Receive streamed KV blocks ahead of their session's import:
        pool blocks under a staging reservation take the payloads, filed
        under ``tag`` (repeat calls append) for import_slot(staged=tag).
        Sheds with AdmissionFull when the pool cannot take them. Returns
        the count staged under the tag."""
        self._need_paged("stage_kv_blocks")
        blocks = list(blocks)
        self._check_blocks(blocks, "staged")
        if blocks and self._kv_reserved + len(blocks) \
                > self.pool.num_blocks:
            raise AdmissionFull(
                f"kv pool exhausted: staging {len(blocks)} blocks, "
                f"{self.pool.num_blocks - self._kv_reserved} unreserved")
        if blocks:
            self._kv_reserved += len(blocks)
            ids = self._alloc_kv_blocks(len(blocks))
            self.pool.write_blocks(self._caches, blocks, ids)
            self._kv_blocks_adopted += len(blocks)
            self._staged.setdefault(tag, []).extend(ids)
        elif tag not in self._staged:
            self._staged[tag] = []
        return len(self._staged[tag])

    def abort_stage(self, tag):
        """Drop a staging tag, its pool blocks and reservation.
        Idempotent; returns the blocks released."""
        ids = self._staged.pop(tag, None)
        if not ids:
            return 0
        self.pool.deref(ids)
        self._kv_reserved -= len(ids)
        return len(ids)

    # ----------------------------------------------------- QoS preemption
    # A parked request stays this engine's (same rid, index entry and
    # harvest cursor, state "preempted"), and keeps its committed blocks:
    # only its running reservation and physical blocks are released.
    def preempt_to_host(self, rid):
        """Park a RUNNING request in host memory: its decode state, KV
        bytes included, in the migration format; its slot and blocks
        freed. resume_from_host restores it token-identically, greedy and
        plain sampled (the seed rides the state)."""
        self._need_paged("preempt_to_host", " (the parked payload is pool "
                         "blocks; paged=False disables it)")
        req = self._req_index.get(rid)
        if req is None or req.state != "running":
            raise ValueError(f"request {rid} is not running in a slot")
        now = self.clock()
        state = self._slot_state(req)
        del state["kv_skip"]
        row = self._tables[req.slot]
        state["kv"] = self.pool.read_blocks(
            self._caches, [int(row[j]) for j in
                           range(-(-state["lens"] // self.prefill_cap))])
        self._release_slot(req)
        req.slot = None
        req.state = "preempted"
        self._parked[rid] = state
        self._preempted += 1
        if self.telemetry.enabled:
            self.telemetry.req_event(rid, "preempt", now)
        return rid

    def resume_from_host(self, rid):
        """A parked request back into a free slot (fresh blocks, its KV
        re-uploaded). Sheds with AdmissionFull when no slot or
        reservation can take it; the parked copy stays. Its t_submit and
        deadline are untouched: parked time counts."""
        state = self._parked.get(rid)
        req = self._req_index.get(rid)
        if state is None or req is None or req.state != "preempted":
            raise ValueError(f"request {rid} is not parked here")
        if not self._free_slots():
            raise AdmissionFull("no free slot to resume the parked "
                                "request into")
        need = self._blocks_needed(req.prompt.size, req.max_new_tokens)
        if self._kv_reserved + need > self.pool.num_blocks:
            raise AdmissionFull(
                f"kv pool exhausted: resume needs {need} blocks, "
                f"{self.pool.num_blocks - self._kv_reserved} unreserved")
        now = self.clock()
        s = self._free_slots()[0]
        del self._parked[rid]
        blocks = state["kv"]
        self._kv_reserved += need          # committed never left
        ids = self._alloc_kv_blocks(len(blocks)) if blocks else []
        self.pool.write_blocks(self._caches, blocks, ids)
        self._place(req, s, state, ids)
        req.state = "running"
        self._resumed += 1
        if self.telemetry.enabled:
            self.telemetry.req_event(rid, "resume", now)
        if not self._active[s] and not self._pf_left[s] and req.tokens:
            self._finish(req, now)
        return rid

    def _qos_schedule(self):
        """One pass a step (paged engines): resume parked requests best
        class first while they fit (never ahead of a strictly better
        queued head), then, when a strictly better queue head is blocked
        on slots or reservation, preempt the one worst running request
        (lowest class, youngest)."""
        if not self.paged:
            return
        for rid in sorted(self._parked, key=lambda r: (
                QOS_RANK[self._parked[r]["priority"]], r)):
            head = self._queue_head()
            if head is not None and QOS_RANK[head.priority] < \
                    QOS_RANK[self._parked[rid]["priority"]]:
                break
            try:
                self.resume_from_host(rid)
            except AdmissionFull:
                break
        head = self._queue_head()
        if head is None:
            return
        need = self._blocks_needed(head.prompt.size, head.max_new_tokens)
        if self._free_slots() and \
                self._kv_reserved + need <= self.pool.num_blocks:
            return
        victims = [r for r in self._slot_req
                   if r is not None and r.state == "running"
                   and QOS_RANK[r.priority] > QOS_RANK[head.priority]]
        if victims:
            self.preempt_to_host(max(victims, key=lambda r: (
                QOS_RANK[r.priority], r.rid)).rid)

    # ------------------------------------------------------------- steps
    def _free_slots(self):
        return [i for i in range(self.num_slots)
                if not self._active[i] and self._slot_req[i] is None]

    def _admit_chunked(self):
        """Move queued requests into free slots (best class first, FIFO
        within a class) while the pool can reserve their worst-case
        blocks; per request, in order, the prefix
        lookup and adoption (``lens`` starts at the adopted length).
        Prefill happens in the budget steps, and a prompt publishes when
        it completes there, so a cold gang of one template admitted
        together misses alike (the store converges one prompt later, as
        in JAX)."""
        free = self._free_slots()
        tele = self.telemetry
        t_adm = None
        while free and self._reserve(self._queue_head()):
            if t_adm is None:
                t_adm = self.clock()
            req = self._queue_popleft()
            s = free.pop(0)
            req.slot, req.state, req.t_admit = s, "running", t_adm
            self._slot_req[s] = req
            self._admitted += 1
            self._class_admitted[req.priority] += 1
            tele.req_admitted(req.rid, s, t_adm)
            self._seed_presence(req)
            base = self._adopt(s, req.prompt)
            if base:
                tele.req_event(req.rid, "prefix_adopt", t_adm)
            self._lens[s] = base
            self._pf_left[s] = req.prompt.size - base
            self._nt[s] = 0
            self._max_nt[s] = req.max_new_tokens
            self._eos[s] = (-1 if req.eos_token_id is None
                            else int(req.eos_token_id))
            self._min_len[s] = req.min_length
            self._rep_pen[s] = req.repetition_penalty
            self._rseed[s] = req.seed
            self._active[s] = False          # decoding starts at finish
            if self._drafters is not None:
                self._drafters[s].reset(req.prompt)

    # ------------------------------------------------------ prefix cache
    def _adopt(self, slot, prompt):
        """The prefix lookup of one admission: on a hit the chain goes
        into the slot (paged: its block ids into the table, zero-copy;
        dense: copied into the ring row, pinned across the copy). Counts
        the hit or miss and the prefill tokens saved and computed.
        Returns the adopted token count (0 without a cache or on a
        miss)."""
        if self.prefix_cache is None:
            return 0
        pc = self._prefix_cache_for_dispatch()
        base = 0
        nodes = pc.lookup(prompt) if pc is not None else None
        if nodes:
            if self.paged:
                base = pc.adopt_into(self._tables, slot, nodes)
            else:
                pc.store.acquire(nodes)
                try:
                    pc.adopt(self._caches, slot, nodes)
                finally:
                    pc.store.release(nodes)
                base = len(nodes) * pc.block_tokens
            self._prefix_hits += 1
            self._prefill_tokens_saved += base
        else:
            self._prefix_misses += 1
        self._prefill_tokens_computed += prompt.size - base
        return base

    def _publish(self, slot, req):
        """Commit-on-prefill: the prompt's full blocks into the store
        (paged: the store's reference on the slot's own blocks; dense:
        copied out of the ring row)."""
        pc = self._prefix_cache_for_dispatch()
        if pc is None:
            return
        if self.paged:
            pc.publish_from(self._tables, slot, req.prompt)
        else:
            pc.publish(self._caches, slot, req.prompt)

    def _prefix_cache_for_dispatch(self):
        """The prefix cache admissions may use, or None. The paged cache is
        host bookkeeping over the (head-sharded) pool and runs under a mesh
        unchanged; the dense cache's copies assume an unsharded ring, so
        under a mesh it stays off (warned once) and every admission counts
        as a miss, as in JAX."""
        if self.prefix_cache is None or self.paged \
                or self.dec._mesh_mp() is None:
            return self.prefix_cache
        if not self._pc_mesh_warned:
            import warnings
            warnings.warn(
                "serving: dense prefix cache disabled under an active "
                "mp mesh — its adopt/commit copies assume an "
                "unsharded ring cache, so every admission counts as a "
                "miss. The paged engine (the default) shards its pool "
                "by head and keeps prefix caching on under a mesh.",
                RuntimeWarning, stacklevel=3)
            self._pc_mesh_warned = True
        return None

    # ------------------------------------------------- phase scheduler
    def _admit(self):
        """Phase-mode admission: move queued requests into free slots (best
        class first, FIFO within a class) while the pool can reserve their worst-case blocks; per request,
        in order, the prefix lookup, then a miss's bulk pass over its
        whole prompt and its publication (so later requests of the same
        admission can hit), a hit's adoption; the hits' suffixes go
        through the masked-scan prefill together (``_prefill_chunks``),
        then publish. Then every admitted slot's first token is sampled in
        one dispatch over all B rows (the host reads only the admitted
        rows). Returns the admitted requests, each of which just emitted
        its first token."""
        free = self._free_slots()
        batch = []
        while free and self._reserve(self._queue_head()):
            req = self._queue_popleft()
            req.slot, req.state = free.pop(0), "running"
            self._slot_req[req.slot] = req
            batch.append(req)
            self._class_admitted[req.priority] += 1
        if not batch:
            return []
        self._admitted += len(batch)
        tele = self.telemetry
        t_adm = self.clock()
        for r in batch:
            r.t_admit = t_adm
            tele.req_admitted(r.rid, r.slot, t_adm)
        stk = self.dec._stacked()
        f = self.dec.fmt
        b = self.num_slots
        last_x = torch.zeros((b, 1, f.embed_dim),
                             dtype=f.qkv_weights[0].dtype, device=self.device)
        base = np.zeros(b, np.int64)            # adopted tokens per slot
        for r in batch:
            self._seed_presence(r)
            base[r.slot] = self._adopt(r.slot, r.prompt)
            if base[r.slot]:
                tele.req_event(r.rid, "prefix_adopt", t_adm)
            self._map_blocks(r.slot, r.prompt.size)
            if not base[r.slot]:
                last_x[r.slot] = self._bulk_admit_row(stk, r)
                tele.req_event(r.rid, "prefill_chunk", t_adm)
                self._publish(r.slot, r)
        scan = [r for r in batch if base[r.slot]]
        if scan:
            last_x = self._scan_prefill(stk, scan, base, last_x)
        for r in scan:
            tele.req_event(r.rid, "prefill_chunk", t_adm)
            self._publish(r.slot, r)
        for r in batch:
            s = r.slot
            self._lens[s] = r.prompt.size
            self._nt[s] = 0
            self._max_nt[s] = r.max_new_tokens
            self._eos[s] = (-1 if r.eos_token_id is None
                            else int(r.eos_token_id))
            self._min_len[s] = r.min_length
            self._rep_pen[s] = r.repetition_penalty
            self._rseed[s] = r.seed
            if self._drafters is not None:
                self._drafters[s].reset(r.prompt)
        rep_pen, presence, seeds = self._sample_args()
        nxt, _ = self._run_dispatch(
            ("admit_sample",), self._build_admit_sample(),
            (last_x, seeds, self._dev(self._eos), self._dev(self._min_len),
             rep_pen, presence), rows=len(batch), tokens=len(batch))
        if presence is not None:
            rows = torch.tensor([r.slot for r in batch], device=self.device)
            presence[rows, nxt[rows]] = True
        nxt = nxt.cpu().numpy()
        now = self.clock()
        self._decode_steps += len(batch)     # one sample event per row
        for r in batch:
            s = r.slot
            tok0 = int(nxt[s])
            r.t_first = now
            tele.req_event(r.rid, "first_token", now)
            r.tokens.append(tok0)
            self._class_tokens[r.priority] += 1
            self._nt[s] = 1
            self._tok[s] = tok0
            if self._drafters is not None:
                self._drafters[s].update([tok0])
            hit_eos = (r.eos_token_id is not None
                       and tok0 == int(r.eos_token_id))
            self._active[s] = not hit_eos and r.max_new_tokens > 1
            if not self._active[s]:
                self._finish(r, now)
        return batch

    def _prefill_chunks(self, maxp):
        """The masked-scan prefill's dispatch sizes for maxp tokens: full
        ``prefill_cap`` chunks, then one chunk rounded up to a power of
        two (its tail steps write nothing)."""
        out, pos = [], 0
        while pos < maxp:
            rem = maxp - pos
            c = (self.prefill_cap if rem >= self.prefill_cap
                 else 1 << (rem - 1).bit_length())
            out.append(c)
            pos += c
        return out

    def _build_prefill_chunk(self, chunk):
        """The masked-scan prefill: ``chunk`` teacher-forced tokens of
        toks [B, chunk], row b's step i at position t0[b] + i and writing
        only while i < n_valid[b] (every row attends; the others' outputs
        are discarded); each row's last valid hidden state lands in
        last_x [B, 1, E]. Returns prefill(stk, caches, toks, t0, n_valid,
        last_x) -> last_x."""
        dec = self.dec

        def prefill(stk, caches, toks, t0, n_valid, last_x):
            for i in range(chunk):
                mask = i < n_valid
                x = dec.hidden(stk, caches, toks[:, i], t0 + i, mask)
                last_x = torch.where(mask[:, None, None], x, last_x)
            return last_x
        return prefill

    def _scan_prefill(self, stk, scan, base, last_x):
        """The suffixes of the prefix hits ``scan`` (prompt positions from
        base[slot]) through the masked-scan prefill, all rows in each
        dispatch; rows outside ``scan`` write nothing. Returns last_x."""
        b = self.num_slots
        chunks = self._prefill_chunks(max(r.prompt.size - int(base[r.slot])
                                          for r in scan))
        prompts = np.zeros((b, sum(chunks)), np.int64)
        n_left = np.zeros(b, np.int64)
        for r in scan:
            sfx = r.prompt[int(base[r.slot]):]
            prompts[r.slot, :sfx.size] = sfx
            n_left[r.slot] = sfx.size
        pos = 0
        for chunk in chunks:
            t0 = np.where(n_left > 0, base + pos, self._lens)
            n_valid = np.clip(n_left - pos, 0, chunk)
            last_x, _ = self._run_dispatch(
                ("prefill", chunk), self._build_prefill_chunk(chunk),
                (stk, self._cache_arg(),
                 self._dev(prompts[:, pos:pos + chunk]), self._dev(t0),
                 self._dev(n_valid), last_x),
                rows=int((n_valid > 0).sum()), tokens=int(n_valid.sum()))
            pos += chunk
        return last_x

    def _build_admit_sample(self):
        """The first-token sample on the prefill hidden states, with each
        slot's logit controls applied at nt = 0 (the host reads only the
        admitted rows)."""
        dec, b = self.dec, self.num_slots
        rep_on, *sample = self._sampling()

        def admit_sample(last_x, seeds, eos_ids, min_len, rep_pen,
                         presence):
            logits = dec.head_logits(last_x).reshape(b, -1)
            nt0 = torch.zeros(b, dtype=eos_ids.dtype, device=eos_ids.device)
            logits = _penalize_slots(logits, presence if rep_on else None,
                                     rep_pen, nt0, min_len, eos_ids)
            return _sample_rows(logits, *sample, seeds, nt0)
        return admit_sample

    def _sampling(self):
        # (rep_on, do_sample, top_k, top_p, temperature) of every dispatch
        return (self._rep_on, self.do_sample, self.top_k, self.top_p,
                self.temperature)

    def _sample_args(self):
        """(rep_pen [B] fp32, presence [B, V] or None, seeds [B]) on the
        device, as every dispatch takes them."""
        return (self._dev(self._rep_pen, torch.float32),
                self._presence_init() if self._rep_on else None,
                self._dev(self._rseed))

    def _presence_init(self):
        if self._presence is None:
            self._presence = torch.zeros(
                (self.num_slots, self.dec.head.weight.shape[1]),
                dtype=torch.bool, device=self.device)
        return self._presence

    def _seed_presence(self, req):
        """Under rep_on, reset the admitted slot's presence row to its
        prompt's tokens (teacher-forced prefill never adds to it)."""
        if not self._rep_on:
            return
        row = self._presence_init()[req.slot]
        row.zero_()
        row[torch.from_numpy(req.prompt).to(self.device)] = True

    def _build_bulk_admit(self, sb):
        """Bulk prefill of one prompt padded to sb tokens: one causal flash
        pass over [1, sb], then the prompt's K/V written in place (an int8
        cache takes each row quantized with ``_absmax_int8`` and its
        scale). Through the slot's table row, pad positions >= plen are
        selected away before the write (JAX drops them with mode="drop"),
        so the pad needs no blocks; a ring takes positions [0, sb) of the
        slot's row, pad included, as JAX's does: write-then-attend
        overwrites each pad position before any query reads it. Under the
        mesh each shard writes its heads into its own cache. Returns
        bulk_admit(stk, caches, toks, slot, plen) -> the hidden state of the
        last prompt token [1, E]."""
        dec = self.dec

        def write(caches, kv, slot, plen):
            # kv [L, 2, H, sb, D] (a shard's heads) into caches (its part)
            if "tbl" not in caches:
                if "sc" in caches:
                    kv, sc = _absmax_int8(kv, -1)
                    caches["sc"][:, :, slot, :, 0, :sb] = sc[..., 0]
                caches["kv"][:, :, slot, :, :sb] = kv
                return
            pool = caches["kv"]
            row = caches["tbl"][slot].to(pool.device).long()
            nb, bt = pool.shape[2], pool.shape[4]
            pos = torch.arange(sb, device=kv.device)
            blk = torch.where(pos < plen, row[pos // bt],
                              torch.full_like(pos, nb))
            keep = (blk < nb).nonzero(as_tuple=True)[0]
            blk, off = blk[keep], (pos % bt)[keep]
            pool_p = pool.permute(2, 4, 0, 1, 3, 5)      # [NB, Bt, L, 2, H, D]
            if "sc" in caches:
                kv, sc = _absmax_int8(kv, -1)
                sc_p = caches["sc"][:, :, :, :, 0].permute(2, 4, 0, 1, 3)
                sc_p[blk, off] = sc[..., 0].permute(3, 0, 1, 2)[keep]
            pool_p[blk, off] = kv.permute(3, 0, 1, 2, 4)[keep].to(pool.dtype)

        def bulk_admit(stk, caches, toks, slot, plen):
            x, kv_all = dec.bulk_hidden(stk, toks)
            if isinstance(kv_all, ShardedTensor):
                for i, kv in enumerate(kv_all.shards):
                    write(dict(caches, **{k: caches[k].shards[i]
                                          for k in ("kv", "sc")
                                          if k in caches}),
                          kv[:, :, 0], slot, plen)
            else:
                write(caches, kv_all[:, :, 0], slot, plen)
            return x[0, plen - 1][None]
        return bulk_admit

    def _bulk_admit_row(self, stk, req):
        plen = req.prompt.size
        sb = min(1 << (int(plen) - 1).bit_length(), self.smax)
        toks = np.zeros((1, sb), np.int64)
        toks[0, :plen] = req.prompt
        row_x, _ = self._run_dispatch(
            ("bulk_admit", sb), self._build_bulk_admit(sb),
            (stk, self._cache_arg(), self._dev(toks), req.slot, plen),
            rows=1, tokens=int(plen))
        return row_x

    def _dev(self, a, dtype=torch.int64):
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _prefill_allocations(self, pf_rows, budget, col_cap=None):
        """The weighted-fair prefill share of one budget dispatch, each
        row taking at most col_cap prompt tokens (the whole budget when
        None): with several QoS classes prefilling, each first gets
        floor(budget * share / total shares) tokens, first come first
        served by rid within the class; then what is left goes to the
        remaining demand in (class rank, rid) order. With one class this
        is the plain first-come-first-served packing. Returns ([(slot,
        n), ...] with n > 0 in (class rank, rid) order, remaining
        budget)."""
        req = self._slot_req
        order = sorted(pf_rows, key=lambda s: (QOS_RANK[req[s].priority],
                                               req[s].rid))
        cap = budget if col_cap is None else col_cap
        want = {s: min(int(self._pf_left[s]), cap) for s in order}
        alloc = dict.fromkeys(order, 0)
        classes = {req[s].priority for s in order}
        if len(classes) > 1:
            total = sum(self.qos_shares[c] for c in classes)
            for c in classes:
                fair = budget * self.qos_shares[c] // total
                for s in order:
                    if req[s].priority == c:
                        n = min(want[s] - alloc[s], fair)
                        alloc[s] += n
                        fair -= n
        left = budget - sum(alloc.values())
        for s in order:
            if left <= 0:
                break
            n = min(want[s] - alloc[s], left)
            alloc[s] += n
            left -= n
        return [(s, alloc[s]) for s in order if alloc[s] > 0], left

    def _map_write_windows(self, adv, pf_n, tail):
        """Before a budget dispatch, map each packed slot's write window:
        its adv[s] stream positions plus, for a slot that decodes after
        the block (active, or finishing its prompt here), the trailing
        scan's steps — clamped to the admission-time reservation
        plen + max_new."""
        for s in range(self.num_slots):
            if not adv[s]:
                continue
            decodes = bool(self._active[s]) or (
                pf_n[s] and pf_n[s] == self._pf_left[s])
            hi = int(self._lens[s]) + int(adv[s]) + (tail if decodes else 0)
            cap_pos = self._slot_req[s].prompt.size + int(self._max_nt[s])
            self._ensure_writable(s, int(self._lens[s]), min(hi, cap_pos))

    def _budget_step(self):
        """One token-budget dispatch: decode inputs are mandatory, prefill
        chunks (oldest request first, at most C each) fill the rest, and
        under spec_k the decode rows' draft claims take what is left. A
        step with only decode rows runs the plain decode chunk when that
        moves more tokens than the block would. Under flat_budget the
        block is the flat stream (``_flat_budget_step``). With drafts the
        core returns its chain and the host accepts
        (``_harvest_budget_chain``). Returns tokens emitted."""
        b, c, k = self.num_slots, self._budget_cols, self.spec_k
        dec_rows = [s for s in range(b) if self._active[s]]
        pf_rows = [s for s in range(b) if self._pf_left[s] > 0]
        if not dec_rows and not pf_rows:
            return 0
        # a row's whole segment (input + drafts) fits C columns; the flat
        # stream has no column cap
        drafts, dlen = propose_claims(
            self._drafters or [None] * b, dec_rows, k,
            self._max_nt - self._nt,
            col_cap=None if self._flat_budget else c)
        if not pf_rows and len(dec_rows) + int(dlen.sum()) < \
                len(dec_rows) * self.decode_chunk:
            return self._decode_one_chunk()
        if self._flat_budget:
            return self._flat_budget_step(dec_rows, pf_rows, drafts, dlen)
        budget = self.token_budget - len(dec_rows)
        toks = np.zeros((b, c), np.int64)
        seg = np.zeros(b, np.int64)
        gen0 = np.full(b, c, np.int64)
        pf_n = np.zeros(b, np.int64)
        for s in dec_rows:
            toks[s, 0] = self._tok[s]
            seg[s] = 1
            gen0[s] = 0
        allocs, budget = self._prefill_allocations(pf_rows, budget,
                                                   col_cap=c)
        for s, n in allocs:
            req = self._slot_req[s]
            p0 = req.prompt.size - int(self._pf_left[s])
            toks[s, :n] = req.prompt[p0:p0 + n]
            seg[s] = pf_n[s] = n
            if n == int(self._pf_left[s]):
                # the last prompt token's logits sample the first token
                gen0[s] = n - 1
        for s in dec_rows if k else ():
            m = min(int(dlen[s]), budget)
            dlen[s] = m
            if m > 0:
                toks[s, 1:1 + m] = drafts[s, :m]
                seg[s] = 1 + m
                budget -= m
        tail = 0 if k else max(self.decode_chunk - 1, 0)
        self._map_write_windows(seg, pf_n, tail)
        full_logits = bool(self.do_sample and k)
        core = self.dec._build_budget_core(
            c, *self._sampling(), full_logits=full_logits, chain=bool(k),
            scan_tail=tail)
        out, ev = self._run_dispatch(
            ("budget", c), core,
            (self.dec._stacked(), self._cache_arg(), self._dev(toks),
             self._dev(self._lens), self._dev(seg), self._dev(gen0),
             self._dev(self._nt), self._dev(self._max_nt),
             self._dev(self._eos), self._dev(self._min_len),
             *self._sample_args()),
            rows=int((seg > 0).sum()), budget_used=int(seg.sum()),
            budget_wasted=b * c - int(seg.sum()), drafts=int(dlen.sum()))
        res = self._host_out(out, full_logits)
        self._count_budget(int(seg.sum()), b * c, pf_n, len(dec_rows),
                           int(dlen.sum()))
        if not k:
            return self._harvest_budget_plain(res, ev, pf_n, tail)
        chain_out = {s: res[s, :int(seg[s])] for s in range(b) if seg[s]}
        return self._harvest_budget_chain(chain_out, ev, pf_n, dec_rows,
                                          drafts, dlen, full_logits)

    @staticmethod
    def _host_out(out, full_logits):
        """A budget core's outputs on the host: a chain (argmax, or fp32
        logits under full_logits), or the advanced state as (tok0, emit0,
        ys_t, ys_e, tok, lens, active, nt)."""
        if torch.is_tensor(out):
            return (out.float() if full_logits else out).cpu().numpy()
        tok0, emit0, ys, *state = out
        return [t.cpu().numpy() for t in (tok0, emit0, *ys, *state)]

    def _count_budget(self, used, computed, pf_n, n_decode, n_draft=0):
        # padding: the positions a dispatch computed beyond the packed ones
        self._budget_steps += 1
        self._budget_tokens_used += used
        self._budget_prefill_tokens += int(pf_n.sum())
        self._budget_decode_tokens += n_decode
        self._budget_draft_tokens += n_draft
        self._budget_padding_tokens += computed - used

    def _flat_budget_step(self, dec_rows, pf_rows, drafts, dlen):
        """One token-flattened budget dispatch: a [T = b + ts] stream whose
        tokens [0, b) are the decode region (token i is slot i's input when
        it decodes without drafts, else the slot sentinel b) and whose
        segments — prefill chunks first come first served with no column
        cap, then the draft claims (input token and drafts) — start on
        FLAT_CHUNK boundaries. ts comes from an eighth-octave ladder: the
        aligned width rounded up to a multiple of next_pow2(width) / 8.
        Returns tokens emitted."""
        b, k = self.num_slots, self.spec_k
        budget = self.token_budget - len(dec_rows)
        pf_n = np.zeros(b, np.int64)
        segs = []                        # (slot, tokens, a draft claim?)
        allocs, budget = self._prefill_allocations(pf_rows, budget)
        for s, n in allocs:
            req = self._slot_req[s]
            p0 = req.prompt.size - int(self._pf_left[s])
            segs.append((s, req.prompt[p0:p0 + n], False))
            pf_n[s] = n
        for s in dec_rows if k else ():
            m = min(int(dlen[s]), budget)
            dlen[s] = m
            if m > 0:
                segs.append((s, np.concatenate(([self._tok[s]],
                                                drafts[s, :m])), True))
                budget -= m
        regd = [s for s in dec_rows if not (k and dlen[s] > 0)]
        align = FLAT_CHUNK
        starts, cursor = [], 0
        for _, tk, _ in segs:
            starts.append(cursor)
            cursor = -(-(cursor + len(tk)) // align) * align
        if segs:
            need = max(cursor, align)
            step = max((1 << (need - 1).bit_length()) // 8, align)
            ts = -(-need // step) * step
        else:
            ts = 0
        t_total, nc = b + ts, ts // align
        toks = np.zeros(t_total, np.int64)
        tslot = np.full(t_total, b, np.int64)       # b: the pad sentinel
        tpos = np.zeros(t_total, np.int64)
        tcol = np.zeros(t_total, np.int64)
        tstart = np.zeros(t_total, np.int64)
        cslot = np.zeros(nc, np.int32)
        cbase = np.zeros(nc, np.int32)
        cn = np.zeros(nc, np.int32)
        last_idx = np.zeros(b, np.int64)
        emit0 = np.zeros(b, bool)
        adv = np.zeros(b, np.int64)
        gen0 = np.zeros(b, np.int64)
        for s in regd:
            toks[s] = self._tok[s]
            tslot[s] = s
            tpos[s] = self._lens[s]
            tstart[s] = s
            last_idx[s] = s
            emit0[s] = True
            adv[s] = 1
        for (s, tk, is_dec), st in zip(segs, starts):
            n = len(tk)
            base = int(self._lens[s])
            sl = slice(b + st, b + st + n)
            toks[sl] = tk
            tslot[sl] = s
            tpos[sl] = base + np.arange(n)
            tcol[sl] = np.arange(n)
            tstart[sl] = b + st
            last_idx[s] = b + st + n - 1
            adv[s] = n
            if is_dec:
                emit0[s] = True
            else:
                # the last prompt token's logits sample the first token;
                # chunks in the middle of a prompt never emit
                fin = pf_n[s] == self._pf_left[s]
                emit0[s] = fin
                gen0[s] = n - 1 if fin else 1 << 30
            for ci in range(st // align, (st + n - 1) // align + 1):
                cslot[ci] = s
                cbase[ci] = base + (ci * align - st)
                cn[ci] = min(n - (ci * align - st), align)
        tail = 0 if k else max(self.decode_chunk - 1, 0)
        self._map_write_windows(adv, pf_n, tail)
        full_logits = bool(self.do_sample and k)
        core = self.dec._build_flat_budget_core(
            b, *self._sampling(), full_logits=full_logits, chain=bool(k),
            scan_tail=tail)
        i32 = torch.int32
        used = len(regd) + sum(len(tk) for _, tk, _ in segs)
        out, ev = self._run_dispatch(
            ("flat_budget", ts), core,
            (self.dec._stacked(), self._cache_arg(), self._dev(toks),
             self._dev(tslot), self._dev(tpos), self._dev(cslot, i32),
             self._dev(cbase, i32), self._dev(cn, i32), self._dev(tcol),
             self._dev(tstart), self._dev(gen0), self._dev(self._tok),
             self._dev(last_idx), self._dev(emit0, torch.bool),
             self._dev(adv), self._dev(self._lens), self._dev(self._nt),
             self._dev(self._max_nt), self._dev(self._eos),
             self._dev(self._min_len), *self._sample_args()),
            rows=int((adv > 0).sum()), budget_used=used,
            budget_wasted=t_total - used, drafts=int(dlen.sum()))
        res = self._host_out(out, full_logits)
        self._count_budget(used, t_total, pf_n, len(dec_rows),
                           int(dlen.sum()))
        if not k:
            return self._harvest_budget_plain(res, ev, pf_n, tail)
        chain_out = {s: res[s:s + 1] for s in regd}
        for (s, tk, _), st in zip(segs, starts):
            chain_out[s] = res[b + st:b + st + len(tk)]
        return self._harvest_budget_chain(chain_out, ev, pf_n, dec_rows,
                                          drafts, dlen, full_logits)

    def _harvest_budget_plain(self, res, ev, pf_n, tail):
        """Walk the dispatch's tokens and finish events; the core already
        advanced every row's state on the device. A prompt that completed
        here publishes its blocks (decode writes, this dispatch's trailing
        scan too, land past them)."""
        tok0, emit0, ys_t, ys_e, tokc, lensc, activec, ntc = res
        tele = self.telemetry
        now = self.clock()
        prev_active = self._active.copy()
        self._tok, self._lens, self._nt = tokc, lensc, ntc
        still_active = activec.copy()
        n_emitted = 0
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None:
                continue
            if pf_n[s]:
                self._pf_left[s] -= int(pf_n[s])
                tele.req_event(req.rid, "prefill_chunk", now)
                if self._pf_left[s] == 0:
                    self._publish(s, req)
            if not emit0[s] and not prev_active[s]:
                continue                 # still prefilling
            row_toks = []
            if emit0[s]:
                row_toks.append(int(tok0[s]))
                if pf_n[s]:              # the prompt finished here
                    req.t_first = now
                    tele.req_event(req.rid, "first_token", now)
            if tail:
                row_toks.extend(int(t) for t in ys_t[ys_e[:, s], s])
            if row_toks and prev_active[s]:
                tele.req_event(req.rid, "decode", now)
            req.tokens.extend(row_toks)
            self._class_tokens[req.priority] += len(row_toks)
            n_emitted += len(row_toks)
            self._decode_steps += len(row_toks)
            if not still_active[s]:
                self._finish(req, now)
        self._active = still_active
        tele.finish_step(ev, self.clock() if ev is not None else 0.0,
                         tokens=n_emitted)
        return n_emitted

    def _get_spec_rng(self):
        """The host generator of sampled acceptance, seeded from the key
        stream at its first use, as JAX's."""
        if self._spec_rng is None:
            self._spec_rng = np.random.RandomState(_host_seed(next_key()))
        return self._spec_rng

    def _accept(self, s, req, drafts, dlen, out, full_logits, now):
        """One decode row's acceptance over its verify outputs ``out``
        (argmax chain [m + 1], or logits [m + 1, V] under full_logits):
        emits the accepted drafts and the bonus token within the row's
        limits, advances its state and counters, and finishes it at eos
        or its budget. Returns the tokens emitted."""
        m = int(dlen[s])
        if full_logits:
            probs = filtered_probs(out[:m + 1], self.top_k, self.top_p,
                                   self.temperature)
            kept, _ = rejection_sample(drafts[s, :m], probs,
                                       self._get_spec_rng())
        else:
            kept, _ = greedy_accept(drafts[s, :m], out[:m + 1])
        eos = None if self._eos[s] < 0 else int(self._eos[s])
        emitted, hit_eos = truncate_emitted(
            kept, int(self._max_nt[s] - self._nt[s]), eos)
        self._nt[s] += len(emitted)
        req.tokens.extend(emitted)
        self._class_tokens[req.priority] += len(emitted)
        self._lens[s] += len(emitted)
        self._tok[s] = emitted[-1]
        # one verify row step emitted len(emitted) tokens, all but one
        # of them drafts
        self._decode_steps += 1
        self._draft_proposed += m
        self._draft_accepted += len(emitted) - 1
        self.telemetry.req_event(req.rid, "verify", now)
        self._drafters[s].update(emitted)
        self._mark(s, emitted)
        if hit_eos or self._nt[s] >= self._max_nt[s]:
            self._active[s] = False
            self._finish(req, now)
        return len(emitted)

    def _mark(self, s, toks):
        """Under rep_on, the tokens slot s emitted join its presence row
        (a chain's speculative presence was the core's only)."""
        if self._rep_on and len(toks):
            self._presence[s, torch.tensor(toks, device=self.device)] = True

    def _harvest_budget_chain(self, chain_out, ev, pf_n, dec_rows, drafts,
                              dlen, full_logits):
        """The spec harvest of either layout: ``chain_out`` maps each
        packed slot to its segment's outputs (argmax chain, or logits
        under full_logits). Prefill rows advance in request order (the
        store's publication order is part of its eviction state); a row
        whose prompt completed publishes and takes its first token from
        the last column (sampled: a host draw from its filtered
        probabilities). Decode rows accept (``_accept``). Returns tokens
        emitted."""
        tele = self.telemetry
        now = self.clock()
        n_emitted = 0
        for s in sorted((s for s in range(self.num_slots) if pf_n[s]),
                        key=lambda s: self._slot_req[s].rid):
            req = self._slot_req[s]
            self._pf_left[s] -= int(pf_n[s])
            self._lens[s] += int(pf_n[s])
            tele.req_event(req.rid, "prefill_chunk", now)
            if self._pf_left[s] > 0:
                continue
            self._publish(s, req)
            arr = chain_out[s]
            if full_logits:
                p = filtered_probs(arr[-1][None], self.top_k, self.top_p,
                                   self.temperature)
                tok0 = int(self._get_spec_rng().choice(p.shape[-1],
                                                       p=p[0]))
            else:
                tok0 = int(arr[-1])
            req.t_first = now
            tele.req_event(req.rid, "first_token", now)
            req.tokens.append(tok0)
            self._class_tokens[req.priority] += 1
            self._nt[s] = 1
            self._tok[s] = tok0
            self._decode_steps += 1
            n_emitted += 1
            self._drafters[s].update([tok0])
            self._mark(s, [tok0])
            hit_eos = (req.eos_token_id is not None
                       and tok0 == int(req.eos_token_id))
            self._active[s] = not hit_eos and req.max_new_tokens > 1
            if not self._active[s]:
                self._finish(req, now)
        for s in dec_rows:
            req = self._slot_req[s]
            if req is not None and self._active[s]:
                n_emitted += self._accept(s, req, drafts, dlen, chain_out[s],
                                          full_logits, now)
        tele.finish_step(ev, self.clock() if ev is not None else 0.0,
                         tokens=n_emitted)
        return n_emitted

    def _build_decode_chunk(self):
        """The plain decode dispatch: decode_chunk steps over all slots
        (the budget core's trailing scan, run on its own)."""
        return self.dec._make_budget_tail(self.decode_chunk,
                                          *self._sampling())

    def _decode_one_chunk(self):
        chunk = self.decode_chunk
        for s in range(self.num_slots):
            if self._active[s]:
                self._ensure_writable(
                    s, int(self._lens[s]),
                    min(int(self._lens[s]) + chunk, self._budget_pos(s)))
        ((tok, lens, active, nt), (toks, emitted)), ev = self._run_dispatch(
            ("decode", chunk), self._build_decode_chunk(),
            (self.dec._stacked(), self._cache_arg(), self._dev(self._tok),
             self._dev(self._lens), self._dev(self._active, torch.bool),
             self._dev(self._nt), self._dev(self._max_nt),
             self._dev(self._eos), self._dev(self._min_len),
             *self._sample_args()),
            rows=int(self._active.sum()))
        toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
        self._tok, self._lens = tok.cpu().numpy(), lens.cpu().numpy()
        self._nt = nt.cpu().numpy()
        still_active = active.cpu().numpy()
        n_emitted = 0
        now = self.clock()
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or not self._active[s]:
                continue
            hits = emitted[:, s]
            req.tokens.extend(int(t) for t in toks[hits, s])
            self._class_tokens[req.priority] += int(hits.sum())
            if hits.any():
                self.telemetry.req_event(req.rid, "decode", now)
            n_emitted += int(hits.sum())
            if self._drafters is not None:
                # a spec engine reaches here through the thin-draft
                # fallback: the drafter tracks every emitted token
                self._drafters[s].update(toks[hits, s])
            if not still_active[s]:
                self._finish(req, now)
        self._active = still_active
        self._decode_steps += n_emitted
        self.telemetry.finish_step(
            ev, self.clock() if ev is not None else 0.0, tokens=n_emitted)
        return n_emitted

    def _spec_decode_step(self):
        """The phase scheduler's speculative step over all slots: the
        active rows' draft claims ride into one K+1-position verify pass
        (``FusedDecoder._build_verify_core``) and the host accepts. Below
        ``_spec_min_draft`` drafts an active row on average the plain
        decode chunk runs instead. Returns tokens emitted."""
        k, b = self.spec_k, self.num_slots
        drafts, dlen = propose_claims(
            self._drafters, [s for s in range(b) if self._active[s]], k,
            self._max_nt - self._nt)
        if int(dlen.sum()) < self._spec_min_draft * self._active.sum():
            return self._decode_one_chunk()
        toks = np.zeros((b, k + 1), np.int64)
        toks[:, 0] = self._tok
        toks[:, 1:] = drafts
        for s in range(b):
            if self._active[s]:
                # every valid draft write must land: map the K+1 window
                self._ensure_writable(
                    s, int(self._lens[s]),
                    min(int(self._lens[s]) + k + 1, self._budget_pos(s)))
        full_logits = self.do_sample
        vstep = self.dec._build_verify_core(k, self._rep_on,
                                            greedy_out=not full_logits)
        rep_pen, presence, _ = self._sample_args()
        out, ev = self._run_dispatch(
            ("verify", k), vstep,
            (self.dec._stacked(), self._cache_arg(), self._dev(toks),
             self._dev(self._lens), self._dev(dlen),
             self._dev(self._active, torch.bool), self._dev(self._nt),
             self._dev(self._eos), self._dev(self._min_len), rep_pen,
             presence),
            rows=int(self._active.sum()), drafts=int(dlen.sum()))
        out = self._host_out(out, full_logits)
        if full_logits:
            self._get_spec_rng()
        now = self.clock()
        n_emitted = 0
        for s in range(b):
            req = self._slot_req[s]
            if req is not None and self._active[s]:
                n_emitted += self._accept(s, req, drafts, dlen, out[s],
                                          full_logits, now)
        self.telemetry.finish_step(
            ev, self.clock() if ev is not None else 0.0, tokens=n_emitted)
        return n_emitted

    def _expire_deadlines(self, now):
        """Expire every request past its deadline_s: queued ones leave
        the queue before any prefill, running ones free their slot, and
        parked ones drop their host copy (the deadline runs on while
        parked)."""
        for q in self._queues.values():
            for req in [r for r in q if r.deadline_s is not None
                        and now - r.t_submit > r.deadline_s]:
                q.remove(req)
                self._finish(req, now, expired=True)
        for req in list(self._slot_req):
            if (req is not None and req.deadline_s is not None
                    and now - req.t_submit > req.deadline_s):
                self._finish(req, now, expired=True)
        for rid in [r for r, st in self._parked.items()
                    if st["deadline_s"] is not None
                    and now - self._req_index[r].t_submit
                    > st["deadline_s"]]:
            self._finish(self._req_index[rid], now, expired=True)

    def _finish(self, req, now, expired=False):
        """Finish (or, with ``expired``, shed) a request: its verdict and
        histograms (finished only), its result, its index entry unless a
        cursor holds it, its committed blocks, then its slot if it has
        one."""
        req.state = "expired" if expired else "finished"
        req.t_done = now
        if expired:
            self._expired += 1
        else:
            self._finished += 1
            t_adm = req.t_admit if req.t_admit is not None else now
            queue_s = max(t_adm - req.t_submit, 0.0)
            service_s = max(now - t_adm, 0.0)
            n = len(req.tokens)
            itl_s = (max(req.t_done - req.t_first, 0.0) / (n - 1)
                     if n > 1 and req.t_first is not None else 0.0)
            verdict = self._slo.classify(queue_s, service_s, req.ttft_s,
                                         itl_s, req.latency_s)
            if verdict == "ok":
                self._slo_ok += 1
            elif verdict == "queue":
                self._slo_violated_queue += 1
                self._slo_vq_class[req.priority] += 1
            else:
                self._slo_violated_service += 1
            self.telemetry.observe_request(req.ttft_s, req.latency_s,
                                           queue_s, service_s)
        self.telemetry.req_done(req.rid, req.state, now)
        self.results[req.rid] = req.result()
        while len(self.results) > self._results_cap:
            self.results.pop(next(iter(self.results)))
        if req.rid not in self._harvest:
            self._req_index.pop(req.rid, None)
        self._parked.pop(req.rid, None)
        if self.paged:
            self._kv_committed -= self._blocks_needed(req.prompt.size,
                                                      req.max_new_tokens)
        s = req.slot
        if s is None:                    # shed from the queue or the lot
            return
        self._slot_req[s] = None
        self._active[s] = False
        self._pf_left[s] = 0
        if self._presence is not None:
            self._presence[s] = False
        if self.paged:
            self._kv_reserved -= self._blocks_needed(req.prompt.size,
                                                     req.max_new_tokens)
        # the table row resets to the sentinel, so the idle row's writes
        # drop instead of landing; a ring's idle row keeps rewriting its
        # frozen position, which the next admission overwrites
        self._free_slot_blocks(s)


def _kv_payload_bytes(blocks):
    """Wire size of a KV handoff payload: the kv arrays plus the int8
    scales when present."""
    total = 0
    for blk in blocks:
        total += int(blk["kv"].nbytes)
        if "sc" in blk:
            total += int(blk["sc"].nbytes)
    return total
