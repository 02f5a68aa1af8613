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

Under either budget, a step with only decode rows runs the plain
``decode_chunk``-step scan instead, which moves more tokens. Host state
(lens, counts, block tables) lives in numpy and crosses to the device
once per dispatch. A dense engine has no pool: no block reservation, no
tables, and ``metrics()`` reports the ``kv_blocks_*`` and ``kv_shard_*``
gauges as None.

Every constructor argument that selects a path outside this slice
raises NotImplementedError naming its ROADMAP item; the engine reads no
environment variables.
"""
from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from ..ops.decode_attention import FLAT_CHUNK
from ..core.rng import next_key
from .generation import (FusedDecoder, _absmax_int8, _host_seed,
                         _penalize_slots, _sample_rows)
from .paged_kv import BlockPool
from .telemetry import (DEFAULT_RING, QOS_CLASSES, QOS_DEFAULT, SloPolicy,
                        Telemetry)

__all__ = ["ServingEngine", "ServedRequest"]

# constructor argument -> (values that stay in this slice, ROADMAP item)
_OUT_OF_SLICE = {
    "max_pending": ((None,), "Queue 1 item 6(f) (admission shedding)"),
    "prefix_cache_blocks": ((0, None), "Queue 1 item 6(c) (prefix caching)"),
    "prefix_cache": ((None,), "Queue 1 item 6(c) (prefix caching)"),
    "spec_k": ((None, 0), "Queue 1 item 6(d) (speculative decoding)"),
    "kv_pool": ((None,), "Queue 1 item 5 (BlockPool sharing, copy_block)"),
    "kv_pool_blocks": ((None,), "Queue 1 item 6(f) (explicit pool budget)"),
    "role": ((None, "mixed"), "Queue 1 item 6(f) (prefill/decode roles)"),
}


class ServedRequest:
    """One request's lifecycle: queued -> running -> finished."""

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
        # kept for the request spans of ROADMAP Queue 1 item 6(f), as the
        # JAX record keeps them
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
                "expired": False}


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
                 device=None):
        given = dict(max_pending=max_pending,
                     prefix_cache_blocks=prefix_cache_blocks,
                     prefix_cache=prefix_cache, spec_k=spec_k,
                     kv_pool=kv_pool, kv_pool_blocks=kv_pool_blocks,
                     role=role)
        for name, value in given.items():
            accepted, item = _OUT_OF_SLICE[name]
            if not any(value is a or value == a for a in accepted):
                raise NotImplementedError(
                    f"ServingEngine({name}={value!r}) selects a path the "
                    f"PyTorch port does not have yet: ROADMAP {item}")
        self.paged = paged is None or bool(paged)
        if weight_quant == "int4" and not self.paged:
            # JAX's refusal: int4 packed weights are a paged-serving memory
            # feature; the dense ring costs B x Smax regardless
            raise ValueError(
                "weight_quant='int4' with a dense KV ring: this engine "
                "resolved to the dense layout (paged=False) — int4 packed "
                "weights are a paged-serving memory feature; use "
                "paged=True or drop weight_quant")
        self.dec = FusedDecoder(fmt, embed, head, max_seq_len,
                                use_rotary=use_rotary,
                                weight_quant=weight_quant,
                                kv_quant=kv_quant, head_quant=head_quant,
                                device=device)
        self.device = self.dec.device
        self.num_slots = b = int(num_slots)
        self.smax = self.dec.smax
        self.role = "mixed"
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
        # the pool block size IS prefill_cap; the default pool holds
        # B x Smax/Bt blocks, so every admissible request fits
        self.pool = (BlockPool(b * (self.smax // cap), cap, self.smax)
                     if self.paged else None)
        self._kv_reserved = 0
        tb = int(token_budget if token_budget is not None
                 else b * 4 * self.decode_chunk)
        if tb < 0:
            raise ValueError(f"token_budget must be >= 0, got {tb}")
        if tb and tb < b:
            raise ValueError(
                f"token_budget={tb} < num_slots={b}: every active decode "
                "row claims one token per step (token_budget=0 selects "
                "the phase scheduler)")
        self.token_budget = tb
        cw = -(-tb // b) if tb else 1
        self._budget_cols = 1 << (cw - 1).bit_length()
        self._flat_budget = bool(flat_budget)
        if self._flat_budget and not tb:
            raise ValueError(
                "flat_budget needs the token-budget scheduler "
                "(token_budget > 0): token_budget=0 selects the phase "
                "scheduler, which has no budget step to flatten")
        self.clock = clock or time.perf_counter
        self.telemetry = Telemetry(telemetry_ring)
        self._slo = slo if slo is not None else SloPolicy()
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
        self._queue = deque()
        self.results = {}
        self._rid = itertools.count()
        self._tokens_emitted = 0
        self._busy_s = 0.0
        self._admitted = 0
        self._finished = 0
        self._decode_steps = 0
        self._budget_steps = 0
        self._budget_tokens_used = 0
        self._budget_prefill_tokens = 0
        self._budget_decode_tokens = 0
        self._budget_padding_tokens = 0
        self._slo_ok = 0
        self._slo_violated_queue = 0
        self._slo_violated_service = 0

    # ------------------------------------------------------------- public
    def submit(self, prompt, max_new_tokens=20, eos_token_id=None,
               min_length=0, repetition_penalty=1.0, deadline_s=None,
               trace_id=None, attempt=1, priority=QOS_DEFAULT):
        """Queue one request; returns its id. prompt + max_new_tokens
        must fit Smax (a slot's lens then never reaches Smax). JAX's
        parameters: ``repetition_penalty`` needs
        ``enable_repetition_penalty=True`` (ValueError without it, as in
        JAX); request expiry (``deadline_s``) and QoS classes other than
        the default (``priority``) are not ported yet (ROADMAP Queue 1
        item 6(f)); ``trace_id`` and ``attempt`` are kept on the
        request. A sampling engine draws the request's seed here."""
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
        if deadline_s is not None or priority != QOS_DEFAULT:
            raise NotImplementedError(
                f"submit: deadline_s={deadline_s!r}, priority={priority!r}: "
                "request expiry and QoS classes are not ported yet (ROADMAP "
                "Queue 1 item 6(f))")
        req = ServedRequest(next(self._rid), ids, max_new_tokens,
                            eos_token_id, min_length, repetition_penalty,
                            self.clock(), seed=self._fresh_seed(),
                            trace_id=trace_id, attempt=attempt)
        self._queue.append(req)
        return req.rid

    def _fresh_seed(self):
        """One per-request sampling seed off the global key stream (a
        greedy engine draws none, so submit order cannot move other
        consumers of the stream)."""
        return _host_seed(next_key()) if self.do_sample else 0

    @property
    def has_work(self):
        return (bool(self._queue) or bool(self._active.any())
                or bool((self._pf_left > 0).any()))

    @property
    def queue_depth(self):
        return len(self._queue)

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
        if self.token_budget:
            self._admit_chunked()
            emitted = self._budget_step()
        else:
            emitted = len(self._admit())
            if self._active.any():
                emitted += self._decode_one_chunk()
        self._busy_s += self.clock() - t0
        self._tokens_emitted += emitted
        if had_work:
            self.telemetry.observe_step_tokens(emitted)
        return emitted

    def run(self):
        """Drive until the queue and all slots drain."""
        while self.has_work:
            self.step()
        return self.results

    def metrics(self):
        tele = self.telemetry
        # a dense ring has no pool: its block and shard gauges are None
        pool, paged = self.pool, self.paged
        w_bytes = sum(a.numel() * a.element_size()
                      for a in self._weight_arrays())
        used, pad = self._budget_tokens_used, self._budget_padding_tokens
        return {
            "tokens_emitted": self._tokens_emitted,
            "busy_s": round(self._busy_s, 4),
            "tokens_per_sec": (
                round(self._tokens_emitted / self._busy_s, 2)
                if self._busy_s > 0
                else (0.0 if self._tokens_emitted else None)),
            "requests_finished": self._finished,
            "requests_admitted": self._admitted,
            "requests_admitted_high": 0,
            "requests_admitted_normal": self._admitted,
            "requests_admitted_low": 0,
            "tokens_emitted_high": 0,
            "tokens_emitted_normal": self._tokens_emitted,
            "tokens_emitted_low": 0,
            "requests_forked": 0, "requests_rejected": 0,
            "requests_expired": 0, "requests_migrated_in": 0,
            "requests_migrated_out": 0, "requests_preempted": 0,
            "requests_resumed": 0, "requests_parked": 0,
            "role": self.role,
            "kv_blocks_shipped": 0, "kv_blocks_adopted": 0,
            "queue_depth": self.queue_depth,
            "occupancy": self.occupancy,
            "traces": 0,
            "ttft_p50_s": tele.hist_ttft.percentile(50),
            "ttft_p90_s": tele.hist_ttft.percentile(90),
            "ttft_p99_s": tele.hist_ttft.percentile(99),
            "latency_p50_s": tele.hist_latency.percentile(50),
            "latency_p99_s": tele.hist_latency.percentile(99),
            "prefix_hits": 0, "prefix_misses": 0, "prefix_hit_rate": None,
            "prefill_tokens_saved": 0, "prefill_tokens_computed": 0,
            "decode_steps": self._decode_steps,
            "draft_proposed": 0, "draft_accepted": 0,
            "acceptance_rate": None,
            "tokens_per_step": (
                round(self._tokens_emitted / self._decode_steps, 4)
                if self._decode_steps else None),
            "kv_blocks_total": pool.num_blocks if paged else None,
            "kv_blocks_used": pool.used if paged else None,
            "kv_blocks_free": pool.free_count if paged else None,
            "kv_cow_copies": 0,
            "kv_shard_count": 1 if paged else None,
            "kv_shard_heads": self.dec.fmt.num_heads if paged else None,
            "kv_shard_pool_bytes": (sum(a.nbytes
                                        for a in self._caches.values())
                                    if paged else None),
            "weight_shard_count": 1,
            "weight_bytes_per_device": w_bytes,
            "weight_bytes_replicated": w_bytes,
            "budget_steps": self._budget_steps,
            "budget_tokens_used": used,
            "budget_prefill_tokens": self._budget_prefill_tokens,
            "budget_decode_tokens": self._budget_decode_tokens,
            "budget_draft_tokens": 0,
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

    def metrics_prometheus(self):
        from .telemetry import render_prometheus
        return render_prometheus(self)

    def _weight_arrays(self):
        """The tensors every dispatch reads: the stacked layer weights,
        the embedding and the LM head."""
        dec = self.dec
        return (list(dec._stacked().values())
                + [p.detach() for p in dec.embed.parameters()]
                + [p.detach() for p in dec.head.parameters()])

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
        reservation) when the pool cannot cover them. A ring reserves
        nothing: every slot owns Smax positions."""
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
        if got is None:
            raise RuntimeError(
                f"kv block pool over-committed: need {n} blocks, "
                f"{self.pool.free_count} free — the admission-time "
                "reservation should make this unreachable")
        return got

    def _budget_pos(self, slot):
        # one past the slot's last possible write position
        return (int(self._lens[slot]) - int(self._nt[slot])
                + int(self._max_nt[slot]))

    def _ensure_writable(self, slot, lo, hi):
        """Map every unmapped block of the write window [lo, hi) (a ring has
        nothing to map). Blocks are never shared in this slice (no prefix
        cache, no fork), so no copy-on-write is needed."""
        hi = min(int(hi), self.smax)
        if hi <= lo or not self.paged:
            return
        row = self._tables[slot]
        nb = self.pool.num_blocks
        bt = self.prefill_cap
        for j in range(int(lo) // bt, (hi - 1) // bt + 1):
            if int(row[j]) == nb:
                row[j] = self._alloc_kv_blocks(1)[0]

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

    # ------------------------------------------------------------- steps
    def _free_slots(self):
        return [i for i in range(self.num_slots)
                if not self._active[i] and self._slot_req[i] is None]

    def _admit_chunked(self):
        """Move queued requests into free slots (FIFO) while the pool can
        reserve their worst-case blocks; prefill happens in the budget
        steps."""
        free = self._free_slots()
        t_adm = self.clock()
        while free and self._queue and self._reserve(self._queue[0]):
            req = self._queue.popleft()
            s = free.pop(0)
            req.slot, req.state, req.t_admit = s, "running", t_adm
            self._slot_req[s] = req
            self._admitted += 1
            self._lens[s] = 0
            self._pf_left[s] = req.prompt.size
            self._nt[s] = 0
            self._max_nt[s] = req.max_new_tokens
            self._eos[s] = (-1 if req.eos_token_id is None
                            else int(req.eos_token_id))
            self._min_len[s] = req.min_length
            self._rep_pen[s] = req.repetition_penalty
            self._rseed[s] = req.seed
            self._active[s] = False          # decoding starts at finish
            self._seed_presence(req)

    # ------------------------------------------------- phase scheduler
    def _admit(self):
        """Phase-mode admission: move queued requests into free slots (FIFO)
        while the pool can reserve their worst-case blocks, prefill each
        one in its own bulk pass, then sample every admitted slot's first
        token in one dispatch over all B rows (the host reads only the
        admitted rows). Returns the admitted requests, each of which just
        emitted its first token."""
        free = self._free_slots()
        batch = []
        while free and self._queue and self._reserve(self._queue[0]):
            req = self._queue.popleft()
            req.slot, req.state = free.pop(0), "running"
            self._slot_req[req.slot] = req
            batch.append(req)
        if not batch:
            return []
        self._admitted += len(batch)
        t_adm = self.clock()
        stk = self.dec._stacked()
        f = self.dec.fmt
        last_x = torch.zeros((self.num_slots, 1, f.embed_dim),
                             dtype=f.qkv_weights[0].dtype, device=self.device)
        for r in batch:
            r.t_admit = t_adm
            self._map_blocks(r.slot, r.prompt.size)
            last_x[r.slot] = self._bulk_admit_row(stk, r)
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
            self._seed_presence(r)
        rep_pen, presence, seeds = self._sample_args()
        t0 = self.clock()
        nxt = self._build_admit_sample()(
            last_x, seeds, self._dev(self._eos), self._dev(self._min_len),
            rep_pen, presence)
        if presence is not None:
            rows = torch.tensor([r.slot for r in batch], device=self.device)
            presence[rows, nxt[rows]] = True
        nxt = nxt.cpu().numpy()
        self.telemetry.step_event("admit", t0, self.clock() - t0,
                                  rows=len(batch), tokens=len(batch))
        now = self.clock()
        self._decode_steps += len(batch)     # one sample event per row
        for r in batch:
            s = r.slot
            tok0 = int(nxt[s])
            r.t_first = now
            r.tokens.append(tok0)
            self._nt[s] = 1
            self._tok[s] = tok0
            hit_eos = (r.eos_token_id is not None
                       and tok0 == int(r.eos_token_id))
            self._active[s] = not hit_eos and r.max_new_tokens > 1
            if not self._active[s]:
                self._finish(r, now)
        return batch

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
        overwrites each pad position before any query reads it. Returns
        bulk_admit(stk, caches, toks, slot, plen) -> the hidden state of the
        last prompt token [1, E]."""
        dec = self.dec

        def bulk_admit(stk, caches, toks, slot, plen):
            x, kv_all = dec.bulk_hidden(stk, toks)
            kv = kv_all[:, :, 0]                         # [L, 2, H, sb, D]
            if "tbl" not in caches:
                if "sc" in caches:
                    kv, sc = _absmax_int8(kv, -1)
                    caches["sc"][:, :, slot, :, 0, :sb] = sc[..., 0]
                caches["kv"][:, :, slot, :, :sb] = kv
                return x[0, plen - 1][None]
            pool, row = caches["kv"], caches["tbl"][slot].long()
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
            return x[0, plen - 1][None]
        return bulk_admit

    def _bulk_admit_row(self, stk, req):
        plen = req.prompt.size
        sb = min(1 << (int(plen) - 1).bit_length(), self.smax)
        toks = np.zeros((1, sb), np.int64)
        toks[0, :plen] = req.prompt
        t0 = self.clock()
        row_x = self._build_bulk_admit(sb)(stk, self._cache_arg(),
                                           self._dev(toks), req.slot, plen)
        self.telemetry.step_event("prefill", t0, self.clock() - t0, rows=1,
                                  tokens=plen)
        return row_x

    def _dev(self, a, dtype=torch.int64):
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _prefill_allocations(self, pf_rows, budget, col_cap=None):
        """The prefill share of one budget dispatch, first come first
        served by request id: each prefilling row takes up to col_cap
        prompt tokens (the whole remaining budget when None) until the
        budget runs out. The JAX engine's single-QoS-class case. Returns
        ([(slot, n), ...] with n > 0, remaining budget)."""
        allocs = []
        for s in sorted(pf_rows, key=lambda s: self._slot_req[s].rid):
            if budget <= 0:
                break
            n = min(int(self._pf_left[s]), budget, col_cap or budget)
            allocs.append((s, n))
            budget -= n
        return allocs, budget

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
        chunks (oldest request first, at most C each) fill the rest. A
        step with only decode rows runs the plain decode chunk when that
        moves more tokens. Under flat_budget the block is the flat
        stream (``_flat_budget_step``). Returns tokens emitted."""
        b, c = self.num_slots, self._budget_cols
        dec_rows = [s for s in range(b) if self._active[s]]
        pf_rows = [s for s in range(b) if self._pf_left[s] > 0]
        if not dec_rows and not pf_rows:
            return 0
        # the JAX engine also weighs the draft columns here; they come
        # back with spec decoding (ROADMAP Queue 1 item 6(d))
        if not pf_rows and self.decode_chunk > 1:
            return self._decode_one_chunk()
        if self._flat_budget:
            return self._flat_budget_step(dec_rows, pf_rows)
        budget = self.token_budget - len(dec_rows)
        toks = np.zeros((b, c), np.int64)
        seg = np.zeros(b, np.int64)
        gen0 = np.full(b, c, np.int64)
        pf_n = np.zeros(b, np.int64)
        for s in dec_rows:
            toks[s, 0] = self._tok[s]
            seg[s] = 1
            gen0[s] = 0
        allocs, _ = self._prefill_allocations(pf_rows, budget, col_cap=c)
        for s, n in allocs:
            req = self._slot_req[s]
            p0 = req.prompt.size - int(self._pf_left[s])
            toks[s, :n] = req.prompt[p0:p0 + n]
            seg[s] = pf_n[s] = n
            if n == int(self._pf_left[s]):
                # the last prompt token's logits sample the first token
                gen0[s] = n - 1
        tail = max(self.decode_chunk - 1, 0)
        self._map_write_windows(seg, pf_n, tail)
        core = self.dec._build_budget_core(c, *self._sampling(),
                                           scan_tail=tail)
        t0 = self.clock()
        tok0, emit0, (ys_t, ys_e), tok, lens, active, nt = core(
            self.dec._stacked(), self._cache_arg(), self._dev(toks),
            self._dev(self._lens), self._dev(seg), self._dev(gen0),
            self._dev(self._nt), self._dev(self._max_nt),
            self._dev(self._eos), self._dev(self._min_len),
            *self._sample_args())
        res = [t.cpu().numpy() for t in (tok0, emit0, ys_t, ys_e, tok, lens,
                                         active, nt)]
        self.telemetry.step_event("budget", t0, self.clock() - t0,
                                  rows=int((seg > 0).sum()))
        self._count_budget(int(seg.sum()), b * c, pf_n, len(dec_rows))
        return self._harvest_budget_plain(res, pf_n, tail)

    def _count_budget(self, used, computed, pf_n, n_decode):
        # padding: the positions a dispatch computed beyond the packed ones
        self._budget_steps += 1
        self._budget_tokens_used += used
        self._budget_prefill_tokens += int(pf_n.sum())
        self._budget_decode_tokens += n_decode
        self._budget_padding_tokens += computed - used

    def _flat_budget_step(self, dec_rows, pf_rows):
        """One token-flattened budget dispatch: a [T = b + ts] stream whose
        tokens [0, b) are the decode region (token i is slot i's input when
        it decodes, else the slot sentinel b) and whose segments — prefill
        chunks, first come first served with no column cap — start on
        FLAT_CHUNK boundaries. ts comes from an eighth-octave ladder: the
        aligned width rounded up to a multiple of next_pow2(width) / 8.
        Returns tokens emitted."""
        b = self.num_slots
        budget = self.token_budget - len(dec_rows)
        pf_n = np.zeros(b, np.int64)
        segs = []                              # (slot, prompt tokens)
        allocs, _ = self._prefill_allocations(pf_rows, budget)
        for s, n in allocs:
            req = self._slot_req[s]
            p0 = req.prompt.size - int(self._pf_left[s])
            segs.append((s, req.prompt[p0:p0 + n]))
            pf_n[s] = n
        align = FLAT_CHUNK
        starts, cursor = [], 0
        for _, tk in segs:
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
        cslot = np.zeros(nc, np.int32)
        cbase = np.zeros(nc, np.int32)
        cn = np.zeros(nc, np.int32)
        last_idx = np.zeros(b, np.int64)
        emit0 = np.zeros(b, bool)
        adv = np.zeros(b, np.int64)
        for s in dec_rows:
            toks[s] = self._tok[s]
            tslot[s] = s
            tpos[s] = self._lens[s]
            last_idx[s] = s
            emit0[s] = True
            adv[s] = 1
        for (s, tk), st in zip(segs, starts):
            n = len(tk)
            base = int(self._lens[s])
            sl = slice(b + st, b + st + n)
            toks[sl] = tk
            tslot[sl] = s
            tpos[sl] = base + np.arange(n)
            last_idx[s] = b + st + n - 1
            adv[s] = n
            # the last prompt token's logits sample the first token;
            # chunks in the middle of a prompt never emit
            emit0[s] = pf_n[s] == self._pf_left[s]
            for ci in range(st // align, (st + n - 1) // align + 1):
                cslot[ci] = s
                cbase[ci] = base + (ci * align - st)
                cn[ci] = min(n - (ci * align - st), align)
        tail = max(self.decode_chunk - 1, 0)
        self._map_write_windows(adv, pf_n, tail)
        core = self.dec._build_flat_budget_core(b, *self._sampling(),
                                                scan_tail=tail)
        i32 = torch.int32
        t0 = self.clock()
        tok0, emit0_d, (ys_t, ys_e), tok, lens, active, nt = core(
            self.dec._stacked(), self._cache_arg(), self._dev(toks),
            self._dev(tslot), self._dev(tpos), self._dev(cslot, i32),
            self._dev(cbase, i32), self._dev(cn, i32), self._dev(self._tok),
            self._dev(last_idx), self._dev(emit0, torch.bool),
            self._dev(adv), self._dev(self._lens), self._dev(self._nt),
            self._dev(self._max_nt), self._dev(self._eos),
            self._dev(self._min_len), *self._sample_args())
        res = [t.cpu().numpy() for t in (tok0, emit0_d, ys_t, ys_e, tok,
                                         lens, active, nt)]
        self.telemetry.step_event("budget", t0, self.clock() - t0,
                                  rows=int((adv > 0).sum()))
        used = len(dec_rows) + int(pf_n.sum())
        self._count_budget(used, t_total, pf_n, len(dec_rows))
        return self._harvest_budget_plain(res, pf_n, tail)

    def _harvest_budget_plain(self, res, pf_n, tail):
        """Walk the dispatch's tokens and finish events; the core already
        advanced every row's state on the device."""
        tok0, emit0, ys_t, ys_e, tokc, lensc, activec, ntc = res
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
            if not emit0[s] and not prev_active[s]:
                continue                 # still prefilling
            row_toks = []
            if emit0[s]:
                row_toks.append(int(tok0[s]))
                if pf_n[s]:              # the prompt finished here
                    req.t_first = now
            if tail:
                row_toks.extend(int(t) for t in ys_t[ys_e[:, s], s])
            req.tokens.extend(row_toks)
            n_emitted += len(row_toks)
            self._decode_steps += len(row_toks)
            if not still_active[s]:
                self._finish(req, now)
        self._active = still_active
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
        run = self._build_decode_chunk()
        t0 = self.clock()
        (tok, lens, active, nt), (toks, emitted) = run(
            self.dec._stacked(), self._cache_arg(), self._dev(self._tok),
            self._dev(self._lens), self._dev(self._active, torch.bool),
            self._dev(self._nt), self._dev(self._max_nt),
            self._dev(self._eos), self._dev(self._min_len),
            *self._sample_args())
        toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
        self._tok, self._lens = tok.cpu().numpy(), lens.cpu().numpy()
        self._nt = nt.cpu().numpy()
        still_active = active.cpu().numpy()
        self.telemetry.step_event("decode", t0, self.clock() - t0,
                                  rows=int(self._active.sum()))
        n_emitted = 0
        now = self.clock()
        for s in range(self.num_slots):
            req = self._slot_req[s]
            if req is None or not self._active[s]:
                continue
            hits = emitted[:, s]
            req.tokens.extend(int(t) for t in toks[hits, s])
            n_emitted += int(hits.sum())
            if not still_active[s]:
                self._finish(req, now)
        self._active = still_active
        self._decode_steps += n_emitted
        return n_emitted

    def _finish(self, req, now):
        req.state = "finished"
        req.t_done = now
        self._finished += 1
        t_adm = req.t_admit if req.t_admit is not None else now
        queue_s = max(t_adm - req.t_submit, 0.0)
        service_s = max(now - t_adm, 0.0)
        n = len(req.tokens)
        itl_s = (max(req.t_done - req.t_first, 0.0) / (n - 1)
                 if n > 1 and req.t_first is not None else 0.0)
        verdict = self._slo.classify(queue_s, service_s, req.ttft_s, itl_s,
                                     req.latency_s)
        if verdict == "ok":
            self._slo_ok += 1
        elif verdict == "queue":
            self._slo_violated_queue += 1
        else:
            self._slo_violated_service += 1
        self.telemetry.observe_request(req.ttft_s, req.latency_s, queue_s,
                                       service_s)
        self.telemetry.req_done(req.rid, req.state, req.t_submit, now)
        self.results[req.rid] = req.result()
        while len(self.results) > self._results_cap:
            self.results.pop(next(iter(self.results)))
        s = req.slot
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
