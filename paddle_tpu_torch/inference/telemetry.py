"""Serving telemetry: request spans, step timeline, bounded histograms,
Prometheus and Chrome-trace export.

A copy of ``paddle_tpu/inference/telemetry.py`` under the same names and
contracts (it is host-only: stdlib and numpy), so the port's engine and
cluster read and write the same payloads as the JAX package's:

  * ``Telemetry`` — per-engine event collector. Per-request lifecycle
    spans (queued -> admitted -> prefix-adopt -> prefill chunks ->
    first token -> decode/verify dispatches -> finished|expired|
    rejected|migrated, on the engine's clock) and a step timeline (one
    event per dispatch: its kind from ``generation.dispatch_kind``, rows
    packed, budget used/wasted, draft tokens, dispatch vs host-side
    elapsed, gauge snapshots), both in bounded rings of ``ring`` entries
    (default 2048; ``0`` disables span and step collection, one branch
    per event).
  * ``LogHistogram`` — fixed-size log2-bucketed streaming histograms
    (TTFT, latency, tokens per step, queue and service time, handoff
    bytes): O(1) memory and observe, percentiles within one bucket
    width, exact counts. They stay on with the ring off.
  * ``export_chrome_tracing(engine, path)`` — the rings as Chrome-trace
    JSON (one pid per engine, one tid per slot plus a dispatch timeline,
    counter tracks), for chrome://tracing or Perfetto.
  * ``render_prometheus(engine)`` / ``parse_prometheus(text)`` — the
    text exposition under the stable names of ``PROMETHEUS_NAMES``
    (counters monotonic across ``reset_metrics``: the engine folds each
    window into a lifetime base), plus ``runtime_prometheus()``, the
    process-global runtime registry.
  * ``snapshot(engine)`` — the JSON routing payload the cluster router
    reads per replica (schema ``SNAPSHOT_SCHEMA_VERSION``).
  * ``SloPolicy`` — declared latency objectives; each finished request
    is classified ok, violated by queueing or violated by service.
  * ``trace_dump(engine)`` — the per-replica payload
    ``serving_cluster.trace.export_cluster_trace`` merges into one
    cluster trace (spans carry the gateway's ``trace_id``/``attempt``; a
    wall/monotonic anchor pair rebases them).
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque

import numpy as np

__all__ = ["LogHistogram", "Telemetry", "RequestTrace", "SloPolicy",
           "export_chrome_tracing", "render_prometheus",
           "parse_prometheus", "snapshot", "trace_dump",
           "runtime_histogram",
           "runtime_counter", "runtime_prometheus",
           "runtime_registry_snapshot", "PROMETHEUS_NAMES",
           "PROMETHEUS_EXEMPT_KEYS", "RESET_EXEMPT_KEYS", "DEFAULT_RING",
           "SNAPSHOT_SCHEMA_VERSION", "SNAPSHOT_REQUIRED_KEYS",
           "SNAPSHOT_OPTIONAL_KEYS", "SLO_ENV_VARS", "QOS_CLASSES",
           "QOS_DEFAULT", "QOS_RANK", "DEFAULT_QOS_SHARES"]

DEFAULT_RING = 2048

# ---- QoS priority classes -------------------------------------------
# The canonical class set, best-first: admission, preemption-victim
# selection, and the weighted-fair packer all rank by position in this
# tuple. It lives here (a host-only module) so the cluster protocol
# (serving_cluster/protocol.py) can validate the X-Priority header
# without importing the engine.
QOS_CLASSES = ("high", "normal", "low")
QOS_DEFAULT = "normal"
QOS_RANK = {c: i for i, c in enumerate(QOS_CLASSES)}
# weighted-fair token-budget shares (PADDLE_QOS_SHARES overrides,
# "high=4,normal=2,low=1" syntax): a class's share of the SPARE prefill
# budget when several classes are prefilling at once — work-conserving,
# so an idle class's share spills to the hungry ones
DEFAULT_QOS_SHARES = {"high": 4, "normal": 2, "low": 1}

# ---- telemetry_snapshot() wire contract -----------------------------
# The snapshot IS a wire payload now: the cluster router
# (serving_cluster/router.py) reads it over rpc to place requests, so
# its key set is pinned structurally (tools/check_metrics_surface.py
# fails on drift, the same discipline as PROMETHEUS_NAMES).
# Bump SNAPSHOT_SCHEMA_VERSION on any key addition/removal/semantic
# change — a router seeing an unknown version refuses to score the
# replica instead of silently misreading it.
# v2: added the "slo" block (declared objectives + goodput counters)
# and the queue_s/service_s decomposition histograms — the signals the
# autoscaling item consumes.
# v3: the "requests" block gains migrated_in/migrated_out (live session
# migration — the autoscaler's drain accounting).
# v4: per-class QoS — top-level "queue_depths" ({class: depth}, the
# router/gateway shed signal), the "requests" block gains
# preempted/resumed (preemption-to-host accounting), and the "slo"
# block gains "violated_queue_by_class" (the autoscaler scales up on
# HIGH-priority queue violations only; low-priority backlog is the QoS
# layer degrading gracefully, not a capacity signal).
# v5: disaggregated serving — top-level "role" (prefill|decode|mixed;
# the router's placement filter and the autoscaler's pool split) and
# the "handoff" block (kv_blocks_shipped/adopted — the streamed
# prefill->decode KV transfer accounting). Routers older than v5 must
# refuse rather than place decode traffic on a prefill-only replica.
# v6: gray-failure defense — top-level "do_sample" (engine sampling
# mode: the router's hedged-dispatch safety gate — only a GREEDY
# stream is bit-identical across replicas, so only do_sample=False
# traffic may hedge) and the "health" block (step_ewma_s — the
# engine's own smoothed step duration, the replica-local slowness
# signal the router's median-relative health scorer consumes).
# v7: tensor-parallel weights — the "weights" block (shard_count /
# bytes_per_device / bytes_replicated — the per-chip HBM residency of
# the serving step's weight arrays; (per_device - replicated) x
# shard_count + replicated == the dense byte total). The capacity
# planner's model-fits-here signal for mp-sharded replicas.
# v8: quantized serving — the "weights" block gains weight_quant
# ("none"|"int8"|"int4") and kv_quant ("none"|"int8"): the byte gauges
# already report QUANTIZED residency (packed arrays + scale mirrors at
# their true size), so without the mode fields a capacity planner
# cannot tell a small fp model from a quantized large one, and a
# router cannot refuse to mix quantized/fp replicas in a greedy-parity
# hedge pool.
SNAPSHOT_SCHEMA_VERSION = 8

# keys every snapshot carries, on every engine configuration
SNAPSHOT_REQUIRED_KEYS = frozenset({
    "schema_version", "queue_depth", "occupancy", "num_slots",
    "slots_free", "prefill_cap", "has_work", "tokens_per_sec",
    "requests", "histograms", "budget", "prefix", "spans_logged",
    "steps_logged", "telemetry_ring", "slo", "queue_depths",
    "role", "handoff", "do_sample", "health", "weights",
})

# keys present only on some configurations (paged pool / spec decode)
SNAPSHOT_OPTIONAL_KEYS = frozenset({"kv_blocks", "drafter"})


# ------------------------------------------------------------------ SLO
# Declared latency objectives (the goodput contract), read only by
# SloPolicy.from_env (the cluster's __main__); registered in
# testing.GW_ENV_VARS — a leaked objective silently flips every later
# engine's goodput counters.
SLO_ENV_VARS = ("PADDLE_SLO_TTFT_S", "PADDLE_SLO_ITL_S",
                "PADDLE_SLO_E2E_S")


class SloPolicy:
    """Declared per-request latency objectives (``PADDLE_SLO_*``):

      * ``ttft_s``  — time to first token (submit -> first token);
      * ``itl_s``   — MEAN inter-token latency over the request
        ((t_done - t_first) / (n - 1)); the fleet-level p99 is read off the latency histograms — per-token
        timestamps are not recorded (tokens harvest in batches), so a
        within-request p99 would be an invention, not a measurement;
      * ``e2e_s``   — end-to-end latency (submit -> finished).

    Unset objectives are never violated, so a no-knob engine counts
    every finished request as ``slo_ok`` and the reconciliation
    ``slo_ok + slo_violated_* == requests_finished`` holds universally.

    ``classify`` attributes a violation to where the request spent its
    time: ``queue`` when the queue wait (submit -> admitted) was at
    least the service time, else ``service`` — the split the
    autoscaler needs (queued-too-long = add replicas; slow-service =
    the engine itself is the bottleneck)."""

    __slots__ = ("ttft_s", "itl_s", "e2e_s")

    def __init__(self, ttft_s=None, itl_s=None, e2e_s=None):
        for name, v in (("ttft_s", ttft_s), ("itl_s", itl_s),
                        ("e2e_s", e2e_s)):
            if v is not None and float(v) <= 0:
                raise ValueError(f"SLO objective {name} must be > 0, "
                                 f"got {v}")
        self.ttft_s = None if ttft_s is None else float(ttft_s)
        self.itl_s = None if itl_s is None else float(itl_s)
        self.e2e_s = None if e2e_s is None else float(e2e_s)

    @classmethod
    def from_env(cls):
        def _f(name):
            v = os.environ.get(name)
            return None if v in (None, "") else float(v)
        return cls(_f("PADDLE_SLO_TTFT_S"), _f("PADDLE_SLO_ITL_S"),
                   _f("PADDLE_SLO_E2E_S"))

    @property
    def enabled(self):
        return (self.ttft_s is not None or self.itl_s is not None
                or self.e2e_s is not None)

    def objectives(self):
        return {"ttft_s": self.ttft_s, "itl_s": self.itl_s,
                "e2e_s": self.e2e_s}

    def classify(self, queue_s, service_s, ttft_s, itl_s, e2e_s):
        """``"ok" | "queue" | "service"`` for one finished request."""
        violated = (
            (self.ttft_s is not None and ttft_s is not None
             and ttft_s > self.ttft_s)
            or (self.itl_s is not None and itl_s is not None
                and itl_s > self.itl_s)
            or (self.e2e_s is not None and e2e_s is not None
                and e2e_s > self.e2e_s))
        if not violated:
            return "ok"
        return "queue" if queue_s >= service_s else "service"


# ---------------------------------------------------------------- histogram
class LogHistogram:
    """Fixed-size log2-bucketed streaming histogram.

    Buckets: one underflow bucket [0, lo), then ``buckets_per_octave``
    geometric buckets per factor-of-two up to ``hi``, then one overflow
    bucket. Percentile estimates interpolate linearly inside the target
    bucket, so they sit within ONE bucket width of the exact value —
    the accuracy/footprint trade the serving metrics need (memory is a
    few hundred int64s forever, vs one dict per finished request).

    Two layers of counts: the WINDOW (what ``percentile``/``count``
    read; ``reset()`` zeroes it) and a lifetime BASE ``reset()`` folds
    the window into — ``cumulative_counts()`` reads window + base, so
    Prometheus counters stay monotonic across ``reset_metrics``.
    """

    __slots__ = ("edges", "counts", "total", "sum",
                 "_base", "_base_total", "_base_sum", "bpo")

    def __init__(self, lo=1e-6, hi=1e4, buckets_per_octave=4):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.bpo = int(buckets_per_octave)
        n = int(math.ceil(math.log2(hi / lo) * self.bpo))
        self.edges = lo * np.power(2.0, np.arange(n + 1) / self.bpo)
        self.counts = np.zeros(n + 2, np.int64)   # under + n + over
        self._base = np.zeros(n + 2, np.int64)
        self.total = 0
        self.sum = 0.0
        self._base_total = 0
        self._base_sum = 0.0

    @property
    def count(self):
        return self.total

    def observe(self, value):
        v = max(float(value), 0.0)
        # side="left": a value EXACTLY on a bucket edge belongs to the
        # bucket that edge closes (buckets are (lo, hi]) — Prometheus'
        # `le` boundaries are inclusive, so the text exposition's
        # cumulative count at le=edge must include edge-valued samples
        # (integer-valued series like tokens-per-step land exactly on
        # the pow-2 edges every time)
        i = int(np.searchsorted(self.edges, v, side="left"))
        self.counts[i] += 1
        self.total += 1
        self.sum += v

    def _bucket_bounds(self, i):
        """(lo, hi] of bucket index ``i`` (0 = underflow; the overflow
        bucket is clamped to its lower edge — an estimate can never
        exceed the histogram's stated range)."""
        n = self.edges.size
        lo = 0.0 if i == 0 else float(self.edges[i - 1])
        hi = float(self.edges[min(i, n - 1)])
        return lo, hi

    def percentile(self, q):
        """Estimated q-th percentile (linear interpolation inside the
        target bucket); None when the window is empty."""
        if self.total == 0:
            return None
        target = (q / 100.0) * self.total
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo, hi = self._bucket_bounds(i)
                frac = min(max((target - cum) / c, 0.0), 1.0)
                return float(lo + frac * (hi - lo))
            cum += c
        lo, hi = self._bucket_bounds(len(self.counts) - 1)
        return float(hi)

    def bucket_width_at(self, value):
        """Width of the bucket containing ``value`` — the documented
        bound on the percentile estimation error. Same edge rule as
        observe: a value on an edge belongs to the bucket it closes."""
        v = max(float(value), 0.0)
        i = int(np.searchsorted(self.edges, v, side="left"))
        lo, hi = self._bucket_bounds(i)
        return hi - lo

    def reset(self):
        """Zero the window, folding it into the lifetime base (the
        Prometheus exposition never moves backwards)."""
        self._base += self.counts
        self._base_total += self.total
        self._base_sum += self.sum
        self.counts[:] = 0
        self.total = 0
        self.sum = 0.0

    def cumulative_counts(self):
        """(bucket counts, total, sum) over the histogram's LIFETIME
        (window + every reset-folded window)."""
        return (self._base + self.counts, self._base_total + self.total,
                self._base_sum + self.sum)

    def snapshot(self):
        return {"count": int(self.total), "sum": round(float(self.sum), 6),
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def prometheus_lines(self, name, help_text=""):
        """Prometheus histogram exposition over the LIFETIME counts.
        Bucket boundaries are decimated to one per octave (the full
        sub-octave resolution stays available to ``percentile``; the
        text format does not need 130 lines per histogram)."""
        counts, total, total_sum = self.cumulative_counts()
        lines = [f"# HELP {name} {help_text or name}",
                 f"# TYPE {name} histogram"]
        for i in range(0, self.edges.size, self.bpo):
            # le=edges[i] covers buckets 0..i (underflow + everything
            # strictly below that edge)
            cum = int(counts[: i + 1].sum())
            lines.append(f'{name}_bucket{{le="{self.edges[i]:.6g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {int(total)}')
        lines.append(f"{name}_sum {float(total_sum):.9g}")
        lines.append(f"{name}_count {int(total)}")
        return lines


# ------------------------------------------------------------ request spans
class RequestTrace:
    """One request's lifecycle span: ordered (event, t) pairs on the
    engine clock. Lives in ``Telemetry._live`` while in flight, moves
    to the bounded ``spans`` ring at finish/expiry/rejection.

    ``trace_id``/``attempt`` are the CLUSTER trace context: the gateway
    mints one trace id per HTTP request and the router threads it
    through every placement (attempt increments across failover
    re-submits), so a kill-drill stream yields ONE joined trace across
    gateway, router, and both replicas."""

    __slots__ = ("rid", "slot", "state", "events", "trace_id", "attempt")

    def __init__(self, rid, slot=None, trace_id=None, attempt=1):
        self.rid = rid
        self.slot = slot
        self.state = "queued"
        self.events = []                  # [(name, t_monotonic), ...]
        self.trace_id = trace_id
        self.attempt = int(attempt)

    def t0(self):
        return self.events[0][1] if self.events else 0.0

    def t1(self):
        return self.events[-1][1] if self.events else 0.0


class Telemetry:
    """Per-engine telemetry collector (see the module docstring).

    Every ``req_*``/``step_event`` entry point starts with ONE enabled
    branch; call sites are expected to guard their own timestamp
    computation on ``self.enabled`` so a disabled ring costs no clock
    reads. The histograms are independent of the ring and stay on
    (they are the ``metrics()`` percentile source). ``ring=None`` is
    ``DEFAULT_RING``: the port reads no PADDLE_TELEMETRY_RING."""

    def __init__(self, ring=None, clock=None):
        ring = DEFAULT_RING if ring is None else int(ring)
        if ring < 0:
            raise ValueError(f"telemetry ring must be >= 0, got {ring}")
        self.ring = int(ring)
        self.enabled = self.ring > 0
        self.clock = clock or time.perf_counter
        self.spans = deque(maxlen=max(self.ring, 1))
        self.steps = deque(maxlen=max(self.ring, 1))
        self._live = {}                   # rid -> RequestTrace
        self.hist_ttft = LogHistogram(1e-6, 1e4)
        self.hist_latency = LogHistogram(1e-6, 1e4)
        self.hist_step_tokens = LogHistogram(1.0, 1 << 16)
        # queue-time vs service-time decomposition (the SLO layer's
        # cause attribution + the autoscaler's queue-pressure signal);
        # like the other histograms these stay on with the ring off
        self.hist_queue = LogHistogram(1e-6, 1e4)
        self.hist_service = LogHistogram(1e-6, 1e4)
        # disaggregated-serving KV transfer sizes (bytes per handoff
        # payload: export_slot kv + streamed export_kv_prefix chunks) —
        # stays on with the ring off like the latency histograms
        self.hist_handoff = LogHistogram(64.0, 1e9)

    # ------------------------------------------------------- request spans
    def req_queued(self, rid, t, trace_id=None, attempt=1):
        if not self.enabled:
            return
        tr = RequestTrace(rid, trace_id=trace_id, attempt=attempt)
        tr.events.append(("queued", t))
        self._live[rid] = tr

    def req_admitted(self, rid, slot, t):
        if not self.enabled:
            return
        tr = self._live.get(rid)
        if tr is not None:
            tr.slot = slot
            tr.events.append(("admitted", t))

    def req_event(self, rid, name, t):
        if not self.enabled:
            return
        tr = self._live.get(rid)
        if tr is not None:
            tr.events.append((name, t))

    def req_done(self, rid, state, t):
        if not self.enabled:
            return
        tr = self._live.pop(rid, None)
        if tr is None:                    # never tracked (ring was off
            tr = RequestTrace(rid)        # at submit); synthesize
        tr.state = state
        tr.events.append((state, t))
        self.spans.append(tr)

    def req_rejected(self, t, rid=None, trace_id=None, attempt=1):
        """Sheds never get a rid — record a one-event span directly.
        ``attempt`` matters for failover re-submits that shed: the
        merged cluster trace must attribute the rejection to the
        placement attempt that actually hit this replica."""
        if not self.enabled:
            return
        tr = RequestTrace(rid, trace_id=trace_id, attempt=attempt)
        tr.state = "rejected"
        tr.events.append(("rejected", t))
        self.spans.append(tr)

    # ------------------------------------------------------- step timeline
    def step_event(self, kind, t, dur_s, rows=0, tokens=0,
                   traces_delta=0, **gauges):
        """One dispatch on the timeline; returns the record so
        the caller can attach harvest results (tokens, host_s) once the
        host side finishes. None when disabled."""
        if not self.enabled:
            return None
        ev = {"kind": kind, "t": t, "dur_s": dur_s, "rows": int(rows),
              "tokens": int(tokens), "traces_delta": int(traces_delta)}
        ev.update(gauges)
        self.steps.append(ev)
        return ev

    @staticmethod
    def finish_step(ev, now, tokens=None):
        """Close a step record: host-side elapsed = everything between
        the dispatch returning and the harvest completing."""
        if ev is None:
            return
        if tokens is not None:
            ev["tokens"] = int(tokens)
        ev["host_s"] = round(max(0.0, now - ev["t"] - ev["dur_s"]), 9)

    # --------------------------------------------------------- histograms
    def observe_request(self, ttft_s, latency_s, queue_s=None,
                        service_s=None):
        if ttft_s is not None:
            self.hist_ttft.observe(ttft_s)
        if latency_s is not None:
            self.hist_latency.observe(latency_s)
        if queue_s is not None:
            self.hist_queue.observe(queue_s)
        if service_s is not None:
            self.hist_service.observe(service_s)

    def observe_step_tokens(self, n):
        self.hist_step_tokens.observe(n)

    def observe_handoff(self, nbytes):
        self.hist_handoff.observe(nbytes)

    def reset(self):
        """Window reset (rides ``engine.reset_metrics``): clears the
        rings so the next export covers exactly the measured window,
        folds the histograms' windows into their lifetime bases.
        In-flight spans survive — their requests are still live."""
        self.spans.clear()
        self.steps.clear()
        self.hist_ttft.reset()
        self.hist_latency.reset()
        self.hist_step_tokens.reset()
        self.hist_queue.reset()
        self.hist_service.reset()
        self.hist_handoff.reset()


# -------------------------------------------------------- runtime registry
# Process-global metrics the distributed runtime feeds (rpc call
# latency, error counts); folded into every engine's exposition and
# into runtime_prometheus() for engine-less processes.
_runtime_hists: dict = {}
_runtime_counters: dict = {}


def runtime_histogram(name, lo=1e-6, hi=1e3):
    h = _runtime_hists.get(name)
    if h is None:
        h = _runtime_hists[name] = LogHistogram(lo, hi)
    return h


def runtime_counter(name, inc=0):
    _runtime_counters[name] = _runtime_counters.get(name, 0) + inc
    return _runtime_counters[name]


def runtime_registry_snapshot():
    """JSON-able snapshot of the process-global runtime registry
    (counter values + histogram percentile summaries) — embedded in
    flight-recorder dumps and cluster snapshots so a post-mortem sees
    the rank's rpc/collective latency state without scraping
    Prometheus."""
    return {"counters": dict(sorted(_runtime_counters.items())),
            "histograms": {name: _runtime_hists[name].snapshot()
                           for name in sorted(_runtime_hists)}}


def runtime_prometheus():
    """Runtime gauges: the supervisor restart generation and whatever
    the runtime registry accumulated (the gateway's HTTP latency, rpc
    latency and errors)."""
    lines = []

    def gauge(name, value, help_text="", labels=""):
        lines.append(f"# HELP {name} {help_text or name}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {value:g}")

    gen = int(os.environ.get("PADDLE_RESTART_COUNT", "0") or 0)
    gauge("paddle_runtime_restart_generation", gen,
          "gang supervisor restart generation (PADDLE_RESTART_COUNT)")
    # the watchdog's heartbeat-age and peer-failure gauges come with the
    # distributed runtime (ROADMAP 10(e)); JAX's exposition skips them too
    # while no watchdog runs
    for name in sorted(_runtime_counters):
        lines.append(f"# HELP {name} {name}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_runtime_counters[name]}")
    for name in sorted(_runtime_hists):
        lines.extend(_runtime_hists[name].prometheus_lines(name))
    return lines


# --------------------------------------------------- prometheus exposition
# STABLE name (and type) for every key ServingEngine.metrics() can emit.
# tools/check_metrics_surface.py asserts the mapping is total: a future
# counter that skips this table fails a test instead of silently missing
# from the exposition. Percentile keys map to their backing histogram.
PROMETHEUS_NAMES = {
    "tokens_emitted": ("paddle_serving_tokens_emitted_total", "counter"),
    "busy_s": ("paddle_serving_busy_seconds_total", "counter"),
    "tokens_per_sec": ("paddle_serving_tokens_per_sec", "gauge"),
    "requests_finished": ("paddle_serving_requests_finished_total",
                          "counter"),
    "requests_admitted": ("paddle_serving_requests_admitted_total",
                          "counter"),
    "requests_forked": ("paddle_serving_requests_forked_total", "counter"),
    "requests_rejected": ("paddle_serving_requests_rejected_total",
                          "counter"),
    "requests_expired": ("paddle_serving_requests_expired_total",
                         "counter"),
    "requests_migrated_in": (
        "paddle_serving_requests_migrated_in_total", "counter"),
    "requests_migrated_out": (
        "paddle_serving_requests_migrated_out_total", "counter"),
    # disaggregated KV handoff: blocks this engine read out for another
    # engine (export_slot / streamed export_kv_prefix) vs blocks
    # written into this pool from another engine (import_slot /
    # stage_kv_blocks) — the prefill->decode transfer volume
    "kv_blocks_shipped": ("paddle_serving_kv_blocks_shipped_total",
                          "counter"),
    "kv_blocks_adopted": ("paddle_serving_kv_blocks_adopted_total",
                          "counter"),
    # QoS preemption-to-host: preempted left their slot for the host-RAM
    # parking lot (same rid, stream intact), resumed re-entered a slot;
    # preempted >= resumed always (the difference is currently parked)
    "requests_preempted": ("paddle_serving_requests_preempted_total",
                           "counter"),
    "requests_resumed": ("paddle_serving_requests_resumed_total",
                         "counter"),
    "requests_parked": ("paddle_serving_requests_parked", "gauge"),
    # per-class QoS counters as LABELED series of one family (the three
    # entries share a family name; render_prometheus emits HELP/TYPE
    # once per family and one labeled sample per key, zero-initialized
    # so every class is discoverable before traffic arrives)
    "requests_admitted_high": (
        'paddle_serving_class_requests_admitted_total{class="high"}',
        "counter"),
    "requests_admitted_normal": (
        'paddle_serving_class_requests_admitted_total{class="normal"}',
        "counter"),
    "requests_admitted_low": (
        'paddle_serving_class_requests_admitted_total{class="low"}',
        "counter"),
    "tokens_emitted_high": (
        'paddle_serving_class_tokens_emitted_total{class="high"}',
        "counter"),
    "tokens_emitted_normal": (
        'paddle_serving_class_tokens_emitted_total{class="normal"}',
        "counter"),
    "tokens_emitted_low": (
        'paddle_serving_class_tokens_emitted_total{class="low"}',
        "counter"),
    "queue_depth": ("paddle_serving_queue_depth", "gauge"),
    "occupancy": ("paddle_serving_slot_occupancy", "gauge"),
    "traces": ("paddle_serving_compiled_traces_total", "counter"),
    "ttft_p50_s": ("paddle_serving_ttft_seconds", "histogram"),
    "ttft_p90_s": ("paddle_serving_ttft_seconds", "histogram"),
    "ttft_p99_s": ("paddle_serving_ttft_seconds", "histogram"),
    "latency_p50_s": ("paddle_serving_request_latency_seconds",
                      "histogram"),
    "latency_p99_s": ("paddle_serving_request_latency_seconds",
                      "histogram"),
    "prefix_hits": ("paddle_serving_prefix_hits_total", "counter"),
    "prefix_misses": ("paddle_serving_prefix_misses_total", "counter"),
    "prefix_hit_rate": ("paddle_serving_prefix_hit_rate", "gauge"),
    "prefill_tokens_saved": ("paddle_serving_prefill_tokens_saved_total",
                             "counter"),
    "prefill_tokens_computed": (
        "paddle_serving_prefill_tokens_computed_total", "counter"),
    "decode_steps": ("paddle_serving_decode_row_steps_total", "counter"),
    "draft_proposed": ("paddle_serving_draft_proposed_total", "counter"),
    "draft_accepted": ("paddle_serving_draft_accepted_total", "counter"),
    "acceptance_rate": ("paddle_serving_draft_acceptance_rate", "gauge"),
    "tokens_per_step": ("paddle_serving_tokens_per_step", "gauge"),
    "kv_blocks_total": ("paddle_serving_kv_blocks_total", "gauge"),
    "kv_blocks_used": ("paddle_serving_kv_blocks_used", "gauge"),
    "kv_blocks_free": ("paddle_serving_kv_blocks_free", "gauge"),
    "kv_cow_copies": ("paddle_serving_kv_cow_copies_total", "counter"),
    # mesh-sharded pool layout (static config gauges — constant for an
    # engine's lifetime, so reset-stable without an exemption):
    # shard_count x shard_pool_bytes == the whole pool, i.e.
    # per-device residency is dense/mp
    "kv_shard_count": ("paddle_serving_kv_shard_count", "gauge"),
    "kv_shard_heads": ("paddle_serving_kv_shard_heads", "gauge"),
    "kv_shard_pool_bytes": ("paddle_serving_kv_shard_pool_bytes",
                            "gauge"),
    # tensor-parallel weight placement (static config gauges, same
    # reset-stable discipline; never None — every engine has weights):
    # (bytes_per_device - bytes_replicated) x shard_count
    #   + bytes_replicated == the dense weight byte total
    "weight_shard_count": ("paddle_serving_weight_shard_count",
                           "gauge"),
    "weight_bytes_per_device": (
        "paddle_serving_weight_bytes_per_device", "gauge"),
    "weight_bytes_replicated": (
        "paddle_serving_weight_bytes_replicated", "gauge"),
    "budget_steps": ("paddle_serving_budget_steps_total", "counter"),
    "budget_tokens_used": ("paddle_serving_budget_tokens_used_total",
                           "counter"),
    "budget_prefill_tokens": (
        "paddle_serving_budget_prefill_tokens_total", "counter"),
    "budget_decode_tokens": (
        "paddle_serving_budget_decode_tokens_total", "counter"),
    "budget_draft_tokens": ("paddle_serving_budget_draft_tokens_total",
                            "counter"),
    # masked/pad positions the budget dispatches actually computed
    # (the flat layout's win gauge: row-aligned pays B x C - used per
    # step, the token-flattened stream ~0) — utilization is
    # used / (used + padding) by construction
    "budget_padding_tokens": (
        "paddle_serving_budget_padding_tokens_total", "counter"),
    "budget_utilization": ("paddle_serving_budget_utilization", "gauge"),
    # SLO/goodput layer: every finished request is classified against
    # the declared objectives (SloPolicy) — ok, violated-by-queueing,
    # or violated-by-slow-service; the three always sum to
    # requests_finished
    "slo_ok": ("paddle_serving_slo_ok_total", "counter"),
    "slo_violated_queue": ("paddle_serving_slo_violated_queue_total",
                           "counter"),
    "slo_violated_service": (
        "paddle_serving_slo_violated_service_total", "counter"),
    "queue_p50_s": ("paddle_serving_queue_time_seconds", "histogram"),
    "queue_p99_s": ("paddle_serving_queue_time_seconds", "histogram"),
    "service_p50_s": ("paddle_serving_service_time_seconds",
                      "histogram"),
    "service_p99_s": ("paddle_serving_service_time_seconds",
                      "histogram"),
}

# metrics() keys with no scalar Prometheus twin (nested dicts whose
# fields are exported under their own names below; "role" is a string
# — it exports as the labeled info gauge paddle_serving_role{role=..})
PROMETHEUS_EXEMPT_KEYS = {"prefix_store", "role"}

# metrics() keys reset_metrics legitimately does NOT restore to a fresh
# engine's values: the trace spy (documented: never reset, it IS the
# retrace contract) and allocator STATE (published prefix blocks stay
# resident across a window reset)
RESET_EXEMPT_KEYS = {"traces", "prefix_store", "kv_blocks_total",
                     "kv_blocks_used", "kv_blocks_free"}

# window counters the engine folds into its lifetime base at
# reset_metrics — exactly the counter-typed keys minus the never-reset
# trace spy
COUNTER_FOLD_KEYS = tuple(
    k for k, (_, t) in PROMETHEUS_NAMES.items()
    if t == "counter" and k != "traces")


def _fmt(v):
    return f"{float(v):.9g}"


def render_prometheus(engine):
    """Prometheus text exposition for one ServingEngine: every scalar
    metrics() key under its stable name (counters = lifetime base +
    current window, monotonic across reset_metrics), the three
    telemetry histograms, pool/prefix-store gauges, and the
    distributed-runtime section."""
    m = engine.metrics()
    base = getattr(engine, "_prom_base", {})
    lines = []
    seen = set()
    seen_fams = set()
    for key, (name, typ) in PROMETHEUS_NAMES.items():
        if typ == "histogram" or name in seen:
            continue
        v = m.get(key)
        if typ == "counter":
            v = base.get(key, 0) + (v or 0)
        elif v is None:
            continue                      # gauge with nothing to report
        seen.add(name)
        # labeled per-class series share ONE metric family: HELP/TYPE
        # are emitted once per family (label-stripped name — a TYPE
        # line naming `family{label}` is malformed text format), then
        # each labeled sample rides under it
        fam = name.split("{", 1)[0]
        if fam not in seen_fams:
            seen_fams.add(fam)
            lines.append(f"# HELP {fam} serving metric {key!r}")
            lines.append(f"# TYPE {fam} {typ}")
        lines.append(f"{name} {_fmt(v)}")
    tele = engine.telemetry
    lines.extend(tele.hist_ttft.prometheus_lines(
        "paddle_serving_ttft_seconds",
        "time to first token (submit -> first token), seconds"))
    lines.extend(tele.hist_latency.prometheus_lines(
        "paddle_serving_request_latency_seconds",
        "per-request latency (submit -> finished), seconds"))
    lines.extend(tele.hist_step_tokens.prometheus_lines(
        "paddle_serving_step_tokens",
        "tokens emitted per scheduler step"))
    lines.extend(tele.hist_queue.prometheus_lines(
        "paddle_serving_queue_time_seconds",
        "per-request queue wait (submit -> admitted), seconds"))
    lines.extend(tele.hist_service.prometheus_lines(
        "paddle_serving_service_time_seconds",
        "per-request service time (admitted -> finished), seconds"))
    lines.extend(tele.hist_handoff.prometheus_lines(
        "paddle_serving_handoff_bytes",
        "KV handoff payload size per transfer (kv + scales), bytes"))
    role = m.get("role")
    if role is not None:
        # info-style gauge: the role is a string, so it rides as a
        # label with a constant value of 1 (the Prometheus idiom for
        # enum state)
        name = "paddle_serving_role"
        lines.append(f"# HELP {name} replica role "
                     "(prefill|decode|mixed), exported as a label")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f'{name}{{role="{role}"}} 1')
    if engine.pool is not None:
        g = engine.pool.gauges()
        name = "paddle_serving_kv_blocks_used_peak"
        lines.append(f"# HELP {name} kv pool residency high-water mark")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {g['kv_blocks_used_peak']}")
    if engine.prefix_cache is not None:
        st = engine.prefix_cache.store.stats()
        for k in ("blocks_used", "blocks_capacity"):
            if k not in st:
                continue
            name = f"paddle_serving_prefix_store_{k}"
            lines.append(f"# HELP {name} prefix store {k}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {st[k]}")
    lines.extend(runtime_prometheus())
    return "\n".join(lines) + "\n"


def parse_prometheus(text):
    """Text-format parse back into ``{name{labels} or name: value}``.
    Strict enough for round-trip tests: every non-comment line must be
    ``<name>[{labels}] <float>``, and every sample must sit under a
    preceding # TYPE for its metric family."""
    samples = {}
    typed = set()
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram"):
                raise ValueError(f"malformed TYPE line: {ln!r}")
            typed.add(parts[2])
            continue
        if ln.startswith("#"):
            continue
        name_part, _, value = ln.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed sample line: {ln!r}")
        fam = name_part.split("{", 1)[0]
        for sfx in ("_bucket", "_sum", "_count", ""):
            if sfx and fam.endswith(sfx) and fam[: -len(sfx)] in typed:
                break
        else:
            if fam not in typed:
                raise ValueError(f"sample {fam!r} has no # TYPE line")
        samples[name_part] = float(value)
    return samples


# ------------------------------------------------------------------ export
class ChromeTrace:
    """Chrome-trace (chrome://tracing / Perfetto) event builder, a copy of
    the JAX package's ``profiler.ChromeTrace``: the one event model of the
    single-engine export and the cluster merge. Phases: "M" metadata
    (process/thread names), "X" complete events (ts + dur), "i"
    instants, "C" counters. Timestamps and durations are microseconds."""

    def __init__(self):
        self.events = []

    def process(self, pid, name):
        self.events.append({"ph": "M", "name": "process_name",
                            "pid": pid, "tid": 0,
                            "args": {"name": name}})

    def thread(self, pid, tid, name):
        self.events.append({"ph": "M", "name": "thread_name",
                            "pid": pid, "tid": tid,
                            "args": {"name": name}})

    def complete(self, name, pid, tid, ts_us, dur_us, args=None):
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": round(float(ts_us), 3),
              "dur": round(max(float(dur_us), 0.0), 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name, pid, tid, ts_us):
        self.events.append({"ph": "i", "name": name, "pid": pid,
                            "tid": tid, "ts": round(float(ts_us), 3),
                            "s": "t"})

    def counter(self, name, pid, ts_us, values):
        self.events.append({"ph": "C", "name": name, "pid": pid,
                            "tid": 0, "ts": round(float(ts_us), 3),
                            "args": dict(values)})

    def to_dict(self):
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def write(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


def snapshot(engine):
    """JSON-serializable telemetry snapshot — the routing payload a
    cluster front-end polls per replica (load + affinity + headroom in
    one cheap read). Key set pinned by SNAPSHOT_REQUIRED_KEYS/
    SNAPSHOT_OPTIONAL_KEYS; bump SNAPSHOT_SCHEMA_VERSION on change."""
    m = engine.metrics()
    tele = engine.telemetry
    out = {
        "schema_version": SNAPSHOT_SCHEMA_VERSION,
        "queue_depth": m["queue_depth"],
        "occupancy": m["occupancy"],
        "num_slots": engine.num_slots,
        # free = admittable right now (neither decoding nor prefilling
        # nor parked finished): the router's slot-headroom signal
        "slots_free": len(engine._free_slots()),
        # the prefix-block alignment: the router's consistent-hash key
        # is the first prefill_cap-aligned prompt block, so every
        # replica's cap must agree and the router reads it from here
        "prefill_cap": engine.prefill_cap,
        "has_work": bool(engine.has_work),
        "tokens_per_sec": m["tokens_per_sec"],
        "requests": {k: m[f"requests_{k}"] for k in
                     ("admitted", "finished", "forked", "rejected",
                      "expired", "migrated_in", "migrated_out",
                      "preempted", "resumed")},
        # per-class queue depths (v4): the gateway's SLO-aware shed and
        # the router's placement read backlog BY CLASS — a deep
        # low-priority queue is graceful degradation, not overload
        "queue_depths": dict(engine.queue_depths()),
        "histograms": {
            "ttft_s": tele.hist_ttft.snapshot(),
            "latency_s": tele.hist_latency.snapshot(),
            "tokens_per_step": tele.hist_step_tokens.snapshot(),
            # queue-time vs service-time decomposition — the
            # autoscaler's "is the backlog queueing or slow service"
            # signal, per replica
            "queue_s": tele.hist_queue.snapshot(),
            "service_s": tele.hist_service.snapshot(),
        },
        # goodput accounting against the declared objectives (v2)
        "slo": {
            "objectives": engine._slo.objectives(),
            "ok": m["slo_ok"],
            "violated_queue": m["slo_violated_queue"],
            "violated_service": m["slo_violated_service"],
            # per-class queue-violation attribution (v4): the
            # autoscaler scales up on the HIGH class only — low-class
            # queueing under overload is the QoS layer working
            "violated_queue_by_class": dict(engine._slo_vq_class),
        },
        "budget": {k: m[f"budget_{k}"] for k in
                   ("steps", "tokens_used", "prefill_tokens",
                    "decode_tokens", "draft_tokens", "padding_tokens",
                    "utilization")},
        "prefix": {"hits": m["prefix_hits"], "misses": m["prefix_misses"],
                   "hit_rate": m["prefix_hit_rate"]},
        # v5: disaggregation — the router's placement filter (role) and
        # the KV transfer accounting the zero-recompute check
        # reconciles across the prefill/decode pools
        "role": m["role"],
        "handoff": {"kv_blocks_shipped": m["kv_blocks_shipped"],
                    "kv_blocks_adopted": m["kv_blocks_adopted"]},
        # v6: gray-failure defense — the hedge safety gate (ONLY greedy
        # streams are bit-identical across replicas, so only
        # do_sample=False traffic may hedge) and the engine's own
        # smoothed step duration (the replica-local slowness signal)
        "do_sample": bool(engine.do_sample),
        "health": {"step_ewma_s": float(
            getattr(engine, "_step_ewma_s", 0.0))},
        # v7: tensor-parallel weight placement — the per-chip HBM
        # residency of the step's weight arrays ((per_device -
        # replicated) x shard_count + replicated == dense total): the
        # capacity planner's model-fits-here signal
        # v8: + quant modes — the byte gauges report QUANTIZED
        # residency (packed stacks + scale mirrors), so the planner
        # needs the mode to size an fp replica of the same model, and
        # the router needs it to keep hedge pools mode-homogeneous
        "weights": {"shard_count": m["weight_shard_count"],
                    "bytes_per_device": m["weight_bytes_per_device"],
                    "bytes_replicated": m["weight_bytes_replicated"],
                    "weight_quant": engine.dec._weight_quant_mode(),
                    "kv_quant": ("int8" if engine.dec._int8_cache()
                                 else "none")},
        "spans_logged": len(tele.spans),
        "steps_logged": len(tele.steps),
        "telemetry_ring": tele.ring,
    }
    if engine.pool is not None:
        g = dict(engine.pool.gauges())
        # worst-case ADMISSION headroom (total minus running
        # reservations), not residency: import_slot sheds against the
        # reservation ledger, so a router deciding whether a decode
        # target can take a handoff must read this — kv_blocks_free
        # can be ample while every free block is already spoken for
        g["kv_blocks_unreserved"] = (engine.pool.num_blocks
                                     - engine._kv_reserved)
        out["kv_blocks"] = g
    if engine._drafters is not None:
        out["drafter"] = {
            "propose_calls": sum(d.propose_calls
                                 for d in engine._drafters),
            "propose_hits": sum(d.propose_hits
                                for d in engine._drafters),
        }
    return out


def trace_dump(engine):
    """JSON-serializable dump of one engine's telemetry rings — the
    per-replica payload the CLUSTER trace export merges
    (serving_cluster/trace.py): finished spans + still-live spans (a
    killed replica's stranded requests are exactly the interesting
    ones), the step timeline, and a (t_wall, t_mono) anchor pair so a
    cross-process merge can rebase every engine-clock timestamp to wall
    time — the same discipline as the flight recorder's dumps."""
    tele = engine.telemetry
    spans = []
    for sp in list(tele.spans) + list(tele._live.values()):
        spans.append({
            "rid": sp.rid, "slot": sp.slot, "state": sp.state,
            "trace_id": sp.trace_id, "attempt": sp.attempt,
            "events": [[n, float(t)] for n, t in sp.events],
        })
    return {
        "t_wall": time.time(),
        "t_mono": engine.clock(),
        "num_slots": engine.num_slots,
        "spans": spans,
        "steps": [dict(ev) for ev in tele.steps],
    }


def render_trace_dump(tr, pid, dump, us, process_name,
                      counters=False):
    """Render one engine ``trace_dump`` into ``tr`` (ChromeTrace) as
    process ``pid``: tid 0 = the dispatch timeline (one complete event
    per dispatch), tid 1..B = slots (complete span per request,
    instants for each lifecycle event), tid B+1 = requests shed from
    the queue. ONE implementation shared by ``export_chrome_tracing``
    and the cluster merge (serving_cluster/trace.py) so the
    single-engine and cluster exports cannot drift apart. ``us`` maps
    an engine-clock timestamp to trace microseconds (the caller owns
    rebasing/anchoring); ``counters=True`` adds the kv_blocks_used /
    queue_depth / budget_utilization counter tracks."""
    nslots = dump["num_slots"]
    tr.process(pid, process_name)
    tr.thread(pid, 0, "dispatch timeline")
    for s in range(nslots):
        tr.thread(pid, s + 1, f"slot {s}")
    tr.thread(pid, nslots + 1, "queue (never admitted)")
    for ev in dump["steps"]:
        args = {k: v for k, v in ev.items()
                if k not in ("kind", "t") and v is not None}
        tr.complete(ev["kind"], pid, 0, us(ev["t"]),
                    max(ev["dur_s"], 0.0) * 1e6, args=args)
        if not counters:
            continue
        t_us = us(ev["t"])
        if ev.get("kv_blocks_used") is not None:
            tr.counter("kv_blocks_used", pid, t_us,
                       {"blocks": ev["kv_blocks_used"]})
        if ev.get("queue_depth") is not None:
            tr.counter("queue_depth", pid, t_us,
                       {"requests": ev["queue_depth"]})
        if ev["kind"] == "budget":
            used = ev.get("budget_used", 0)
            cap = used + ev.get("budget_wasted", 0)
            if cap:
                tr.counter("budget_utilization", pid, t_us,
                           {"frac": round(used / cap, 4)})
    for sp in dump["spans"]:
        if not sp["events"]:
            continue
        tid = (sp["slot"] + 1 if sp["slot"] is not None
               else nslots + 1)
        t0, t1 = sp["events"][0][1], sp["events"][-1][1]
        args = {"state": sp["state"],
                "events": [[n, round(t - t0, 6)]
                           for n, t in sp["events"]]}
        if sp["trace_id"] is not None:
            args["trace_id"] = sp["trace_id"]
            args["attempt"] = sp["attempt"]
        tr.complete(f"req {sp['rid']} [{sp['state']}]", pid, tid,
                    us(t0), max(t1 - t0, 0.0) * 1e6, args=args)
        for name, t in sp["events"]:
            tr.instant(name, pid, tid, us(t))


def export_chrome_tracing(engine, path, pid=0):
    """Write the engine's telemetry rings as Chrome-trace JSON
    (chrome://tracing / Perfetto: File > Open), one pid per engine
    (``pid``) in the ``render_trace_dump`` layout with counter tracks.
    Still-live spans are included (via ``trace_dump`` — a wedged
    request is exactly the interesting one). Timestamps are the engine
    clock rebased to the earliest recorded event. Returns ``path``."""
    dump = trace_dump(engine)
    ts = [ev["t"] for ev in dump["steps"]]
    ts += [sp["events"][0][1] for sp in dump["spans"] if sp["events"]]
    base = min(ts) if ts else 0.0

    def us(t):
        return max((t - base) * 1e6, 0.0)

    tr = ChromeTrace()
    render_trace_dump(tr, pid, dump, us,
                      process_name="paddle_tpu_torch ServingEngine",
                      counters=True)
    tr.write(path)
    return path


def validate_chrome_trace(path_or_dict):
    """Cheap structural validation of a Chrome-trace export (chip_smoke
    and tests assert on it): must json-parse, carry a traceEvents list,
    and every event must have the required ph/pid/ts fields."""
    if isinstance(path_or_dict, dict):
        doc = path_or_dict
    else:
        with open(path_or_dict) as f:
            doc = json.load(f)
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("chrome trace: no traceEvents list")
    for e in evs:
        if e.get("ph") not in ("X", "i", "C", "M"):
            raise ValueError(f"chrome trace: unknown phase in {e!r}")
        if e["ph"] != "M" and ("ts" not in e or e["ts"] < 0):
            raise ValueError(f"chrome trace: bad ts in {e!r}")
        if "pid" not in e:
            raise ValueError(f"chrome trace: missing pid in {e!r}")
    return doc
