"""The serving engine's histograms and their text exposition.

Copied from ``paddle_tpu/inference/telemetry.py`` under the same names:
``LogHistogram`` (fixed-size log-bucketed histogram, the source of every
percentile in ``metrics()``), ``SloPolicy`` (with no objectives every
finished request is ok), a ``Telemetry`` holding the per-request and
per-step histograms plus bounded rings of finished requests and
dispatches, the QoS classes with their ranks and weighted-fair shares,
and ``render_prometheus`` (counters and histograms over the engine's
lifetime, across ``reset_metrics``). Request spans, Chrome-trace export
and snapshots belong to a later slice.
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np

__all__ = ["DEFAULT_QOS_SHARES", "DEFAULT_RING", "LogHistogram",
           "QOS_CLASSES", "QOS_DEFAULT", "QOS_RANK", "SloPolicy",
           "Telemetry", "render_prometheus"]

DEFAULT_RING = 2048
# the QoS priority classes, best first, and the default class (a
# request's ``priority``)
QOS_CLASSES = ("high", "normal", "low")
QOS_DEFAULT = "normal"
QOS_RANK = {c: i for i, c in enumerate(QOS_CLASSES)}
# each class's weight in the split of a budget step's prefill tokens
# when several classes prefill at once
DEFAULT_QOS_SHARES = {"high": 4, "normal": 2, "low": 1}


class SloPolicy:
    """Declared per-request latency objectives; unset objectives are
    never violated. ``classify`` returns ``"ok"``, ``"queue"`` (the queue
    wait was at least the service time) or ``"service"``."""

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

    @property
    def enabled(self):
        return (self.ttft_s is not None or self.itl_s is not None
                or self.e2e_s is not None)

    def classify(self, queue_s, service_s, ttft_s, itl_s, e2e_s):
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


class LogHistogram:
    """Fixed-size log2-bucketed streaming histogram: an underflow bucket
    [0, lo), ``buckets_per_octave`` geometric buckets per octave up to
    ``hi``, an overflow bucket. Percentiles interpolate linearly inside
    the target bucket, so they sit within one bucket width of the exact
    value."""

    __slots__ = ("edges", "counts", "total", "sum", "bpo", "_base",
                 "_base_total", "_base_sum")

    def __init__(self, lo=1e-6, hi=1e4, buckets_per_octave=4):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.bpo = int(buckets_per_octave)
        n = int(math.ceil(math.log2(hi / lo) * self.bpo))
        self.edges = lo * np.power(2.0, np.arange(n + 1) / self.bpo)
        self.counts = np.zeros(n + 2, np.int64)   # under + n + over
        self.total = 0
        self.sum = 0.0
        self._base = np.zeros_like(self.counts)   # windows before reset
        self._base_total = 0
        self._base_sum = 0.0

    @property
    def count(self):
        return self.total

    def observe(self, value):
        v = max(float(value), 0.0)
        # buckets are (lo, hi]: a value on an edge belongs to the bucket
        # that edge closes, as Prometheus' inclusive `le` reads it
        i = int(np.searchsorted(self.edges, v, side="left"))
        self.counts[i] += 1
        self.total += 1
        self.sum += v

    def reset(self):
        """Start a new window, folding this one into the lifetime base
        the exposition reads."""
        self._base += self.counts
        self._base_total += self.total
        self._base_sum += self.sum
        self.counts[:] = 0
        self.total = 0
        self.sum = 0.0

    def _bucket_bounds(self, i):
        n = self.edges.size
        lo = 0.0 if i == 0 else float(self.edges[i - 1])
        hi = float(self.edges[min(i, n - 1)])
        return lo, hi

    def percentile(self, q):
        """Estimated q-th percentile; None when nothing was observed."""
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
        return self._bucket_bounds(len(self.counts) - 1)[1]

    def prometheus_lines(self, name, help_text=""):
        """Prometheus histogram exposition over the lifetime counts, one
        bucket line per octave."""
        counts = self._base + self.counts
        total = self._base_total + self.total
        lines = [f"# HELP {name} {help_text or name}",
                 f"# TYPE {name} histogram"]
        for i in range(0, self.edges.size, self.bpo):
            cum = int(counts[: i + 1].sum())
            lines.append(f'{name}_bucket{{le="{self.edges[i]:.6g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {int(total)}')
        lines.append(f"{name}_sum {float(self._base_sum + self.sum):.9g}")
        lines.append(f"{name}_count {int(total)}")
        return lines


class Telemetry:
    """Per-engine collector: the request and step histograms (always
    on) and, with ``ring > 0``, bounded rings of finished-request
    records and dispatch records."""

    def __init__(self, ring=None, clock=None):
        if clock is not None:
            raise NotImplementedError(
                "Telemetry: clock= (the request spans' clock) is not ported "
                "yet (ROADMAP Queue 1 item 6(f)); the engine passes its own "
                "times")
        ring = DEFAULT_RING if ring is None else int(ring)
        if ring < 0:
            raise ValueError(f"telemetry ring must be >= 0, got {ring}")
        self.ring = ring
        self.enabled = ring > 0
        self.spans = deque(maxlen=max(ring, 1))
        self.steps = deque(maxlen=max(ring, 1))
        self.hist_ttft = LogHistogram(1e-6, 1e4)
        self.hist_latency = LogHistogram(1e-6, 1e4)
        self.hist_step_tokens = LogHistogram(1.0, 1 << 16)
        self.hist_queue = LogHistogram(1e-6, 1e4)
        self.hist_service = LogHistogram(1e-6, 1e4)

    def req_done(self, rid, state, t_submit, t_done):
        if self.enabled:
            self.spans.append({"rid": rid, "state": state,
                               "t_submit": t_submit, "t_done": t_done})

    def step_event(self, kind, t, dur_s, rows=0, tokens=0,
                   traces_delta=0, **gauges):
        """One dispatch on the timeline, with any ``gauges`` beside it, as
        in JAX; returns the record (None when the ring is off)."""
        if not self.enabled:
            return None
        ev = {"kind": kind, "t": t, "dur_s": dur_s, "rows": int(rows),
              "tokens": int(tokens), "traces_delta": int(traces_delta)}
        ev.update(gauges)
        self.steps.append(ev)
        return ev

    def observe_request(self, ttft_s, latency_s, queue_s=None,
                        service_s=None):
        """Each time that is not None into its histogram, as in JAX."""
        for hist, v in ((self.hist_ttft, ttft_s),
                        (self.hist_latency, latency_s),
                        (self.hist_queue, queue_s),
                        (self.hist_service, service_s)):
            if v is not None:
                hist.observe(v)

    def observe_step_tokens(self, n):
        self.hist_step_tokens.observe(n)

    def reset(self):
        """The window reset of ``engine.reset_metrics``: the rings clear,
        the histograms fold into their lifetime bases."""
        self.spans.clear()
        self.steps.clear()
        for h in (self.hist_ttft, self.hist_latency, self.hist_step_tokens,
                  self.hist_queue, self.hist_service):
            h.reset()


# metrics() key -> (exposition name, type), the JAX package's names
PROMETHEUS_NAMES = {
    "tokens_emitted": ("paddle_serving_tokens_emitted_total", "counter"),
    "requests_admitted": ("paddle_serving_requests_admitted_total",
                          "counter"),
    "requests_finished": ("paddle_serving_requests_finished_total",
                          "counter"),
    "decode_steps": ("paddle_serving_decode_steps_total", "counter"),
    "budget_steps": ("paddle_serving_budget_steps_total", "counter"),
    "requests_forked": ("paddle_serving_requests_forked_total", "counter"),
    "requests_rejected": ("paddle_serving_requests_rejected_total",
                          "counter"),
    "requests_expired": ("paddle_serving_requests_expired_total",
                         "counter"),
    "requests_migrated_in": (
        "paddle_serving_requests_migrated_in_total", "counter"),
    "requests_migrated_out": (
        "paddle_serving_requests_migrated_out_total", "counter"),
    "kv_blocks_shipped": ("paddle_serving_kv_blocks_shipped_total",
                          "counter"),
    "kv_blocks_adopted": ("paddle_serving_kv_blocks_adopted_total",
                          "counter"),
    "requests_preempted": ("paddle_serving_requests_preempted_total",
                           "counter"),
    "requests_resumed": ("paddle_serving_requests_resumed_total",
                         "counter"),
    "requests_parked": ("paddle_serving_requests_parked", "gauge"),
    "kv_cow_copies": ("paddle_serving_kv_cow_copies_total", "counter"),
    "queue_depth": ("paddle_serving_queue_depth", "gauge"),
    "occupancy": ("paddle_serving_slot_occupancy", "gauge"),
    "kv_blocks_used": ("paddle_serving_kv_blocks_used", "gauge"),
    "kv_blocks_free": ("paddle_serving_kv_blocks_free", "gauge"),
}


def render_prometheus(engine):
    """Prometheus text exposition of one engine's metrics() counters and
    gauges and its request histograms; a counter adds the windows that
    ``reset_metrics`` folded away, so it never moves backwards."""
    m = engine.metrics()
    base = getattr(engine, "_prom_base", {})
    lines = []
    for key, (name, typ) in PROMETHEUS_NAMES.items():
        v = m.get(key)
        if v is None:
            continue
        if typ == "counter":
            v += base.get(key, 0)
        lines.append(f"# HELP {name} serving metric {key!r}")
        lines.append(f"# TYPE {name} {typ}")
        lines.append(f"{name} {float(v):.9g}")
    tele = engine.telemetry
    lines.extend(tele.hist_ttft.prometheus_lines(
        "paddle_serving_ttft_seconds",
        "time to first token (submit -> first token), seconds"))
    lines.extend(tele.hist_latency.prometheus_lines(
        "paddle_serving_request_latency_seconds",
        "per-request latency (submit -> finished), seconds"))
    lines.extend(tele.hist_step_tokens.prometheus_lines(
        "paddle_serving_step_tokens", "tokens emitted per scheduler step"))
    return "\n".join(lines) + "\n"
