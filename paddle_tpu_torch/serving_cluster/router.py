"""Placement-sensitive request router over N replicas.

The router turns replica handles (replica.py) into one submit/harvest
surface with three policies (``PADDLE_ROUTER_POLICY``):

  * ``round_robin`` — arrival order over alive replicas (the A/B
    baseline: placement-blind).
  * ``least_loaded`` — minimize a load score read from each replica's
    ``telemetry_snapshot()``: ``queue_depth + busy_slots +
    num_slots * kv_used_frac`` (queue pressure, slot pressure, pool
    headroom — the three admission bottlenecks the engine exposes).
  * ``prefix_affinity`` (default) — consistent-hash the FIRST
    ``prefill_cap``-aligned prompt block onto a replica ring, so every
    request sharing a template lands where that template's radix chain
    is already hot (prefix_cache.py); prompts shorter than one block
    carry no shareable block and fall back to least-loaded, and a
    SATURATED owner (queue_depth >= ``PADDLE_ROUTER_SPILL_DEPTH``)
    spills to least-loaded — affinity must never become head-of-line
    blocking. Honesty note: affinity only pays at hit-rate > 0; on
    no-template traffic it IS least-loaded with extra hashing.

Replica death is a first-class path, not an exception trail:
``check_health()`` (the gateway's heartbeat loop) marks a replica dead
when its heartbeat age passes ``PADDLE_GATEWAY_HB_DEAD_S`` and its
liveness probe fails, removes it from the hash ring (consistent
hashing: only ITS keys move), and re-submits every one of its
unfinished assignments elsewhere. Re-submission is idempotent by
gateway request id and replays from the prompt; the assignment
remembers how many tokens were already DELIVERED downstream and skips
that many from the replacement stream — greedy decoding makes the
replayed prefix token-identical, so the client's stream is seamless
(sampled mode re-draws its per-request seed on the new engine and is
documented as NOT replay-identical).

Snapshots are trusted only at the pinned ``SNAPSHOT_SCHEMA_VERSION``:
a replica reporting an unknown version is excluded from load scoring
(counted in ``version_mismatches``) instead of being silently misread.

The replica set is ELASTIC: ``add_replica`` joins a new replica to the
ring (minimal key movement — only the new vnodes' keys change home),
``remove_replica`` drains one gracefully — off the ring immediately,
every live assignment MIGRATED (``export_slot``/``import_slot``: the
session's KV blocks + sampler state move and decode resumes mid-stream
with zero re-prefill, greedy token-identical through the delivered-
prefix skip), then the handle retires. Any migration failure (target
death mid-transfer, rpc timeout, fault injection) degrades that
assignment to the classic failover path — replay from the prompt,
never a hang, never a double delivery. The autoscaler (autoscale.py)
drives both off the telemetry-snapshot signals; scale events and
migrations land in the decision audit and ``/metrics``
(``paddle_gateway_scale_events_total{direction=}``,
``paddle_gateway_migrations_total``/``_aborts_total``).

Gray failure — a replica that is SLOW but alive (degraded host, lossy
rpc link) — is defended in three layers, because death detection never
fires for it (the heartbeat keeps beating):

  * **health scoring** — per-replica first-token-latency EWMA observed
    on the router's own harvest path (plus the engine's step-duration
    EWMA from the v6 snapshot ``health`` block as a cold-start signal),
    judged RELATIVE to the cluster median: ``healthy`` / ``suspect``
    (>= ``PADDLE_ROUTER_SUSPECT_RATIO`` x median) / ``degraded``
    (>= ``PADDLE_ROUTER_BREAKER_RATIO`` x median). Exposed via
    ``health_status()`` -> /healthz and /metrics.
  * **circuit breaker** per replica: closed -> open on a degraded
    verdict or ``PADDLE_ROUTER_BREAKER_ERRS`` accumulated transport/
    snapshot errors; open replicas are shed from placement (never
    declared dead) until ``PADDLE_ROUTER_BREAKER_COOLDOWN_S`` passes;
    then half-open admits <= ``PADDLE_ROUTER_BREAKER_PROBES``
    concurrent probe placements whose first-token latency closes the
    breaker (non-outlier) or re-opens it. Recovery needs no operator.
  * **hedged dispatch** — a GREEDY request whose first token is
    overdue (past the cluster's own TTFT
    p``PADDLE_ROUTER_HEDGE_QUANTILE`` x ``PADDLE_ROUTER_HEDGE_MARGIN``)
    is speculatively re-submitted to the next-best replica;
    first-to-first-token wins, the loser is aborted through the normal
    release path and its tokens are never delivered or billed. Greedy
    decoding makes the two legs bit-identical, so the race is pure
    latency; SAMPLED streams never hedge (each engine submit re-draws
    the per-request seed, so two legs would diverge and the client's
    stream would depend on which leg won). Hedges draw from a
    cluster-wide retry-budget token bucket
    (``PADDLE_ROUTER_RETRY_RATE``/``_BURST``) so a brown-out cannot
    amplify into a retry storm — death failovers also drain the
    bucket but proceed on empty (they are the stream's only copy).

Every placement is AUDITED: the router records WHY each request landed
where it did — policy, per-candidate load scores, chosen replica, and
a reason from ``AUDIT_REASONS`` — in a bounded ring
(``PADDLE_ROUTER_AUDIT_RING``, default 2048), with per-reason counters
in the ``/metrics`` exposition
(``paddle_gateway_route_decisions_total{reason=...}``) and the full
entries merged into the cluster Perfetto export (trace.py). Trace
context rides along: ``submit`` mints (or accepts) a ``trace_id`` and
threads it through every replica submit — failover re-submits carry
the SAME trace id with an incremented attempt, so a kill-drill stream
yields one joined trace.
"""
from __future__ import annotations

import bisect
import hashlib
import os
import threading
import time
import uuid
from collections import deque

from ..inference.serving import AdmissionFull
from ..inference.telemetry import LogHistogram, SNAPSHOT_SCHEMA_VERSION
from .replica import ReplicaError

__all__ = ["HashRing", "Router", "NoReplicaError", "POLICIES",
           "AUDIT_REASONS"]

POLICIES = ("prefix_affinity", "least_loaded", "round_robin")

# every reason a placement decision can record (pinned by
# tools/check_metrics_surface.py — the audit counters' label set must
# not drift): affinity_hit = consistent-hash owner took it, spill =
# saturated/shedding owner overflowed to least-loaded, least_loaded /
# round_robin = the policy's own choice, failover = re-submit after a
# replica death, orphaned = failover found nowhere to go, migrated =
# a live session moved to a new replica during a drain, scale_up /
# scale_down = the elastic control plane changed the replica set
# (autoscaler watermark trip or an /admin scale command), hedge = a
# speculative duplicate of an overdue greedy request (gray-failure
# defense; first-to-first-token wins, the loser is aborted)
AUDIT_REASONS = ("affinity_hit", "least_loaded", "round_robin", "spill",
                 "failover", "orphaned", "migrated", "scale_up",
                 "scale_down", "hedge")


class NoReplicaError(ReplicaError):
    """Every replica is dead/unreachable — the gateway maps this to 503
    (service unavailable), distinct from 429 backpressure."""


def _hash64(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes: add/remove a replica
    moves only the keys it owns (~K/N of them), which is exactly the
    prefix-affinity requirement — a replica death must not reshuffle
    every template's home and cold-start every other radix store."""

    def __init__(self, vnodes=64):
        self.vnodes = int(vnodes)
        self._points = []                 # sorted [(hash, name)]
        self.names = set()

    def add(self, name):
        if name in self.names:
            return
        self.names.add(name)
        for i in range(self.vnodes):
            h = _hash64(f"{name}#{i}".encode())
            bisect.insort(self._points, (h, name))

    def remove(self, name):
        if name not in self.names:
            return
        self.names.discard(name)
        self._points = [(h, n) for h, n in self._points if n != name]

    def owner(self, key: bytes):
        """The replica owning ``key`` (first point clockwise), or None
        on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_left(self._points, (_hash64(key), b""))
        if i == len(self._points):
            i = 0
        return self._points[i][1]


def _locked(fn):
    """Serialize a Router method on the instance lock (see the class
    docstring's thread-safety contract). RLock: harvest -> mark_dead ->
    _place nest on the same thread."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


class _Assignment:
    __slots__ = ("gid", "request_id", "prompt", "kw", "replica", "rid",
                 "tokens", "skip", "done", "state", "resubmits",
                 "t_submit", "orphaned", "failed", "dup_returns",
                 "trace_id", "ho_target", "ho_tag", "ho_blocks",
                 "ho_busy", "t_placed", "first_seen", "hedged",
                 "hg_replica", "hg_rid", "hg_t")

    def __init__(self, gid, request_id, prompt, kw, replica, rid,
                 t_submit, trace_id=None):
        self.gid = gid
        self.request_id = request_id
        self.trace_id = trace_id          # cluster trace context
        self.prompt = prompt
        self.kw = kw
        self.replica = replica            # None = placement in flight
        self.rid = rid
        self.tokens = []                  # full de-duplicated history:
        self.skip = 0                     # replayed prefix to drop
        self.done = False                 # every harvested token lands
        self.state = "running"            # here exactly once, so N
        self.resubmits = 0                # concurrent readers can each
        self.t_submit = t_submit          # stream from their own cursor
        self.orphaned = False
        self.failed = None                # placement exception, if any
        self.dup_returns = 0              # idempotent-retry handouts
        # streamed prefill->decode handoff state: the decode replica
        # holding this session's staged KV prefix, the staging tag it
        # filed under, and the block cursor (how many leading blocks
        # are already over there — export_slot skips exactly these)
        self.ho_target = None
        self.ho_tag = None
        self.ho_blocks = 0
        self.ho_busy = False              # one streaming ship at a time
        # gray-failure defense: when the CURRENT leg was placed (the
        # first-token latency anchor — re-set on failover/migration/
        # hedge promotion so TTFT attributes to the serving replica),
        # whether a fresh token has been observed, and the hedge leg
        self.t_placed = t_submit
        self.first_seen = False
        self.hedged = False               # one hedge per request, ever
        self.hg_replica = None            # hedge leg: replica name
        self.hg_rid = None                # hedge leg: engine rid
        self.hg_t = 0.0                   # hedge leg: placement time


class Router:
    """See the module docstring. All waits are the caller's: submit and
    harvest are single bounded calls; health checking is explicit
    (``check_health``), so a virtual-clock drive or a deterministic test
    can drive the whole failure path without sleeping.

    Thread-safety: the gateway drives this from multiple thread-pool
    executor threads (one per in-flight HTTP request) plus the health
    loop. ONE reentrant lock guards all router state (gid allocation,
    the assignment table, the ring, the dead set, snapshots) — but
    replica I/O (submit/harvest/snapshot/probe over a lock or rpc) is
    ALWAYS performed outside it, so a frozen replica stalls only the
    calls touching it, never the whole front-end. Races with failover
    are resolved by re-checking the assignment's (replica, rid) epoch
    after the I/O: a harvest that lost the race discards its batch
    (the replacement replays those tokens), and each harvested token
    lands in the assignment's history exactly once."""

    def __init__(self, replicas, policy=None, spill_depth=None,
                 hb_dead_s=None, snap_max_age_s=None, clock=None,
                 audit_ring=None, handoff_blocks=None,
                 suspect_ratio=None, breaker_ratio=None,
                 breaker_errs=None, breaker_cooldown_s=None,
                 breaker_probes=None, hedge_quantile=None,
                 hedge_margin=None, hedge_min_s=None,
                 retry_rate=None, retry_burst=None):
        self.replicas = {r.name: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise ValueError("replica names must be unique")
        # pool roles, read once at registration (engine-construction
        # config, immutable): prefill workers take fresh prompts only,
        # decode workers take handed-off resident sessions only, mixed
        # (the default everywhere) takes both — today's behavior
        self.roles = {n: str(getattr(r, "role", "mixed"))
                      for n, r in self.replicas.items()}
        # streamed-handoff chunk: ship a prefilling session's committed
        # KV to its decode target once this many NEW full blocks exist
        # (0 = ship only at prompt completion, no mid-prefill overlap)
        self._handoff_blocks = int(
            handoff_blocks if handoff_blocks is not None
            else os.environ.get("PADDLE_ROLE_HANDOFF_BLOCKS", "0"))
        self.handoffs_total = 0
        self.policy = policy or os.environ.get("PADDLE_ROUTER_POLICY",
                                               "prefix_affinity")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r} "
                             f"(choose from {POLICIES})")
        self.spill_depth = int(
            spill_depth if spill_depth is not None
            else os.environ.get("PADDLE_ROUTER_SPILL_DEPTH", "4"))
        self.hb_dead_s = float(
            hb_dead_s if hb_dead_s is not None
            else os.environ.get("PADDLE_GATEWAY_HB_DEAD_S", "2.0"))
        self.snap_max_age_s = float(
            snap_max_age_s if snap_max_age_s is not None
            else os.environ.get("PADDLE_ROUTER_SNAP_AGE_S", "0.25"))
        self.clock = clock or time.monotonic
        self._lock = threading.RLock()
        self.ring = HashRing()
        for name in sorted(self.replicas):
            self.ring.add(name)
        self.dead = set()
        self._snaps = {}                  # name -> (snapshot, t)
        self._rr = 0                      # round-robin cursor
        self._gid = 0
        self._table = {}                  # gid -> _Assignment
        self._by_request_id = {}          # idempotency key -> gid
        self.submits_total = 0
        self.failovers_total = 0
        self.version_mismatches = 0
        self._prefill_cap = None
        # placement decision audit: bounded ring of WHY each request
        # landed where it did, plus per-reason counters (exposed in
        # /metrics and merged into the cluster Perfetto export)
        ar = int(audit_ring if audit_ring is not None
                 else os.environ.get("PADDLE_ROUTER_AUDIT_RING", "2048"))
        if ar < 0:
            raise ValueError(f"audit ring must be >= 0, got {ar}")
        # 0 disables the ring (no per-decision entry is built or
        # stored) but the per-reason counters stay — they're pinned in
        # /metrics by tools/check_metrics_surface.py and cost one dict
        # increment per placement
        self.audit_enabled = ar > 0
        self.audit = deque(maxlen=max(ar, 1))
        self.audit_counts = {r: 0 for r in AUDIT_REASONS}
        # elastic control plane: replicas mid-drain take no NEW
        # placements but keep serving their existing assignments until
        # every one has migrated off; scale/migration counters ride
        # /metrics next to the decision counters
        self.draining = set()
        self.migrations_total = 0
        self.migration_aborts_total = 0
        self.scale_events = {"up": 0, "down": 0}
        # (t, sum of replica finished counters) samples from refresh():
        # the measured queue-drain rate behind retry_after_s(). Samples
        # are spaced at least _drain_gap_s apart — refresh() runs on
        # EVERY submit, so a 429 retry storm would otherwise collapse
        # the 16-slot window to milliseconds in which nothing finished
        # and retry_after_s would report the cap while the queue
        # actually drains fine (each retry re-collapsing the window)
        self._drain_samples = deque(maxlen=16)
        self._drain_gap_s = 0.25
        # ---- gray-failure defense (see module docstring) ----------
        # health scoring: router-observed first-token latency EWMA per
        # replica (it sees queueing AND service on the real placement
        # path), plus the cluster-wide TTFT histogram the hedge delay
        # derives from. Verdicts are cluster-MEDIAN-relative: absolute
        # thresholds would need per-model tuning, and tail-at-scale
        # defense only cares about outliers anyway.
        self.suspect_ratio = float(
            suspect_ratio if suspect_ratio is not None
            else os.environ.get("PADDLE_ROUTER_SUSPECT_RATIO", "3.0"))
        self.breaker_ratio = float(
            breaker_ratio if breaker_ratio is not None
            else os.environ.get("PADDLE_ROUTER_BREAKER_RATIO", "6.0"))
        self.breaker_errs = int(
            breaker_errs if breaker_errs is not None
            else os.environ.get("PADDLE_ROUTER_BREAKER_ERRS", "3"))
        self.breaker_cooldown_s = float(
            breaker_cooldown_s if breaker_cooldown_s is not None
            else os.environ.get("PADDLE_ROUTER_BREAKER_COOLDOWN_S",
                                "2.0"))
        self.breaker_probes = int(
            breaker_probes if breaker_probes is not None
            else os.environ.get("PADDLE_ROUTER_BREAKER_PROBES", "1"))
        # hedged dispatch: 0 disables; the delay derives from the
        # cluster's OWN TTFT distribution, not a configured constant
        self.hedge_quantile = float(
            hedge_quantile if hedge_quantile is not None
            else os.environ.get("PADDLE_ROUTER_HEDGE_QUANTILE", "95"))
        self.hedge_margin = float(
            hedge_margin if hedge_margin is not None
            else os.environ.get("PADDLE_ROUTER_HEDGE_MARGIN", "2.0"))
        self.hedge_min_s = float(
            hedge_min_s if hedge_min_s is not None
            else os.environ.get("PADDLE_ROUTER_HEDGE_MIN_S", "0.02"))
        # cluster-wide retry budget (token bucket over retries+hedges)
        self.retry_rate = float(
            retry_rate if retry_rate is not None
            else os.environ.get("PADDLE_ROUTER_RETRY_RATE", "8.0"))
        self.retry_burst = float(
            retry_burst if retry_burst is not None
            else os.environ.get("PADDLE_ROUTER_RETRY_BURST", "16"))
        self._ttft_ewma = {}              # name -> first-token EWMA (s)
        self._ttft_seen = {}              # name -> observation count
        self.hist_ttft = LogHistogram()   # cluster-wide (hedge delay)
        self._breaker = {}                # name -> breaker record
        self.breaker_transitions = {"open": 0, "half_open": 0,
                                    "closed": 0}
        self.hedges_total = 0
        self.hedge_wins_total = 0
        self.retry_budget_exhausted_total = 0
        self._retry_tokens = self.retry_burst
        self._retry_t = self.clock()

    # -------------------------------------------------------- snapshots
    def alive_names(self):
        return [n for n in sorted(self.replicas) if n not in self.dead]

    def placeable_names(self):
        """Alive AND not draining — the placement candidate set. A
        draining replica still serves (and is harvested for) its
        existing assignments until the drain moves them off."""
        return [n for n in self.alive_names() if n not in self.draining]

    def refresh(self, force=False):
        """Pull each alive replica's telemetry snapshot (the routing
        payload), at most once per ``snap_max_age_s`` unless forced. A
        replica that errors here is NOT declared dead — one flaky
        snapshot must not drain a healthy replica; its stale snapshot
        is dropped (it scores worst until it answers again) and the
        death verdict stays with check_health's heartbeat + liveness
        probe (and with actual failed submits/harvests).

        Deliberately NOT @_locked around the replica I/O: when the
        health loop refreshes, a frozen rpc worker must stall only ITS
        snapshot call, never every submit/harvest waiting on the
        router lock. (A submit-path refresh still runs under the
        caller's RLock frame — the short rpc snapshot timeout bounds
        that case.)"""
        now = self.clock()
        with self._lock:
            todo = []
            for name in self.placeable_names():
                got = self._snaps.get(name)
                if force or got is None \
                        or now - got[1] > self.snap_max_age_s:
                    todo.append(name)
        fetched = {}
        for name in todo:
            try:
                fetched[name] = self.replicas[name].snapshot()
            except ReplicaError:
                fetched[name] = None
        with self._lock:
            for name, snap in fetched.items():
                if name in self.dead:
                    continue
                if snap is None:
                    self._snaps.pop(name, None)
                    # breaker input, NOT a death verdict: enough
                    # accumulated snapshot/transport errors shed the
                    # replica from placement (state "open") while the
                    # heartbeat keeps it alive
                    self._breaker_err(name)
                elif snap.get("schema_version") != \
                        SNAPSHOT_SCHEMA_VERSION:
                    # unknown payload: refuse to score it (drop any
                    # stale cached one too) rather than misread it
                    self.version_mismatches += 1
                    self._snaps.pop(name, None)
                else:
                    self._snaps[name] = (snap, now)
                    self._prefill_cap = snap["prefill_cap"]
                    br = self._breaker.get(name)
                    if br is not None and br["errs"]:
                        # DECAY (not reset) on success: a lossy link
                        # alternating ok/error must still accumulate
                        # toward the breaker threshold
                        br["errs"] -= 1
            # drain-rate sample for retry_after_s: the cluster-wide
            # finished count at this instant (engine window counters —
            # monotonic between resets; a negative step from a replica
            # leaving/reset invalidates the window, handled there)
            total_fin = 0
            saw = False
            for name in self.placeable_names():
                got = self._snaps.get(name)
                if got is not None:
                    total_fin += int(got[0].get("requests", {})
                                     .get("finished", 0))
                    saw = True
            if saw and (not self._drain_samples
                        or now - self._drain_samples[-1][0]
                        >= self._drain_gap_s):
                self._drain_samples.append((now, total_fin))

    def _snap(self, name):
        got = self._snaps.get(name)
        return got[0] if got else None

    def retry_after_s(self):
        """429 Retry-After from the MEASURED queue drain rate: total
        queued requests / (finished per second over the recent refresh
        window), floored at protocol.RETRY_AFTER_S and capped at
        protocol.RETRY_AFTER_MAX_S. No backlog or no data yet -> the
        floor; a backlog with zero observed drain -> the cap (honest
        "back off hard" instead of an invented number)."""
        import math

        from . import protocol
        with self._lock:
            qd = 0
            for name in self.placeable_names():
                snap = self._snap(name)
                if snap is not None:
                    qd += int(snap.get("queue_depth", 0))
            samples = list(self._drain_samples)
        lo, hi = protocol.RETRY_AFTER_S, protocol.RETRY_AFTER_MAX_S
        if qd <= 0 or len(samples) < 2:
            return lo
        dt = samples[-1][0] - samples[0][0]
        df = samples[-1][1] - samples[0][1]
        if df < 0:
            # a replica retired/reset mid-window: the cumulative count
            # stepped backwards, the window is garbage — drop it
            with self._lock:
                self._drain_samples.clear()
            return lo
        if dt <= 0 or df == 0:
            return hi
        return int(min(max(math.ceil(qd / (df / dt)), lo), hi))

    def qos_pressure(self):
        """Cluster-wide overload reading for the gateway's SLO-aware
        shed: mean queue depth over placeable replicas plus the
        cumulative queue-vs-service violation split (the SLO
        decomposition, summed from the snapshot cache — no rpc)."""
        with self._lock:
            names = self.placeable_names()
            snaps = [self._snap(n) for n in names]
        snaps = [s for s in snaps if s is not None]
        qmean = (sum(int(s.get("queue_depth", 0)) for s in snaps)
                 / max(len(snaps), 1))
        vq = sum(int((s.get("slo") or {}).get("violated_queue", 0))
                 for s in snaps)
        vs = sum(int((s.get("slo") or {}).get("violated_service", 0))
                 for s in snaps)
        return {"queue_mean": qmean, "violated_queue": vq,
                "violated_service": vs}

    @staticmethod
    def load_score(snap):
        """queue pressure + slot pressure + pool pressure, one number.
        Missing snapshot scores worst — never prefer a replica you know
        nothing about over one you do."""
        if snap is None:
            return float("inf")
        busy = snap["num_slots"] - snap["slots_free"]
        score = snap["queue_depth"] + busy
        kv = snap.get("kv_blocks")
        if kv and kv["kv_blocks_total"]:
            score += snap["num_slots"] * (kv["kv_blocks_used"]
                                          / kv["kv_blocks_total"])
        return score

    @staticmethod
    def decode_load_score(snap):
        """Decode-pool placement score: resident sessions + pool
        residency, NO queue term — decode workers take handed-off
        sessions straight into slots, so backlogged prompts (a prefill
        signal) must not repel a decode target whose slots and pool
        are actually free."""
        if snap is None:
            return float("inf")
        score = snap["num_slots"] - snap["slots_free"]
        kv = snap.get("kv_blocks")
        if kv and kv["kv_blocks_total"]:
            score += snap["num_slots"] * (kv["kv_blocks_used"]
                                          / kv["kv_blocks_total"])
        return score

    # ------------------------------------------------------------ roles
    def prefill_capable(self, name):
        """Can ``name`` run a prompt from scratch? Fresh submits and
        failover replays (both re-prefill) may only land here."""
        return self.roles.get(name, "mixed") in ("prefill", "mixed")

    def decode_capable(self, name):
        """Can ``name`` decode a resident session? Handoffs and
        mid-decode migrations may only land here — never on a
        prefill-only worker (it would hold the session forever)."""
        return self.roles.get(name, "mixed") in ("decode", "mixed")

    # -------------------------------------------------------- placement
    def _least_loaded(self, names):
        return min(names, key=lambda n: (self.load_score(self._snap(n)),
                                         n))

    def prefix_key(self, prompt):
        """The affinity key: the first ``prefill_cap``-aligned prompt
        block (bytes), or None when the prompt is shorter than one
        block (nothing shareable to be affine about)."""
        cap = self._prefill_cap
        if cap is None or len(prompt) < cap:
            return None
        return ",".join(str(int(t)) for t in prompt[:cap]).encode()

    def _choose(self, prompt, names):
        """One policy choice over ``names``: returns ``(name, reason)``
        with reason from AUDIT_REASONS — the decision audit records WHY
        alongside WHERE."""
        if self.policy == "round_robin":
            self._rr += 1
            return names[self._rr % len(names)], "round_robin"
        if self.policy == "least_loaded":
            return self._least_loaded(names), "least_loaded"
        key = self.prefix_key(prompt)
        if key is None:
            return self._least_loaded(names), "least_loaded"
        owner = self.ring.owner(key)
        if owner not in names:
            return self._least_loaded(names), "least_loaded"
        snap = self._snap(owner)
        if snap is not None and snap["queue_depth"] >= self.spill_depth:
            # saturation spill: the hot replica keeps its cache, the
            # overflow goes wherever there is headroom
            return self._least_loaded(names), "spill"
        return owner, "affinity_hit"

    def _record_decision(self, asg, chosen, reason, scores, attempt):
        """Append one audit entry (bounded ring) + bump its reason
        counter. JSON-able by construction (the cluster trace export
        and tools/slo_report.py both consume entries verbatim):
        unknown-snapshot scores (inf) are recorded as None. Ring size
        0 skips the entry entirely; the reason counter always bumps."""
        entry = None
        if self.audit_enabled:
            entry = {
                "t": self.clock(),
                "gid": asg.gid,
                "trace_id": asg.trace_id,
                "attempt": int(attempt),
                "policy": self.policy,
                "chosen": chosen,
                "reason": reason,
                "scores": {n: (None if s == float("inf")
                               else round(s, 4))
                           for n, s in scores.items()},
            }
        with self._lock:
            if entry is not None:
                self.audit.append(entry)
            self.audit_counts[reason] += 1

    # ---------------------------------------------- gray-failure defense
    def _breaker_of(self, name):
        """Get-or-create one replica's breaker record (call under the
        lock)."""
        br = self._breaker.get(name)
        if br is None:
            br = {"state": "closed", "errs": 0, "opened_t": 0.0,
                  "probe_gids": set()}
            self._breaker[name] = br
        return br

    def _breaker_transition(self, name, to):
        """Move one breaker to state ``to`` (call under the lock);
        bumps the per-target-state transition counter in /metrics."""
        br = self._breaker_of(name)
        if br["state"] == to:
            return
        br["state"] = to
        self.breaker_transitions[to] += 1
        br["probe_gids"].clear()
        if to == "open":
            br["opened_t"] = self.clock()
        elif to == "closed":
            br["errs"] = 0

    def _breaker_err(self, name):
        """One transport/snapshot error against ``name`` (call under
        the lock). NEVER a death verdict: enough accumulated errors
        OPEN the breaker — shed from placement, still heartbeating —
        and a half-open probe-phase error re-opens immediately."""
        br = self._breaker_of(name)
        br["errs"] += 1
        if br["state"] == "closed" and br["errs"] >= self.breaker_errs:
            self._breaker_transition(name, "open")
        elif br["state"] == "half_open":
            self._breaker_transition(name, "open")

    def _breaker_admits(self, name):
        """Placement gate (call under the lock): open sheds; after
        ``breaker_cooldown_s`` the breaker half-opens and admits at
        most ``breaker_probes`` concurrent probe placements."""
        br = self._breaker.get(name)
        if br is None or br["state"] == "closed":
            return True
        if br["state"] == "open":
            if self.clock() - br["opened_t"] < self.breaker_cooldown_s:
                return False
            self._breaker_transition(name, "half_open")
        # prune probe gids whose request no longer lives here
        # (released / failed over / hedged away before the first
        # token): a vanished probe must not wedge the breaker
        # half-open with its only probe slot occupied forever
        live = set()
        for g in br["probe_gids"]:
            a = self._table.get(g)
            if a is not None and not a.done and a.replica == name:
                live.add(g)
        br["probe_gids"] = live
        return len(br["probe_gids"]) < self.breaker_probes

    def breaker_state(self, name):
        """closed | half_open | open (public, for /healthz + drills)."""
        with self._lock:
            br = self._breaker.get(name)
            return "closed" if br is None else br["state"]

    def _health_signals(self):
        """Per-replica slowness signal in seconds (call under the
        lock; lower = better): the router-observed first-token EWMA
        once it has >= 3 observations, else the engine's own
        step-duration EWMA from the v6 snapshot ``health`` block,
        else None (no data — never judged on ignorance)."""
        vals = {}
        for n in self.alive_names():
            v = None
            if self._ttft_seen.get(n, 0) >= 3:
                v = self._ttft_ewma[n]
            else:
                snap = self._snap(n)
                if snap is not None:
                    sv = float((snap.get("health") or {})
                               .get("step_ewma_s", 0.0) or 0.0)
                    if sv > 0.0:
                        v = sv
            vals[n] = v
        return vals

    def health_status(self):
        """Cluster-median-relative gray-failure verdicts, one entry
        per alive replica: ``{"verdict": healthy|suspect|degraded,
        "signal_s", "median_s", "breaker", "consecutive_errors"}``.
        Judged RELATIVE to the cluster median (suspect_ratio /
        breaker_ratio multiples) — exposed via /healthz and
        /metrics."""
        with self._lock:
            vals = self._health_signals()
            known = sorted(v for v in vals.values() if v is not None)
            med = known[len(known) // 2] if known else None
            out = {}
            for n, v in vals.items():
                verdict = "healthy"
                if (v is not None and med is not None and med > 0.0
                        and len(known) >= 2):
                    if v >= self.breaker_ratio * med:
                        verdict = "degraded"
                    elif v >= self.suspect_ratio * med:
                        verdict = "suspect"
                br = self._breaker.get(n)
                out[n] = {
                    "verdict": verdict,
                    "signal_s": v,
                    "median_s": med,
                    "breaker": ("closed" if br is None
                                else br["state"]),
                    "consecutive_errors": (0 if br is None
                                           else br["errs"]),
                }
            return out

    def _observe_ttft(self, name, dt, gid=None, hist=True):
        """One first-token-latency observation against ``name`` (call
        under the lock): feeds the per-replica EWMA, the cluster TTFT
        histogram (the hedge-delay source), and — when ``gid`` is a
        half-open breaker probe — the probe verdict: close on a
        non-outlier TTFT, re-open on an outlier. ``hist=False`` keeps
        a PENALTY reading (a hedge loser's pending age) out of the
        histogram: it must inflate the sick replica's EWMA, but
        letting it poison the cluster-wide delay source would make
        every subsequent hedge slower exactly when hedges are most
        needed — a positive feedback loop."""
        dt = max(float(dt), 0.0)
        prev = self._ttft_ewma.get(name)
        self._ttft_ewma[name] = dt if prev is None else (
            0.7 * prev + 0.3 * dt)
        self._ttft_seen[name] = self._ttft_seen.get(name, 0) + 1
        if hist:
            self.hist_ttft.observe(dt)
        br = self._breaker.get(name)
        if br is not None and br["state"] == "half_open" \
                and gid in br["probe_gids"]:
            br["probe_gids"].discard(gid)
            others = sorted(
                v for n2, v in self._health_signals().items()
                if n2 != name and v is not None)
            med = others[len(others) // 2] if others else None
            if med is not None and med > 0.0 \
                    and dt >= self.breaker_ratio * med:
                self._breaker_transition(name, "open")
            else:
                # recovered: seed the EWMA from the fresh probe
                # reading — slow-era history must not re-trip it
                self._ttft_ewma[name] = dt
                self._breaker_transition(name, "closed")

    def _take_retry_token(self, force=False):
        """Cluster-wide retry budget (token bucket over retries +
        hedges). Hedges are SPECULATIVE and strictly require a token;
        a death failover is the stream's ONLY copy, so it proceeds
        even on an empty bucket (``force=True``) — the exhausted
        counter still records that the cluster is in retry debt."""
        with self._lock:
            now = self.clock()
            self._retry_tokens = min(
                self.retry_burst,
                self._retry_tokens + self.retry_rate
                * max(0.0, now - self._retry_t))
            self._retry_t = now
            if self._retry_tokens >= 1.0:
                self._retry_tokens -= 1.0
                return True
            self.retry_budget_exhausted_total += 1
            return bool(force)

    def _drop_hedge(self, asg, dead=None):
        """Release ``asg``'s hedge leg, if any (replica I/O outside
        the lock): the assignment is moving (migration/handoff) or
        ending, and a speculative duplicate must never outlive the
        decision. ``dead`` skips the release on a corpse."""
        with self._lock:
            hg_name, hg_rid = asg.hg_replica, asg.hg_rid
            asg.hg_replica, asg.hg_rid = None, None
            rep = (self.replicas.get(hg_name)
                   if hg_name is not None and hg_name != dead
                   else None)
        if rep is not None:
            rep.release(hg_rid)

    def _maybe_hedge(self, asg):
        """Hedged dispatch trigger (called from the harvest path,
        replica I/O outside the lock): a GREEDY request whose first
        token is overdue — older than the cluster's own TTFT
        p(hedge_quantile) x hedge_margin — is speculatively
        re-submitted to the next-best replica. One hedge per request,
        ever; sampled traffic never hedges (the legs would diverge);
        the retry budget strictly gates it."""
        if self.hedge_quantile <= 0:
            return
        with self._lock:
            if (asg.done or asg.orphaned or asg.hedged
                    or asg.first_seen or asg.replica is None
                    or asg.hg_rid is not None):
                return
            owner = asg.replica
            # greedy-only safety gate (v6 snapshots carry do_sample;
            # absent/unknown reads as NOT greedy — never hedge on a
            # guess): a sampled stream re-draws its per-request seed
            # on each engine submit, so two legs would DIVERGE and
            # the delivered stream would depend on which leg won.
            # Greedy decoding is bit-identical across replicas,
            # making first-to-first-token a pure latency race.
            snap = self._snap(owner)
            if snap is None:
                for n2 in self.placeable_names():
                    snap = self._snap(n2)
                    if snap is not None:
                        break
            if snap is None or snap.get("do_sample") is not False:
                return
            if self.hist_ttft.count < 8:
                return            # no distribution to derive from yet
            p = self.hist_ttft.percentile(self.hedge_quantile)
            delay = max((p or 0.0) * self.hedge_margin,
                        self.hedge_min_s)
            if self.clock() - asg.t_placed <= delay:
                return
            cands = [n for n in self.placeable_names()
                     if n != owner and self.prefill_capable(n)
                     and self._breaker_admits(n)]
            if not cands:
                return
            target = self._least_loaded(cands)
            asg.hedged = True     # one attempt per request, win or lose
            attempt = asg.resubmits + 2
            kw = dict(asg.kw)
        if kw.get("deadline_s") is not None:
            remaining = kw["deadline_s"] - (self.clock()
                                            - asg.t_submit)
            if remaining <= 0:
                return            # the deadline path expires it
            kw["deadline_s"] = remaining
        if not self._take_retry_token():
            return                # budget empty: no speculative copies
        try:
            rid = self.replicas[target].submit(
                asg.prompt, trace_id=asg.trace_id, attempt=attempt,
                **kw)
        except (AdmissionFull, ReplicaError):
            return                # opportunistic: no retry walk
        with self._lock:
            live = (asg.gid in self._table and not asg.done
                    and not asg.orphaned and not asg.first_seen
                    and asg.hg_rid is None)
            if live:
                asg.hg_replica, asg.hg_rid = target, rid
                asg.hg_t = self.clock()
                self.hedges_total += 1
                stray = None
            else:                 # finished/released while submitting
                stray = self.replicas.get(target)
        if stray is not None:
            stray.release(rid)
            return
        self._record_decision(asg, target, "hedge", {}, attempt)

    def _poll_hedge(self, asg, leg, base):
        """Poll ``asg``'s hedge leg (replica I/O outside the lock) and
        decide the race when it produced tokens: promote the leg if
        the owner is still silent (the owner becomes the loser), else
        abort it. The loser is released through the normal path — its
        tokens never enter the delivered history, so they are never
        streamed or billed. Returns the updated harvest triple after
        a promotion, else None."""
        hname, hrid = leg
        rep = self.replicas.get(hname)
        if rep is None:
            with self._lock:
                if (asg.hg_replica, asg.hg_rid) == leg:
                    asg.hg_replica, asg.hg_rid = None, None
            return None
        try:
            hnew, hdone, hstate = rep.harvest(hrid)
        except ReplicaError:
            # the hedge leg was speculative: drop it, leave the death
            # verdict to the heartbeat sweep
            with self._lock:
                if (asg.hg_replica, asg.hg_rid) == leg:
                    asg.hg_replica, asg.hg_rid = None, None
            return None
        loser = None
        out = None
        with self._lock:
            if (asg.hg_replica, asg.hg_rid) != leg \
                    or asg.done or asg.orphaned:
                return None
            if not hnew:
                if hdone:         # zero-token finish: useless leg
                    asg.hg_replica, asg.hg_rid = None, None
                return None
            if asg.first_seen:
                # the owner answered while we polled: hedge lost
                asg.hg_replica, asg.hg_rid = None, None
                loser = leg
            else:
                # hedge wins: promote the leg, the old owner is the
                # loser. Its pending age is ITS first-token
                # observation — the slow replica's EWMA inflates NOW,
                # not whenever it finally answers.
                loser = (asg.replica, asg.rid)
                # gid passes through: if this request was the loser's
                # half-open breaker PROBE, being hedged away IS the
                # probe verdict (an outlier pending age re-opens) —
                # otherwise the probe slot would stay occupied by a
                # request that no longer lives there
                self._observe_ttft(loser[0],
                                   self.clock() - asg.t_placed,
                                   gid=asg.gid, hist=False)
                asg.replica, asg.rid = hname, hrid
                asg.t_placed = asg.hg_t
                asg.hg_replica, asg.hg_rid = None, None
                asg.resubmits += 1
                asg.tokens.extend(hnew)
                asg.first_seen = True
                self._observe_ttft(hname, self.clock() - asg.hg_t,
                                   gid=asg.gid)
                if hdone:
                    asg.done, asg.state = True, hstate
                self.hedge_wins_total += 1
                out = (list(asg.tokens[base:]), asg.done, asg.state)
        if loser is not None:
            lrep = self.replicas.get(loser[0])
            if lrep is not None:
                lrep.release(loser[1])
        return out

    # ------------------------------------------------------- submit path
    def submit(self, prompt, request_id=None, trace_id=None, **kw):
        """Route one request; returns the gateway-global id (gid).
        Idempotent on ``request_id``: a repeat — concurrent or later,
        while the original assignment is live — returns the existing
        gid without re-running anything (the gid is RESERVED before
        the placement I/O, so two simultaneous retries cannot race
        into two engine submissions). AdmissionFull propagates only
        when EVERY alive replica sheds (honest cluster-wide
        backpressure); a replica that dies mid-submit is failed over
        transparently.

        ``trace_id`` is the cluster trace context (the gateway mints
        one per HTTP request, honoring an inbound ``X-Request-Id``);
        direct callers that pass none get a minted id, so every
        placement is traceable. The id survives failover re-submits
        (attempt increments), joining the request's spans across
        replicas."""
        prompt = [int(t) for t in prompt]
        if trace_id is None:
            trace_id = uuid.uuid4().hex
        with self._lock:
            if request_id is not None \
                    and request_id in self._by_request_id:
                gid = self._by_request_id[request_id]
                got = self._table.get(gid)
                if got is not None:
                    got.dup_returns += 1
                return gid
            self._gid += 1
            gid = f"req-{self._gid}"
            asg = _Assignment(gid, request_id, prompt, kw, None, None,
                              self.clock(), trace_id=str(trace_id))
            self._table[gid] = asg
            if request_id is not None:
                self._by_request_id[request_id] = gid
            self.submits_total += 1
        self.refresh()
        try:
            name, rid = self._place(prompt, kw, asg=asg, attempt=1)
        except Exception as e:
            with self._lock:
                # unwind the reservation — unless a concurrent
                # idempotent retry already took this gid home, in
                # which case the entry stays and carries the failure
                # (its harvest re-raises e, so 429 stays 429 instead
                # of decaying into a 404 for the duplicate; the
                # duplicate's release drops the entry)
                if request_id is not None:
                    self._by_request_id.pop(request_id, None)
                if asg.dup_returns:
                    asg.failed = e
                else:
                    self._table.pop(gid, None)
            raise
        with self._lock:
            asg.replica, asg.rid = name, rid
            asg.t_placed = self.clock()
            # the chosen replica may have been declared dead between
            # our successful engine submit and this bookkeeping write
            # — mark_dead's drain skipped the still-placement-pending
            # assignment, so the failover is OURS to run
            raced_death = name in self.dead and not asg.done
            if raced_death:
                asg.replica, asg.rid = None, None
        if raced_death:
            self._failover_one(asg)
        return gid

    def _place(self, prompt, kw, exclude=(), asg=None, attempt=1,
               reason_override=None):
        """One placement attempt over the alive set: policy choice
        first, then the remaining candidates by load on AdmissionFull
        (spill), marking dead anything that errors. The replica submit
        itself runs OUTSIDE the router lock (a frozen replica must not
        stall unrelated requests). Raises the LAST AdmissionFull when
        everyone sheds. A successful placement is recorded in the
        decision audit (reason from the policy choice; ``spill`` once a
        shed forced a retry elsewhere; ``reason_override`` stamps the
        failover path)."""
        last_full = None
        tried = set(exclude)
        shed = False
        while True:
            with self._lock:
                # fresh submits and failover replays both run the
                # prompt from scratch — decode-only workers are never
                # candidates (satellite bugfix: a prefill drain must
                # re-route in-flight prompts to prefill-capable
                # replicas, not strand them on a decode pool)
                names = [n for n in self.placeable_names()
                         if n not in tried and self.prefill_capable(n)]
                # gray-failure shed: an open breaker drops the replica
                # from placement WITHOUT declaring it dead. Availability
                # beats purity — when every candidate's breaker is open
                # the unfiltered set stays (serve slow over serve
                # nothing)
                ok = [n for n in names if self._breaker_admits(n)]
                if ok:
                    names = ok
                if names:
                    name, reason = self._choose(prompt, names)
                    # the per-candidate score dict exists only for the
                    # audit entry — skip it when the ring is off
                    scores = ({n: self.load_score(self._snap(n))
                               for n in names}
                              if self.audit_enabled else {})
                else:
                    name = None
            if name is None:
                if last_full is not None:
                    raise last_full
                raise NoReplicaError(
                    "no alive prefill-capable replica to place on")
            tried.add(name)
            try:
                rid = self.replicas[name].submit(
                    prompt,
                    trace_id=None if asg is None else asg.trace_id,
                    attempt=attempt, **kw)
            except AdmissionFull as e:
                last_full = e
                shed = True               # the next landing is a spill
            except ReplicaError:
                self.mark_dead(name)
            else:
                if asg is not None:
                    with self._lock:
                        br = self._breaker.get(name)
                        if br is not None and br["state"] == "half_open":
                            # this placement IS the recovery probe: its
                            # first-token latency closes or re-opens the
                            # breaker (_observe_ttft)
                            br["probe_gids"].add(asg.gid)
                    self._record_decision(
                        asg, name,
                        reason_override or ("spill" if shed else reason),
                        scores, attempt)
                return name, rid

    # ------------------------------------------------------ harvest path
    def harvest(self, gid, cursor=None):
        """Incremental harvest for one gateway request: ``(new_tokens,
        done, state)``. Every harvested token lands in the
        assignment's history exactly once; ``cursor=None`` returns the
        tokens appended since the last cursorless call (single-reader
        delta semantics), an explicit integer cursor returns
        ``history[cursor:]`` so concurrent readers of one gid (an
        idempotent client retry) each see the complete stream. A
        replica death here triggers the failover re-submit and returns
        an empty batch (the stream stalls one poll interval, never
        errors); the replayed prefix is skipped so the history gets
        each token once. KeyError for an unknown/released gid."""
        with self._lock:
            asg = self._table[gid]
            base = len(asg.tokens) if cursor is None else int(cursor)
            if asg.failed is not None:
                raise asg.failed          # duplicate of a shed submit:
            if asg.done:                  # 429 stays 429, never a 404
                return list(asg.tokens[base:]), True, asg.state
            if asg.orphaned:
                raise NoReplicaError(
                    f"{gid}: no alive replica to fail over to")
            epoch = (asg.replica, asg.rid)
            rep = (None if asg.replica is None
                   else self.replicas[asg.replica])
            if rep is None:               # failover placement in flight
                return list(asg.tokens[base:]), False, "running"
        try:
            new, done, state = rep.harvest(epoch[1])
        except ReplicaError:
            self.mark_dead(epoch[0])
            with self._lock:
                # mark_dead no-ops when the replica was ALREADY dead
                # (e.g. it died between a submit placing here and the
                # bookkeeping write) — if the assignment still points
                # at the corpse, the failover is ours to run
                stuck = (not asg.done and not asg.orphaned
                         and (asg.replica, asg.rid) == epoch)
                if stuck:
                    asg.replica, asg.rid = None, None
            if stuck:
                self._failover_one(asg)
            with self._lock:
                return list(asg.tokens[base:]), False, "running"
        with self._lock:
            if (asg.replica, asg.rid) != epoch:
                # failover raced this harvest: DISCARD the batch — the
                # replacement replays it (skip was set against the
                # history length, which this batch never joined)
                return list(asg.tokens[base:]), False, "running"
            if asg.skip:
                drop = min(asg.skip, len(new))
                asg.skip -= drop
                new = new[drop:]
            asg.tokens.extend(new)
            if new and not asg.first_seen:
                # first delivered token: the owner answered — feed the
                # health EWMA + cluster TTFT histogram (and settle a
                # half-open breaker probe, if this placement was one)
                asg.first_seen = True
                self._observe_ttft(epoch[0],
                                   self.clock() - asg.t_placed,
                                   gid=gid)
            # a hedge leg racing this stream loses the moment the owner
            # produces (or finishes): capture it for release outside
            # the lock. A still-silent owner leaves the leg up for the
            # poll below.
            hg_release = None
            if asg.hg_rid is not None and (new or done):
                hg_release = (asg.hg_replica, asg.hg_rid)
                asg.hg_replica, asg.hg_rid = None, None
            hedge_poll = ((asg.hg_replica, asg.hg_rid)
                          if asg.hg_rid is not None else None)
            if done:
                asg.done, asg.state = True, state
            out = (list(asg.tokens[base:]), done, state)
            # disaggregation hook: this poll is the handoff driver. A
            # session a prefill worker HOLDS (state "prefilled":
            # prompt complete, first token sampled, decode parked)
            # moves to a decode worker now; a still-prefilling session
            # streams its committed KV blocks ahead when the chunk
            # knob is on — the import overlaps the prefill tail.
            src_role = self.roles.get(epoch[0], "mixed")
            handoff = (None if done or src_role != "prefill"
                       else "full" if state == "prefilled"
                       else "stream" if (state == "running"
                                         and self._handoff_blocks > 0)
                       else None)
        if hg_release is not None:
            lrep = self.replicas.get(hg_release[0])
            if lrep is not None:
                lrep.release(hg_release[1])
        if hedge_poll is not None:
            # owner still silent, hedge leg up: poll it — a promotion
            # repoints the assignment at the hedge replica and the
            # delivered stream continues from ITS tokens
            promoted = self._poll_hedge(asg, hedge_poll, base)
            if promoted is not None:
                out = promoted
                done = out[1]
                handoff = None
        elif not done and not out[0]:
            # no tokens, no hedge yet: maybe the owner is gray-slow —
            # the hedge trigger compares its silence to the cluster's
            # own TTFT distribution
            self._maybe_hedge(asg)
        if done:
            self._drop_stage(asg)
        elif handoff == "full":
            self._handoff_one(asg)
        elif handoff == "stream":
            self._handoff_stream(asg)
        return out

    @_locked
    def poll(self, gid):
        asg = self._table.get(gid)
        if asg is None:
            return None
        return {"gid": gid, "replica": asg.replica, "done": asg.done,
                "state": asg.state, "delivered": len(asg.tokens),
                "resubmits": asg.resubmits, "trace_id": asg.trace_id,
                "attempt": asg.resubmits + 1}

    def trace_id_of(self, gid):
        """The trace id riding assignment ``gid`` (None once
        released). The gateway re-reads this after submit: an
        idempotent repeat returns the ORIGINAL submission's gid, and
        the response must echo the trace id the engine spans and the
        decision audit actually carry — not whatever fresh id the
        retry arrived with."""
        with self._lock:
            got = self._table.get(gid)
            return None if got is None else got.trace_id

    def release(self, gid):
        """Forget a finished/abandoned request (client disconnect).
        NOTE: with concurrent readers of one gid (idempotent retry),
        the first release drops the assignment for all of them — the
        gateway maps the survivors' KeyError to 404."""
        with self._lock:
            asg = self._table.pop(gid, None)
            if asg is None:
                return
            if asg.request_id is not None:
                self._by_request_id.pop(asg.request_id, None)
            rep = None
            if not asg.done and not asg.orphaned \
                    and asg.replica is not None:
                rep = self.replicas.get(asg.replica)
        if rep is not None:
            rep.release(asg.rid)
        if asg.hg_rid is not None:
            self._drop_hedge(asg)
        if asg.ho_tag is not None:
            self._drop_stage(asg)

    # ----------------------------------------------------------- health
    def check_health(self):
        """Heartbeat sweep: a replica whose heartbeat age passed
        ``hb_dead_s`` gets ONE bounded liveness probe (outside the
        router lock); failure = dead = drain + re-route. Returns the
        names newly marked dead."""
        with self._lock:
            # a mid-drain replica is the drain's responsibility — its
            # heartbeat may stall while blocks stream off it, and
            # declaring it dead would turn a graceful migrate-then-
            # retire into kill-and-reprefill
            suspects = [n for n in self.placeable_names()
                        if self.replicas[n].heartbeat_age()
                        > self.hb_dead_s]
        died = []
        for name in suspects:
            if self.replicas[name].alive:  # probe refreshes the beat
                continue
            self.mark_dead(name)
            died.append(name)
        # gray-failure sweep: a replica whose latency signal is a
        # breaker_ratio outlier against the cluster median is DEGRADED
        # — open its breaker (shed from placement, keep heartbeating;
        # half-open probes re-admit it once it recovers). Deliberately
        # NOT a death: its in-flight streams keep draining.
        status = self.health_status()
        with self._lock:
            for n, st in status.items():
                if st["verdict"] == "degraded" \
                        and self._breaker_of(n)["state"] == "closed":
                    self._breaker_transition(n, "open")
        return died

    def mark_dead(self, name):
        """Death IS drain: remove from the ring (only its keys move),
        then re-submit every unfinished assignment it held — idempotent
        per assignment (each is re-placed exactly once per death), with
        the delivered-history length remembered so the replayed greedy
        prefix is skipped, not double-streamed. Re-placement I/O runs
        outside the lock; until it lands the assignment's replica is
        None and harvests return empty batches. A deadline_s request
        fails over with its REMAINING budget (measured from the
        original submit) — an already-expired one goes straight to the
        expired state instead of restarting its clock."""
        with self._lock:
            if name in self.dead:
                return
            self.dead.add(name)
            self.ring.remove(name)
            self._snaps.pop(name, None)
            victims = [asg for asg in self._table.values()
                       if asg.replica == name and not asg.done
                       and not asg.orphaned]
            for asg in victims:
                asg.replica, asg.rid = None, None
            # hedge legs parked on the corpse are gone with it
            for asg in self._table.values():
                if asg.hg_replica == name:
                    asg.hg_replica, asg.hg_rid = None, None
        for asg in victims:
            self._failover_one(asg)

    def _failover_one(self, asg):
        """Re-place ONE assignment whose replica is gone (the caller
        already nulled its replica/rid under the lock). Deadline
        requests fail over with their REMAINING budget; a released-
        while-draining assignment (client disconnect racing the drain)
        gets its stray replacement submission released instead of
        leaking a tracked engine record forever."""
        if asg.ho_tag is not None:
            # the replayed prompt re-prefills from scratch — a staged
            # prefix from the dead leg is garbage on its target
            self._drop_stage(asg)
        # a live hedge leg IS the failover, already paid for: promote
        # it instead of burning a third prefill of the same prompt
        with self._lock:
            hg_name, hg_rid = asg.hg_replica, asg.hg_rid
            if hg_rid is not None and hg_name not in self.dead \
                    and hg_name in self.replicas \
                    and asg.gid in self._table \
                    and not asg.done and not asg.orphaned:
                asg.skip = len(asg.tokens)
                asg.replica, asg.rid = hg_name, hg_rid
                asg.t_placed = asg.hg_t
                asg.hg_replica, asg.hg_rid = None, None
                asg.resubmits += 1
                self.failovers_total += 1
                return
            # a leg on a dead/gone replica is just forgotten
            asg.hg_replica, asg.hg_rid = None, None
        kw = dict(asg.kw)
        if kw.get("deadline_s") is not None:
            remaining = kw["deadline_s"] - (self.clock()
                                            - asg.t_submit)
            if remaining <= 0:
                with self._lock:
                    asg.done, asg.state = True, "expired"
                return
            kw["deadline_s"] = remaining
        # death failovers draw on the retry budget but are never
        # blocked by it (force=True): this is the stream's only copy
        self._take_retry_token(force=True)
        # same trace id, NEXT attempt: the re-submitted stream joins
        # the original's trace (resubmits bumps only after placement
        # lands, so attempt = prior resubmits + this one + 1)
        attempt = asg.resubmits + 2
        try:
            new_name, rid = self._place(asg.prompt, kw, asg=asg,
                                        attempt=attempt,
                                        reason_override="failover")
        except (AdmissionFull, NoReplicaError):
            # nowhere to go RIGHT NOW: orphan it honestly; the
            # gateway surfaces 503/429 instead of hanging
            with self._lock:
                asg.orphaned = True
                asg.state = "orphaned"
            self._record_decision(asg, None, "orphaned", {}, attempt)
            return
        with self._lock:
            if asg.gid in self._table and not asg.done:
                asg.skip = len(asg.tokens)
                asg.replica, asg.rid = new_name, rid
                asg.t_placed = self.clock()
                asg.resubmits += 1
                self.failovers_total += 1
                stray = None
            else:                         # released/finished meanwhile
                stray = self.replicas.get(new_name)
        if stray is not None:
            stray.release(rid)

    # -------------------------------------------- disaggregated handoff
    def _drop_stage(self, asg):
        """Abort any streamed-KV prefix parked on a decode target for
        ``asg`` (the session finished, was released, or failed over
        before the handoff consumed it). Staged blocks hold pool
        reservation on the target and would leak forever otherwise.
        Best-effort: a dead target already freed them with its pool."""
        with self._lock:
            tgt, tag = asg.ho_target, asg.ho_tag
            asg.ho_target = asg.ho_tag = None
            asg.ho_blocks = 0
            rep = self.replicas.get(tgt) if tag is not None else None
        if rep is not None:
            try:
                rep.abort_stage(tag)
            except Exception:
                pass                      # corpse cleanup is moot

    @staticmethod
    def _import_headroom_ok(snap, plen, max_new, staged_blocks=0):
        """Would ``import_slot`` on the replica behind ``snap`` admit a
        session of this shape right now? Mirrors the engine's own shed
        gates: a free slot, plus worst-case pool blocks against the
        RESERVATION ledger (``kv_blocks_unreserved``), not residency —
        every free block can already be spoken for by running
        sessions' growth budgets. ``staged_blocks`` already hold their
        own reservation on the target, which transfers into the
        imported session's, so they count toward the need. No
        snapshot (or an old one missing the gauge) reads optimistic:
        the import's own AdmissionFull shed stays the safety net."""
        if snap is None:
            return True
        if snap.get("slots_free", 1) < 1:
            return False
        unres = (snap.get("kv_blocks") or {}).get("kv_blocks_unreserved")
        if unres is None:
            return True
        bt = int(snap.get("prefill_cap", 1)) or 1
        need = -(-(int(plen) + int(max_new)) // bt)
        return unres + staged_blocks >= need

    def _handoff_one(self, asg):
        """Ship one HELD session (engine state "prefilled": prompt
        complete, first token sampled, decode parked) from its prefill
        worker to a decode worker — the disaggregation transfer. With
        a streamed prefix already staged on a decode target
        (``ho_tag`` set), the export skips those blocks and the import
        splices them in: the remaining transfer is just the partial
        tail block plus bookkeeping, so TTFT tracks prefill time
        rather than prefill + full KV copy. No decode capacity RIGHT
        NOW is not an error — the session stays parked on the prefill
        worker (bounced back if the export already happened) and the
        next harvest poll retries: "held" is backpressure, not
        failure. Returns "handed_off" | "held" | "skipped" |
        "failed_over" | "orphaned" | "expired"."""
        # snapshot freshness IS the export/bounce economy here: a slot
        # another handoff filled microseconds ago must read as taken,
        # or this session pays a full KV export + re-import bounce (or
        # worse, a prompt replay when a staged prefix pins the target).
        # refresh() throttles itself to snap_max_age_s, so the steady
        # state costs nothing extra
        self.refresh()
        if asg.hg_rid is not None:
            self._drop_hedge(asg)
        with self._lock:
            if asg.done or asg.orphaned or asg.replica is None \
                    or asg.rid is None or asg.ho_busy:
                return "skipped"
            src_name, rid = asg.replica, asg.rid
            asg.ho_busy = True
            names = self.placeable_names()
            tgt0, tag, cursor = asg.ho_target, asg.ho_tag, asg.ho_blocks
            dead_stage = None
            if tag is not None and (tgt0 not in names
                                    or not self.decode_capable(tgt0)):
                # the staged prefix's target is gone: forget the stage
                # and export the full payload from block 0 instead
                dead_stage = (tgt0, tag)
                asg.ho_target = asg.ho_tag = None
                asg.ho_blocks = 0
                tgt0, tag, cursor = None, None, 0
            max_new = int(asg.kw.get("max_new_tokens", 20))
            plen = len(asg.prompt)
            if tag is not None:
                # a partially-staged session can ONLY land where its
                # prefix lives (import validates staged == kv_skip);
                # it must be admittable BEFORE the export: once
                # export_slot runs, the source slot is gone and a shed
                # import can only fall back to a prompt replay
                targets = [tgt0] if self._import_headroom_ok(
                    self._snap(tgt0), plen, max_new,
                    staged_blocks=cursor) else []
            else:
                # unstaged sessions can go anywhere decode-capable,
                # but exporting toward a full target just buys a
                # bounce (export + re-import on the source, twice the
                # KV traffic for nothing) — screen on the same
                # headroom the import gates on
                targets = sorted(
                    (n for n in names
                     if n != src_name and self.decode_capable(n)
                     and self._import_headroom_ok(
                         self._snap(n), plen, max_new)),
                    key=lambda n: (self.decode_load_score(
                        self._snap(n)), n))
        try:
            if dead_stage is not None and \
                    dead_stage[0] in self.replicas:
                try:
                    self.replicas[dead_stage[0]].abort_stage(
                        dead_stage[1])
                except Exception:
                    pass
            if not targets:
                return "held"
            with self._lock:
                if asg.done or asg.orphaned \
                        or (asg.replica, asg.rid) != (src_name, rid):
                    return "skipped"
                # detach: a concurrent harvest discards its batch on
                # the epoch mismatch, exactly like migration/failover
                asg.replica, asg.rid = None, None
            attempt = asg.resubmits + 2
            src = self.replicas[src_name]
            tgt_name = rid2 = None
            try:
                state = src.export_slot(rid, skip_blocks=cursor)
                if asg.kw.get("deadline_s") is not None:
                    remaining = asg.kw["deadline_s"] - (self.clock()
                                                        - asg.t_submit)
                    if remaining <= 0:
                        with self._lock:
                            asg.done, asg.state = True, "expired"
                        return "expired"
                    state["deadline_s"] = remaining
                state["attempt"] = attempt
            except Exception:
                with self._lock:
                    self.migration_aborts_total += 1
                    stuck = not asg.done and not asg.orphaned
                if stuck:
                    self._failover_one(asg)
                with self._lock:
                    return ("orphaned" if asg.orphaned else
                            "expired" if asg.state == "expired" else
                            "failed_over")
            for cand in targets:
                try:
                    rid2 = self.replicas[cand].import_slot(
                        state, staged=(tag if cand == tgt0 else None))
                except (AdmissionFull, ReplicaError, KeyError):
                    continue
                tgt_name = cand
                break
            if tgt_name is None and cursor == 0:
                # nowhere to decode RIGHT NOW: bounce the full payload
                # back onto the prefill worker — the engine re-holds
                # it ("prefilled") and the next poll retries
                try:
                    rid2 = src.import_slot(state)
                    tgt_name = src_name
                except Exception:
                    pass
            if tgt_name is None:
                # the payload is off every engine (and a skipped
                # prefix, if any, lives only on a target that just
                # refused it) — honest fallback: drop the stage and
                # replay from the prompt
                if tag is not None and tgt0 in self.replicas:
                    try:
                        self.replicas[tgt0].abort_stage(tag)
                    except Exception:
                        pass
                with self._lock:
                    asg.ho_target = asg.ho_tag = None
                    asg.ho_blocks = 0
                    self.migration_aborts_total += 1
                    stuck = not asg.done and not asg.orphaned
                if stuck:
                    self._failover_one(asg)
                with self._lock:
                    return ("orphaned" if asg.orphaned else
                            "expired" if asg.state == "expired" else
                            "failed_over")
            with self._lock:
                if asg.gid in self._table and not asg.done:
                    asg.skip = len(asg.tokens)
                    asg.replica, asg.rid = tgt_name, rid2
                    asg.t_placed = self.clock()
                    stray = None
                    if tgt_name != src_name:
                        asg.resubmits += 1
                        self.handoffs_total += 1
                        asg.ho_target = asg.ho_tag = None
                        asg.ho_blocks = 0
                else:                     # released/finished meanwhile
                    stray = self.replicas.get(tgt_name)
            if stray is not None:
                stray.release(rid2)
                return "skipped"
            if tgt_name == src_name:
                return "held"
            self._record_decision(asg, tgt_name, "migrated", {},
                                  attempt)
            return "handed_off"
        finally:
            with self._lock:
                asg.ho_busy = False

    def _handoff_stream(self, asg):
        """Stream the COMMITTED full KV blocks of a still-prefilling
        session on a prefill worker ahead to a decode target
        (``stage_kv_blocks``): the transfer overlaps the prefill tail,
        so by the time the prompt completes and ``_handoff_one`` runs,
        only the partial tail block is left to move. The cursor
        (``asg.ho_blocks``) advances only after a successful stage —
        a shed (AdmissionFull) just re-reads the same span on the
        next poll (reads are idempotent). No decode target, or fewer
        than ``handoff_blocks`` new committed blocks, is a silent
        no-op."""
        with self._lock:
            if asg.done or asg.orphaned or asg.replica is None \
                    or asg.rid is None or asg.ho_busy:
                return
            src_name, rid = asg.replica, asg.rid
            asg.ho_busy = True
            names = self.placeable_names()
            tgt0, tag, cursor = asg.ho_target, asg.ho_tag, asg.ho_blocks
            if tag is not None and (tgt0 not in names
                                    or not self.decode_capable(tgt0)):
                # stage target died/drained (its pool freed the
                # blocks with it): restart streaming from scratch
                asg.ho_target = asg.ho_tag = None
                asg.ho_blocks = 0
                tgt0, tag, cursor = None, None, 0
            if tag is None:
                cands = sorted(
                    (n for n in names
                     if n != src_name and self.decode_capable(n)),
                    key=lambda n: (self.decode_load_score(
                        self._snap(n)), n))
                if not cands:
                    asg.ho_busy = False
                    return
                tgt0 = cands[0]
                # resubmits in the tag: a failover between streams
                # must not collide with a stale stage under the
                # same gid on the same target
                tag = ("ho", asg.gid, asg.resubmits)
                cursor = 0
        try:
            try:
                blocks, _n_full = self.replicas[src_name] \
                    .export_kv_prefix(rid, start_block=cursor,
                                      min_blocks=self._handoff_blocks)
            except (ValueError, KeyError, ReplicaError):
                return
            if not blocks:
                return                    # below the chunk threshold
            try:
                self.replicas[tgt0].stage_kv_blocks(tag, blocks)
            except AdmissionFull:
                return                    # target pool full — retry;
                                          # cursor does NOT advance
            except (ReplicaError, KeyError):
                with self._lock:
                    asg.ho_target = asg.ho_tag = None
                    asg.ho_blocks = 0
                return
            raced = False
            with self._lock:
                if asg.done or asg.orphaned:
                    raced = True
                else:
                    asg.ho_target, asg.ho_tag = tgt0, tag
                    asg.ho_blocks = cursor + len(blocks)
            if raced and tgt0 in self.replicas:
                try:
                    self.replicas[tgt0].abort_stage(tag)
                except Exception:
                    pass
        finally:
            with self._lock:
                asg.ho_busy = False

    # ------------------------------------------------- elastic scaling
    def _record_scale(self, direction, name):
        """One scale event in the decision audit (reason scale_up /
        scale_down, gid None — dashboards and the merged cluster trace
        see WHEN the replica set changed next to WHERE requests went)
        plus the per-direction counter in /metrics."""
        entry = None
        if self.audit_enabled:
            entry = {"t": self.clock(), "gid": None, "trace_id": None,
                     "attempt": 0, "policy": self.policy, "chosen": name,
                     "reason": f"scale_{direction}", "scores": {}}
        with self._lock:
            if entry is not None:
                self.audit.append(entry)
            self.audit_counts[f"scale_{direction}"] += 1
            self.scale_events[direction] += 1

    def add_replica(self, replica):
        """Dynamic scale-up: register a new replica and add it to the
        consistent-hash ring — ONLY the keys the new vnodes claim move
        (~K/(N+1)); every other template's home replica, and its hot
        radix chain, stays put (pinned by test). Re-using a retired
        name is allowed (a replaced process). Records a scale_up
        audit event."""
        with self._lock:
            name = replica.name
            if name in self.replicas and name not in self.dead:
                raise ValueError(
                    f"replica {name!r} is already registered and alive")
            self.dead.discard(name)
            self.draining.discard(name)
            self.replicas[name] = replica
            self.roles[name] = str(getattr(replica, "role", "mixed"))
            self._snaps.pop(name, None)
            self.ring.add(name)
        self._record_scale("up", name)
        return name

    def remove_replica(self, name, migrate=True):
        """Graceful scale-down: drain = MIGRATE-then-retire. The
        replica leaves the ring and the placement set immediately (no
        new work lands), every unfinished assignment it holds is
        live-migrated to another replica (``export_slot`` ->
        ``import_slot``: KV blocks + sampler state move, the stream
        resumes mid-decode with zero re-prefill and the delivered
        prefix skipped — greedy token-identical), and only then is the
        handle closed and dropped. ``migrate=False`` (or any migration
        error: target death mid-transfer, rpc timeout, a fault
        injection at the "migration" point) degrades per-assignment to
        the classic failover path — replay from the prompt, never a
        hang, never a double delivery. Returns a drain summary dict
        (protocol.DRAIN_FIELDS)."""
        with self._lock:
            if name not in self.replicas:
                raise KeyError(f"unknown replica {name!r}")
            was_dead = name in self.dead
            src = self.replicas[name]
            if not was_dead:
                self.draining.add(name)
                self.ring.remove(name)
                self._snaps.pop(name, None)
            victims = [asg for asg in self._table.values()
                       if asg.replica == name and not asg.done
                       and not asg.orphaned]
        summary = {"replica": name, "migrated": 0, "failed_over": 0,
                   "orphaned": 0, "expired": 0}
        self.refresh()                    # fresh load scores for targets
        for asg in victims:
            if migrate and not was_dead:
                out = self._migrate_one(asg, name)
            else:
                with self._lock:
                    stuck = (not asg.done and not asg.orphaned
                             and asg.replica == name)
                    if stuck:
                        asg.replica, asg.rid = None, None
                out = None
                if stuck:
                    self._failover_one(asg)
                    out = ("orphaned" if asg.orphaned else
                           "expired" if asg.state == "expired" else
                           "failed_over")
            if out in summary:
                summary[out] += 1
        with self._lock:
            self.draining.discard(name)
            self.dead.discard(name)
            self.replicas.pop(name, None)
            self.roles.pop(name, None)
        try:
            src.close()
        except Exception:
            pass                          # retiring a corpse is fine
        self._record_scale("down", name)
        return summary

    def _migrate_one(self, asg, src_name):
        """Live-migrate ONE assignment off ``src_name``: export the
        slot (KV blocks + decode state leave the source atomically),
        import it on the least-loaded placeable replica (AdmissionFull
        walks the next candidate), and repoint the assignment with the
        delivered-prefix skip — the client stream never notices. ANY
        failure after the export (the testing/fault.py "migration"
        point, a target dying mid-transfer, everyone full) aborts to
        the classic failover fallback: re-submit from the prompt, skip
        the delivered prefix — degraded to a re-prefill, still
        exactly-once. Returns "migrated" | "failed_over" | "orphaned" |
        "expired" | "skipped"."""
        from ..testing import fault
        src = self.replicas[src_name]
        with self._lock:
            if asg.done or asg.orphaned or asg.replica != src_name \
                    or asg.rid is None:
                return "skipped"
            rid = asg.rid
        if asg.ho_tag is not None:
            # a drain-migration exports the FULL payload (skip 0) —
            # any streamed prefix staged for the handoff path is
            # stale the moment the session moves
            self._drop_stage(asg)
        if asg.hg_rid is not None:
            # a speculative duplicate must not chase a moving session
            self._drop_hedge(asg)
        # final harvest first: a request that FINISHED on the engine but
        # was not yet collected needs its tokens drained, not a
        # migration (exporting it would fail and the fallback would
        # wastefully replay a completed request elsewhere)
        try:
            new, done, state = src.harvest(rid)
        except Exception:
            new, done, state = None, False, None
        with self._lock:
            if new is not None and (asg.replica, asg.rid) == (src_name,
                                                              rid):
                if asg.skip:
                    drop = min(asg.skip, len(new))
                    asg.skip -= drop
                    new = new[drop:]
                asg.tokens.extend(new)
                if done:
                    asg.done, asg.state = True, state
                    return "skipped"
            if asg.done or asg.orphaned or (asg.replica, asg.rid) != \
                    (src_name, rid):
                return "skipped"
            # detach NOW: a concurrent harvest that raced the export
            # discards its batch (epoch mismatch) exactly like failover
            asg.replica, asg.rid = None, None
        attempt = asg.resubmits + 2
        tgt_name = rid2 = None
        try:
            state = src.export_slot(rid)
            # the chaos lever: PADDLE_FI_AT_POINT=migration kills the
            # transfer exactly here — state is off the source, not yet
            # on any target (the worst moment)
            fault.inject("migration")
            if asg.kw.get("deadline_s") is not None:
                # remaining budget from the PRISTINE submit-time deadline
                # (like _failover_one) — the exported value is already
                # the remainder from any prior migration, so subtracting
                # elapsed-since-submit from IT would double-count every
                # leg before this one
                remaining = asg.kw["deadline_s"] - (self.clock()
                                                    - asg.t_submit)
                if remaining <= 0:
                    with self._lock:
                        asg.done, asg.state = True, "expired"
                    return "expired"
                state["deadline_s"] = remaining
            state["attempt"] = attempt
            # role check (pinned by the drain test): a session that
            # still owes prefill work may only land prefill-capable —
            # a decode-only replica would starve it forever. A
            # prompt-complete session goes to the decode pool, scored
            # by resident-session pressure (no queue term).
            need_prefill = (int(state.get("pf_left", 0)) > 0
                            or int(state.get("nt", 0)) == 0)
            with self._lock:
                if need_prefill:
                    order = sorted(
                        (n for n in self.placeable_names()
                         if n != src_name and self.prefill_capable(n)),
                        key=lambda n: (self.load_score(self._snap(n)),
                                       n))
                else:
                    order = sorted(
                        (n for n in self.placeable_names()
                         if n != src_name and self.decode_capable(n)),
                        key=lambda n: (self.decode_load_score(
                            self._snap(n)), n))
            last_full = None
            for cand in order:
                try:
                    rid2 = self.replicas[cand].import_slot(state)
                except AdmissionFull as e:
                    last_full = e
                    continue
                tgt_name = cand
                break
            if tgt_name is None:
                raise last_full if last_full is not None else \
                    NoReplicaError("no placeable replica to migrate to")
        except Exception:
            with self._lock:
                self.migration_aborts_total += 1
                stuck = not asg.done and not asg.orphaned
            if stuck:
                self._failover_one(asg)
            with self._lock:
                return ("orphaned" if asg.orphaned else
                        "expired" if asg.state == "expired" else
                        "failed_over")
        with self._lock:
            if asg.gid in self._table and not asg.done:
                asg.skip = len(asg.tokens)
                asg.replica, asg.rid = tgt_name, rid2
                asg.t_placed = self.clock()
                asg.resubmits += 1
                self.migrations_total += 1
                stray = None
            else:                         # released/finished meanwhile
                stray = self.replicas.get(tgt_name)
        if stray is not None:
            stray.release(rid2)
            return "skipped"
        self._record_decision(asg, tgt_name, "migrated", {}, attempt)
        return "migrated"

    def scale_status(self):
        """The /admin/scale payload's router half (the gateway folds in
        the autoscaler's bounds)."""
        with self._lock:
            roles = {"prefill": 0, "decode": 0, "mixed": 0}
            for n in self.alive_names():
                roles[self.roles.get(n, "mixed")] += 1
            return {"replicas_alive": len(self.alive_names()),
                    "replicas_total": len(self.replicas),
                    "draining": sorted(self.draining),
                    "migrations_total": self.migrations_total,
                    "migration_aborts_total": self.migration_aborts_total,
                    "scale_events_up": self.scale_events["up"],
                    "scale_events_down": self.scale_events["down"],
                    "roles": roles,
                    "handoffs_total": self.handoffs_total}

    # ------------------------------------------------------- aggregation
    def metrics_prometheus(self):
        """Cluster exposition: each alive replica's engine exposition
        with a ``replica`` label injected on every sample, the GATEWAY
        PROCESS's own runtime registry (HTTP latency histograms, rpc
        client latency) under ``replica="gateway"``, the router's
        placement-decision counters, and the router gauges (replica
        I/O outside the lock). One scrape shows the whole cluster.

        Note for in-process (LocalReplica) clusters: the gateway and
        its replicas share one process, so process-global runtime
        families legitimately appear under both a replica label and
        the gateway label — distinct series, one HELP/TYPE."""
        with self._lock:
            names = self.alive_names()
        lines = []
        seen_meta = set()

        def _append(text, label):
            for ln in _relabel(text, label):
                if ln.startswith("#"):
                    # ONE HELP/TYPE line per family across the whole
                    # cluster: Prometheus rejects a second HELP line
                    # for the same metric name, so duplicates from
                    # replica 2..N are dropped here
                    parts = ln.split(None, 3)
                    key = tuple(parts[:3])
                    if key in seen_meta:
                        continue
                    seen_meta.add(key)
                lines.append(ln)

        for name in names:
            try:
                text = self.replicas[name].metrics_prometheus()
            except ReplicaError:
                self.mark_dead(name)
                continue
            _append(text, name)
        # the gateway process's own runtime registry: HTTP endpoint
        # latency histograms (gateway.py records them per
        # endpoint+status) and the rpc client's call latency — the
        # front-end's accept/parse/stream time was invisible when
        # /metrics only relabeled engine expositions
        from ..inference.telemetry import runtime_prometheus
        _append("\n".join(runtime_prometheus()) + "\n", "gateway")
        with self._lock:
            name = "paddle_gateway_route_decisions_total"
            lines.append(f"# HELP {name} placements by audit reason "
                         "(router decision audit ring)")
            lines.append(f"# TYPE {name} counter")
            for reason in AUDIT_REASONS:
                lines.append(f'{name}{{reason="{reason}"}} '
                             f"{self.audit_counts[reason]}")
            # elastic control-plane counters (zero-initialized like the
            # decision counters: the label set is discoverable before
            # any scale event — pinned by check_metrics_surface)
            name = "paddle_gateway_scale_events_total"
            lines.append(f"# HELP {name} replica-set changes by "
                         "direction (autoscaler or /admin/scale)")
            lines.append(f"# TYPE {name} counter")
            for d in ("up", "down"):
                lines.append(f'{name}{{direction="{d}"}} '
                             f"{self.scale_events[d]}")
            # circuit-breaker state machine traffic (zero-initialized:
            # the label set is discoverable before any gray failure)
            name = "paddle_gateway_breaker_transitions_total"
            lines.append(f"# HELP {name} circuit breaker state "
                         "transitions by target state")
            lines.append(f"# TYPE {name} counter")
            for to in ("open", "half_open", "closed"):
                lines.append(f'{name}{{to="{to}"}} '
                             f"{self.breaker_transitions[to]}")
        # per-replica gray-failure verdicts + breaker states (encoded
        # gauges: 0 healthy/closed, 1 suspect/half_open, 2
        # degraded/open); health_status takes the lock itself
        status = self.health_status()
        vmap = {"healthy": 0, "suspect": 1, "degraded": 2}
        bmap = {"closed": 0, "half_open": 1, "open": 2}
        name = "paddle_gateway_replica_health_state"
        lines.append(f"# HELP {name} gray-failure verdict "
                     "(0=healthy 1=suspect 2=degraded)")
        lines.append(f"# TYPE {name} gauge")
        for n in sorted(status):
            lines.append(f'{name}{{replica="{n}"}} '
                         f'{vmap[status[n]["verdict"]]}')
        name = "paddle_gateway_breaker_state"
        lines.append(f"# HELP {name} circuit breaker state "
                     "(0=closed 1=half_open 2=open)")
        lines.append(f"# TYPE {name} gauge")
        for n in sorted(status):
            lines.append(f'{name}{{replica="{n}"}} '
                         f'{bmap[status[n]["breaker"]]}')
        with self._lock:
            gauges = (
                ("paddle_gateway_replicas_alive", "gauge",
                 len(self.alive_names()), "replicas currently routable"),
                ("paddle_gateway_replicas_total", "gauge",
                 len(self.replicas), "replicas configured"),
                ("paddle_gateway_requests_routed_total", "counter",
                 self.submits_total, "requests placed by the router"),
                ("paddle_gateway_failovers_total", "counter",
                 self.failovers_total,
                 "in-flight re-submissions after a replica death"),
                ("paddle_gateway_migrations_total", "counter",
                 self.migrations_total,
                 "live sessions moved replica-to-replica (drain)"),
                ("paddle_gateway_migration_aborts_total", "counter",
                 self.migration_aborts_total,
                 "migrations aborted mid-transfer -> classic failover"),
                ("paddle_gateway_handoffs_total", "counter",
                 self.handoffs_total,
                 "prefill->decode KV handoffs completed (disagg)"),
                ("paddle_gateway_snapshot_version_mismatches_total",
                 "counter", self.version_mismatches,
                 "snapshots refused for schema_version drift"),
                ("paddle_gateway_hedges_total", "counter",
                 self.hedges_total,
                 "speculative duplicate dispatches (greedy only)"),
                ("paddle_gateway_hedge_wins_total", "counter",
                 self.hedge_wins_total,
                 "hedge legs that beat the original to first token"),
                ("paddle_gateway_retry_budget_exhausted_total",
                 "counter", self.retry_budget_exhausted_total,
                 "retry/hedge attempts that found the token bucket "
                 "empty"),
                ("paddle_gateway_retry_budget_tokens", "gauge",
                 round(self._retry_tokens, 4),
                 "retry/hedge token bucket level"))
        for gname, typ, val, help_ in gauges:
            lines.append(f"# HELP {gname} {help_}")
            lines.append(f"# TYPE {gname} {typ}")
            lines.append(f"{gname} {val}")
        return "\n".join(lines) + "\n"


def _relabel(text, replica):
    """Inject ``replica="name"`` into every sample line of one
    replica's Prometheus exposition; HELP/TYPE comments pass through
    (the caller de-duplicates them across replicas — Prometheus rejects
    a repeated HELP line for one family)."""
    out = []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            out.append(ln)
            continue
        name_part, _, value = ln.rpartition(" ")
        if "{" in name_part:
            fam, rest = name_part.split("{", 1)
            out.append(f'{fam}{{replica="{replica}",{rest} {value}')
        else:
            out.append(f'{name_part}{{replica="{replica}"}} {value}')
    return out
