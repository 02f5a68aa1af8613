"""Gateway-driven autoscaling: spawn/drain replicas on telemetry
signals.

The ``Autoscaler`` closes the loop the trace plane opened: the router
already polls every replica's ``telemetry_snapshot()`` (schema v3) for
placement — this consumer reads the SAME payload for capacity
decisions:

  * queue pressure   — mean ``queue_depth`` across placeable replicas
    (the backlog the SLO layer attributes to queueing);
  * pool headroom    — the minimum ``kv_blocks_free / kv_blocks_total``
    across replicas (a full pool sheds admissions before queues grow);
  * goodput verdicts — new ``slo.violated_queue`` counts since the
    last tick (a request that already missed its objective because it
    queued too long is the lagging-edge scale-up signal).

Decisions are deliberately sluggish: a watermark must hold for
``hysteresis`` consecutive ticks before acting, and ``cooldown_s``
must elapse after any scale event before the next — flapping load
changes the replica set at most once per cooldown instead of
thrashing spawn/drain cycles.

Scale-UP calls the caller-provided ``spawn(name)`` hook (build an
engine, wrap it in a replica handle, return it) and registers the
result via ``Router.add_replica`` — consistent hashing moves only the
new replica's keys. In-process clusters spawn ``LocalReplica``s; an
out-of-process deployment spawns a worker under the PR-3 gang
supervisor (``distributed/launch``), calls ``serve_engine()`` in it,
and returns an ``RpcReplica`` — the heartbeat/liveness machinery is
the same either way.

Scale-DOWN picks the least-loaded replica (fewest sessions to move)
and calls ``Router.remove_replica(..., migrate=True)``: live sessions
migrate off (KV blocks + sampler state — zero re-prefill, greedy
token-identical), then the replica retires. A drain that cannot place
a session falls back to classic failover per session; the stream is
never dropped.

Knobs (constructor args override env; registered in
``testing.GW_ENV_VARS``):

  PADDLE_AUTOSCALE_MIN          floor replica count (1)
  PADDLE_AUTOSCALE_MAX          ceiling replica count (4)
  PADDLE_AUTOSCALE_QUEUE_HIGH   mean queue depth tripping scale-up (4.0)
  PADDLE_AUTOSCALE_QUEUE_LOW    mean queue depth allowing scale-down (0.5)
  PADDLE_AUTOSCALE_KV_FREE_FRAC min pool-free fraction below which the
                                cluster scales up (0.1)
  PADDLE_AUTOSCALE_COOLDOWN_S   seconds between scale events (10)
  PADDLE_AUTOSCALE_HYSTERESIS   consecutive agreeing ticks required (2)

Disaggregated mode (``role_aware=True`` / PADDLE_AUTOSCALE_ROLE_AWARE):
the PREFILL pool and the DECODE pool scale on DIFFERENT signal
families — prefill work is arrival-shaped (queue depth is the load),
decode work is residency-shaped (live sessions pinning KV). One
global watermark would starve whichever pool's signal is quieter.
The spawn hook must accept ``spawn(name, role)`` in this mode, and
each pool keeps at least one replica regardless of watermarks.

  PADDLE_AUTOSCALE_ROLE_AWARE      enable per-pool scaling (0)
  PADDLE_AUTOSCALE_PF_QUEUE_HIGH   prefill-pool mean queue depth
                                   tripping scale-up (queue_high)
  PADDLE_AUTOSCALE_PF_QUEUE_LOW    prefill-pool mean queue depth
                                   allowing scale-down (queue_low)
  PADDLE_AUTOSCALE_DC_KV_FREE_FRAC decode-pool min free-block fraction
                                   below which it scales up
                                   (kv_free_low)
  PADDLE_AUTOSCALE_DC_SESSIONS_HIGH decode-pool worst resident-session
                                   fraction tripping scale-up (0.85)
  PADDLE_AUTOSCALE_DC_SESSIONS_LOW  decode-pool worst resident-session
                                   fraction allowing scale-down (0.3)
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["Autoscaler"]


def _env(name, default, cast):
    v = os.environ.get(name)
    return cast(v) if v not in (None, "") else default


class Autoscaler:
    """See the module docstring. ``tick()`` is the whole control loop:
    the gateway's health sweep calls it (or a test drives it
    explicitly on a virtual clock); it reads signals, applies
    hysteresis + cooldown, and performs at most ONE scale event."""

    def __init__(self, router, spawn, min_replicas=None,
                 max_replicas=None, queue_high=None, queue_low=None,
                 kv_free_low=None, cooldown_s=None, hysteresis=None,
                 clock=None, name_prefix="scaled", role_aware=None,
                 pf_queue_high=None, pf_queue_low=None,
                 dc_kv_free_low=None, dc_sessions_high=None,
                 dc_sessions_low=None):
        self.router = router
        self.spawn = spawn
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else _env("PADDLE_AUTOSCALE_MIN", 1, int))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _env("PADDLE_AUTOSCALE_MAX", 4, int))
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min ({self.min_replicas}) <= max "
                f"({self.max_replicas}) replicas")
        self.queue_high = float(
            queue_high if queue_high is not None
            else _env("PADDLE_AUTOSCALE_QUEUE_HIGH", 4.0, float))
        self.queue_low = float(
            queue_low if queue_low is not None
            else _env("PADDLE_AUTOSCALE_QUEUE_LOW", 0.5, float))
        if not 0 <= self.queue_low < self.queue_high:
            raise ValueError(
                f"need 0 <= queue_low ({self.queue_low}) < queue_high "
                f"({self.queue_high}) — equal watermarks flap on every "
                "tick")
        self.kv_free_low = float(
            kv_free_low if kv_free_low is not None
            else _env("PADDLE_AUTOSCALE_KV_FREE_FRAC", 0.1, float))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _env("PADDLE_AUTOSCALE_COOLDOWN_S", 10.0, float))
        self.hysteresis = int(
            hysteresis if hysteresis is not None
            else _env("PADDLE_AUTOSCALE_HYSTERESIS", 2, int))
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        # disaggregated per-pool watermarks (role_aware mode): prefill
        # defaults inherit the global queue watermarks; decode kv
        # headroom inherits the global one; session-depth watermarks
        # are decode-pool-only (a mixed cluster has no such signal)
        self.role_aware = bool(
            role_aware if role_aware is not None
            else _env("PADDLE_AUTOSCALE_ROLE_AWARE", 0, int))
        self.pf_queue_high = float(
            pf_queue_high if pf_queue_high is not None
            else _env("PADDLE_AUTOSCALE_PF_QUEUE_HIGH",
                      self.queue_high, float))
        self.pf_queue_low = float(
            pf_queue_low if pf_queue_low is not None
            else _env("PADDLE_AUTOSCALE_PF_QUEUE_LOW",
                      self.queue_low, float))
        if not 0 <= self.pf_queue_low < self.pf_queue_high:
            raise ValueError(
                f"need 0 <= pf_queue_low ({self.pf_queue_low}) < "
                f"pf_queue_high ({self.pf_queue_high})")
        self.dc_kv_free_low = float(
            dc_kv_free_low if dc_kv_free_low is not None
            else _env("PADDLE_AUTOSCALE_DC_KV_FREE_FRAC",
                      self.kv_free_low, float))
        self.dc_sessions_high = float(
            dc_sessions_high if dc_sessions_high is not None
            else _env("PADDLE_AUTOSCALE_DC_SESSIONS_HIGH", 0.85, float))
        self.dc_sessions_low = float(
            dc_sessions_low if dc_sessions_low is not None
            else _env("PADDLE_AUTOSCALE_DC_SESSIONS_LOW", 0.3, float))
        if not 0 <= self.dc_sessions_low < self.dc_sessions_high:
            raise ValueError(
                f"need 0 <= dc_sessions_low ({self.dc_sessions_low}) "
                f"< dc_sessions_high ({self.dc_sessions_high})")
        self.clock = clock or time.monotonic
        self.name_prefix = name_prefix
        # serializes tick / scale_to / the gateway's drain path: the
        # health sweep, POST /admin/scale, and POST /admin/drain all run
        # in executor threads — unserialized, two concurrent scale-downs
        # can each pass the min-replica check and drain the cluster to
        # zero with no recovery path (decide() then reads the empty
        # cluster as "down" forever)
        self._op_lock = threading.RLock()
        self._seq = 0
        self._streak_dir = None           # pending decision direction
        self._streak = 0                  # consecutive agreeing ticks
        self._last_scale_t = None
        # None = not yet seeded: the engines' violated_queue counters
        # are CUMULATIVE window counters, so the first real reading
        # must become the baseline, not a delta — otherwise attaching
        # an autoscaler to a cluster with violation history spawns a
        # replica on a quiet cluster at the first tick
        self._last_violated_queue = None
        self.ticks = 0

    # ---------------------------------------------------------- signals
    def signals(self):
        """One reading of the scaling inputs off the router's snapshot
        cache (refreshing it first)."""
        self.router.refresh()
        with self.router._lock:
            names = self.router.placeable_names()
            snaps = [self.router._snap(n) for n in names]
        snaps = [s for s in snaps if s is not None]
        n = max(len(snaps), 1)
        qmean = sum(int(s.get("queue_depth", 0)) for s in snaps) / n
        kv_free = 1.0
        for s in snaps:
            b = s.get("kv_blocks")
            if b and b.get("kv_blocks_total"):
                kv_free = min(kv_free, b["kv_blocks_free"]
                              / b["kv_blocks_total"])
        # scale on HIGH-priority queue pain only (snapshot v4 splits
        # violated_queue by class): low-class violations under overload
        # are the QoS layer degrading gracefully — spawning a replica
        # for them defeats the priority shed. Snapshots without the
        # per-class split (none today; defensive) fall back to totals.
        vq = 0
        for s in snaps:
            slo = s.get("slo") or {}
            by_cls = slo.get("violated_queue_by_class")
            vq += int(by_cls["high"] if by_cls is not None
                      else slo.get("violated_queue", 0))
        return {"replicas": len(names), "snapshots": len(snaps),
                "queue_mean": qmean, "kv_free_frac": kv_free,
                "slo_violated_queue": vq}

    def signals_roles(self):
        """One per-pool reading for role-aware scaling: the PREFILL
        pool is scored by queue pressure (its work arrives as prompt
        backlog), the DECODE pool by kv headroom and worst resident-
        session depth (its work is sessions pinning slots + blocks).
        Mixed replicas belong to neither pool — they scale on the
        classic global path only."""
        self.router.refresh()
        with self.router._lock:
            pf, dc = [], []
            for n in self.router.placeable_names():
                role = self.router.roles.get(n, "mixed")
                if role == "prefill":
                    pf.append(self.router._snap(n))
                elif role == "decode":
                    dc.append(self.router._snap(n))
        n_pf, n_dc = len(pf), len(dc)
        pf = [s for s in pf if s is not None]
        dc = [s for s in dc if s is not None]
        qmean = (sum(int(s.get("queue_depth", 0)) for s in pf)
                 / max(len(pf), 1))
        kv_free, sess = 1.0, 0.0
        for s in dc:
            b = s.get("kv_blocks")
            if b and b.get("kv_blocks_total"):
                kv_free = min(kv_free, b["kv_blocks_free"]
                              / b["kv_blocks_total"])
            if s.get("num_slots"):
                sess = max(sess, (s["num_slots"] - s["slots_free"])
                           / s["num_slots"])
        return {"prefill_replicas": n_pf, "decode_replicas": n_dc,
                "prefill_snapshots": len(pf),
                "decode_snapshots": len(dc),
                "prefill_queue_mean": qmean,
                "decode_kv_free_frac": kv_free,
                "decode_sessions_frac": sess}

    def decide_roles(self, sig):
        """Pure per-pool watermark logic for ONE ``signals_roles``
        reading: ``("up"|"down", "prefill"|"decode")`` or None. The
        pools scale on DIFFERENT signal families — prefill on queue
        depth, decode on kv headroom + resident sessions. Scale-up
        wins over scale-down when both fire, and prefill backlog
        beats decode pressure (the backlog is user-visible TTFT).
        Bounds/hysteresis/cooldown live in ``tick`` — this stays a
        unit-testable truth table."""
        if sig["prefill_snapshots"] > 0 \
                and sig["prefill_queue_mean"] > self.pf_queue_high:
            return ("up", "prefill")
        if sig["decode_snapshots"] > 0 \
                and (sig["decode_kv_free_frac"] < self.dc_kv_free_low
                     or sig["decode_sessions_frac"]
                     > self.dc_sessions_high):
            return ("up", "decode")
        if sig["prefill_snapshots"] > 0 \
                and sig["prefill_queue_mean"] < self.pf_queue_low:
            return ("down", "prefill")
        if sig["decode_snapshots"] > 0 \
                and sig["decode_sessions_frac"] < self.dc_sessions_low \
                and sig["decode_kv_free_frac"] > self.dc_kv_free_low:
            return ("down", "decode")
        return None

    def decide(self, sig):
        """Pure watermark logic for ONE signal reading: ``"up"``,
        ``"down"``, or None. Hysteresis/cooldown/bounds live in
        ``tick`` — this stays unit-testable as a truth table."""
        vq_delta = (0 if self._last_violated_queue is None
                    else max(sig["slo_violated_queue"]
                             - self._last_violated_queue, 0))
        if (sig["queue_mean"] > self.queue_high
                or sig["kv_free_frac"] < self.kv_free_low
                or vq_delta > 0):
            return "up"
        if sig.get("snapshots", 1) == 0:
            # no snapshot data at all (every placeable replica's fetch
            # failed — e.g. busy rpc workers timing out the liveness
            # probe during a load spike): the zeroed signals would read
            # as an idle cluster and drain healthy, saturated capacity
            # exactly when load is highest. No data -> hold.
            return None
        if sig["queue_mean"] < self.queue_low:
            return "down"
        return None

    # ------------------------------------------------------------- loop
    def tick(self):
        """One control iteration; returns "up"/"down" when a scale
        event fired, else None. Serialized with scale_to()/drain():
        at most one scale operation is in flight at a time."""
        with self._op_lock:
            self.ticks += 1
            # the min-replica FLOOR is an invariant, not a load signal:
            # an operator /admin/drain (guarded only against the LAST
            # replica) or a replica death can leave the set below it,
            # and no watermark would ever fire on an idle cluster —
            # restore it now, bypassing hysteresis and cooldown (a
            # failing spawn hook is retried at the sweep cadence; the
            # gateway's health loop swallows the exception)
            if self.role_aware:
                return self._tick_roles()
            if len(self.router.placeable_names()) < self.min_replicas:
                self._scale_up()
                self._last_scale_t = self.clock()
                self._streak_dir, self._streak = None, 0
                return "up"
            sig = self.signals()
            want = self.decide(sig)
            # goodput violations are EVENT-shaped (a delta consumed by
            # the baseline update below), so the consecutive-tick
            # hysteresis meant for level signals could never be met by
            # them alone — and a violated SLO is already lagging
            # evidence of damage done. New violations bypass the
            # streak requirement (cooldown still rate-limits).
            vq_event = (self._last_violated_queue is not None
                        and sig.get("snapshots", 1) > 0
                        and sig["slo_violated_queue"]
                        > self._last_violated_queue)
            if sig.get("snapshots", 1) > 0:
                # don't let a snapshot outage zero the baseline — the
                # counters' full history would read as a fresh delta
                # (spurious scale-up) when the snapshots return
                self._last_violated_queue = sig["slo_violated_queue"]
            if want != self._streak_dir:
                self._streak_dir, self._streak = want, 0
            if want is None:
                return None
            self._streak += 1
            if self._streak < self.hysteresis \
                    and not (want == "up" and vq_event):
                return None
            now = self.clock()
            if self._last_scale_t is not None \
                    and now - self._last_scale_t < self.cooldown_s:
                return None
            # bound check against the CURRENT placeable count, not the
            # signal reading — an /admin drain may have landed between
            # signals() and here
            n = len(self.router.placeable_names())
            if want == "up" and n < self.max_replicas:
                self._scale_up()
            elif want == "down" and n > self.min_replicas:
                self._scale_down()
            else:
                return None               # at a bound: keep watching
            self._last_scale_t = now
            self._streak_dir, self._streak = None, 0
            return want

    def _tick_roles(self):
        """One role-aware control iteration (caller holds _op_lock):
        pools are repaired first (each must keep >= 1 replica — an
        empty prefill pool strands every new prompt, an empty decode
        pool strands every prefilled session), then at most one
        watermark-driven per-pool scale event fires. Returns
        "up:prefill"-style verdicts."""
        with self.router._lock:
            names = self.router.placeable_names()
            by_pool = {"prefill": [], "decode": []}
            mixed = 0
            for n in names:
                role = self.router.roles.get(n, "mixed")
                if role in by_pool:
                    by_pool[role].append(n)
                else:
                    mixed += 1
        # pool-floor repair bypasses hysteresis/cooldown like the
        # classic min-floor (mixed replicas cover for either pool)
        for pool in ("prefill", "decode"):
            if not by_pool[pool] and not mixed \
                    and len(names) < self.max_replicas:
                self._scale_up(pool)
                self._last_scale_t = self.clock()
                self._streak_dir, self._streak = None, 0
                return f"up:{pool}"
        sig = self.signals_roles()
        want = self.decide_roles(sig)
        if want != self._streak_dir:
            self._streak_dir, self._streak = want, 0
        if want is None:
            return None
        self._streak += 1
        if self._streak < self.hysteresis:
            return None
        now = self.clock()
        if self._last_scale_t is not None \
                and now - self._last_scale_t < self.cooldown_s:
            return None
        direction, pool = want
        n = len(self.router.placeable_names())
        if direction == "up" and n < self.max_replicas:
            self._scale_up(pool)
        elif direction == "down" and n > self.min_replicas \
                and len(by_pool[pool]) > 1:
            self._scale_down(pool)
        else:
            return None                   # at a bound: keep watching
        self._last_scale_t = now
        self._streak_dir, self._streak = None, 0
        return f"{direction}:{pool}"

    def _scale_up(self, role=None):
        self._seq += 1
        if role is None and self.role_aware:
            # operator scale_to / min-floor repair in role-aware mode:
            # generic capacity goes to the decode pool (sessions live
            # there; the prefill pool scales on its own queue signal)
            role = "decode"
        if role is not None:
            name = f"{self.name_prefix}-{role}-{self._seq}"
            rep = self.spawn(name, role)
        else:
            rep = self.spawn(f"{self.name_prefix}-{self._seq}")
        self.router.add_replica(rep)
        return rep.name

    def _scale_down(self, role=None):
        """Drain the LEAST-loaded placeable replica — fewest live
        sessions to migrate. ``role`` restricts the victim to one
        pool (role-aware mode); the decode pool scores by resident-
        session pressure (no queue term)."""
        if role is None and self.role_aware:
            role = "decode"
        with self.router._lock:
            cands = [n for n in self.router.placeable_names()
                     if role is None
                     or self.router.roles.get(n, "mixed") == role]
            if role is not None and len(cands) <= 1:
                return None               # never drain a pool to zero
            score = (self.router.decode_load_score if role == "decode"
                     else self.router.load_score)
            victim = min(cands, key=lambda n: (
                score(self.router._snap(n)), n))
        self.router.remove_replica(victim, migrate=True)
        return victim

    def scale_to(self, n):
        """Operator override (the gateway's POST /admin/scale): walk
        the replica count to ``n`` (clamped to [min, max]) NOW,
        bypassing hysteresis and cooldown. Returns the clamped
        target."""
        n = max(self.min_replicas, min(int(n), self.max_replicas))
        with self._op_lock:
            guard = 0
            while guard < 64:
                cur = len(self.router.placeable_names())
                if cur == n:
                    break
                if cur < n:
                    self._scale_up()
                else:
                    self._scale_down()
                guard += 1
            self._last_scale_t = self.clock()
            self._streak_dir, self._streak = None, 0
        return n
