"""Replica handles: ONE interface over an in-process engine thread and
(with the distributed runtime, ROADMAP 10(e)) a remote engine behind rpc.

The router never sees a ServingEngine — it sees a *replica*: submit /
poll / harvest / release / snapshot / heartbeat. Two implementations:

  * ``LocalReplica`` — thread-per-engine. The driver thread loops
    ``engine.step()`` while there is work and publishes a heartbeat
    each iteration; every engine touch (submit, harvest, snapshot)
    serializes on one lock, so the single-threaded engine stays
    single-threaded. ``threaded=False`` hands the drive loop to the
    caller (``pump()``) — the router tests use it to run the whole
    cluster on a virtual clock, deterministically.
  * ``RpcReplica`` — the same interface over ``rpc_sync`` to a worker
    process that runs ``serve_engine()``. The port has no rpc yet: both
    raise NotImplementedError naming ROADMAP 10(e), with JAX's
    signatures.

Death is a first-class state: ``kill()`` (tests, fault drills) freezes the
driver without draining — heartbeats stop, ``alive`` flips false, and
every engine touch raises ``ReplicaError`` so the router's failover
path (drain + re-submit elsewhere) is the ONLY way forward, exactly
like a crashed process.
"""
from __future__ import annotations

import threading
import time

from ..inference.serving import AdmissionFull

__all__ = ["ReplicaError", "LocalReplica", "RpcReplica", "serve_engine"]


class ReplicaError(RuntimeError):
    """The replica is dead or unreachable — the router must fail over.
    Deliberately DISTINCT from AdmissionFull: backpressure means retry
    or spill, death means drain and re-route."""


_RTT_ALPHA = 0.2    # EWMA smoothing for proxy-side RTT observation


class _HealthMeter:
    """Proxy-side gray-failure observables, shared by both replica
    flavors: an EWMA of per-operation round-trip time (submit / harvest
    / snapshot / ping) and a consecutive-transport-error streak. The
    router's health scorer reads these through ``health_stats()`` —
    RTTs catch a slow-but-alive replica, the error streak catches a
    lossy link, and NEITHER declares death (that stays the heartbeat
    sweep's job)."""

    __slots__ = ("rtt", "consec_errors", "errors_total", "ops_total")

    def __init__(self):
        self.rtt = {}             # op -> EWMA seconds
        self.consec_errors = 0
        self.errors_total = 0
        self.ops_total = 0

    def ok(self, op, dt):
        prev = self.rtt.get(op)
        self.rtt[op] = dt if prev is None else (
            (1.0 - _RTT_ALPHA) * prev + _RTT_ALPHA * dt)
        self.consec_errors = 0
        self.ops_total += 1

    def err(self):
        self.consec_errors += 1
        self.errors_total += 1
        self.ops_total += 1

    def stats(self):
        return {
            "rtt_ewma_s": dict(self.rtt),
            "consecutive_errors": self.consec_errors,
            "errors_total": self.errors_total,
            "ops_total": self.ops_total,
        }


class LocalReplica:
    """Thread-per-engine in-process replica (see module docstring)."""

    def __init__(self, name, engine, threaded=True, clock=None,
                 idle_wait_s=0.002, step_hook=None):
        self.name = name
        self.engine = engine
        # pool role for the router's placement filter (prefill workers
        # never take decode-resident sessions and vice versa); engines
        # predating the role knob read as mixed = place anywhere
        self.role = getattr(engine, "role", "mixed")
        self._lock = threading.RLock()
        self._clock = clock or time.monotonic
        self._hb = self._clock()
        self._failed = False
        self._stop = False
        self._wake = threading.Event()
        self._idle_wait_s = float(idle_wait_s)
        # called as hook(self) after every WORKING engine step — the
        # deterministic fault-drill lever (kill at exactly step K,
        # mid-request, regardless of scheduler/socket timing)
        self._step_hook = step_hook
        self._health = _HealthMeter()
        self._thread = None
        if threaded:
            self._thread = threading.Thread(
                target=self._drive, daemon=True,
                name=f"replica-{name}")
            self._thread.start()

    # ------------------------------------------------------------ drive
    def _drive(self):
        while not self._stop:
            if self._failed:
                return                    # crash: heartbeat freezes
            with self._lock:
                work = self.engine.has_work and not self._failed
                if work:
                    self.engine.step()
            if work and self._step_hook is not None:
                self._step_hook(self)
            self._hb = self._clock()
            if not work:
                self._wake.wait(self._idle_wait_s)
                self._wake.clear()

    def pump(self):
        """Unthreaded drive: one engine step if there is work; returns
        tokens emitted. The caller owns the cadence (virtual-clock
        drives, deterministic tests)."""
        self._check_alive()
        with self._lock:
            work = self.engine.has_work
            out = self.engine.step() if work else 0
        if work and self._step_hook is not None:
            self._step_hook(self)
        self._hb = self._clock()
        return out

    # ---------------------------------------------------------- health
    def heartbeat_age(self):
        return self._clock() - self._hb

    @property
    def alive(self):
        if self._failed or self._stop:
            return False
        return self._thread is None or self._thread.is_alive()

    def _check_alive(self):
        if not self.alive:
            raise ReplicaError(f"replica {self.name!r} is dead")

    def health_stats(self):
        """Proxy-side gray-failure observables (see _HealthMeter)."""
        return self._health.stats()

    def kill(self):
        """Simulated crash (tests and fault drills): the driver stops
        mid-flight WITHOUT draining — in-flight requests are stranded
        exactly as a SIGKILLed process would strand them."""
        self._failed = True
        self._wake.set()

    def close(self):
        """Graceful stop (not a crash): the drive thread exits; the
        engine keeps its state."""
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # ----------------------------------------------------------- engine
    def submit(self, prompt, **kw):
        """submit + track under ONE lock hold: the streaming cursor is
        registered before the driver thread can possibly finish the
        request, closing the results-cap race by construction."""
        self._check_alive()
        t0 = self._clock()
        with self._lock:
            rid = self.engine.submit(prompt, **kw)
            self.engine.track(rid)
        self._health.ok("submit", self._clock() - t0)
        self._wake.set()
        return rid

    def harvest(self, rid):
        self._check_alive()
        t0 = self._clock()
        with self._lock:
            out = self.engine.harvest_new_tokens(rid)
        self._health.ok("harvest", self._clock() - t0)
        return out

    def poll(self, rid):
        self._check_alive()
        with self._lock:
            return self.engine.poll(rid)

    def release(self, rid):
        if not self.alive:
            return                        # nothing to free on a corpse
        with self._lock:
            self.engine.release(rid)

    def export_slot(self, rid, skip_blocks=0):
        """Live-migration export: detach one request's full decode
        state (engine.export_slot) under the replica lock, so the
        driver thread can never interleave a step mid-export.
        ``skip_blocks`` elides KV blocks the target already staged
        (streamed handoff)."""
        self._check_alive()
        with self._lock:
            return self.engine.export_slot(rid, skip_blocks=skip_blocks)

    def import_slot(self, state, staged=None):
        """Live-migration import: resume an exported session here.
        Tracks the new rid under the SAME lock hold, exactly like
        submit — the streaming cursor exists before the driver can
        finish the request. ``staged`` names a stage_kv_blocks tag
        whose blocks splice in as the session's leading KV."""
        self._check_alive()
        with self._lock:
            rid = self.engine.import_slot(state, staged=staged)
            self.engine.track(rid)
        self._wake.set()
        return rid

    def export_kv_prefix(self, rid, start_block=0, min_blocks=1):
        """Streamed-handoff source: read a live request's committed
        full KV blocks from ``start_block`` on, WITHOUT detaching it
        (engine.export_kv_prefix). Returns (blocks, cursor)."""
        self._check_alive()
        with self._lock:
            return self.engine.export_kv_prefix(
                rid, start_block=start_block, min_blocks=min_blocks)

    def stage_kv_blocks(self, tag, blocks):
        """Streamed-handoff sink: land KV blocks ahead of their
        session's import under ``tag`` (engine.stage_kv_blocks;
        AdmissionFull = backpressure, the stream stays put)."""
        self._check_alive()
        with self._lock:
            return self.engine.stage_kv_blocks(tag, blocks)

    def abort_stage(self, tag):
        """Release a staging tag's blocks (handoff fell through)."""
        if not self.alive:
            return 0                      # nothing to free on a corpse
        with self._lock:
            return self.engine.abort_stage(tag)

    def snapshot(self):
        self._check_alive()
        t0 = self._clock()
        with self._lock:
            snap = self.engine.telemetry_snapshot()
        self._health.ok("snapshot", self._clock() - t0)
        snap["replica"] = self.name
        return snap

    def metrics_prometheus(self):
        self._check_alive()
        with self._lock:
            return self.engine.metrics_prometheus()

    def trace_dump(self):
        """JSON-able dump of the engine's telemetry rings for the
        cluster trace export (telemetry.trace_dump + replica name).
        Deliberately NO alive check: a killed replica's rings are the
        post-mortem — its stranded in-flight spans are exactly what the
        merged kill-drill trace must show."""
        from ..inference.telemetry import trace_dump
        with self._lock:
            d = trace_dump(self.engine)
        d["replica"] = self.name
        return d


# ----------------------------------------------------------- rpc worker
_RPC_TODO = ("out-of-process replicas need the distributed runtime's rpc, "
             "which the port does not have yet (ROADMAP 10(e)); use "
             "LocalReplica")


def serve_engine(engine, name="replica", threaded=True):
    """Install ``engine`` as this process's rpc-served replica (JAX's
    signature); raises NotImplementedError until 10(e)'s rpc."""
    raise NotImplementedError(f"serve_engine: {_RPC_TODO}")


class RpcReplica:
    """The replica interface over rpc to a ``serve_engine`` worker (JAX's
    signature); raises NotImplementedError until 10(e)'s rpc."""

    def __init__(self, worker_name, timeout=None, ping_timeout=None):
        raise NotImplementedError(f"RpcReplica({worker_name!r}): {_RPC_TODO}")
