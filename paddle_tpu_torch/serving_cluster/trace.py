"""Cluster-merged Perfetto export: ONE Chrome trace for a whole
serving cluster.

``export_cluster_trace(gateway_or_router, path)`` merges three event
sources into one ``telemetry.ChromeTrace`` document:

  * pid 0 — the GATEWAY process: one complete event per handled HTTP
    request (the gateway's bounded ``http_log``) on an "http" track,
    and one instant per router placement decision (the audit ring) on
    a "router" track — policy, reason, per-candidate scores, attempt;
  * pid 1..N — one process per REPLICA (dead ones included: a killed
    LocalReplica's rings are the post-mortem): its engine's dispatch
    timeline on tid 0 and per-slot request spans on tids 1..B, each
    span carrying its ``trace_id``/``attempt`` args — the same layout
    as ``telemetry.export_chrome_tracing`` for one engine.

Cross-process alignment follows the flight recorder's discipline:
every source contributes a ``(t_wall, t_mono)`` anchor pair captured
at dump time, each monotonic timestamp is rebased to wall time through
its OWN source's anchor, and the whole trace is shifted to the
earliest rebased event — so a gateway HTTP span, the router decision
that placed it, and both replicas' engine spans (attempt 1 on the
killed replica, attempt 2 on the failover target) line up on one
timeline under one trace id.

The output passes ``telemetry.validate_chrome_trace`` (the tests and
``chip_smoke.py``'s cluster phase gate on it, the same discipline as
the single-engine export gate).
"""
from __future__ import annotations

import time

from ..inference import telemetry
from ..inference.telemetry import ChromeTrace
from .replica import ReplicaError

__all__ = ["export_cluster_trace"]


def _source_anchors(router):
    """(t_wall - t_mono) offsets for the gateway/router's own clocks,
    captured NOW (their events are still in-process — unlike replica
    dumps there is no serialized anchor to read). The gateway's HTTP
    spans stamp ``time.monotonic()``, so its anchor is the plain
    monotonic offset."""
    now_wall = time.time()
    return {"http": now_wall - time.monotonic(),
            "router": now_wall - router.clock()}


def export_cluster_trace(source, path):
    """Write the merged cluster trace; ``source`` is a ``Gateway`` (the
    full picture: http + router + replicas) or a bare ``Router``
    (virtual-clock drives: router + replicas, no http track).
    Unreachable rpc replicas are skipped with a metadata note instead
    of failing the export — a post-mortem tool must degrade, not die.
    Returns ``path``."""
    gateway = source if hasattr(source, "router") else None
    router = gateway.router if gateway is not None else source

    anchors = _source_anchors(router)
    http_events = []
    http_log_lost = False
    if gateway is not None:
        for i in range(3):
            try:
                http_events = list(gateway.http_log)
                break
            except RuntimeError:
                # the event loop appended mid-iteration (deques guard
                # their iterators); a live gateway is a supported
                # export target, so retry rather than die — and if
                # every retry loses the race, say so in the trace
                # instead of silently exporting an empty HTTP track
                http_log_lost = i == 2
    with router._lock:
        audit = list(router.audit)
    dumps = {}
    unreachable = []
    for name in sorted(router.replicas):
        try:
            dumps[name] = router.replicas[name].trace_dump()
        except ReplicaError:
            unreachable.append(name)

    # ---- rebase: every event to wall time through ITS source's anchor
    times = []
    for ev in http_events:
        times.append(anchors["http"] + ev["t"])
    for ev in audit:
        times.append(anchors["router"] + ev["t"])
    for d in dumps.values():
        a = d["t_wall"] - d["t_mono"]
        for sp in d["spans"]:
            times.extend(a + t for _, t in sp["events"])
        times.extend(a + ev["t"] for ev in d["steps"])
    base = min(times) if times else 0.0

    def us(anchor_off, t):
        return max((anchor_off + t - base) * 1e6, 0.0)

    tr = ChromeTrace()
    tr.process(0, "gateway")
    tr.thread(0, 0, "http")
    tr.thread(0, 1, "router decisions")
    for ev in http_events:
        args = {"trace_id": ev["trace_id"], "status": ev["status"]}
        if ev.get("gid"):
            args["gid"] = ev["gid"]
        tr.complete(f"{ev['method']} {ev['path']} [{ev['status']}]",
                    0, 0, us(anchors["http"], ev["t"]),
                    max(ev["dur_s"] or 0.0, 0.0) * 1e6, args=args)
    for ev in audit:
        tr.instant(f"route[{ev['reason']}] {ev['gid']} -> "
                   f"{ev['chosen']}", 0, 1,
                   us(anchors["router"], ev["t"]))
        # instants carry no args in the shared event model — follow
        # with a zero-duration complete event holding the decision
        # payload (policy, scores, trace context) for inspection
        tr.complete(f"decision {ev['gid']}", 0, 1,
                    us(anchors["router"], ev["t"]), 0.0,
                    args={"trace_id": ev["trace_id"],
                          "policy": ev["policy"],
                          "reason": ev["reason"],
                          "chosen": ev["chosen"],
                          "attempt": ev["attempt"],
                          "scores": ev["scores"]})
    if http_log_lost:
        tr.instant("gateway http log unavailable (snapshot raced the "
                   "event loop 3x — HTTP track incomplete)", 0, 0, 0.0)
    for name in unreachable:
        tr.instant(f"replica {name}: trace unavailable (unreachable)",
                   0, 1, 0.0)

    for pid, name in enumerate(sorted(dumps), start=1):
        d = dumps[name]
        a = d["t_wall"] - d["t_mono"]
        # the per-replica layout is telemetry's single-engine renderer
        # verbatim — shared so the two exports cannot drift apart
        telemetry.render_trace_dump(
            tr, pid, d, lambda t, a=a: us(a, t),
            process_name=f"replica {name}")
    tr.write(path)
    return path
