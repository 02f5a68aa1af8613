"""Metrics-surface coverage check of the port (the counterpart of the
repository's ``tools/check_metrics_surface.py``, which checks the JAX
package's), runnable as
``python -m paddle_tpu_torch.tools.check_metrics_surface [--device cpu]``
and from a test.

Every key ``ServingEngine.metrics()`` can emit must be covered by all
three of:

  1. ``reset_metrics`` — after a reset the key must read like a fresh
     engine's (or be on ``telemetry.RESET_EXEMPT_KEYS``: the trace spy
     and allocator state, which legitimately survive a window reset);
  2. the reconciliation — ``check_serving_metrics`` in tests/conftest.py
     must mention the key (every serving test then exercises its
     invariant);
  3. the Prometheus exposition — ``telemetry.PROMETHEUS_NAMES`` must
     map the key to a stable name (or list it in
     ``telemetry.PROMETHEUS_EXEMPT_KEYS``), and the mapped name must
     actually appear in ``metrics_prometheus()`` output whenever the
     key has a value.

Also pinned: the ``telemetry_snapshot()`` schema (the router's wire
payload), the runtime registry's exposition, the SLO and router-audit
counter names, the dispatch kinds every scheduler's dispatches take
(``generation.DISPATCH_KINDS``), the QoS per-class series and the
disaggregated-serving role and handoff surface, and (section 8) the
mesh shard gauges of an mp=2 engine: ``kv_shard_*`` against the pool it
allocated, the weight-placement gauges' byte identity (fp, and int4 with
an int8 pool), their Prometheus series, and the dispatch families of the
sharded step.

The engines run on the card unless ``--device cpu`` asks for the CPU.
Exit code 0 means the surface is covered.
"""
from __future__ import annotations

import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_DEVICE = [None]


def _build_engine(**kw):
    import numpy as np

    from ..inference.serving import ServingEngine
    from ..weights import from_jax_state, random_state

    V, E, H, FF, L = 67, 32, 4, 64, 1
    mods = from_jax_state(*random_state(np.random.default_rng(11),
                                        E, H, FF, L, V),
                          device=_DEVICE[0])
    # prefix cache ON (paged default): the widest metrics surface —
    # every key the engine can emit is present in this configuration
    rng = np.random.RandomState(5)
    args = dict(num_slots=2, max_seq_len=64, decode_chunk=2,
                prefill_cap=4, prefix_cache_blocks=8, device=_DEVICE[0])
    args.update(kw)
    eng = ServingEngine(*mods, **args)
    return eng, rng, V


def _record_dispatches(eng, seen):
    """Wrap the engine's dispatch choke point so every dispatch family
    it runs lands in ``seen``."""
    run = eng._run_dispatch

    def spy(key, *a, **kw):
        seen.add(key[0])
        return run(key, *a, **kw)
    eng._run_dispatch = spy
    return eng


def main(argv=None):
    import argparse

    from ..inference.telemetry import (PROMETHEUS_EXEMPT_KEYS,
                                       PROMETHEUS_NAMES, RESET_EXEMPT_KEYS)
    import numpy as np

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.check_metrics_surface")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda)")
    _DEVICE[0] = ap.parse_args(argv).device
    failures = []
    eng, rng, V = _build_engine()
    dispatched = set()
    _record_dispatches(eng, dispatched)
    fresh = eng.metrics()
    keys = set(fresh)

    # ---- drive real traffic so every counter that CAN move has moved
    for n in (5, 9):
        eng.submit(rng.randint(1, V, (n,)).astype(np.int32),
                   max_new_tokens=3)
    eng.run()
    moved = eng.metrics()
    # exposition captured on the ACTIVE window (post-reset, derived
    # gauges like tokens_per_sec legitimately report None and vanish)
    text = eng.metrics_prometheus()

    # ---- 1. reset coverage
    eng.reset_metrics(keep_results=False)
    after = eng.metrics()
    for k in sorted(keys):
        if k in RESET_EXEMPT_KEYS:
            continue
        if after[k] != fresh[k]:
            failures.append(
                f"reset_metrics does not restore {k!r}: fresh "
                f"{fresh[k]!r} vs post-reset {after[k]!r} (cover it in "
                "reset_metrics or document it in "
                "telemetry.RESET_EXEMPT_KEYS)")

    # ---- 2. conftest reconciliation coverage (textual: the key must
    # be asserted on in check_serving_metrics)
    conftest_path = os.path.join(REPO_ROOT, "tests", "conftest.py")
    with open(conftest_path) as f:
        src = f.read()
    body = src.split("def check_serving_metrics", 1)
    if len(body) != 2:
        failures.append("tests/conftest.py lost check_serving_metrics")
        body = ["", src]
    for k in sorted(keys):
        if f'"{k}"' not in body[1]:
            failures.append(
                f"check_serving_metrics (tests/conftest.py) never "
                f"touches metrics key {k!r} — add a reconciliation or "
                "sanity assert for it")

    # ---- 3. Prometheus exposition coverage
    for k in sorted(keys):
        if k in PROMETHEUS_EXEMPT_KEYS:
            continue
        if k not in PROMETHEUS_NAMES:
            failures.append(
                f"metrics key {k!r} has no telemetry.PROMETHEUS_NAMES "
                "entry (map it to a stable name, or add it to "
                "PROMETHEUS_EXEMPT_KEYS with a reason)")
            continue
        name, typ = PROMETHEUS_NAMES[k]
        probe = f"{name}_bucket" if typ == "histogram" else name
        # a gauge currently reporting None may legitimately be absent;
        # anything the engine HAS a value for must be in the text.
        # `moved` (pre-reset) is the window where values existed.
        if moved.get(k) is not None and probe not in text:
            failures.append(
                f"metrics key {k!r} maps to {name!r} ({typ}) but the "
                "exposition does not contain it")

    # ---- 4. telemetry_snapshot() schema coverage: the snapshot is the
    # cluster router's WIRE payload (serving_cluster/router.py scores
    # replicas off it over rpc), so its key set is pinned structurally:
    # required keys all present, nothing outside required+optional, a
    # version stamp the router refuses to misread, and the whole thing
    # JSON-serializable (it crosses process boundaries)
    _check_snapshot_schema(failures, eng)

    # ---- 5. runtime registry coverage: a registered histogram and
    # counter surface under their names in runtime_prometheus() and the
    # registry snapshot, beside the restart generation
    _check_runtime_registry(failures)

    # ---- 6. SLO counter names + router decision-audit counters: the
    # goodput surface the autoscaling item will consume — dashboards
    # key on these exact strings, so they are pinned BY VALUE, not just
    # by the mapping-exists rule of section 3
    _check_slo_and_audit_surface(failures)

    # ---- 7. dispatch-kind coverage: every dispatch family the
    # serving engines actually run must name itself in
    # generation.DISPATCH_KINDS — a new family without an entry would
    # silently fall through to an unclassified label in the telemetry
    # step timeline instead of failing here
    n_kinds = _check_dispatch_kinds(failures, dispatched)

    # ---- 8. mesh shard-gauge coverage: an mp=2 head-sharded paged
    # engine must reconcile its kv_shard_* gauges against the actual
    # pool layout, its weight gauges against the arrays it dispatches,
    # expose them in Prometheus, and dispatch ONLY families already in
    # DISPATCH_KINDS
    _check_mesh_shard_surface(failures)

    # ---- 9. QoS surface: the per-class counter names (class-labeled
    # Prometheus series) are pinned BY VALUE — QoS dashboards and the
    # chip checks key on these exact strings — the class-label series
    # exist zero-valued BEFORE any traffic (the label set is
    # discoverable up front), and the v4 snapshot carries the per-class
    # queue depths + violation split the shed/autoscale paths read
    _check_qos_surface(failures)

    # ---- 10. disaggregated-serving surface: the role label (snapshot
    # + Prometheus info gauge), the handoff counters
    # kv_blocks_shipped/adopted, and the transfer-bytes histogram —
    # what the disaggregated checks and the per-pool dashboards key
    # on; the v5 snapshot stamp keeps pre-role routers refusing the
    # payload instead of misreading it
    _check_role_surface(failures)

    if failures:
        print("check_metrics_surface: FAILED")
        for f_ in failures:
            print(f"  - {f_}")
        return 1
    print(f"check_metrics_surface: ok ({len(keys)} metrics keys covered "
          "by reset_metrics + conftest reconciliation + Prometheus "
          "exposition; snapshot schema pinned; runtime registry "
          "exposed; SLO + router-audit counter names pinned; "
          f"{n_kinds} dispatched families covered by "
          "generation.DISPATCH_KINDS; QoS per-class series pinned + "
          "zero-initialized; disagg role/handoff surface pinned "
          "end-to-end; mp=2 shard gauges reconcile)")
    return 0


def _check_mesh_shard_surface(failures):
    """Drive an mp=2 head-sharded paged engine (both shards on this
    check's device) and reconcile its shard gauges against the pool and
    the weights it actually holds. The port's fleet state is saved and
    restored around the probe."""
    import math

    import numpy as np

    from ..distributed.fleet import _fleet_state
    from ..distributed.fleet.base.topology import _HYBRID_GROUP
    from ..inference import generation
    from ..inference.telemetry import PROMETHEUS_NAMES
    from ..parallel import init_serving_mesh

    dev = _DEVICE[0] or "cuda:0"
    prior_hcg = _HYBRID_GROUP[0]
    prior_fleet = dict(_fleet_state)
    try:
        _HYBRID_GROUP[0] = None
        _fleet_state.update(strategy=None, hcg=None)
        init_serving_mesh(2, devices=[dev] * 2)
        eng, rng, V = _build_engine()
        seen = set()
        _record_dispatches(eng, seen)
        for n in (5, 9):
            eng.submit(rng.randint(1, V, (n,)).astype(np.int32),
                       max_new_tokens=3)
        eng.run()
        m = eng.metrics()
        if m.get("kv_shard_count") != 2:
            failures.append(
                f"mp=2 mesh engine reports kv_shard_count="
                f"{m.get('kv_shard_count')!r}, expected 2")
            return
        heads = eng.dec.fmt.num_heads
        if m["kv_shard_heads"] * m["kv_shard_count"] != heads:
            failures.append(
                f"mesh shard gauges do not reconcile: kv_shard_heads="
                f"{m['kv_shard_heads']} x kv_shard_count="
                f"{m['kv_shard_count']} != num_heads={heads}")
        kv = eng._caches["kv"]
        pool_bytes = sum(int(t.nbytes) for c in eng._caches.values()
                         for t in c.shards)
        if kv.shard_shape()[3] != heads // 2:
            failures.append(
                f"the pool is not head-sharded: local shard "
                f"{kv.shard_shape()} of {tuple(kv.shape)}")
        if m["kv_shard_pool_bytes"] * m["kv_shard_count"] != pool_bytes:
            failures.append(
                f"mesh shard gauges do not reconcile: "
                f"kv_shard_pool_bytes={m['kv_shard_pool_bytes']} x "
                f"{m['kv_shard_count']} != pool bytes {pool_bytes} — "
                "per-device residency must be the dense pool / mp")
        if m.get("weight_shard_count") != 2:
            failures.append(
                f"mp=2 mesh engine reports weight_shard_count="
                f"{m.get('weight_shard_count')!r}, expected 2 — the "
                "stacked weights are no longer mesh-placed")
        else:
            dense_w = sum(math.prod(a.shape) * a.element_size()
                          for a in eng._weight_arrays())
            per_dev = m["weight_bytes_per_device"]
            repl = m["weight_bytes_replicated"]
            if (per_dev - repl) * 2 + repl != dense_w:
                failures.append(
                    f"weight byte identity broke: (per_device="
                    f"{per_dev} - replicated={repl}) x 2 + {repl} != "
                    f"dense {dense_w}")
            if not 0 <= repl < per_dev < dense_w:
                failures.append(
                    f"mp=2 mesh engine shards no weight bytes: "
                    f"per_device={per_dev} replicated={repl} "
                    f"dense={dense_w} — expected replicated < "
                    "per_device < dense")
            qkv = eng.dec._stacked()["qkv_w"]
            if qkv.shard_shape()[1] * 2 != qkv.shape[1]:
                failures.append(
                    f"stacked qkv_w is not head-sharded: local shard "
                    f"{qkv.shard_shape()} vs full {tuple(qkv.shape)}")
        # an int4 + int8-pool engine's gauges report the packed and
        # quantized bytes it dispatches, and its identity still holds
        eng4, _, _ = _build_engine(weight_quant="int4", kv_quant="int8")
        m4 = eng4.metrics()
        dense4 = sum(math.prod(a.shape) * a.element_size()
                     for a in eng4._weight_arrays())
        n4 = m4["weight_shard_count"]
        pd4, rp4 = (m4["weight_bytes_per_device"],
                    m4["weight_bytes_replicated"])
        if (pd4 - rp4) * n4 + rp4 != dense4:
            failures.append(
                f"int4 weight byte identity broke: (per_device={pd4} "
                f"- replicated={rp4}) x {n4} + {rp4} != quantized "
                f"dense {dense4}")
        text = eng.metrics_prometheus()
        for k in ("kv_shard_count", "kv_shard_heads",
                  "kv_shard_pool_bytes", "weight_shard_count",
                  "weight_bytes_per_device", "weight_bytes_replicated"):
            name, _typ = PROMETHEUS_NAMES[k]
            if name not in text:
                failures.append(
                    f"mesh engine exposition lost {name!r} (metrics key "
                    f"{k!r} has a value under the mesh)")
        for fam in sorted(seen, key=str):
            if fam not in generation.DISPATCH_KINDS:
                failures.append(
                    f"mesh engine dispatched family {fam!r} with no "
                    "generation.DISPATCH_KINDS entry — the sharded step "
                    "must reuse the registered dispatches")
    finally:
        _HYBRID_GROUP[0] = prior_hcg
        _fleet_state.clear()
        _fleet_state.update(prior_fleet)


def _check_dispatch_kinds(failures, seen):
    """Drive every scheduler flavor (the row budget — the engine
    already driven above —, the flat budget, the phase scheduler with
    the spec verify step) and assert each dispatch family that actually
    ran has a DISPATCH_KINDS entry and each timeline step one of its
    kinds."""
    import numpy as np

    from ..inference import generation

    kinds = set(generation.DISPATCH_KINDS.values())
    # flat budget: the token-flattened [T] dispatch
    flat = set()
    eng_f, rng, V = _build_engine(flat_budget=True,
                                  prefix_cache_blocks=0)
    _record_dispatches(eng_f, flat)
    for n in (5, 9):
        eng_f.submit(rng.randint(1, V, (n,)).astype(np.int32),
                     max_new_tokens=3)
    eng_f.run()
    if "flat_budget" not in flat:
        failures.append(
            "the flat-budget engine never dispatched a 'flat_budget' "
            "family — the dispatch-kind probe lost its flat coverage")
    # phase scheduler + spec verify: bulk_admit / admit_sample /
    # decode / verify
    eng_p, rng, V = _build_engine(token_budget=0, spec_k=2,
                                  prefix_cache_blocks=0)
    _record_dispatches(eng_p, seen)
    for _ in range(2):
        core = rng.randint(1, V, (4,)).astype(np.int32)
        eng_p.submit(np.tile(core, 3), max_new_tokens=8)
    eng_p.run()
    seen |= flat
    for fam in sorted(seen, key=str):
        if fam not in generation.DISPATCH_KINDS:
            failures.append(
                f"dispatched family {fam!r} has no "
                "generation.DISPATCH_KINDS entry — its step-timeline "
                "kind falls through to an unclassified label")
    for eng in (eng_f, eng_p):
        bad = {ev["kind"] for ev in eng.telemetry.steps} - kinds
        if bad:
            failures.append(f"timeline steps of kinds {sorted(bad)} "
                            "outside generation.DISPATCH_KINDS")
    for fam in ("budget", "flat_budget", "decode"):
        if fam not in seen:
            failures.append(
                f"dispatch-kind probe no longer exercises the {fam!r} "
                "family — it can no longer catch an unregistered kind "
                "there")
    return len(seen)


def _check_slo_and_audit_surface(failures):
    from ..inference.telemetry import PROMETHEUS_NAMES
    from ..serving_cluster.router import AUDIT_REASONS, Router

    pinned = {
        "slo_ok": ("paddle_serving_slo_ok_total", "counter"),
        "slo_violated_queue": (
            "paddle_serving_slo_violated_queue_total", "counter"),
        "slo_violated_service": (
            "paddle_serving_slo_violated_service_total", "counter"),
        "queue_p50_s": ("paddle_serving_queue_time_seconds",
                        "histogram"),
        "service_p50_s": ("paddle_serving_service_time_seconds",
                          "histogram"),
    }
    for k, want in pinned.items():
        got = PROMETHEUS_NAMES.get(k)
        if got != want:
            failures.append(
                f"SLO metrics key {k!r} maps to {got!r}, pinned "
                f"{want!r} — the goodput surface must not drift")
    # migration counters join the pinned-by-value set: the engine's
    # migrated_in/out totals are what the scale drill's zero-reprefill
    # gate and the drain dashboards key on
    mig_pinned = {
        "requests_migrated_in": (
            "paddle_serving_requests_migrated_in_total", "counter"),
        "requests_migrated_out": (
            "paddle_serving_requests_migrated_out_total", "counter"),
    }
    for k, want in mig_pinned.items():
        got = PROMETHEUS_NAMES.get(k)
        if got != want:
            failures.append(
                f"migration metrics key {k!r} maps to {got!r}, pinned "
                f"{want!r}")
    want_reasons = {"affinity_hit", "least_loaded", "round_robin",
                    "spill", "failover", "orphaned", "migrated",
                    "scale_up", "scale_down", "hedge"}
    if set(AUDIT_REASONS) != want_reasons:
        failures.append(
            f"router AUDIT_REASONS drifted: {sorted(AUDIT_REASONS)} != "
            f"{sorted(want_reasons)} (dashboards key on the reason "
            "label values)")
    # an EMPTY router still exposes every reason counter (zero-valued):
    # the label set is discoverable before any traffic flows
    text = Router([]).metrics_prometheus()
    for reason in want_reasons:
        probe = (f'paddle_gateway_route_decisions_total'
                 f'{{reason="{reason}"}}')
        if probe not in text:
            failures.append(
                f"router exposition lost the {reason!r} decision "
                f"counter ({probe} not found)")
    # ... and every elastic control-plane counter, zero-valued before
    # any scale event (migrations, aborts, per-direction scale events)
    for probe in ("paddle_gateway_migrations_total 0",
                  "paddle_gateway_migration_aborts_total 0",
                  'paddle_gateway_scale_events_total{direction="up"} 0',
                  'paddle_gateway_scale_events_total{direction="down"}'
                  " 0"):
        if probe not in text:
            failures.append(
                f"empty-router exposition lost the elastic counter "
                f"{probe.split()[0]!r}")
    # ... and the gray-failure defense surface: breaker transition
    # counters (per target state), hedge/retry-budget counters, and
    # the bucket-level gauge — all zero/full on an idle router, so the
    # chaos-drill dashboards discover the series before any failure
    for probe in ('paddle_gateway_breaker_transitions_total{to="open"}'
                  " 0",
                  'paddle_gateway_breaker_transitions_total'
                  '{to="half_open"} 0',
                  'paddle_gateway_breaker_transitions_total'
                  '{to="closed"} 0',
                  "paddle_gateway_hedges_total 0",
                  "paddle_gateway_hedge_wins_total 0",
                  "paddle_gateway_retry_budget_exhausted_total 0",
                  "paddle_gateway_retry_budget_tokens "):
        if probe not in text:
            failures.append(
                f"empty-router exposition lost the gray-failure "
                f"series {probe.split()[0]!r}")


def _check_qos_surface(failures):
    from ..inference.telemetry import (PROMETHEUS_NAMES,
                                                QOS_CLASSES, QOS_DEFAULT,
                                                QOS_RANK,
                                                SNAPSHOT_REQUIRED_KEYS)

    # the class vocabulary itself is wire surface: MIGRATION_FMT state
    # dicts, X-Priority values, and the label values below all use it
    if QOS_CLASSES != ("high", "normal", "low") \
            or QOS_DEFAULT != "normal":
        failures.append(
            f"QoS class vocabulary drifted: {QOS_CLASSES!r} default "
            f"{QOS_DEFAULT!r} — pinned ('high', 'normal', 'low') / "
            "'normal' (headers, parked state dicts, and label values "
            "all carry these strings)")
    if [QOS_RANK[c] for c in QOS_CLASSES] != [0, 1, 2]:
        failures.append(f"QOS_RANK no longer orders QOS_CLASSES: "
                        f"{QOS_RANK!r}")
    pinned = {
        "requests_preempted": (
            "paddle_serving_requests_preempted_total", "counter"),
        "requests_resumed": (
            "paddle_serving_requests_resumed_total", "counter"),
        "requests_parked": ("paddle_serving_requests_parked", "gauge"),
    }
    for c in QOS_CLASSES:
        pinned[f"requests_admitted_{c}"] = (
            'paddle_serving_class_requests_admitted_total'
            f'{{class="{c}"}}', "counter")
        pinned[f"tokens_emitted_{c}"] = (
            'paddle_serving_class_tokens_emitted_total'
            f'{{class="{c}"}}', "counter")
    for k, want in pinned.items():
        got = PROMETHEUS_NAMES.get(k)
        if got != want:
            failures.append(
                f"QoS metrics key {k!r} maps to {got!r}, pinned "
                f"{want!r} — the per-class surface must not drift")
    # a FRESH engine already exposes every class-labeled series,
    # zero-valued: dashboards discover the label set before traffic
    eng, _rng, _V = _build_engine()
    text = eng.metrics_prometheus()
    for k, (name, _typ) in pinned.items():
        probe = f"{name} 0"
        if probe not in text:
            failures.append(
                f"fresh-engine exposition missing zero-valued QoS "
                f"series {name!r} (metrics key {k!r})")
    # v4 snapshot: per-class queue depths (the weighted-fair / shed
    # inputs) are REQUIRED, and the slo block carries the per-class
    # queue-violation split the autoscaler scales on
    if "queue_depths" not in SNAPSHOT_REQUIRED_KEYS:
        failures.append(
            "SNAPSHOT_REQUIRED_KEYS lost 'queue_depths' — the v4 "
            "per-class backlog signal")
    snap = eng.telemetry_snapshot()
    qd = snap.get("queue_depths")
    if qd is None or set(qd) != set(QOS_CLASSES):
        failures.append(
            f"snapshot queue_depths keys {sorted(qd or ())} != "
            f"QOS_CLASSES {sorted(QOS_CLASSES)}")
    by_cls = (snap.get("slo") or {}).get("violated_queue_by_class")
    if by_cls is None or set(by_cls) != set(QOS_CLASSES):
        failures.append(
            f"snapshot slo.violated_queue_by_class keys "
            f"{sorted(by_cls or ())} != QOS_CLASSES "
            f"{sorted(QOS_CLASSES)} — the autoscaler scales on "
            "['high'] and the shed path reads the split")
    for blk in ("requests", ):
        r = snap.get(blk) or {}
        for key in ("preempted", "resumed"):
            if key not in r:
                failures.append(
                    f"snapshot {blk!r} block lost {key!r} — the "
                    "preemption accounting the drill gates read")


def _check_role_surface(failures):
    """Disagg surface probe: drive ONE real prefill->decode KV handoff
    (engine-level export/import — the same path the router's
    ``_handoff_one`` rides) and assert every series the disaggregated
    checks and the per-pool dashboards key on actually moved."""
    import numpy as np

    from ..inference.telemetry import (PROMETHEUS_NAMES,
                                                SNAPSHOT_REQUIRED_KEYS,
                                                SNAPSHOT_SCHEMA_VERSION)
    from ..serving_cluster import protocol as P
    from ..serving_cluster.router import Router

    if SNAPSHOT_SCHEMA_VERSION != 8:
        failures.append(
            f"SNAPSHOT_SCHEMA_VERSION = {SNAPSHOT_SCHEMA_VERSION!r}, "
            "pinned 8 (v8 = quant modes in the weights block — bump "
            "this check deliberately alongside the schema)")
    for key in ("role", "handoff", "do_sample", "health", "weights"):
        if key not in SNAPSHOT_REQUIRED_KEYS:
            failures.append(
                f"SNAPSHOT_REQUIRED_KEYS lost {key!r} — the router's "
                "disagg placement filter, the hedge-safety gate and "
                "the capacity planner read them off the wire")
    pinned = {
        "kv_blocks_shipped": (
            "paddle_serving_kv_blocks_shipped_total", "counter"),
        "kv_blocks_adopted": (
            "paddle_serving_kv_blocks_adopted_total", "counter"),
    }
    for k, want in pinned.items():
        got = PROMETHEUS_NAMES.get(k)
        if got != want:
            failures.append(
                f"handoff metrics key {k!r} maps to {got!r}, pinned "
                f"{want!r} — the zero-recompute check "
                "keys on it")
    for fld in ("roles", "handoffs_total"):
        if fld not in P.SCALE_FIELDS:
            failures.append(
                f"protocol.SCALE_FIELDS lost {fld!r} — the /scale "
                "control surface no longer reports the disagg pools")
    # one REAL handoff: the prefill-role engine runs the prompt then
    # HOLDS the session (no decode), export/import moves the KV to the
    # decode-role engine, which finishes the generation off it
    eng_p, rng, V = _build_engine(role="prefill")
    eng_d, _rng2, _V2 = _build_engine(role="decode")
    rid = eng_p.submit(rng.randint(1, V, (9,)).astype(np.int32),
                       max_new_tokens=3)
    for _ in range(64):
        if not eng_p.has_work:
            break
        eng_p.step()
    if eng_p.has_work:
        failures.append("prefill-role probe engine never quiesced — "
                        "the prompt-complete hold is broken")
        return
    state = eng_p.export_slot(rid)
    rid2 = eng_d.import_slot(state)
    eng_d.run()
    toks, done, _st = eng_d.harvest_new_tokens(rid2)
    if not done or not toks:
        failures.append(
            "decode-role engine did not finish the adopted session "
            f"(done={done}, {len(toks)} tokens) — the handoff path is "
            "not end-to-end")
    mp, md = eng_p.metrics(), eng_d.metrics()
    if mp.get("role") != "prefill" or md.get("role") != "decode":
        failures.append(
            f"engine role gauges drifted: prefill engine reports "
            f"{mp.get('role')!r}, decode engine {md.get('role')!r}")
    if not mp.get("kv_blocks_shipped"):
        failures.append(
            "prefill engine kv_blocks_shipped did not move on "
            "export_slot — the zero-recompute conservation gate reads "
            "this counter")
    if md.get("kv_blocks_adopted") != mp.get("kv_blocks_shipped"):
        failures.append(
            f"handoff counters do not reconcile: shipped "
            f"{mp.get('kv_blocks_shipped')!r} != adopted "
            f"{md.get('kv_blocks_adopted')!r} on a lossless transfer")
    snap = eng_p.telemetry_snapshot()
    if snap.get("role") != "prefill":
        failures.append(
            f"snapshot role {snap.get('role')!r} != 'prefill' — the "
            "router filters placement on this field")
    ho = snap.get("handoff") or {}
    if ho.get("kv_blocks_shipped") != mp.get("kv_blocks_shipped"):
        failures.append(
            "snapshot handoff block does not mirror the "
            "kv_blocks_shipped counter")
    text_p = eng_p.metrics_prometheus()
    probe = 'paddle_serving_role{role="prefill"} 1'
    if probe not in text_p:
        failures.append(
            f"prefill exposition lost the role info gauge ({probe!r})")
    if "paddle_serving_handoff_bytes_bucket" not in text_p:
        failures.append(
            "exposition lost the paddle_serving_handoff_bytes "
            "transfer-size histogram")
    count = [ln for ln in text_p.splitlines()
             if ln.startswith("paddle_serving_handoff_bytes_count")]
    if not count or count[0].split()[-1] == "0":
        failures.append(
            "paddle_serving_handoff_bytes recorded no observation "
            "after a real export_slot — transfer sizes are not being "
            "observed")
    # an EMPTY router still exposes the gateway handoff counter,
    # zero-valued — discoverable before any disagg traffic flows
    if "paddle_gateway_handoffs_total 0" not in \
            Router([]).metrics_prometheus():
        failures.append(
            "empty-router exposition lost "
            "'paddle_gateway_handoffs_total'")


def _check_snapshot_schema(failures, eng):
    import json

    from ..inference.telemetry import (SNAPSHOT_OPTIONAL_KEYS,
                                                SNAPSHOT_REQUIRED_KEYS,
                                                SNAPSHOT_SCHEMA_VERSION)
    snap = eng.telemetry_snapshot()
    if snap.get("schema_version") != SNAPSHOT_SCHEMA_VERSION:
        failures.append(
            f"telemetry_snapshot()['schema_version'] = "
            f"{snap.get('schema_version')!r} != pinned "
            f"{SNAPSHOT_SCHEMA_VERSION} — the router keys its trust on "
            "this stamp")
    missing = SNAPSHOT_REQUIRED_KEYS - set(snap)
    if missing:
        failures.append(
            f"telemetry_snapshot() lost required keys {sorted(missing)} "
            "(update telemetry.SNAPSHOT_REQUIRED_KEYS AND bump "
            "SNAPSHOT_SCHEMA_VERSION if this is intentional)")
    extra = set(snap) - SNAPSHOT_REQUIRED_KEYS - SNAPSHOT_OPTIONAL_KEYS
    if extra:
        failures.append(
            f"telemetry_snapshot() grew unpinned keys {sorted(extra)} "
            "— add them to SNAPSHOT_REQUIRED_KEYS or "
            "SNAPSHOT_OPTIONAL_KEYS and bump SNAPSHOT_SCHEMA_VERSION")
    if "kv_blocks" not in snap:
        failures.append(
            "the paged default engine's snapshot lost 'kv_blocks' — "
            "the router's pool-headroom signal")
    try:
        json.dumps(snap)
    except (TypeError, ValueError) as e:
        failures.append(f"telemetry_snapshot() is not JSON-serializable:"
                        f" {e} — it is a wire payload")


def _check_runtime_registry(failures):
    """The process-global runtime registry: a histogram and a counter
    registered under fresh names appear in runtime_prometheus() and in
    runtime_registry_snapshot(), beside the restart generation; the
    probe removes them afterwards (the registry is process-global)."""
    from ..inference import telemetry as T

    hname = "paddle_surface_probe_seconds"
    cname = "paddle_surface_probe_total"
    try:
        T.runtime_histogram(hname).observe(0.5)
        T.runtime_counter(cname, 3)
        text = "\n".join(T.runtime_prometheus())
        snap = T.runtime_registry_snapshot()
        for probe in (f"{hname}_bucket", f"{hname}_count 1",
                      f"{cname} 3",
                      "paddle_runtime_restart_generation "):
            if probe not in text:
                failures.append(
                    f"runtime_prometheus() lost {probe.split()[0]!r}")
        if snap["counters"].get(cname) != 3 or \
                (snap["histograms"].get(hname) or {}).get("count") != 1:
            failures.append("runtime_registry_snapshot() does not carry "
                            "the registered counter and histogram")
        T.parse_prometheus(text)
    finally:
        T._runtime_hists.pop(hname, None)
        T._runtime_counters.pop(cname, None)


if __name__ == "__main__":
    sys.exit(main())
