"""The port's serving cluster against the JAX package's, on the CPU.

- ``HashRing``: the same owners as JAX's ring across replica churn.
- The router: the port's ``Router`` and JAX's run the same scripts over
  the JAX suite's stub replicas (``FakeReplica`` / ``RecordingReplica``
  of tests/test_serving_cluster.py, raising each package's own
  ``AdmissionFull`` / ``ReplicaError``) on a virtual clock — policies,
  spill, shedding, idempotency, schema trust, failover with the
  remaining deadline, the decision audit, the circuit breaker, the
  median-relative health verdicts and hedging — and must give equal
  placements, releases, audit entries (reasons, choices, attempts),
  counters and ``paddle_gateway_*`` series.
- Over HTTP: two port ``LocalReplica``s (the toy model V=97, E=32, H=4,
  FF=64, L=2, fp32) behind the port's ``Gateway``: JSON and SSE tokens
  equal a JAX ``FusedDecoder`` oracle on the same weights; a replica
  killed mid-stream fails over with greedy parity, and the merged
  cluster trace (both packages' validators) joins one trace id across
  both replicas at attempts 1 and 2.
- On a virtual clock: the deterministic failover, the trace id
  surviving it, a drain that live-migrates a stream (and, with the fault
  harness raising mid-migration, falls back to failover), disaggregated
  prefill/decode serving (greedy and sampled parity with one engine,
  zero prompt recompute, shipped == adopted).
- The autoscaler's ``decide_roles`` against JAX's, the environment
  registry, the refusals of the parts that wait (rpc replicas,
  ``--workers``, ``--mesh-mp``), and ``tools/check_http_surface``.
"""
import json
import os
import re
import socket
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import telemetry as T
from paddle_tpu_torch.serving_cluster import (Gateway, HashRing,
                                              LocalReplica, Router,
                                              export_cluster_trace)
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

V, E, H, FF, L = 97, 32, 4, 64, 2
WAIT_S = 120                              # bound on every drain loop
PORT_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch")


@pytest.fixture(scope="module")
def models():
    """(JAX modules, port modules) over the same numpy weights."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(3)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    state = random_state(np.random.default_rng(3), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


@pytest.fixture(scope="module")
def oracle(models):
    """The JAX sequential decoder's greedy tokens (one decoder, so its
    compiles are shared across the cases)."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.generation import FusedDecoder
    dec = FusedDecoder(*models[0], max_seq_len=128)

    def run(prompt, max_new):
        out = dec.generate(
            paddle.to_tensor(np.asarray(prompt, np.int32)[None]),
            max_new_tokens=max_new)
        return [int(t) for t in np.asarray(out._data)[0, len(prompt):]]
    return run


def _engine(tmods, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("prefill_cap", 8)
    return ServingEngine(*tmods, device="cpu", **kw)


def _prompt(seed, n=10):
    return [int(t) for t in np.random.RandomState(seed).randint(1, V, (n,))]


# =====================================================================
# consistent-hash ring
# =====================================================================
def test_hash_ring_owners_equal_jax():
    from paddle_tpu.serving_cluster import HashRing as JRing
    rings = (HashRing(), JRing())
    keys = [f"template-{i}".encode() for i in range(512)]
    for op, name in [("add", n) for n in ("r0", "r1", "r2", "r3")] + [
            ("remove", "r2"), ("add", "r4"), ("remove", "r0"),
            ("add", "r2"), ("remove", "r4")]:
        for ring in rings:
            getattr(ring, op)(name)
        assert [rings[0].owner(k) for k in keys] == \
            [rings[1].owner(k) for k in keys]
    assert HashRing().owner(b"k") is None


# =====================================================================
# router scripts over stub replicas, both packages
# =====================================================================
def _stubs(port):
    """The JAX suite's stub replicas, raising the package's own
    AdmissionFull and ReplicaError."""
    import test_serving_cluster as J
    if port:
        from paddle_tpu_torch.inference.serving import AdmissionFull
        from paddle_tpu_torch.serving_cluster.replica import ReplicaError
        from paddle_tpu_torch.serving_cluster.router import Router as R
    else:
        from paddle_tpu.inference.serving import AdmissionFull
        from paddle_tpu.serving_cluster.replica import ReplicaError
        from paddle_tpu.serving_cluster.router import Router as R

    class Fake(J.FakeReplica):
        def submit(self, prompt, **kw):
            if self.full:
                raise AdmissionFull(f"{self.name} full")
            return super().submit(prompt, **kw)

    class Rec(J.RecordingReplica):
        def submit(self, prompt, **kw):
            if self.full:
                raise AdmissionFull(f"{self.name} full")
            return J.FakeReplica.submit(self, prompt, **kw)

        def snapshot(self):
            if self.fail_snap:
                raise ReplicaError(f"{self.name}: injected snapshot flake")
            snap = J.FakeReplica.snapshot(self)
            snap["do_sample"] = self.do_sample
            return snap

    return R, Fake, Rec, AdmissionFull


def _minted(tid):
    return "minted" if re.fullmatch(r"[0-9a-f]{32}", str(tid)) else tid


def _record(r, reps, extra):
    """What a script saw: submissions, releases, the audit ring, the
    counters and the router's own exposition."""
    audit = [dict(e, trace_id=_minted(e["trace_id"])) for e in r.audit]
    subs = {rep.name: [(rid, p, {k: _minted(v) if k == "trace_id" else v
                                 for k, v in kw.items()})
                       for rid, p, kw in rep.submitted] for rep in reps}
    gw = {k: v for k, v in T.parse_prometheus(r.metrics_prometheus())
          .items() if k.startswith("paddle_gateway_")}
    return {"subs": subs, "audit": audit, "counts": dict(r.audit_counts),
            "released": {rep.name: list(getattr(rep, "released", []))
                         for rep in reps},
            "totals": (r.failovers_total, r.hedges_total,
                       r.hedge_wins_total, r.version_mismatches,
                       r.retry_budget_exhausted_total,
                       dict(r.breaker_transitions)),
            "gateway": gw, "extra": extra}


def _policies(R, Fake, Rec, Full, clk):
    out = []
    reps = [Fake("a", queue_depth=3, slots_free=0),
            Fake("b", queue_depth=1, slots_free=1),
            Fake("c", queue_depth=1, slots_free=1),
            Fake("d", queue_depth=0, slots_free=2, kv_used=12),
            Fake("e", queue_depth=0, slots_free=2, kv_used=2)]
    r = R(reps, policy="least_loaded", snap_max_age_s=0.0, clock=clk)
    for i in range(4):
        r.submit([1, 2, i], max_new_tokens=2, trace_id=f"ll-{i}")
    out.append(_record(r, reps, None))
    reps = [Fake(f"r{i}") for i in range(3)]
    r = R(reps, policy="prefix_affinity", spill_depth=4,
          snap_max_age_s=0.0, clock=clk)
    for sfx in range(5):
        r.submit([7, 8, 9, 10, sfx], max_new_tokens=2)
        r.submit([20, 21, 22, 23, sfx], max_new_tokens=2)
    r.submit([1, 2, 3], max_new_tokens=2)            # short: by load
    owner = next(rep for rep in reps if rep.submitted)
    owner.queue_depth = 4                            # saturated: spill
    r.submit(owner.submitted[0][1], max_new_tokens=2)
    owner.queue_depth, owner.full = 0, True          # shedding: spill
    r.submit(owner.submitted[0][1], max_new_tokens=2)
    owner.full = False
    g1 = r.submit([1, 2, 3], request_id="c1", trace_id="orig")
    g2 = r.submit([1, 2, 3], request_id="c1", trace_id="retry")
    out.append(_record(r, reps, (g1 == g2, r.trace_id_of(g1))))
    a, b = Fake("a", full=True), Fake("b")
    r = R([a, b], policy="least_loaded", snap_max_age_s=0.0, clock=clk)
    r.submit([1, 2, 3], max_new_tokens=2)
    b.full = True
    try:
        r.submit([1, 2, 3], max_new_tokens=2)
        shed = False
    except Full:
        shed = True
    out.append(_record(r, [a, b], shed))
    ok = Fake("ok")
    drift = Fake("drift", schema=T.SNAPSHOT_SCHEMA_VERSION + 1)
    r = R([drift, ok], policy="least_loaded", snap_max_age_s=0.0,
          clock=clk)
    r.refresh(force=True)
    r.submit([1, 2, 3], max_new_tokens=2)
    rr = R([Fake("x"), Fake("y")], policy="round_robin",
           snap_max_age_s=0.0, clock=clk, audit_ring=2)
    for i in range(5):
        rr.submit([1, 2, i], max_new_tokens=2)
    out.append(_record(r, [drift, ok], _record(rr, [], len(rr.audit))))
    return out


def _failover_and_audit(R, Fake, Rec, Full, clk):
    out = []
    a, b = Fake("a"), Fake("b", queue_depth=50)
    r = R([a, b], policy="least_loaded", snap_max_age_s=0.0, clock=clk)
    g1 = r.submit([1, 2, 3], max_new_tokens=4, deadline_s=10.0,
                  trace_id="f-1")
    g2 = r.submit([4, 5, 6], max_new_tokens=4, deadline_s=1.0,
                  trace_id="f-2")
    clk.t += 3.0                       # g2's budget is gone
    r.mark_dead("a")
    out.append(_record(r, [a, b], (r.poll(g1), r.poll(g2))))
    reps = [Fake("r0"), Fake("r1")]
    r = R(reps, policy="prefix_affinity", spill_depth=4,
          snap_max_age_s=0.0, clock=clk)
    gid = r.submit([5, 6, 7, 8, 9], max_new_tokens=2, trace_id="aud-1")
    r.mark_dead(r.poll(gid)["replica"])
    r.submit([5, 6, 7, 8, 9], max_new_tokens=2, trace_id="aud-2")
    r.mark_dead(next(iter(r.alive_names())))
    out.append(_record(r, reps, r.poll(gid)))
    return out


def _gray_failure(R, Fake, Rec, Full, clk):
    out = []
    a = Rec("a", script=[([7], True, "finished")])
    b = Rec("b", queue_depth=5)
    r = R([a, b], policy="least_loaded", clock=clk, snap_max_age_s=0.0,
          breaker_errs=2, breaker_cooldown_s=5.0, breaker_probes=1,
          hedge_quantile=0)
    a.fail_snap = True
    r.refresh(force=True)
    clk.t += 1.0
    r.refresh(force=True)
    states = [r.breaker_state("a")]
    a.fail_snap = False
    r.submit([1, 2, 3], trace_id="g1")
    clk.t += 10.0
    gid2 = r.submit([4, 5, 6], trace_id="g2")
    states.append(r.breaker_state("a"))
    r.submit([7, 8, 9], trace_id="g3")
    clk.t += 0.01
    got = r.harvest(gid2)
    states.append(r.breaker_state("a"))
    out.append(_record(r, [a, b], (states, got)))
    reps = [Rec(n) for n in ("a", "b", "c")]
    r = R(reps, hedge_quantile=0, snap_max_age_s=0.0, clock=clk)
    r.refresh(force=True)
    with r._lock:
        for _ in range(3):
            r._observe_ttft("a", 0.01)
            r._observe_ttft("b", 0.012)
            r._observe_ttft("c", 0.4)
    verdicts = {n: s["verdict"] for n, s in r.health_status().items()}
    out.append(_record(r, reps, (verdicts, r.check_health(),
                                 r.breaker_state("c"))))
    for script_a, script_b in (([], [([5, 6], True, "finished")]),
                               ([([], False, "running")] * 2
                                + [([9], True, "finished")], [])):
        a = Rec("a", script=script_a)
        b = Rec("b", queue_depth=5, script=script_b)
        r = R([a, b], clock=clk, policy="least_loaded", hedge_quantile=95,
              hedge_margin=1.0, hedge_min_s=0.001, snap_max_age_s=0.0)
        for _ in range(8):
            r.hist_ttft.observe(0.001)
        gid = r.submit([1, 2, 3], trace_id="h")
        seen = [r.harvest(gid)]
        clk.t += 1.0
        seen += [r.harvest(gid), r.harvest(gid)]
        out.append(_record(r, [a, b], seen))
    return out


@pytest.mark.parametrize("scenario", [_policies, _failover_and_audit,
                                      _gray_failure],
                         ids=["policies", "failover_audit", "gray_failure"])
def test_router_matches_jax(scenario):
    import test_serving_cluster as J
    got = scenario(*_stubs(True), J._Clock())
    want = scenario(*_stubs(False), J._Clock())
    assert got == want
    assert got and all(rec["audit"] or rec["extra"] for rec in got)


# =====================================================================
# the engine behind HTTP
# =====================================================================
def _post(port, body, timeout=WAIT_S):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("POST", "/v1/completions", json.dumps(body))
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, data


def _sse_collect(port, body, timeout=WAIT_S, trace_id=None):
    payload = json.dumps(body).encode()
    hdr = b"" if trace_id is None else b"X-Request-Id: %s\r\n" % \
        trace_id.encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n" + hdr +
              b"Content-Length: %d\r\n\r\n%s" % (len(payload), payload))
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    s.close()
    toks, reason = [], None
    for ln in buf.partition(b"\r\n\r\n")[2].split(b"\n"):
        ln = ln.strip()
        if not ln.startswith(b"data: ") or ln == b"data: [DONE]":
            continue
        ch = json.loads(ln[6:])["choices"][0]
        toks += ch["tokens"]
        reason = ch["finish_reason"] or reason
    return toks, reason


def test_gateway_json_and_sse_match_jax_oracle(models, oracle):
    """Two replicas behind one endpoint: JSON and SSE both give exactly
    the JAX decoder's tokens — routing is invisible; /metrics parses."""
    reps = [LocalReplica(f"replica{i}", _engine(models[1]))
            for i in range(2)]
    gw = Gateway(Router(reps, policy="round_robin", snap_max_age_s=0.0),
                 port=0, hb_s=0.1).start_background()
    try:
        for seed in range(3):
            prompt = _prompt(seed)
            want = oracle(prompt, 6)
            st, data = _post(gw.port, {"prompt": prompt, "max_tokens": 6})
            assert st == 200
            assert json.loads(data)["choices"][0]["tokens"] == want
            toks, reason = _sse_collect(gw.port, {
                "prompt": prompt, "max_tokens": 6, "stream": True})
            assert toks == want and reason == "length"
        import http.client
        c = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
        c.request("GET", "/metrics")
        text = c.getresponse().read().decode()
        c.close()
        samples = T.parse_prometheus(text)
        done = sum(v for k, v in samples.items() if k.startswith(
            "paddle_serving_requests_finished_total"))
        assert done == 6
    finally:
        gw.stop()
        for r in reps:
            r.close()


def test_kill_mid_stream_parity_and_cluster_trace(models, oracle,
                                                  tmp_path):
    """A replica killed at its fourth working step (mid-request) fails
    over: the SSE client sees the JAX decoder's greedy tokens, and the
    merged cluster trace (valid for both packages' validators) holds the
    gateway span, a failover decision and engine spans of one trace id
    on two replica pids at attempts 1 and 2."""
    from paddle_tpu.inference.telemetry import \
        validate_chrome_trace as jvalidate
    hits = {"n": 0}

    def killer(rep):
        hits["n"] += 1
        if hits["n"] == 4:
            rep.kill()

    reps = [LocalReplica(f"replica{i}", _engine(models[1]),
                         step_hook=killer) for i in range(2)]
    router = Router(reps, policy="round_robin", hb_dead_s=0.3,
                    snap_max_age_s=0.0)
    gw = Gateway(router, port=0, hb_s=0.05, poll_s=0.002).start_background()
    try:
        prompt = _prompt(0)
        want = oracle(prompt, 40)
        toks, reason = _sse_collect(gw.port, {
            "prompt": prompt, "max_tokens": 40, "stream": True},
            trace_id="trace-drill-1")
        assert toks == want and reason == "length"
        assert router.failovers_total == 1 and len(router.dead) == 1
        path = export_cluster_trace(gw, str(tmp_path / "cluster.json"))
        doc = T.validate_chrome_trace(path)
        assert jvalidate(path) == doc
        evs, tid = doc["traceEvents"], "trace-drill-1"
        assert any(e.get("pid") == 0 and e["ph"] == "X"
                   and e["name"].startswith("POST")
                   and (e.get("args") or {}).get("trace_id") == tid
                   for e in evs)
        assert any(e.get("pid") == 0 and e["ph"] == "X"
                   and e["name"].startswith("decision")
                   and e["args"]["reason"] == "failover" for e in evs)
        spans = [e for e in evs if e.get("pid", 0) > 0 and e["ph"] == "X"
                 and (e.get("args") or {}).get("trace_id") == tid]
        assert sorted(e["args"]["attempt"] for e in spans) == [1, 2]
        assert len({e["pid"] for e in spans}) == 2
        for rep in reps:
            T.validate_chrome_trace(T.export_chrome_tracing(
                rep.engine, str(tmp_path / f"{rep.name}.json")))
    finally:
        gw.stop()
        for r in reps:
            r.close()


def test_failover_and_trace_id_on_a_virtual_clock(models, oracle):
    """Unthreaded replicas on an injected clock: kill the owner after 3
    harvested tokens, let the heartbeat go stale, and the request ends
    on the other replica with exact parity, exactly once; one trace id
    at attempt 1 on the victim's spans and 2 on the survivor's."""
    clock = [0.0]
    reps = [LocalReplica(f"replica{i}", _engine(models[1]), threaded=False,
                         clock=lambda: clock[0]) for i in range(2)]
    router = Router(reps, policy="round_robin", hb_dead_s=1.0,
                    snap_max_age_s=0.0, clock=lambda: clock[0])
    prompt = _prompt(3)
    want = oracle(prompt, 40)
    gid = router.submit(prompt, max_new_tokens=40, trace_id="trace-f1")
    assert router.poll(gid)["attempt"] == 1
    victim = router._table[gid].replica
    vrep = router.replicas[victim]
    got = []
    deadline = time.monotonic() + WAIT_S
    while len(got) < 3:
        assert time.monotonic() < deadline
        vrep.pump()
        got += router.harvest(gid)[0]
    span = next(sp for sp in vrep.engine.telemetry._live.values()
                if sp.trace_id == "trace-f1")
    assert span.attempt == 1
    vrep.kill()
    clock[0] += 2.0                        # the heartbeat goes stale
    assert router.check_health() == [victim]
    assert router.poll(gid)["attempt"] == 2
    other = router.replicas[router._table[gid].replica]
    assert other is not vrep
    done = False
    while not done:
        assert time.monotonic() < deadline
        other.pump()
        new, done, state = router.harvest(gid)
        got += new
    assert got == want and state == "finished"
    assert router.failovers_total == 1
    sp = next(s for s in other.trace_dump()["spans"]
              if s["trace_id"] == "trace-f1")
    assert sp["attempt"] == 2 and sp["state"] == "finished"
    vs = next(s for s in vrep.trace_dump()["spans"]
              if s["trace_id"] == "trace-f1")
    assert vs["attempt"] == 1 and vs["state"] != "finished"


@pytest.mark.parametrize("fault", [False, True], ids=["migrate", "fault"])
def test_drain_migrates_or_falls_back(models, oracle, monkeypatch, fault):
    """Draining the replica that holds a live stream moves it over
    export_slot / import_slot (zero re-prefill, greedy parity); with
    the fault harness raising at the "migration" point (state off the
    source, on no target) the drain falls back to failover: exactly
    once, parity, no stranded block."""
    from paddle_tpu_torch.testing import fault as fi
    reps = [LocalReplica(f"replica{i}", _engine(models[1]), threaded=False,
                         clock=lambda: 0.0) for i in range(2)]
    router = Router(reps, policy="round_robin", hb_dead_s=1e9,
                    snap_max_age_s=0.0, clock=lambda: 0.0)
    prompt = _prompt(10)
    want = oracle(prompt, 40)
    gid = router.submit(prompt, max_new_tokens=40)
    victim = router.replicas[router._table[gid].replica]
    got = []
    deadline = time.monotonic() + WAIT_S
    while len(got) < 3:
        assert time.monotonic() < deadline
        victim.pump()
        got += router.harvest(gid)[0]
    if fault:
        fi.reset()
        monkeypatch.setenv("PADDLE_FI_AT_POINT", "migration")
        monkeypatch.setenv("PADDLE_FI_RAISE", "0")
    try:
        summary = router.remove_replica(victim.name)
    finally:
        monkeypatch.delenv("PADDLE_FI_AT_POINT", raising=False)
        monkeypatch.delenv("PADDLE_FI_RAISE", raising=False)
        fi.reset()
    assert summary["migrated"] == (0 if fault else 1)
    assert summary["failed_over"] == (1 if fault else 0)
    assert router.migration_aborts_total == int(fault)
    other = router.replicas[router._table[gid].replica]
    done = False
    while not done:
        assert time.monotonic() < deadline
        other.pump()
        new, done, state = router.harvest(gid)
        got += new
    assert got == want and state == "finished"
    assert victim.engine.pool.used == 0
    m = other.engine.metrics()
    assert m["requests_migrated_in"] == (0 if fault else 1)
    if not fault:
        assert m["prefill_tokens_computed"] == 0
        assert m["kv_blocks_adopted"] == \
            victim.engine.metrics()["kv_blocks_shipped"] > 0


def _drive(router, reps, gids):
    outs = {g: [] for g in gids}
    done = {g: False for g in gids}
    deadline = time.monotonic() + WAIT_S
    while not all(done.values()):
        assert time.monotonic() < deadline, "cluster drive stalled"
        for r in reps:
            r.pump()
        for g in gids:
            if not done[g]:
                new, d, _ = router.harvest(g, len(outs[g]))
                outs[g].extend(new)
                done[g] = d
    return [outs[g] for g in gids]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_disaggregated_parity_zero_recompute(models, sampled):
    """A prefill-role engine (flat budget, the JAX demo's shape) and a
    decode-role one vs one mixed engine on the same arrivals: equal
    tokens (sampled too: the slot carries its seed), every session
    handed off once, the decode side prefills nothing, shipped ==
    adopted."""
    from paddle_tpu_torch.core import rng
    tm = models[1]
    samp = (dict(do_sample=True, top_k=12, top_p=0.9, temperature=0.8)
            if sampled else {})
    rs = np.random.RandomState(21)
    prompts = [_prompt(100 + i, int(n)) for i, n in
               enumerate(rs.randint(6, 30, (6,)))]
    mixed = _engine(tm, num_slots=4, prefix_cache_blocks=32, **samp)
    rep = LocalReplica("m0", mixed, threaded=False)
    rt = Router([rep], snap_max_age_s=0.0)
    rng.seed(1234)
    want = _drive(rt, [rep], [rt.submit(p, max_new_tokens=6)
                              for p in prompts])
    eng_p = _engine(tm, role="prefill", num_slots=2, flat_budget=True,
                    token_budget=32, decode_chunk=1,
                    prefix_cache_blocks=32, **samp)
    eng_d = _engine(tm, role="decode", num_slots=4, token_budget=8,
                    prefix_cache_blocks=32, **samp)
    reps = [LocalReplica("pf0", eng_p, threaded=False),
            LocalReplica("dc0", eng_d, threaded=False)]
    rt = Router(reps, snap_max_age_s=0.0)
    rng.seed(1234)
    got = _drive(rt, reps, [rt.submit(p, max_new_tokens=6)
                            for p in prompts])
    assert got == want
    assert rt.handoffs_total == len(prompts) and rt.failovers_total == 0
    mp, md = eng_p.metrics(), eng_d.metrics()
    assert md["prefill_tokens_computed"] == 0
    assert mp["prefill_tokens_computed"] == \
        mixed.metrics()["prefill_tokens_computed"]
    assert mp["kv_blocks_shipped"] == md["kv_blocks_adopted"] > 0
    assert eng_p.telemetry_snapshot()["role"] == "prefill"
    assert md["requests_migrated_in"] == len(prompts)


# =====================================================================
# autoscaler, registry, refusals, HTTP surface
# =====================================================================
def test_decide_roles_equals_jax():
    """The per-pool watermark logic over a grid of signals, verdict for
    verdict against JAX's."""
    from paddle_tpu.serving_cluster.autoscale import Autoscaler as JA
    from paddle_tpu.serving_cluster.router import Router as JR
    from paddle_tpu_torch.serving_cluster.autoscale import Autoscaler
    kw = dict(role_aware=True, pf_queue_high=4.0, pf_queue_low=1.0,
              dc_kv_free_low=0.2, dc_sessions_high=0.8,
              dc_sessions_low=0.3, max_replicas=8)
    a = Autoscaler(Router([]), lambda *x: None, **kw)
    j = JA(JR([]), lambda *x: None, **kw)
    seen = set()
    for pq in (0.0, 0.5, 2.0, 5.0):
        for kv in (0.0, 0.1, 0.5):
            for sess in (0.2, 0.5, 0.9):
                for npf, ndc in ((1, 1), (0, 1), (1, 0), (0, 0), (2, 3)):
                    s = {"prefill_replicas": npf, "decode_replicas": ndc,
                         "prefill_snapshots": npf,
                         "decode_snapshots": ndc,
                         "prefill_queue_mean": pq,
                         "decode_kv_free_frac": kv,
                         "decode_sessions_frac": sess}
                    v = a.decide_roles(s)
                    assert v == j.decide_roles(s), s
                    seen.add(v)
    assert seen == {None, ("up", "prefill"), ("up", "decode"),
                    ("down", "prefill"), ("down", "decode")}


def test_gateway_env_registry():
    """Every PADDLE_* variable the port's cluster and SloPolicy.from_env
    read is registered in ``testing.GW_ENV_VARS``, which equals JAX's
    registry (the names are the cluster's contract); the registry's
    names the port never mentions are rpc's (ROADMAP 10(e)) and the
    serving mesh's weight knob (item 8)."""
    from paddle_tpu.testing import GW_ENV_VARS as JGW
    from paddle_tpu_torch.testing import FI_ENV_VARS, GW_ENV_VARS
    from paddle_tpu.testing import FI_ENV_VARS as JFI
    assert GW_ENV_VARS == JGW and FI_ENV_VARS == JFI
    pkg = os.path.join(PORT_PKG, "serving_cluster")
    paths = [os.path.join(pkg, f) for f in os.listdir(pkg)
             if f.endswith(".py")]
    paths += [os.path.join(PORT_PKG, "inference", f)
              for f in ("telemetry.py", "serving.py", "generation.py")]
    found = set()
    for path in paths:
        with open(path) as f:
            found |= set(re.findall(
                r"PADDLE_(?:(?:GATEWAY|ROUTER|SLO|AUTOSCALE|QOS"
                r"|TENANT|ROLE|RPC|SERVING_MESH)_[A-Z_0-9]+|ROLE\b)",
                f.read()))
    assert found <= set(GW_ENV_VARS), found - set(GW_ENV_VARS)
    assert set(GW_ENV_VARS) - found == {
        "PADDLE_RPC_PING_TIMEOUT_S", "PADDLE_RPC_TIMEOUT_S",
        "PADDLE_SERVING_MESH_WEIGHTS"}
    assert set(T.SLO_ENV_VARS) <= set(GW_ENV_VARS)


def test_parts_that_wait_raise():
    from paddle_tpu_torch.serving_cluster import RpcReplica, serve_engine
    from paddle_tpu_torch.serving_cluster.__main__ import main
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        RpcReplica("cluster_worker1")
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        serve_engine(None)
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        main(["--workers", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 8"):
        main(["--mesh-mp", "2", "--device", "cpu"])


def test_http_surface_check(capsys):
    """``python -m paddle_tpu_torch.tools.check_http_surface``: every
    endpoint's field set and every error row over live HTTP."""
    from paddle_tpu_torch.tools import check_http_surface
    rc = check_http_surface.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "check_http_surface: ok" in out
