"""The port's serving telemetry plane against the JAX package's, on the CPU.

One scripted run per scheduler (the row budget, the flat budget with
speculative decoding at K=2, the phase scheduler; greedy, paged, the
bench toy model E=64, H=4, FF=128, L=2, V=256, fp32) goes through the
JAX engine and the port's from the same bridged weights under a clock
that moves only where the script moves it: requests with trace ids,
classes, an eos, a ``max_pending`` shed, a deadline that expires in the
queue, a copy-on-write fork (or its shed), a ``reset_metrics`` in the
middle, an export and re-import of a running request. Then:

- the Prometheus expositions (Queue 3 fault K): the port's
  ``PROMETHEUS_NAMES`` equals JAX's key for key, the two texts carry the
  same ``paddle_serving_*`` series, and every counter and every
  histogram count is equal (``compiled_traces_total`` aside: JAX counts
  its compiles, the port compiles nothing);
- the request spans of ``trace_dump``, event for event (names, order,
  times, states, trace ids and attempts; rejected, expired and migrated
  requests included), and the step timeline (kinds, rows, tokens,
  budget fields and gauges; ``traces_delta`` left out for the same
  reason);
- ``telemetry_snapshot()`` (schema v8, the same keys and values);
- the Chrome export, which both packages' ``validate_chrome_trace``
  accept and whose events equal JAX's export of the same run.

Also: ``LogHistogram``'s percentiles, snapshot, lifetime counts and
bucket widths, ``parse_prometheus`` and its malformed lines, the runtime
registry, ``SloPolicy.from_env``, the dispatch kinds, the ring off (same
tokens, histograms still on), and ``tools/check_metrics_surface``.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference import telemetry as T
from paddle_tpu_torch.inference.serving import AdmissionFull
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SCHEDULERS = {"row": {}, "flat_spec": {"flat_budget": True, "spec_k": 2},
              "phase": {"token_budget": 0}}


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    state = random_state(np.random.default_rng(4), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


class StepClock:
    """Stands still between the script's moves."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


PROMPTS = [np.random.default_rng(50 + i).integers(0, V, n)
           for i, n in enumerate((5, 20, 40, 3, 33, 9, 17, 12, 6, 8))]


def script(eng, clock, shed_error):
    """The scripted run; each step moves the clock one second first.
    Returns the rids in submit order (None for a shed) and the tokens."""
    def step(n=1):
        for _ in range(n):
            clock.t += 1.0
            eng.step()

    def state(rid):
        return (eng.poll(rid) or {}).get("state")

    rids = [eng.submit(PROMPTS[0], 12, trace_id="t-a"),
            eng.submit(PROMPTS[1], 8, trace_id="t-b", attempt=2),
            eng.submit(PROMPTS[2], 6, priority="high"),
            eng.submit(PROMPTS[3], 10, eos_token_id=144, priority="low")]
    step(2)
    eng.reset_metrics()                # a new window, rings restarted
    try:
        rids.append(eng.fork_slot(rids[0]) if state(rids[0]) == "running"
                    else None)
    except shed_error:
        rids.append(None)
    # the slots are full: these queue, and the fifth is shed
    rids.append(eng.submit(PROMPTS[4], 7, deadline_s=1.5))
    rids += [eng.submit(PROMPTS[5 + i], 30 if i == 0 else 5)
             for i in range(3)]
    try:
        rids.append(eng.submit(PROMPTS[9], 4, trace_id="t-shed"))
    except shed_error:
        rids.append(None)
    step(2)                            # the deadline lapses in the queue
    live = ([r for r in rids if r is not None and state(r) == "running"]
            or [r for r in rids if r is not None and state(r) == "queued"])
    st = eng.export_slot(live[-1])
    rids.append(eng.import_slot(st))
    rids.append(eng.submit(PROMPTS[8], 6, trace_id="t-late"))
    while eng.has_work:
        step()
    return rids, {r: v["tokens"].tolist() for r, v in eng.results.items()}


def _served(eng_cls, mods, clock, shed_error, **kw):
    eng = eng_cls(*mods, num_slots=4, max_seq_len=128, max_pending=4,
                  clock=clock, **kw)
    return eng, script(eng, clock, shed_error)


@pytest.fixture(scope="module", params=list(SCHEDULERS))
def runs(request, models):
    """The same script through the JAX engine and the port's."""
    from paddle_tpu.inference.serving import AdmissionFull as JaxFull
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    kw = SCHEDULERS[request.param]
    jeng, jout = _served(JaxEngine, jmods, StepClock(), JaxFull, **kw)
    teng, tout = _served(ServingEngine, tmods, StepClock(), AdmissionFull,
                         device="cpu", **kw)
    return jeng, jout, teng, tout


def test_prometheus_table_equals_jax():
    """Fault K: JAX's table, key for key, name for name, type for type,
    and the exemption and fold sets with it."""
    from paddle_tpu.inference import telemetry as J
    assert T.PROMETHEUS_NAMES == J.PROMETHEUS_NAMES
    assert list(T.PROMETHEUS_NAMES) == list(J.PROMETHEUS_NAMES)
    assert T.PROMETHEUS_EXEMPT_KEYS == J.PROMETHEUS_EXEMPT_KEYS
    assert T.RESET_EXEMPT_KEYS == J.RESET_EXEMPT_KEYS
    assert T.COUNTER_FOLD_KEYS == J.COUNTER_FOLD_KEYS
    assert T.PROMETHEUS_NAMES["decode_steps"][0] == \
        "paddle_serving_decode_row_steps_total"


def _serving_samples(text):
    return {k: v for k, v in T.parse_prometheus(text).items()
            if k.startswith("paddle_serving_")}


def test_exposition_matches_jax(runs):
    """Fault K: the two expositions of the same run (a reset_metrics in
    the middle) carry the same series, equal counters (lifetime: window
    plus folded base) and equal histogram counts."""
    from paddle_tpu.inference import telemetry as J
    jeng, (jrids, jtoks), teng, (trids, ttoks) = runs
    assert (trids, ttoks) == (jrids, jtoks)
    jtext, ttext = jeng.metrics_prometheus(), teng.metrics_prometheus()
    want, got = _serving_samples(jtext), _serving_samples(ttext)
    assert set(got) == set(want)
    counters = {T.PROMETHEUS_NAMES[k][0] for k in T.COUNTER_FOLD_KEYS}
    counts = {k for k in want if k.endswith("_count")}
    for name in sorted(counters | counts):
        assert got[name] == want[name], name
    assert got["paddle_serving_compiled_traces_total"] == 0
    # the counters moved across the reset, and the runtime section and
    # the typed families parse with either package's parser
    assert got["paddle_serving_requests_rejected_total"] >= 1
    assert got["paddle_serving_requests_expired_total"] == 1
    assert got["paddle_serving_handoff_bytes_count"] == \
        (got["paddle_serving_kv_blocks_shipped_total"] > 0)
    assert "paddle_runtime_restart_generation" in ttext
    assert J.parse_prometheus(ttext) == T.parse_prometheus(ttext)
    m = teng.metrics()
    for k in T.COUNTER_FOLD_KEYS:
        assert got[T.PROMETHEUS_NAMES[k][0]] == pytest.approx(
            teng._prom_base.get(k, 0) + m[k], abs=1e-6), k


def _spans(dump):
    return [(s["rid"], s["slot"], s["state"], s["trace_id"], s["attempt"],
             [tuple(e) for e in s["events"]]) for s in dump["spans"]]


def _steps(dump):
    return [{k: v for k, v in ev.items() if k != "traces_delta"}
            for ev in dump["steps"]]


def test_spans_and_timeline_match_jax(runs):
    """Request spans event for event and the step timeline dispatch for
    dispatch (both rings restarted at the reset)."""
    from paddle_tpu.inference.telemetry import trace_dump as jdump
    jeng, _, teng, _ = runs
    want, got = jdump(jeng), T.trace_dump(teng)
    assert _spans(got) == _spans(want)
    assert _steps(got) == _steps(want)
    states = {s[2] for s in _spans(got)}
    assert {"finished", "expired", "rejected", "migrated"} <= states
    names = {e[0] for s in _spans(got) for e in s[5]}
    assert {"queued", "admitted", "first_token", "migrate_out",
            "migrate_in"} <= names
    from paddle_tpu_torch.inference.generation import DISPATCH_KINDS
    assert {ev["kind"] for ev in got["steps"]} <= set(
        DISPATCH_KINDS.values())
    assert all("host_s" in ev for ev in got["steps"]
               if ev["kind"] in ("budget", "decode", "verify"))


def test_snapshot_matches_jax(runs):
    """``telemetry_snapshot()``: schema v8, JAX's key set, equal
    values (the replica-local step EWMA is 0 on both under the clock
    that stands still within a step), JSON-serializable."""
    jeng, _, teng, _ = runs
    want, got = jeng.telemetry_snapshot(), teng.telemetry_snapshot()
    assert got["schema_version"] == T.SNAPSHOT_SCHEMA_VERSION == 8
    assert set(got) == set(want)
    assert T.SNAPSHOT_REQUIRED_KEYS <= set(got) <= (
        T.SNAPSHOT_REQUIRED_KEYS | T.SNAPSHOT_OPTIONAL_KEYS)
    assert got == want
    json.dumps(got)


def test_chrome_export_matches_jax(runs, tmp_path):
    """Both packages' validators accept the port's Chrome export, whose
    events equal JAX's export of the same run (the process name and the
    compile counts aside)."""
    from paddle_tpu.inference import telemetry as J
    jeng, _, teng, _ = runs
    tp = T.export_chrome_tracing(teng, str(tmp_path / "port.json"))
    jp = J.export_chrome_tracing(jeng, str(tmp_path / "jax.json"))
    got, want = T.validate_chrome_trace(tp), J.validate_chrome_trace(jp)
    assert J.validate_chrome_trace(tp) == got

    def events(doc):
        out = []
        for e in doc["traceEvents"]:
            e = dict(e, args={k: v for k, v in (e.get("args") or {}).items()
                              if k != "traces_delta"})
            if e["name"] == "process_name":
                e["args"] = {}
            out.append(e)
        return out
    assert events(got) == events(want)
    assert {e["ph"] for e in got["traceEvents"]} == {"M", "X", "i", "C"}


def test_log_histogram_matches_jax():
    """Percentiles, snapshot, lifetime counts and bucket widths equal
    JAX's on the same observations (edge values and a reset included)."""
    from paddle_tpu.inference.telemetry import LogHistogram as JH
    rng = np.random.default_rng(3)
    obs = np.concatenate([rng.lognormal(-4, 2, 300), [0.0, 1e-7, 1e5],
                          2.0 ** np.arange(-8, 8)])
    for lo, hi in ((1e-6, 1e4), (1.0, 1 << 16), (64.0, 1e9)):
        th, jh = T.LogHistogram(lo, hi), JH(lo, hi)
        for i, v in enumerate(obs):
            th.observe(v)
            jh.observe(v)
            if i == 150:
                th.reset()
                jh.reset()
        assert th.snapshot() == jh.snapshot()
        (tc, tn, ts), (jc, jn, js) = th.cumulative_counts(), \
            jh.cumulative_counts()
        assert np.array_equal(tc, jc) and tn == jn == len(obs)
        assert ts == pytest.approx(js, rel=1e-12)
        for v in obs[:40]:
            assert th.bucket_width_at(v) == jh.bucket_width_at(v)
        for q in (0, 1, 50, 90, 99, 100):
            assert th.percentile(q) == jh.percentile(q)
        assert th.prometheus_lines("h") == jh.prometheus_lines("h")


def test_parse_prometheus_matches_jax():
    from paddle_tpu.inference.telemetry import parse_prometheus as jparse
    good = ("# HELP a x\n# TYPE a counter\na 3\n"
            "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_sum 1.5\n"
            "h_count 2\n\n# TYPE g gauge\ng{class=\"high\"} 0.25\n")
    assert T.parse_prometheus(good) == jparse(good) == {
        "a": 3.0, 'h_bucket{le="1"}': 2.0, "h_sum": 1.5, "h_count": 2.0,
        'g{class="high"}': 0.25}
    for bad in ("# TYPE a summary\na 1\n", "# TYPE a\n", "b 1\n",
                "# TYPE a counter\nnospace\n", "# TYPE a gauge\nh_sum 1\n"):
        with pytest.raises(ValueError):
            T.parse_prometheus(bad)
        with pytest.raises(ValueError):
            jparse(bad)


def test_runtime_registry_matches_jax(monkeypatch):
    """The process-global registry: JAX's exposition and snapshot for
    the same registrations (each package keeps its own registry)."""
    from paddle_tpu.inference import telemetry as J
    monkeypatch.setattr(T, "_runtime_hists", {})
    monkeypatch.setattr(T, "_runtime_counters", {})
    monkeypatch.setattr(J, "_runtime_hists", {})
    monkeypatch.setattr(J, "_runtime_counters", {})
    monkeypatch.setattr(J, "runtime_prometheus", J.runtime_prometheus)
    monkeypatch.setenv("PADDLE_RESTART_COUNT", "2")
    for mod in (T, J):
        h = mod.runtime_histogram("paddle_rpc_call_seconds")
        assert mod.runtime_histogram("paddle_rpc_call_seconds") is h
        for v in (1e-4, 3e-3, 0.2, 7.0):
            h.observe(v)
        assert mod.runtime_counter("paddle_rpc_errors_total", 2) == 2
        assert mod.runtime_counter("paddle_rpc_errors_total") == 2
    assert T.runtime_registry_snapshot() == J.runtime_registry_snapshot()
    got = T.runtime_prometheus()
    assert got == J.runtime_prometheus()
    assert "paddle_runtime_restart_generation 2" in got


def test_slo_policy_from_env(monkeypatch):
    from paddle_tpu.inference.telemetry import SloPolicy as JSlo
    assert T.SLO_ENV_VARS == ("PADDLE_SLO_TTFT_S", "PADDLE_SLO_ITL_S",
                              "PADDLE_SLO_E2E_S")
    for v in T.SLO_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert T.SloPolicy.from_env().objectives() == \
        {"ttft_s": None, "itl_s": None, "e2e_s": None}
    monkeypatch.setenv("PADDLE_SLO_TTFT_S", "0.5")
    monkeypatch.setenv("PADDLE_SLO_E2E_S", "")
    pol = T.SloPolicy.from_env()
    assert pol.objectives() == JSlo.from_env().objectives() == \
        {"ttft_s": 0.5, "itl_s": None, "e2e_s": None}
    assert pol.enabled and pol.classify(2.0, 1.0, 0.9, 0.0, 3.0) == "queue"
    monkeypatch.setenv("PADDLE_SLO_ITL_S", "-1")
    with pytest.raises(ValueError):
        T.SloPolicy.from_env()


def test_dispatch_kinds_equal_jax():
    from paddle_tpu.inference import generation as jgen
    from paddle_tpu_torch.inference import generation as tgen
    assert tgen.DISPATCH_KINDS == jgen.DISPATCH_KINDS
    for key in [("budget", 16), ("flat_budget", 64), ("bulk_admit", 8),
                ("admit_sample",), ("verify", 4), ("new_family", 1)]:
        assert tgen.dispatch_kind(key) == jgen.dispatch_kind(key)


def test_telemetry_clock_and_req_done():
    """``Telemetry(clock=)`` takes the engine's clock, and ``req_done``
    reads the live span (JAX's signature)."""
    t = [5.0]
    tele = T.Telemetry(8, clock=lambda: t[0])
    assert tele.clock() == 5.0
    tele.req_queued(1, 1.0, trace_id="x", attempt=3)
    tele.req_admitted(1, 0, 2.0)
    tele.req_event(1, "first_token", 2.5)
    tele.req_done(1, "finished", 3.0)
    tele.req_done(2, "expired", 4.0)         # never tracked: synthesized
    tele.req_rejected(4.5, trace_id="y")
    sp = list(tele.spans)
    assert [(s.rid, s.state, s.trace_id, s.attempt, s.events) for s in sp] \
        == [(1, "finished", "x", 3, [("queued", 1.0), ("admitted", 2.0),
                                      ("first_token", 2.5),
                                      ("finished", 3.0)]),
            (2, "expired", None, 1, [("expired", 4.0)]),
            (None, "rejected", "y", 1, [("rejected", 4.5)])]
    assert sp[0].t0() == 1.0 and sp[0].t1() == 3.0 and not tele._live
    off = T.Telemetry(0)
    off.req_queued(1, 1.0)
    assert off.step_event("decode", 1.0, 0.1) is None and not off._live
    with pytest.raises(ValueError):
        T.Telemetry(-1)


def test_ring_off_same_tokens(models):
    """``telemetry_ring=0``: the same tokens and counters, no spans and
    no timeline, the histograms still on."""
    _, tmods = models
    outs = []
    for ring in (0, None):
        eng = ServingEngine(*tmods, num_slots=4, max_seq_len=128,
                            telemetry_ring=ring, device="cpu")
        rids = [eng.submit(p, 5) for p in PROMPTS[:6]]
        eng.run()
        outs.append(([eng.results[r]["tokens"].tolist() for r in rids],
                     eng.metrics()["decode_steps"],
                     eng.telemetry.hist_ttft.count))
        assert bool(eng.telemetry.spans) == (ring is None)
        assert bool(eng.telemetry.steps) == (ring is None)
    assert outs[0] == outs[1]


def test_metrics_surface_check(capsys):
    """``python -m paddle_tpu_torch.tools.check_metrics_surface``."""
    from paddle_tpu_torch.tools import check_metrics_surface
    rc = check_metrics_surface.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "check_metrics_surface: ok" in out and "item 8" in out
