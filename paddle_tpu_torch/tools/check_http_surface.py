"""HTTP wire-surface coverage check of the port's cluster (the
counterpart of the repository's ``tools/check_http_surface.py``, which
checks the JAX package's), runnable as
``python -m paddle_tpu_torch.tools.check_http_surface [--device cpu]``
and from a test.

Boots a REAL gateway (asyncio HTTP server, in-process LocalReplicas of
the port's engine) and asserts every endpoint's response field set and
every error-code mapping against ``serving_cluster/protocol.py`` — over
actual sockets, not by inspecting handler code:

  * POST /v1/completions — COMPLETION_FIELDS / CHOICE_FIELDS /
    USAGE_FIELDS exactly; SSE chunks carry STREAM_CHUNK_FIELDS and the
    stream ends with ``data: [DONE]``; ``X-Request-Id`` echoed in the
    header, the JSON ``trace_id`` and every SSE chunk.
  * GET /v1/models, /healthz, /metrics, and the admin surface
    (/admin/scale, /admin/drain with a real drain, 409s, 404).
  * Every ERROR_STATUS row but ``internal``, triggered for real, the
    429 bodies' ``reason`` field, ``X-Priority`` threading and tenant
    isolation.

The engines run on the card unless ``--device cpu`` asks for the CPU.
Exit code 0 means the surface is pinned.
"""
from __future__ import annotations

import http.client
import json
import socket
import sys
import time

_DEVICE = [None]


def _build_engine(num_slots=2, **kw):
    import numpy as np

    from ..inference.serving import ServingEngine
    from ..weights import from_jax_state, random_state

    V, E, H, FF, L = 67, 32, 4, 64, 1
    mods = from_jax_state(*random_state(np.random.default_rng(11),
                                        E, H, FF, L, V),
                          device=_DEVICE[0])
    return ServingEngine(*mods, num_slots=num_slots, max_seq_len=64,
                         prefill_cap=4, device=_DEVICE[0], **kw)


def _req(port, method, path, body=None, timeout=60, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request(method, path,
              body=None if body is None else json.dumps(body),
              headers=dict({"Content-Type": "application/json"},
                           **(headers or {})))
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, {k.lower(): v for k, v in r.getheaders()}, data


def _sse(port, body, timeout=120, trace_id=None):
    """Raw-socket SSE read: returns (status_line+headers, data lines)."""
    payload = json.dumps(body).encode()
    hdr = (b"" if trace_id is None
           else b"X-Request-Id: %s\r\n" % trace_id.encode())
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n" + hdr +
              b"Content-Length: %d\r\n\r\n%s" % (len(payload), payload))
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = [ln.strip()[6:] for ln in rest.split(b"\n")
             if ln.strip().startswith(b"data: ")]
    return head.decode("latin-1"), lines


def main(argv=None):
    import argparse

    import numpy as np

    from ..inference.serving import AdmissionFull
    from ..serving_cluster import Gateway, LocalReplica, Router
    from ..serving_cluster import protocol as P

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.check_http_surface")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda)")
    _DEVICE[0] = ap.parse_args(argv).device

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    rng = np.random.RandomState(5)
    prompt = [int(t) for t in rng.randint(1, 67, (6,))]

    # ---------------- cluster A: happy path + 400/404/504 ------------
    reps = [LocalReplica(f"replica{i}", _build_engine())
            for i in range(2)]
    router = Router(reps, policy="prefix_affinity")
    gw = Gateway(router, model_id="paddle_tpu", port=0,
                 hb_s=0.1).start_background()
    try:
        st, hd, data = _req(gw.port, "POST", "/v1/completions",
                            {"prompt": prompt, "max_tokens": 4,
                             "stop_token_id": 2})
        obj = json.loads(data)
        check(st == 200, f"completions status {st}")
        check(set(obj) == set(P.COMPLETION_FIELDS),
              f"completion fields {sorted(obj)} != "
              f"{sorted(P.COMPLETION_FIELDS)}")
        ch = obj.get("choices", [{}])[0]
        check(set(ch) == set(P.CHOICE_FIELDS),
              f"choice fields {sorted(ch)} != {sorted(P.CHOICE_FIELDS)}")
        check(set(obj.get("usage", {})) == set(P.USAGE_FIELDS),
              f"usage fields {sorted(obj.get('usage', {}))}")
        check(ch.get("finish_reason") in ("stop", "length"),
              f"finish_reason {ch.get('finish_reason')!r}")
        check(ch.get("text") == " ".join(str(t) for t in ch["tokens"]),
              "text is not the space-joined token ids")
        # trace context echo: a minted id arrives in BOTH the header
        # and the body, and they agree
        check(hd.get(P.TRACE_HEADER.lower()) == obj.get("trace_id")
              and obj.get("trace_id"),
              f"trace echo broken: header "
              f"{hd.get(P.TRACE_HEADER.lower())!r} vs body "
              f"{obj.get('trace_id')!r}")
        # ... and an INBOUND id is honored verbatim end-to-end
        st, hd, data = _req(gw.port, "POST", "/v1/completions",
                            {"prompt": prompt, "max_tokens": 2},
                            headers={P.TRACE_HEADER: "pin-trace-7"})
        obj = json.loads(data)
        check(st == 200 and obj.get("trace_id") == "pin-trace-7"
              and hd.get(P.TRACE_HEADER.lower()) == "pin-trace-7",
              f"inbound {P.TRACE_HEADER} not honored: {st} "
              f"{obj.get('trace_id')!r} {hd.get(P.TRACE_HEADER.lower())!r}")

        head, lines = _sse(gw.port, {"prompt": prompt, "max_tokens": 4,
                                     "stream": True},
                           trace_id="pin-sse-9")
        check("200 OK" in head and "text/event-stream" in head,
              f"SSE head {head!r}")
        check(f"{P.TRACE_HEADER}: pin-sse-9" in head,
              f"SSE head lacks the trace header echo: {head!r}")
        check(all(json.loads(ln).get("trace_id") == "pin-sse-9"
                  for ln in lines[:-1]),
              "SSE chunks lost the trace_id field")
        check(lines and lines[-1] == b"[DONE]",
              "SSE stream does not end with data: [DONE]")
        for ln in lines[:-1]:
            chunk = json.loads(ln)
            check(set(chunk) == set(P.STREAM_CHUNK_FIELDS),
                  f"stream chunk fields {sorted(chunk)}")
            cch = chunk["choices"][0]
            check(set(cch) == set(P.CHOICE_FIELDS),
                  f"stream choice fields {sorted(cch)}")
        reasons = [json.loads(ln)["choices"][0]["finish_reason"]
                   for ln in lines[:-1]]
        check(reasons[-1] in ("stop", "length") and
              all(r is None for r in reasons[:-1]),
              f"finish_reason placement {reasons}")

        st, _, data = _req(gw.port, "GET", "/v1/models")
        obj = json.loads(data)
        check(st == 200 and set(obj) == set(P.MODELS_FIELDS),
              f"/v1/models {st} fields {sorted(obj)}")
        entry = obj.get("data", [{}])[0]
        check(set(entry) == set(P.MODEL_ENTRY_FIELDS),
              f"model entry fields {sorted(entry)}")

        st, _, data = _req(gw.port, "GET", "/healthz")
        obj = json.loads(data)
        check(st == 200 and set(obj) == set(P.HEALTHZ_FIELDS),
              f"/healthz {st} fields {sorted(obj)}")
        check(obj.get("status") == "ok", f"healthz status {obj}")
        hz = obj.get("replicas") or {}
        check(len(hz) == obj.get("replicas_total") and all(
            set(e) == set(P.HEALTHZ_REPLICA_FIELDS)
            for e in hz.values()),
              f"healthz replica entries {hz}")
        check(all(e["verdict"] in ("healthy", "suspect", "degraded")
                  and e["breaker"] in ("closed", "open", "half_open")
                  for e in hz.values()),
              f"healthz replica vocab {hz}")

        st, hd, data = _req(gw.port, "GET", "/metrics")
        check(st == 200 and hd.get("content-type", "").startswith(
            "text/plain"), f"/metrics {st} {hd.get('content-type')}")
        text = data.decode()
        check('replica="replica0"' in text
              and 'replica="replica1"' in text,
              "/metrics lacks per-replica labels")
        check("paddle_gateway_replicas_alive" in text
              and "paddle_gateway_failovers_total" in text,
              "/metrics lacks gateway gauges")
        check('paddle_gateway_route_decisions_total{reason="'
              in text, "/metrics lacks router decision counters")
        check("paddle_gateway_http_request_seconds_completions_200"
              in text and 'replica="gateway"' in text,
              "/metrics lacks the gateway HTTP latency histograms")

        # ---- error rows, each triggered for real ----
        seen = {}

        def err(st, data, hd=None):
            obj = json.loads(data)
            # 429s grow the machine-readable `reason` field — pinned
            # to the code→reason map so clients can tell cluster
            # overload from tenant-specific throttling
            want_fields = (P.ERROR_BODY_FIELDS_429 if st == 429
                           else P.ERROR_BODY_FIELDS)
            check(set(obj) == {"error"} and
                  set(obj["error"]) == set(want_fields),
                  f"error envelope {obj}")
            code = obj["error"]["code"]
            check(P.ERROR_STATUS.get(code) == st,
                  f"code {code!r} arrived with status {st} != "
                  f"{P.ERROR_STATUS.get(code)}")
            if st == 429:
                check(obj["error"].get("reason")
                      == P.REASON_FOR_429.get(code),
                      f"429 reason {obj['error'].get('reason')!r} != "
                      f"{P.REASON_FOR_429.get(code)!r} for {code!r}")
            seen[code] = st
            return obj

        err(*_req(gw.port, "POST", "/v1/completions",
                  {"prompt": "not token ids"})[::2])
        # engine-side validation is ALSO bad_request, not 500: prompt +
        # max_tokens exceeds the replicas' ring capacity (max_seq_len
        # rounds up to Smax=128, so 120 + 20 violates it)
        err(*_req(gw.port, "POST", "/v1/completions",
                  {"prompt": list(range(1, 121)), "max_tokens": 20})[::2])
        # an explicit JSON null takes the default, never a None that
        # reaches the engine's integer comparisons
        st, _, data = _req(gw.port, "POST", "/v1/completions",
                           {"prompt": prompt, "max_tokens": None})
        check(st == 200 and len(json.loads(data)["choices"][0]["tokens"])
              == 16, f"max_tokens:null did not default to 16 ({st})")
        err(*_req(gw.port, "POST", "/v1/completions",
                  {"model": "gpt-4", "prompt": prompt})[::2])
        err(*_req(gw.port, "GET", "/v1/nope")[::2])
        err(*_req(gw.port, "POST", "/v1/completions",
                  {"prompt": prompt, "max_tokens": 4,
                   "deadline_s": 0})[::2])

        # ---- elastic admin surface ----
        st, _, data = _req(gw.port, "GET", "/admin/scale")
        obj = json.loads(data)
        check(st == 200 and set(obj) == set(P.SCALE_FIELDS),
              f"/admin/scale {st} fields {sorted(obj)} != "
              f"{sorted(P.SCALE_FIELDS)}")
        check(obj.get("autoscaler") is False
              and obj.get("min_replicas") is None,
              f"autoscaler-less scale status wrong: {obj}")
        # manual scale without an autoscaler is an honest 409 (the
        # spawn hook lives there), not a 500
        err(*_req(gw.port, "POST", "/admin/scale", {"replicas": 3})[::2])
        # draining an unknown replica -> 404 (the not_found row again)
        err(*_req(gw.port, "POST", "/admin/drain",
                  {"replica": "ghost"})[::2])
        # a REAL drain: replica1 retires gracefully (no in-flight work
        # here, so the summary is all zeros) and leaves the counts
        st, _, data = _req(gw.port, "POST", "/admin/drain",
                           {"replica": "replica1"})
        obj = json.loads(data)
        check(st == 200 and set(obj) == set(P.DRAIN_FIELDS),
              f"/admin/drain {st} fields {sorted(obj)} != "
              f"{sorted(P.DRAIN_FIELDS)}")
        st, _, data = _req(gw.port, "GET", "/healthz")
        obj = json.loads(data)
        check(st == 200 and obj.get("replicas_total") == 1,
              f"drained replica still counted: {obj}")
        # draining the LAST placeable replica is refused (409): its
        # sessions would have nowhere to migrate
        err(*_req(gw.port, "POST", "/admin/drain",
                  {"replica": "replica0"})[::2])
        st, _, data = _req(gw.port, "GET", "/admin/scale")
        obj = json.loads(data)
        check(json.loads(data).get("scale_events_down") == 1,
              f"drain did not count as a scale-down event: {obj}")
    finally:
        gw.stop()
        for r in reps:
            r.close()

    # ---------------- cluster B: 429 backpressure + 503 death --------
    # threaded=False: nothing drains the engine, so the saturation below
    # cannot race the HTTP round-trip — the 429 is deterministic
    tiny = LocalReplica("tiny", _build_engine(num_slots=1,
                                              max_pending=1),
                        threaded=False)
    router_b = Router([tiny], policy="least_loaded")
    gw_b = Gateway(router_b, port=0, hb_s=0.05).start_background()
    try:
        # saturate the only replica: slot + the 1-deep pending queue
        long_prompt = np.asarray(prompt * 4, np.int32)
        for _ in range(4):
            try:
                tiny.submit(long_prompt, max_new_tokens=40)
            except AdmissionFull:
                break
        st, hd, data = _req(gw_b.port, "POST", "/v1/completions",
                            {"prompt": prompt, "max_tokens": 2})
        obj = err(st, data)               # envelope + reason=overload
        check(obj["error"]["code"] == "admission_full",
              f"backpressure {st} {data[:120]!r}")
        # Retry-After is COMPUTED from the measured queue drain rate,
        # so its exact value depends on timing — the wire contract is
        # the documented floor/cap bounds
        ra = hd.get("retry-after", "")
        check(ra.isdigit()
              and P.RETRY_AFTER_S <= int(ra) <= P.RETRY_AFTER_MAX_S,
              f"429 Retry-After {ra!r} outside "
              f"[{P.RETRY_AFTER_S}, {P.RETRY_AFTER_MAX_S}]: {hd}")

        tiny.kill()
        deadline = time.monotonic() + 10
        while router_b.alive_names() and time.monotonic() < deadline:
            time.sleep(0.05)              # the gateway health loop
        check(not router_b.alive_names(),
              "health loop never marked the killed replica dead")
        st, _, data = _req(gw_b.port, "POST", "/v1/completions",
                           {"prompt": prompt, "max_tokens": 2})
        obj = json.loads(data)
        check(st == 503 and obj["error"]["code"] == "no_replica",
              f"dead cluster {st} {data[:120]!r}")
        seen["no_replica"] = st
        st, _, data = _req(gw_b.port, "GET", "/healthz")
        check(st == 503 and json.loads(data)["status"] == "down",
              f"dead healthz {st} {data!r}")
    finally:
        gw_b.stop()
        tiny.close()

    # ---------------- cluster C: tenant QoS admission ----------------
    # a refill rate of 0.01/s with burst 1 makes the bucket effectively
    # one-shot on the check's timescale: the second request is
    # rate-limited no matter how long the first one's compile took
    rep_c = LocalReplica("qos0", _build_engine())
    router_c = Router([rep_c], policy="least_loaded")
    gw_c = Gateway(router_c, port=0, hb_s=0.2, tenant_rate=0.01,
                   tenant_burst=1, tenant_quota=1).start_background()
    try:
        # X-Priority threads the class through gateway -> router ->
        # engine: the per-class admission counter is the proof the
        # header reached the scheduler, not just the parser
        st, _, data = _req(gw_c.port, "POST", "/v1/completions",
                           {"prompt": prompt, "max_tokens": 2},
                           headers={P.PRIORITY_HEADER: "high",
                                    P.TENANT_HEADER: "acme"})
        check(st == 200, f"priority-tagged completion failed: {st}")
        check(rep_c.engine.metrics()["requests_admitted_high"] == 1,
              "X-Priority: high never reached the engine's per-class "
              "admission counter")
        # an invalid class is the client's 400, not a silent default
        err(*_req(gw_c.port, "POST", "/v1/completions",
                  {"prompt": prompt, "priority": "platinum"})[::2])
        # acme's bucket is now empty -> 429 rate_limited, Retry-After
        # from ACME'S OWN refill time: ceil(~1/0.01) clamped to the
        # cap — strictly above the drain-rate floor an idle cluster
        # would report, which is the whole point of the tenant path
        st, hd, data = _req(gw_c.port, "POST", "/v1/completions",
                            {"prompt": prompt, "max_tokens": 2},
                            headers={P.TENANT_HEADER: "acme"})
        obj = err(st, data)
        check(obj["error"]["code"] == "rate_limited",
              f"empty bucket gave {obj['error']['code']!r}, expected "
              "rate_limited")
        ra = hd.get("retry-after", "")
        check(ra.isdigit()
              and P.RETRY_AFTER_S < int(ra) <= P.RETRY_AFTER_MAX_S,
              f"tenant 429 Retry-After {ra!r} not bucket-derived "
              f"(must be > drain floor {P.RETRY_AFTER_S}, <= cap "
              f"{P.RETRY_AFTER_MAX_S})")
        # tenant isolation: acme being throttled must not 429 anyone
        # else — and untagged requests bypass tenant admission entirely
        st, _, _ = _req(gw_c.port, "POST", "/v1/completions",
                        {"prompt": prompt, "max_tokens": 2},
                        headers={P.TENANT_HEADER: "other"})
        check(st == 200, f"tenant isolation broke: 'other' got {st}")
        st, _, _ = _req(gw_c.port, "POST", "/v1/completions",
                        {"prompt": prompt, "max_tokens": 2})
        check(st == 200, f"untagged request hit tenant limits: {st}")
        # live-request quota: while one 'bulk' request is in flight the
        # second is refused quota_exceeded (checked BEFORE the bucket,
        # so it burns no rate allowance)
        import threading as _threading
        t = _threading.Thread(
            target=_req, args=(gw_c.port, "POST", "/v1/completions",
                               {"prompt": prompt, "max_tokens": 40}),
            kwargs={"headers": {P.TENANT_HEADER: "bulk"}}, daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while not gw_c._tenant_live.get("bulk") \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        check(gw_c._tenant_live.get("bulk") == 1,
              "quota accounting never saw the in-flight request")
        st, hd, data = _req(gw_c.port, "POST", "/v1/completions",
                            {"prompt": prompt, "max_tokens": 2},
                            headers={P.TENANT_HEADER: "bulk"})
        obj = err(st, data)
        check(obj["error"]["code"] == "quota_exceeded",
              f"over-quota gave {obj['error']['code']!r}")
        check(hd.get("retry-after", "").isdigit(),
              f"quota 429 lost Retry-After: {hd}")
        t.join(timeout=60)
        # the quota admission is released when its request finishes
        deadline = time.monotonic() + 10
        while gw_c._tenant_live.get("bulk") \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        check("bulk" not in gw_c._tenant_live,
              f"quota leak: {gw_c._tenant_live}")
    finally:
        gw_c.stop()
        rep_c.close()

    # every mapped error code except `internal` must have been
    # triggered over the wire (internal == a bug path by definition)
    want = set(P.ERROR_STATUS) - {"internal"}
    check(set(seen) == want,
          f"error rows exercised {sorted(seen)} != {sorted(want)}")

    if failures:
        print("check_http_surface: FAILED")
        for f_ in failures:
            print(f"  - {f_}")
        return 1
    print(f"check_http_surface: ok ({len(P.ENDPOINTS)} endpoints, "
          f"{len(seen)} error rows pinned over live HTTP)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
