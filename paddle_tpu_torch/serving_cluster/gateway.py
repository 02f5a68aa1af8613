"""Asyncio HTTP gateway: one OpenAI-compatible endpoint over N replicas.

Stdlib-only (asyncio streams + a minimal HTTP/1.1 parser — the
container pins its dependency set, so no aiohttp): the gateway parses
requests, delegates placement/failover to the Router, and streams
tokens back as JSON or SSE. Engine-touching calls (submit / harvest /
refresh — they take a replica lock, or an rpc round-trip) run in the
default thread-pool executor so one slow replica never stalls the
accept loop.

Endpoints (wire shapes pinned in protocol.py, end-to-end by
tools/check_http_surface.py):

  * ``POST /v1/completions`` — JSON, or SSE when ``"stream": true``
    (one chunk per harvest batch, ``data: [DONE]`` terminator).
  * ``GET /v1/models`` — the single served model id.
  * ``GET /healthz``   — ok/degraded + replica counts (degraded = some
    but not all replicas dead; a fully dead cluster still answers,
    status ``down`` — the load balancer's probe must not hang), plus
    per-replica gray-failure verdicts and circuit-breaker states (a
    replica can be alive yet shed from placement).
  * ``GET /metrics``   — the router's aggregated Prometheus exposition
    (every replica's engine metrics with a ``replica`` label + router
    gauges).
  * ``GET/POST /admin/scale`` — elastic status / manual replica-count
    target (POST needs an Autoscaler: its spawn hook builds replicas);
    ``POST /admin/drain`` — graceful single-replica drain (live
    sessions migrate off, then the replica retires; rolling restarts).
    Admin ops refused in the current state (no autoscaler, draining
    the last replica) map to 409 ``conflict``.

Backpressure is honest end-to-end: AdmissionFull from every replica →
HTTP 429 with ``Retry-After``; ``deadline_s`` expiry → 504; all
replicas dead → 503. A replica dying mid-stream never errors the
stream — the router fails over and the replayed greedy prefix is
skipped (router.py), so the client just sees one slow poll interval.

QoS / multi-tenant admission (all off by default):

  * ``X-Priority`` (or the body's ``"priority"`` field, which wins)
    tags the request ``high``/``normal``/``low`` — threaded through
    the router into the engine's per-class queues, weighted-fair
    packer, and preemption policy (inference/serving.py);
  * ``X-Tenant`` keys a per-tenant TOKEN BUCKET
    (``PADDLE_TENANT_RATE`` req/s refill, ``PADDLE_TENANT_BURST``
    capacity) and a live-request quota (``PADDLE_TENANT_QUOTA``).
    Over-rate → 429 ``reason=rate_limited``; over-quota → 429
    ``reason=quota_exceeded`` — both with ``Retry-After`` computed
    from the TENANT'S OWN bucket refill time (not the cluster drain
    rate), so a throttled tenant backs off by its own allowance while
    everyone else's 429s keep the drain-rate hint;
  * SLO-aware shedding (``PADDLE_QOS_SHED_DEPTH`` > 0): a LOW-class
    arrival is refused 429 ``reason=overload`` when the cluster's
    mean queue depth crosses the watermark AND the PR-11 queue-vs-
    service decomposition attributes the SLO pain to queueing
    (``violated_queue >= violated_service``) — shedding only helps
    when waiting, not service time, is the bottleneck.

Trace plane (the cluster observability spine):

  * every HTTP request gets a TRACE ID — inbound ``X-Request-Id``
    honored, else minted — echoed on the response (header + the
    ``trace_id`` body field + every SSE chunk) and threaded through
    the router into each replica engine's request spans, surviving
    failover re-submits (same id, incremented attempt);
  * every handled request lands one HTTP SPAN (method, path, status,
    duration, trace id, gid) in a bounded ring
    (``PADDLE_GATEWAY_TRACE_RING``, default 2048; 0 disables) — the
    gateway pid's track in ``export_cluster_trace`` (trace.py);
  * per-endpoint+status latency histograms ride the process-global
    ``telemetry.runtime_histogram`` registry
    (``paddle_gateway_http_request_seconds_<endpoint>_<status>``),
    exposed under ``replica="gateway"`` in ``/metrics`` — the
    gateway's own accept/parse/stream time was previously invisible.

Env knobs: ``PADDLE_GATEWAY_PORT`` (8100; 0 = ephemeral),
``PADDLE_GATEWAY_POLL_S`` (harvest poll interval, 0.004),
``PADDLE_GATEWAY_HB_S`` (health sweep interval, 0.25),
``PADDLE_GATEWAY_TRACE_RING`` (HTTP span ring) — plus the router's
``PADDLE_ROUTER_POLICY`` / ``PADDLE_ROUTER_SPILL_DEPTH`` /
``PADDLE_ROUTER_AUDIT_RING`` / ``PADDLE_GATEWAY_HB_DEAD_S`` and the
rpc replica's ``PADDLE_GATEWAY_HB_TIMEOUT_S``. All registered in
``testing.GW_ENV_VARS``.
"""
from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import threading
import time
import uuid
from collections import deque

from ..inference.serving import AdmissionFull
from ..inference.telemetry import runtime_histogram
from . import protocol
from .router import NoReplicaError

__all__ = ["Gateway"]

_MAX_BODY = 8 << 20                       # 8 MiB: token-id prompts only

# endpoint key for the per-endpoint+status latency histogram names
# (flat names: the runtime registry has no label dimension)
_ENDPOINT_KEYS = {"/v1/completions": "completions",
                  "/v1/models": "models",
                  "/healthz": "healthz",
                  "/metrics": "metrics",
                  "/admin/scale": "admin_scale",
                  "/admin/drain": "admin_drain"}


class _HttpError(Exception):
    def __init__(self, code, message):
        self.code, self.message = code, message


class Gateway:
    def __init__(self, router, model_id="paddle_tpu", host="127.0.0.1",
                 port=None, poll_s=None, hb_s=None, autoscaler=None,
                 tenant_rate=None, tenant_burst=None, tenant_quota=None,
                 shed_depth=None):
        self.router = router
        # optional elastic control plane (serving_cluster/autoscale.py):
        # the health sweep drives its tick; POST /admin/scale needs it
        # (scale-up requires its spawn hook)
        self.autoscaler = autoscaler
        self.model_id = model_id
        self.host = host
        self.port = int(port if port is not None
                        else os.environ.get("PADDLE_GATEWAY_PORT",
                                            "8100"))
        self.poll_s = float(poll_s if poll_s is not None
                            else os.environ.get("PADDLE_GATEWAY_POLL_S",
                                                "0.004"))
        self.hb_s = float(hb_s if hb_s is not None
                          else os.environ.get("PADDLE_GATEWAY_HB_S",
                                              "0.25"))
        # HTTP span ring: one record per handled request, merged into
        # the cluster Perfetto export as the gateway pid's http track
        ring = int(os.environ.get("PADDLE_GATEWAY_TRACE_RING", "2048"))
        if ring < 0:
            raise ValueError(f"trace ring must be >= 0, got {ring}")
        self.trace_ring = ring
        self.http_log = deque(maxlen=max(ring, 1))
        # per-tenant admission (X-Tenant): token-bucket rate limit +
        # live-request quota. 0 disables a check; buckets/live counts
        # are pure host dicts under one lock (handlers run in executor
        # threads). Constructor args override env so tests don't need
        # the process environment.
        self.tenant_rate = float(
            tenant_rate if tenant_rate is not None
            else os.environ.get("PADDLE_TENANT_RATE", "0") or "0")
        self.tenant_burst = float(
            tenant_burst if tenant_burst is not None
            else os.environ.get("PADDLE_TENANT_BURST", "8") or "8")
        self.tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else os.environ.get("PADDLE_TENANT_QUOTA", "0") or "0")
        if self.tenant_rate < 0 or self.tenant_burst < 1 \
                or self.tenant_quota < 0:
            raise ValueError(
                f"need tenant_rate >= 0, tenant_burst >= 1, "
                f"tenant_quota >= 0; got rate={self.tenant_rate} "
                f"burst={self.tenant_burst} quota={self.tenant_quota}")
        # SLO-aware shed watermark: mean queue depth above which LOW-
        # class arrivals are refused while queueing dominates the SLO
        # violations (router.qos_pressure()); 0 disables
        self.shed_depth = float(
            shed_depth if shed_depth is not None
            else os.environ.get("PADDLE_QOS_SHED_DEPTH", "0") or "0")
        self._tenant_lock = threading.Lock()
        self._buckets = {}                # tenant -> [tokens, last_ts]
        self._tenant_live = {}            # tenant -> in-flight count
        # drain serialization fallback when no autoscaler is configured
        # (with one, its _op_lock serializes drain vs tick/scale_to)
        self._drain_lock = threading.RLock()
        self._thread = None
        self._loop = None
        self._stop_evt = None

    # ------------------------------------------------------------ server
    async def serve(self, ready=None):
        """Run until ``stop()``; sets ``self.port`` to the bound port
        (port 0 = ephemeral, the tests' no-collision mode)."""
        self._loop = asyncio.get_running_loop()
        self._stop_evt = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        health = asyncio.ensure_future(self._health_loop())
        if ready is not None:
            ready.set()
        try:
            async with server:
                await self._stop_evt.wait()
        finally:
            health.cancel()

    def start_background(self):
        """Run the event loop in a daemon thread; returns once the
        socket is listening (tests, tools, the CLI's curl demo)."""
        ready = threading.Event()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self.serve(ready)), daemon=True,
            name="gateway")
        self._thread.start()
        if not ready.wait(timeout=30):
            # name the configuration in the failure: "which port, which
            # replicas" is the first question a hung-start stack trace
            # can't answer
            raise RuntimeError(
                f"gateway failed to start within 30s "
                f"(port={self.port}, replicas="
                f"{sorted(self.router.replicas)})")
        return self

    def stop(self):
        if self._loop is not None and self._stop_evt is not None:
            self._loop.call_soon_threadsafe(self._stop_evt.set)
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # daemon thread: it cannot block exit, but a wedged
                # event loop is worth a loud line, not silence
                logging.getLogger("paddle.gateway").warning(
                    "gateway thread still alive after 10s join "
                    "(port=%s) — event loop wedged; daemon thread "
                    "will be abandoned", self.port)

    async def _health_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            try:
                await loop.run_in_executor(None, self.router.refresh)
                await loop.run_in_executor(None,
                                           self.router.check_health)
                if self.autoscaler is not None:
                    # the elastic control loop rides the health sweep:
                    # one tick per sweep (hysteresis + cooldown make the
                    # effective decision cadence much slower)
                    await loop.run_in_executor(None,
                                               self.autoscaler.tick)
            except Exception:
                pass                      # the sweep must never die
            await asyncio.sleep(self.hb_s)

    # ------------------------------------------------------------- http
    def _finish_span(self, span):
        """Close one HTTP span: ring entry (the cluster trace's gateway
        track) + the endpoint+status latency histogram. A span with no
        status never got a response (client vanished pre-reply) and is
        recorded with status 0."""
        span["dur_s"] = round(time.monotonic() - span["t"], 9)
        status = span["status"] if span["status"] is not None else 0
        key = _ENDPOINT_KEYS.get(span["path"], "other")
        runtime_histogram(
            f"paddle_gateway_http_request_seconds_{key}_{status}",
            1e-6, 1e3).observe(span["dur_s"])
        if self.trace_ring:
            self.http_log.append(dict(span, status=status))

    async def _handle(self, reader, writer):
        # the span exists BEFORE the request is parsed and is filled
        # in as _read_request progresses, so a request that dies in
        # parsing (malformed request line, bad Content-Length) still
        # lands an HTTP span + histogram sample and echoes a trace id
        # on its 400; connections that never complete a request
        # (client vanished, read timeout) are not recorded
        span = {"trace_id": None, "method": "?", "path": "",
                "status": None, "gid": None, "t": time.monotonic(),
                "dur_s": None}
        record = False
        try:
            try:
                # bound the request read: a client that connects and
                # sends nothing must not pin a handler task forever
                (method, path, body, tid, prio_h,
                 tenant) = await asyncio.wait_for(
                    self._read_request(reader, writer, span),
                    timeout=30)
            except (asyncio.IncompleteReadError, ConnectionError,
                    asyncio.TimeoutError):
                return
            except _HttpError as e:
                record = True
                span["trace_id"] = span["trace_id"] or uuid.uuid4().hex
                await self._send_error(writer, e.code, e.message,
                                       span=span)
                return
            # the trace context: honor the client/proxy-minted id, else
            # mint one — every response echoes it (header + body), the
            # router threads it through every replica placement
            record = True
            span["trace_id"] = tid or uuid.uuid4().hex
            try:
                await self._route(method, path, body, writer, span,
                                  prio_h, tenant)
            except protocol.ProtocolError as e:
                await self._send_error(writer, e.code, e.message,
                                       span=span)
            except AdmissionFull as e:
                # Retry-After computed from the MEASURED queue drain
                # rate (router snapshots), floored/capped in protocol
                await self._send_error(
                    writer, "admission_full", str(e),
                    extra={"Retry-After":
                           str(self.router.retry_after_s())},
                    span=span)
            except NoReplicaError as e:
                await self._send_error(writer, "no_replica", str(e),
                                       span=span)
            except KeyError as e:
                # an unknown/already-released gid (e.g. a concurrent
                # duplicate whose twin released first) is the client's
                # 404, not a server bug
                await self._send_error(writer, "not_found",
                                       f"unknown request: {e}",
                                       span=span)
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception as e:
                await self._send_error(writer, "internal",
                                       f"unhandled: {e!r}", span=span)
        except (ConnectionError, asyncio.CancelledError):
            pass                          # client went away mid-write
        finally:
            if record:
                self._finish_span(span)
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader, writer, span):
        line = await reader.readline()
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HttpError("bad_request", "malformed request line")
        method, path = parts[0], parts[1]
        span["method"], span["path"] = method, path
        clen = 0
        expect_continue = False
        trace_id = None
        prio = None
        tenant = None
        while True:
            h = (await reader.readline()).decode("latin-1").strip()
            if not h:
                break
            k, _, v = h.partition(":")
            key = k.strip().lower()
            if key == "content-length":
                try:
                    clen = int(v)
                except ValueError:
                    raise _HttpError("bad_request",
                                     "bad Content-Length")
            elif key == "expect" \
                    and v.strip().lower() == "100-continue":
                expect_continue = True
            elif key == protocol.TRACE_HEADER.lower():
                trace_id = v.strip() or None
                span["trace_id"] = trace_id
            elif key == protocol.PRIORITY_HEADER.lower():
                # QoS class hint; the body's "priority" field wins
                # (protocol.parse_completion_request), validation
                # happens there too
                prio = v.strip() or None
            elif key == protocol.TENANT_HEADER.lower():
                tenant = v.strip() or None
        if not 0 <= clen <= _MAX_BODY:
            # the lower bound matters too: readexactly(-1) raises an
            # unhandled ValueError instead of a clean 400
            raise _HttpError("bad_request",
                             f"Content-Length must be in [0, "
                             f"{_MAX_BODY}], got {clen}")
        if expect_continue and clen:
            # curl sends Expect: 100-continue for bodies > 1 KiB and
            # waits ~1s for this interim reply before transmitting —
            # without it every large-prompt POST eats a fixed stall
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(clen) if clen else b""
        return method, path, body, trace_id, prio, tenant

    async def _route(self, method, path, body, writer, span,
                     prio_h=None, tenant=None):
        if method == "GET" and path == "/healthz":
            alive = len(self.router.alive_names())
            total = len(self.router.replicas)
            status = ("ok" if alive == total
                      else "degraded" if alive else "down")
            # gray-failure verdicts ride the probe payload: a replica
            # can be alive (heartbeating) yet shed from placement —
            # operators see WHICH one and WHY without a /metrics scrape
            loop = asyncio.get_running_loop()
            health = await loop.run_in_executor(
                None, self.router.health_status)
            await self._send_json(writer, 200 if alive else 503, {
                "status": status, "replicas_alive": alive,
                "replicas_total": total,
                "replicas": {
                    n: {"verdict": st["verdict"],
                        "breaker": st["breaker"],
                        "signal_s": st["signal_s"]}
                    for n, st in sorted(health.items())}}, span=span)
        elif method == "GET" and path == "/v1/models":
            await self._send_json(writer, 200, {
                "object": "list",
                "data": [{"id": self.model_id, "object": "model",
                          "owned_by": "paddle_tpu"}]}, span=span)
        elif method == "GET" and path == "/metrics":
            loop = asyncio.get_running_loop()
            text = await loop.run_in_executor(
                None, self.router.metrics_prometheus)
            await self._send_raw(
                writer, 200, text.encode(),
                ctype="text/plain; version=0.0.4; charset=utf-8",
                span=span)
        elif method == "POST" and path == "/v1/completions":
            await self._completions(body, writer, span, prio_h, tenant)
        elif path == "/admin/scale" and method in ("GET", "POST"):
            await self._admin_scale(method, body, writer, span)
        elif method == "POST" and path == "/admin/drain":
            await self._admin_drain(body, writer, span)
        else:
            await self._send_error(writer, "not_found",
                                   f"no route {method} {path}",
                                   span=span)

    # ------------------------------------------------------------ admin
    def _scale_status(self):
        """The /admin/scale payload (protocol.SCALE_FIELDS): the
        router's elastic counters + the autoscaler's bounds (null when
        no autoscaler is configured — the field SET never varies)."""
        st = self.router.scale_status()
        a = self.autoscaler
        st["autoscaler"] = a is not None
        st["min_replicas"] = None if a is None else a.min_replicas
        st["max_replicas"] = None if a is None else a.max_replicas
        return st

    async def _admin_scale(self, method, body, writer, span):
        loop = asyncio.get_running_loop()
        if method == "GET":
            await self._send_json(writer, 200, self._scale_status(),
                                  span=span)
            return
        if self.autoscaler is None:
            raise protocol.ProtocolError(
                "conflict", "no autoscaler configured — manual scaling "
                "needs a spawn hook (Gateway(autoscaler=...))")
        try:
            obj = json.loads(body.decode() or "null")
        except (ValueError, UnicodeDecodeError) as e:
            raise protocol.ProtocolError("bad_request",
                                         f"body is not JSON: {e}")
        n = (obj or {}).get("replicas") if isinstance(obj, dict) else None
        if isinstance(n, bool) or not isinstance(n, int) or n < 1:
            raise protocol.ProtocolError(
                "bad_request", "'replicas' must be a positive integer")
        # the walk migrates live sessions on scale-down — run it in the
        # executor like every other replica-touching call
        await loop.run_in_executor(None, self.autoscaler.scale_to, n)
        await self._send_json(writer, 200, self._scale_status(),
                              span=span)

    async def _admin_drain(self, body, writer, span):
        """Graceful drain of ONE named replica (rolling restarts): live
        sessions migrate off, then the replica retires. Refuses to
        drain the last placeable replica — that would orphan every
        stream it holds."""
        loop = asyncio.get_running_loop()
        try:
            obj = json.loads(body.decode() or "null")
        except (ValueError, UnicodeDecodeError) as e:
            raise protocol.ProtocolError("bad_request",
                                         f"body is not JSON: {e}")
        name = (obj or {}).get("replica") if isinstance(obj, dict) \
            else None
        if not isinstance(name, str) or not name:
            raise protocol.ProtocolError(
                "bad_request", "'replica' must be a replica name")
        summary = await loop.run_in_executor(None, self._drain_sync,
                                             name)
        await self._send_json(writer, 200, summary, span=span)

    def _drain_sync(self, name):
        """Check-and-drain ATOMICALLY under the scale-op lock: two
        concurrent drains of the last two replicas must not both pass
        the last-placeable guard (each seeing count 2) and drain the
        cluster to zero — same for a drain racing an autoscaler
        tick's scale-down."""
        lock = (self.autoscaler._op_lock if self.autoscaler is not None
                else self._drain_lock)
        with lock:
            placeable = self.router.placeable_names()
            if name not in self.router.replicas:
                raise protocol.ProtocolError(
                    "not_found", f"unknown replica {name!r}")
            if name in placeable and len(placeable) <= 1:
                raise protocol.ProtocolError(
                    "conflict", f"refusing to drain {name!r}: it is "
                    "the last placeable replica — its sessions would "
                    "have nowhere to migrate")
            return self.router.remove_replica(name)

    # -------------------------------------------------- QoS / tenants
    def _tenant_retry_after(self, tokens):
        """Retry-After from the TENANT'S OWN bucket: time for it to
        refill to one whole token at its refill rate, ceil'd and
        clamped to the protocol bounds. No refill configured -> the
        floor (the quota frees on a completion, not a clock)."""
        if self.tenant_rate <= 0:
            return protocol.RETRY_AFTER_S
        wait = math.ceil(max(1.0 - tokens, 0.0) / self.tenant_rate)
        return int(min(max(wait, protocol.RETRY_AFTER_S),
                       protocol.RETRY_AFTER_MAX_S))

    def _tenant_admit(self, tenant):
        """One admission decision for a tenant-tagged arrival: returns
        None (admitted; one bucket token consumed) or an error code +
        Retry-After seconds. Quota is checked BEFORE the bucket so a
        refused request doesn't burn rate allowance."""
        if tenant is None or (self.tenant_rate <= 0
                              and self.tenant_quota <= 0):
            return None
        now = time.monotonic()
        with self._tenant_lock:
            if self.tenant_quota > 0 \
                    and self._tenant_live.get(tenant, 0) \
                    >= self.tenant_quota:
                tok = self._buckets.get(tenant,
                                        [self.tenant_burst, now])[0]
                return ("quota_exceeded", self._tenant_retry_after(tok))
            if self.tenant_rate > 0:
                tok, last = self._buckets.get(
                    tenant, (self.tenant_burst, now))
                tok = min(self.tenant_burst,
                          tok + (now - last) * self.tenant_rate)
                if tok < 1.0:
                    self._buckets[tenant] = [tok, now]
                    return ("rate_limited", self._tenant_retry_after(tok))
                self._buckets[tenant] = [tok - 1.0, now]
            if self.tenant_quota > 0:
                self._tenant_live[tenant] = \
                    self._tenant_live.get(tenant, 0) + 1
        return None

    def _tenant_release(self, tenant):
        """Undo a quota admission when its request leaves the gateway
        (finished, errored, or the client vanished)."""
        if tenant is None or self.tenant_quota <= 0:
            return
        with self._tenant_lock:
            n = self._tenant_live.get(tenant, 0) - 1
            if n > 0:
                self._tenant_live[tenant] = n
            else:
                self._tenant_live.pop(tenant, None)

    def _should_shed(self, priority):
        """SLO-aware load shedding: refuse a LOW-class arrival when
        the cluster's mean queue depth crosses the watermark AND the
        queue-vs-service decomposition says queueing (not service
        time) is where the SLO pain comes from — only then does
        refusing new waiters actually protect the objectives. Higher
        classes are never shed here; they preempt instead."""
        if self.shed_depth <= 0 or priority != "low":
            return False
        p = self.router.qos_pressure()
        return (p["queue_mean"] >= self.shed_depth
                and p["violated_queue"] >= p["violated_service"])

    # ------------------------------------------------------ completions
    async def _completions(self, body, writer, span, prio_h=None,
                           tenant=None):
        try:
            obj = json.loads(body.decode() or "null")
        except (ValueError, UnicodeDecodeError) as e:
            raise protocol.ProtocolError("bad_request",
                                         f"body is not JSON: {e}")
        req = protocol.parse_completion_request(obj, self.model_id,
                                                priority_header=prio_h)
        loop = asyncio.get_running_loop()
        trace_id = span["trace_id"]
        # tenant admission first (cheap host arithmetic, no router
        # lock): the 429 carries the tenant's OWN bucket refill time,
        # not the cluster drain rate
        verdict = await loop.run_in_executor(None, self._tenant_admit,
                                             tenant)
        if verdict is not None:
            code, retry = verdict
            await self._send_error(
                writer, code,
                f"tenant {tenant!r} {code.replace('_', ' ')}: "
                f"rate={self.tenant_rate}/s burst={self.tenant_burst} "
                f"quota={self.tenant_quota}",
                extra={"Retry-After": str(retry)}, span=span)
            return
        try:
            if await loop.run_in_executor(None, self._should_shed,
                                          req.priority):
                # surfaces as 429 reason=overload with the drain-rate
                # Retry-After (the _handle AdmissionFull path)
                raise AdmissionFull(
                    f"shedding class={req.priority!r}: cluster queue "
                    f"depth over {self.shed_depth} with queue-"
                    "attributed SLO violations dominating")
            await self._completions_admitted(req, writer, span,
                                             trace_id, loop)
        finally:
            self._tenant_release(tenant)

    async def _completions_admitted(self, req, writer, span, trace_id,
                                    loop):
        try:
            gid = await loop.run_in_executor(
                None, lambda: self.router.submit(
                    req.prompt, request_id=req.request_id,
                    trace_id=trace_id, **req.submit_kwargs()))
        except ValueError as e:
            # engine-side validation (prompt + max_tokens exceeding the
            # ring capacity, disabled repetition penalty, ...) is a
            # MALFORMED REQUEST, not a server bug
            raise protocol.ProtocolError("bad_request", str(e))
        span["gid"] = gid
        # an idempotent repeat (request_id already live) returns the
        # ORIGINAL submission's gid — adopt its trace id so the echoed
        # header/body/SSE ids match the engine spans and router audit
        # instead of the retry's fresh id, which traces nothing. Only
        # requests carrying a request_id can be repeats, so the common
        # path skips the extra executor hop + router lock round-trip.
        if req.request_id is not None:
            canon = await loop.run_in_executor(
                None, self.router.trace_id_of, gid)
            if canon is not None and canon != trace_id:
                span["trace_id"] = trace_id = canon
        if req.stream:
            await self._stream(req, gid, writer, span)
        else:
            tokens, state = [], "running"
            try:
                while True:
                    # explicit cursor: a concurrent idempotent retry
                    # sharing this gid still sees the full stream
                    new, done, state = await loop.run_in_executor(
                        None, self.router.harvest, gid, len(tokens))
                    tokens.extend(new)
                    if done:
                        break
                    await asyncio.sleep(self.poll_s)
            finally:
                # error paths (orphaned request, client gone) must not
                # leak the assignment / the engine-side tracked record
                self.router.release(gid)
            if state == "expired":
                raise protocol.ProtocolError(
                    "deadline_exceeded",
                    f"request exceeded deadline_s="
                    f"{req.deadline_s} before completing")
            await self._send_json(writer, 200, protocol.completion_response(
                gid, self.model_id, time.time(), tokens,
                protocol.finish_reason(tokens, req.stop_token_id,
                                       False),
                len(req.prompt), trace_id=trace_id), span=span)

    async def _stream(self, req, gid, writer, span):
        """SSE: headers go out with the FIRST harvest batch, so a
        request that expires before any token still gets a clean 504
        (after the first byte the stream can only finish via
        finish_reason, OpenAI-style)."""
        loop = asyncio.get_running_loop()
        trace_id = span["trace_id"]
        started = False
        last_tok = None
        sent = 0
        try:
            while True:
                new, done, state = await loop.run_in_executor(
                    None, self.router.harvest, gid, sent)
                sent += len(new)
                if new:
                    if not started:
                        await self._send_sse_headers(writer, span)
                        started = True
                    writer.write(protocol.sse_event(
                        protocol.stream_chunk(gid, self.model_id,
                                              time.time(), new,
                                              trace_id=trace_id)))
                    last_tok = new[-1]
                    await writer.drain()
                if done:
                    break
                await asyncio.sleep(self.poll_s)
        except Exception as e:
            if not started or isinstance(e, ConnectionError):
                raise                     # clean JSON error still possible
            # headers are out: a second HTTP response would be protocol
            # garbage — terminate the STREAM honestly instead
            # (finish_reason "error" + [DONE], see protocol.py)
            writer.write(protocol.sse_event(protocol.stream_chunk(
                gid, self.model_id, time.time(), [], reason="error",
                trace_id=trace_id)))
            writer.write(protocol.SSE_DONE)
            await writer.drain()
            return
        finally:
            # a client that disconnects mid-stream must not leak the
            # router assignment (and its engine-side tracked record)
            self.router.release(gid)
        expired = state == "expired"
        if not started:
            if expired:
                raise protocol.ProtocolError(
                    "deadline_exceeded",
                    f"request exceeded deadline_s={req.deadline_s} "
                    "before its first token")
            await self._send_sse_headers(writer, span)
        reason = protocol.finish_reason(
            [] if last_tok is None else [last_tok], req.stop_token_id,
            expired)
        writer.write(protocol.sse_event(protocol.stream_chunk(
            gid, self.model_id, time.time(), [], reason=reason,
            trace_id=trace_id)))
        writer.write(protocol.SSE_DONE)
        await writer.drain()

    # ---------------------------------------------------------- writers
    async def _send_json(self, writer, status, obj, extra=None,
                         span=None):
        await self._send_raw(writer, status,
                             json.dumps(obj).encode(),
                             ctype="application/json", extra=extra,
                             span=span)

    async def _send_error(self, writer, code, message, extra=None,
                          span=None):
        status, body = protocol.error_body(code, message)
        await self._send_json(writer, status, body, extra=extra,
                              span=span)

    async def _send_sse_headers(self, writer, span=None):
        head = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n")
        if span is not None:
            span["status"] = 200
            head += (f"{protocol.TRACE_HEADER}: "
                     f"{span['trace_id']}\r\n").encode()
        writer.write(head + b"Connection: close\r\n\r\n")
        await writer.drain()

    async def _send_raw(self, writer, status, payload, ctype,
                        extra=None, span=None):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  409: "Conflict", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(status, "OK")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(payload)}",
                "Connection: close"]
        if span is not None:
            # every traced response echoes the trace context header —
            # the client (or a proxy) can correlate any reply, error
            # rows included, with the merged cluster trace
            span["status"] = status
            head.append(f"{protocol.TRACE_HEADER}: {span['trace_id']}")
        for k, v in (extra or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
        await writer.drain()
