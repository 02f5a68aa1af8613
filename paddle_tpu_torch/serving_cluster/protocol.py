"""OpenAI-compatible wire protocol for the cluster gateway.

ONE module owns the HTTP surface: request parsing/validation, the exact
field set of every response shape, the SSE chunk format, and the
error-code mapping. ``tools/check_http_surface.py`` asserts a LIVE
gateway's responses against these constants (standalone and as a
test), so the OpenAI-compat surface cannot drift silently — the same
discipline ``PROMETHEUS_NAMES`` applies to the metrics surface.

Honesty notes (documented, not hidden):

  * The repo has no tokenizer, so ``prompt`` is a list of int token ids
    and each choice carries a ``tokens`` extension field; ``text`` is
    the space-joined decimal ids (curl-able, diffable, honest).
  * Sampling mode is ENGINE config (fixed at the engine's construction —
    see serving.py), so per-request ``temperature``/``top_p`` are
    accepted and IGNORED like other unknown fields; per-request knobs
    that ARE data (``max_tokens``, ``stop_token_id``, ``min_tokens``,
    ``repetition_penalty``, ``deadline_s``) pass through.
  * ``request_id`` is the idempotency key: re-submitting the same id
    while the original is live returns the same routed request instead
    of running it twice — the failover path leans on this. The window
    is the assignment's lifetime (the router forgets delivered
    requests), not forever.
"""
from __future__ import annotations

import json

# import-light by design (telemetry is host-only):
# the QoS class vocabulary is shared engine <-> wire surface
from ..inference.telemetry import QOS_CLASSES, QOS_DEFAULT

__all__ = ["ProtocolError", "CompletionRequest", "ERROR_STATUS",
           "RETRY_AFTER_S", "RETRY_AFTER_MAX_S", "COMPLETION_FIELDS",
           "CHOICE_FIELDS", "USAGE_FIELDS", "STREAM_CHUNK_FIELDS",
           "MODELS_FIELDS", "MODEL_ENTRY_FIELDS", "HEALTHZ_FIELDS",
           "HEALTHZ_REPLICA_FIELDS",
           "SCALE_FIELDS", "DRAIN_FIELDS", "ERROR_BODY_FIELDS",
           "ERROR_BODY_FIELDS_429", "REASON_FOR_429",
           "PRIORITY_HEADER", "TENANT_HEADER",
           "ENDPOINTS", "TRACE_HEADER", "parse_completion_request",
           "completion_response", "stream_chunk", "sse_event",
           "SSE_DONE", "error_body", "finish_reason"]


# ------------------------------------------------------------ error map
# exception/condition -> (HTTP status, OpenAI-style error type). The
# gateway maps engine exceptions through exactly this table; the
# surface check pins every row end-to-end over real HTTP.
ERROR_STATUS = {
    "admission_full": 429,      # ServingEngine.AdmissionFull: shed
    "rate_limited": 429,        # tenant token bucket empty
    "quota_exceeded": 429,      # tenant live-request quota hit
    "deadline_exceeded": 504,   # deadline_s lapsed before completion
    "unknown_model": 404,       # model id not served here
    "not_found": 404,           # unknown route / unknown request id
    "bad_request": 400,         # malformed JSON / invalid fields
    "no_replica": 503,          # every replica dead/unreachable
    "conflict": 409,            # admin op refused in the current state
                                # (no autoscaler; draining the last
                                # alive replica)
    "internal": 500,            # anything else (bug, not backpressure)
}

# 429 responses carry Retry-After (seconds) — honest backpressure tells
# the client WHEN, not just no. The value is COMPUTED from the measured
# queue drain rate (Router.retry_after_s: total queued / finished-per-
# second over the recent snapshot window), floored here and capped at
# RETRY_AFTER_MAX_S so a stalled window can't tell clients to wait an
# hour (or to hammer a saturated cluster every second).
RETRY_AFTER_S = 1
RETRY_AFTER_MAX_S = 30

# QoS headers: X-Priority selects the request's class (the JSON body's
# "priority" field wins when both are present — the body is the signed
# payload, the header the proxy-injectable convenience) and X-Tenant
# keys the gateway's per-tenant token bucket + quota. Both optional:
# absent priority = "normal", absent tenant = the shared anonymous
# bucket-less pool.
PRIORITY_HEADER = "X-Priority"
TENANT_HEADER = "X-Tenant"

# the end-to-end trace context header: the gateway honors an inbound
# id (so an upstream proxy can pre-mint) or mints one, echoes it on
# EVERY response, and threads it through router -> replica -> engine —
# one curl -H "X-Request-Id: ..." is findable in the merged cluster
# trace, the router audit, and each replica's request spans
TRACE_HEADER = "X-Request-Id"

# ---------------------------------------------------- response shapes
COMPLETION_FIELDS = ("id", "object", "created", "model", "choices",
                     "usage", "trace_id")
CHOICE_FIELDS = ("index", "text", "tokens", "finish_reason")
USAGE_FIELDS = ("prompt_tokens", "completion_tokens", "total_tokens")
STREAM_CHUNK_FIELDS = ("id", "object", "created", "model", "choices",
                       "trace_id")
MODELS_FIELDS = ("object", "data")
MODEL_ENTRY_FIELDS = ("id", "object", "owned_by")
HEALTHZ_FIELDS = ("status", "replicas_alive", "replicas_total",
                  "replicas")
# per-replica gray-failure probe entry under /healthz "replicas"
HEALTHZ_REPLICA_FIELDS = ("verdict", "breaker", "signal_s")
# the elastic admin surface: scale status (GET and the POST /admin/scale
# response) and the drain summary. Autoscaler-less gateways report the
# same field set with null bounds — the shape never varies.
SCALE_FIELDS = ("replicas_alive", "replicas_total", "draining",
                "migrations_total", "migration_aborts_total",
                "scale_events_up", "scale_events_down", "autoscaler",
                "min_replicas", "max_replicas",
                # disaggregated serving: alive replicas per role
                # ({"prefill": n, "decode": n, "mixed": n}) and the
                # completed prefill->decode KV handoff count
                "roles", "handoffs_total")
# "expired": a deadline_s stream whose remaining budget lapsed during
# the drain itself — terminal, but the operator must see it in the
# drain accounting (migrated+failed_over+orphaned+expired covers every
# live assignment the drain touched)
DRAIN_FIELDS = ("replica", "migrated", "failed_over", "orphaned",
                "expired")
ERROR_BODY_FIELDS = ("message", "type", "code")
# EVERY 429 additionally carries a machine-readable shed cause, so a
# client can distinguish "the cluster is full, back off" (overload)
# from "YOUR tenant hit its limit" (rate_limited / quota_exceeded) —
# the latter two must not trigger fleet-wide client backoff
ERROR_BODY_FIELDS_429 = ("message", "type", "code", "reason")
REASON_FOR_429 = {
    "admission_full": "overload",
    "rate_limited": "rate_limited",
    "quota_exceeded": "quota_exceeded",
}

# route -> top-level response field tuple (None = non-JSON body, e.g.
# the Prometheus text exposition). The surface check walks this table.
ENDPOINTS = {
    "POST /v1/completions": COMPLETION_FIELDS,
    "GET /v1/models": MODELS_FIELDS,
    "GET /healthz": HEALTHZ_FIELDS,
    "GET /metrics": None,
    "GET /admin/scale": SCALE_FIELDS,
    "POST /admin/scale": SCALE_FIELDS,
    "POST /admin/drain": DRAIN_FIELDS,
}

SSE_DONE = b"data: [DONE]\n\n"


class ProtocolError(Exception):
    """A request the protocol rejects: ``code`` indexes ERROR_STATUS."""

    def __init__(self, code, message):
        if code not in ERROR_STATUS:
            raise ValueError(f"unknown protocol error code {code!r}")
        super().__init__(message)
        self.code = code
        self.message = message


class CompletionRequest:
    """Validated POST /v1/completions payload."""

    __slots__ = ("model", "prompt", "max_tokens", "stream",
                 "stop_token_id", "min_tokens", "repetition_penalty",
                 "deadline_s", "request_id", "priority")

    def __init__(self, model, prompt, max_tokens, stream, stop_token_id,
                 min_tokens, repetition_penalty, deadline_s, request_id,
                 priority=QOS_DEFAULT):
        self.model = model
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.stream = stream
        self.stop_token_id = stop_token_id
        self.min_tokens = min_tokens
        self.repetition_penalty = repetition_penalty
        self.deadline_s = deadline_s
        self.request_id = request_id
        self.priority = priority

    def submit_kwargs(self):
        """The ServingEngine.submit keyword view of this request."""
        return dict(max_new_tokens=self.max_tokens,
                    eos_token_id=self.stop_token_id,
                    min_length=self.min_tokens,
                    repetition_penalty=self.repetition_penalty,
                    deadline_s=self.deadline_s,
                    priority=self.priority)


def _int_field(body, key, default, lo=None):
    v = body.get(key, default)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ProtocolError("bad_request",
                            f"{key!r} must be an integer, got {v!r}")
    if lo is not None and v < lo:
        raise ProtocolError("bad_request", f"{key!r} must be >= {lo}")
    return v


def parse_completion_request(body, served_model, priority_header=None):
    """Validate a decoded JSON body against the served model; raises
    ProtocolError(bad_request / unknown_model). ``priority_header``
    carries the inbound X-Priority value (the body's "priority" field
    wins when both are present)."""
    if not isinstance(body, dict):
        raise ProtocolError("bad_request", "body must be a JSON object")
    model = body.get("model", served_model)
    if not isinstance(model, str):
        raise ProtocolError("bad_request", "'model' must be a string")
    if model != served_model:
        raise ProtocolError(
            "unknown_model",
            f"model {model!r} is not served here (served: "
            f"{served_model!r})")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       and t >= 0 for t in prompt)):
        raise ProtocolError(
            "bad_request",
            "'prompt' must be a non-empty list of int token ids (this "
            "stack serves token ids; there is no server-side tokenizer)")
    rp = body.get("repetition_penalty", 1.0)
    if not isinstance(rp, (int, float)) or isinstance(rp, bool) or rp <= 0:
        raise ProtocolError("bad_request",
                            "'repetition_penalty' must be a positive "
                            "number")
    dl = body.get("deadline_s")
    if dl is not None and (isinstance(dl, bool)
                           or not isinstance(dl, (int, float))
                           or dl < 0):
        raise ProtocolError("bad_request",
                            "'deadline_s' must be a non-negative number")
    rid = body.get("request_id")
    if rid is not None and not isinstance(rid, str):
        raise ProtocolError("bad_request", "'request_id' must be a "
                            "string")
    prio = body.get("priority", priority_header)
    if prio is None:
        prio = QOS_DEFAULT
    if prio not in QOS_CLASSES:
        raise ProtocolError(
            "bad_request",
            f"'priority' must be one of {list(QOS_CLASSES)}, got "
            f"{prio!r}")
    # an explicit JSON null means "use the default" (OpenAI semantics),
    # never a None that would reach the engine's integer comparisons
    mt = _int_field(body, "max_tokens", 16, lo=1)
    mn = _int_field(body, "min_tokens", 0, lo=0)
    return CompletionRequest(
        model=model, prompt=[int(t) for t in prompt],
        max_tokens=16 if mt is None else mt,
        stream=bool(body.get("stream", False)),
        stop_token_id=_int_field(body, "stop_token_id", None, lo=0),
        min_tokens=0 if mn is None else mn,
        repetition_penalty=float(rp),
        deadline_s=None if dl is None else float(dl),
        request_id=rid, priority=prio)


def _choice(tokens, reason):
    return {"index": 0, "text": " ".join(str(t) for t in tokens),
            "tokens": list(tokens), "finish_reason": reason}


def completion_response(req_id, model, created, tokens, reason,
                        prompt_tokens, trace_id=None):
    return {
        "id": req_id, "object": "text_completion",
        "created": int(created), "model": model,
        "choices": [_choice(tokens, reason)],
        "usage": {"prompt_tokens": int(prompt_tokens),
                  "completion_tokens": len(tokens),
                  "total_tokens": int(prompt_tokens) + len(tokens)},
        "trace_id": trace_id,
    }


def stream_chunk(req_id, model, created, tokens, reason=None,
                 trace_id=None):
    """One SSE data payload: the DELTA tokens since the last chunk
    (``finish_reason`` only on the final chunk, OpenAI-style; every
    chunk carries the request's trace id so a mid-stream failover is
    correlatable from the client side)."""
    return {"id": req_id, "object": "text_completion.chunk",
            "created": int(created), "model": model,
            "choices": [_choice(tokens, reason)], "trace_id": trace_id}


def sse_event(payload) -> bytes:
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


def error_body(code, message):
    """OpenAI-style error envelope; returns (status, body_dict). 429s
    auto-carry the machine-readable ``reason`` field (REASON_FOR_429)."""
    err = {"message": message, "type": code, "code": code}
    if ERROR_STATUS[code] == 429:
        err["reason"] = REASON_FOR_429[code]
    return ERROR_STATUS[code], {"error": err}


def finish_reason(tokens, stop_token_id, expired):
    """The finish_reason contract: ``timeout`` for deadline expiry,
    ``stop`` when the last token is the request's stop id, ``length``
    otherwise (max_tokens exhausted). A fourth value, ``error``, is
    emitted directly by the gateway when a stream that already sent
    bytes cannot continue (e.g. every replica died mid-request) — the
    stream still terminates with a well-formed chunk + ``[DONE]``
    instead of a second HTTP response spliced into the event stream."""
    if expired:
        return "timeout"
    if stop_token_id is not None and tokens \
            and tokens[-1] == stop_token_id:
        return "stop"
    return "length"
