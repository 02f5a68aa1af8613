"""paddle_tpu_torch.testing — test-only instrumentation shipped with the
package: the fault-injection harness (``fault``) and the registries of
the environment variables the cluster and the harness read, copied from
the JAX package's ``testing`` (the names are the cluster's contract, so
they are the same names). A test that sets one of them leaks it into
every later cluster unless it uses monkeypatch.
"""
from __future__ import annotations

import os

# Every env var the fault-injection harness reads. Keep sorted.
FI_ENV_VARS = (
    "PADDLE_FI_AT_POINT",       # named hook point targeting KILL/HANG/RAISE
    "PADDLE_FI_AT_STEP",        # step index gating KILL/HANG ("step" point)
    "PADDLE_FI_DROP_HEARTBEAT",  # rank whose heartbeat publisher goes dark
    "PADDLE_FI_HANG",           # rank that hangs (bounded sleep) at the point
    "PADDLE_FI_KILL_RANK",      # rank that hard-exits (os._exit) at the point
    "PADDLE_FI_RAISE",          # rank that raises FaultInjected at the point
    "PADDLE_FI_RPC_DELAY_MS",   # flaky transport: per-rpc-call delay
    "PADDLE_FI_RPC_ERR_RATE",   # flaky transport: deterministic error frac
    "PADDLE_FI_SLOW_MS",        # gray failure: persistent delay at a point
    "PADDLE_FI_SLOW_POINT",     # which hook point the slowness rides
)

# Cluster configuration (serving_cluster/, SloPolicy.from_env): a leaked
# router policy or heartbeat threshold silently changes placement and
# failover in every later cluster. Keep sorted.
GW_ENV_VARS = (
    # elastic autoscaler (serving_cluster/autoscale.py): leaked
    # watermarks silently change when every later cluster spawns or
    # drains replicas — same guard discipline as the router knobs
    "PADDLE_AUTOSCALE_COOLDOWN_S",  # seconds between scale events
    # disaggregated per-pool watermarks (autoscale.py role_aware mode):
    # the prefill pool scales on queue depth, the decode pool on kv
    # headroom + resident-session depth — leaked values silently split
    # every later cluster's scaling behavior by role
    "PADDLE_AUTOSCALE_DC_KV_FREE_FRAC",   # decode pool-free frac -> up
    "PADDLE_AUTOSCALE_DC_SESSIONS_HIGH",  # decode session frac -> up
    "PADDLE_AUTOSCALE_DC_SESSIONS_LOW",   # decode session frac -> down
    "PADDLE_AUTOSCALE_HYSTERESIS",  # consecutive agreeing ticks needed
    "PADDLE_AUTOSCALE_KV_FREE_FRAC",  # pool-free fraction -> scale up
    "PADDLE_AUTOSCALE_MAX",        # replica-count ceiling
    "PADDLE_AUTOSCALE_MIN",        # replica-count floor
    "PADDLE_AUTOSCALE_PF_QUEUE_HIGH",  # prefill queue depth -> up
    "PADDLE_AUTOSCALE_PF_QUEUE_LOW",   # prefill queue depth -> down
    "PADDLE_AUTOSCALE_QUEUE_HIGH",  # mean queue depth -> scale up
    "PADDLE_AUTOSCALE_QUEUE_LOW",  # mean queue depth -> scale down
    "PADDLE_AUTOSCALE_ROLE_AWARE",  # per-pool scaling on/off
    "PADDLE_GATEWAY_HB_DEAD_S",    # heartbeat age -> replica dead
    "PADDLE_GATEWAY_HB_S",         # gateway health-sweep interval
    "PADDLE_GATEWAY_HB_TIMEOUT_S",  # rpc replica liveness-probe timeout
    "PADDLE_GATEWAY_POLL_S",       # SSE harvest poll interval
    "PADDLE_GATEWAY_PORT",         # gateway listen port (0 = ephemeral)
    "PADDLE_GATEWAY_REPLICAS",     # demo-cluster replica count
    "PADDLE_GATEWAY_ROLES",        # demo-cluster pool spec "prefill:1,..."
    "PADDLE_GATEWAY_TRACE_RING",   # HTTP span ring size (0 = off)
    # QoS / multi-tenant knobs (inference/serving.py weighted-fair
    # shares; serving_cluster/gateway.py shed + tenant buckets): a
    # leaked share split or rate limit silently reshapes every later
    # engine's packing and the gateway's 429 behavior
    "PADDLE_QOS_SHARES",           # per-class budget shares "high=4,..."
    "PADDLE_QOS_SHED_DEPTH",       # mean queue depth -> shed low class
    # disaggregated serving roles (inference/serving.py role= and
    # serving_cluster/router.py streamed handoff): a leaked role turns
    # every later engine into a prefill-only worker
    "PADDLE_ROLE",                 # engine role prefill|decode|mixed
    "PADDLE_ROLE_HANDOFF_BLOCKS",  # streamed-handoff chunk (0 = off)
    "PADDLE_ROUTER_AUDIT_RING",    # decision ring (0 = ring off;
                                   # reason counters stay)
    # gray-failure defense (serving_cluster/router.py): a leaked breaker
    # threshold or hedge quantile silently changes which replicas every
    # later cluster sheds and when it speculates — guard them all
    "PADDLE_ROUTER_BREAKER_COOLDOWN_S",  # open -> half-open delay (s)
    "PADDLE_ROUTER_BREAKER_ERRS",  # consecutive errors -> breaker open
    "PADDLE_ROUTER_BREAKER_PROBES",  # concurrent half-open placements
    "PADDLE_ROUTER_BREAKER_RATIO",  # x cluster median -> degraded/open
    "PADDLE_ROUTER_HEDGE_MARGIN",  # hedge delay = pXX * margin
    "PADDLE_ROUTER_HEDGE_MIN_S",   # hedge delay floor (s)
    "PADDLE_ROUTER_HEDGE_QUANTILE",  # TTFT percentile (0 = hedging off)
    "PADDLE_ROUTER_POLICY",        # prefix_affinity|least_loaded|round_robin
    "PADDLE_ROUTER_RETRY_BURST",   # retry/hedge token-bucket capacity
    "PADDLE_ROUTER_RETRY_RATE",    # retry/hedge bucket refill (tokens/s)
    "PADDLE_ROUTER_SNAP_AGE_S",    # snapshot staleness bound
    "PADDLE_ROUTER_SPILL_DEPTH",   # owner queue depth -> affinity spill
    "PADDLE_ROUTER_SUSPECT_RATIO",  # x cluster median -> suspect verdict
    # rpc client timeouts (distributed/rpc.py + serving_cluster/
    # replica.py RpcReplica): a leaked timeout silently changes how fast
    # every later cluster declares a frozen replica dead
    "PADDLE_RPC_PING_TIMEOUT_S",   # liveness-probe rpc timeout
    "PADDLE_RPC_TIMEOUT_S",        # per-call rpc client timeout
    # tensor-parallel serving mesh (parallel/__init__.py
    # init_serving_mesh; inference/generation.py weight placement): a
    # leaked mp degree makes every later engine try to stand up a
    # mesh, a leaked weight opt-out silently re-replicates every later
    # sharded engine's stacks
    "PADDLE_SERVING_MESH_MP",      # mesh mp degree (0/1 = no mesh)
    "PADDLE_SERVING_MESH_WEIGHTS",  # 0 = replicate weights under mesh
    # SLO objectives (inference/telemetry.py SloPolicy): a leaked
    # objective silently flips every later engine's goodput counters —
    # same guard discipline as the router knobs
    "PADDLE_SLO_E2E_S",            # end-to-end latency objective (s)
    "PADDLE_SLO_ITL_S",            # mean inter-token latency objective
    "PADDLE_SLO_TTFT_S",           # time-to-first-token objective (s)
    # per-tenant admission (serving_cluster/gateway.py token buckets):
    # X-Tenant header keys the bucket; 429s carry reason=rate_limited /
    # quota_exceeded with a bucket-derived Retry-After
    "PADDLE_TENANT_BURST",         # token-bucket capacity per tenant
    "PADDLE_TENANT_QUOTA",         # live-request quota per tenant
    "PADDLE_TENANT_RATE",          # bucket refill rate (req/s)
)


def fi_env_active() -> list:
    """The PADDLE_FI_* vars currently set (empty list = harness disarmed)."""
    return [v for v in FI_ENV_VARS if os.environ.get(v) not in (None, "")]


def gw_env_active() -> list:
    """The gateway/router env vars currently set (empty = default)."""
    return [v for v in GW_ENV_VARS if os.environ.get(v) not in (None, "")]


from . import fault  # noqa: E402  (re-export the harness)

__all__ = ["FI_ENV_VARS", "GW_ENV_VARS", "fi_env_active", "gw_env_active",
           "fault"]
