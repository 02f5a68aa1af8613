"""Cluster serving front-end: OpenAI-compatible gateway, prefix-affinity
router, replica failover.

The assembly over the port's serving stack, copied from the JAX
package's ``serving_cluster`` and pointed at the port's engine: the
engine's ``telemetry_snapshot()`` is the routing payload, the radix
prefix store is what makes placement matter, a heartbeat is the death
detector — this package turns N ``ServingEngine`` replicas (in-process
threads; processes behind rpc wait for ROADMAP 10(e)) into ONE
``curl``-able endpoint. See gateway.py / router.py / replica.py /
protocol.py docstrings for the layer contracts, and
``python -m paddle_tpu_torch.serving_cluster`` for a self-contained demo
cluster.

The router is pure host code: nothing here dispatches to the device,
so the cluster adds no device work: every dispatch is a replica engine's own.

The replica set is ELASTIC: ``Autoscaler`` (autoscale.py)
spawns/drains replicas on telemetry-snapshot signals (queue depth, kv
headroom, SLO queue violations) under the PADDLE_AUTOSCALE_* knobs,
and a drain LIVE-MIGRATES every in-flight session (KV blocks + sampler
state over export_slot/import_slot — zero re-prefill, greedy
token-identical) instead of killing it; ``/admin/scale`` and
``/admin/drain`` expose the same levers to operators.

The trace plane rides on top: one ``X-Request-Id`` trace id
per HTTP request threaded gateway -> router -> replica -> engine and
ACROSS failover (same id, incremented attempt), a router decision
audit ring with per-reason counters, gateway HTTP latency histograms,
and ``export_cluster_trace`` — one merged Perfetto trace for the whole
cluster (trace.py).
"""
from .autoscale import Autoscaler
from .gateway import Gateway
from .protocol import ProtocolError
from .replica import LocalReplica, ReplicaError, RpcReplica, serve_engine
from .router import AUDIT_REASONS, HashRing, NoReplicaError, Router
from .trace import export_cluster_trace

__all__ = ["Gateway", "Router", "HashRing", "LocalReplica",
           "RpcReplica", "serve_engine", "ReplicaError",
           "NoReplicaError", "ProtocolError", "AUDIT_REASONS",
           "Autoscaler", "export_cluster_trace"]
