"""python -m paddle_tpu_torch.serving_cluster — a self-contained demo
cluster: N replicas (each its own ServingEngine + prefix cache over a
shared toy model) behind the gateway, ready for curl.

    python -m paddle_tpu_torch.serving_cluster --replicas 2 --port 8100
    python -m paddle_tpu_torch.serving_cluster --replicas 2 --port 8100 \
        --device cpu
    curl -s localhost:8100/v1/models
    curl -s localhost:8100/v1/completions -d \
        '{"prompt": [5, 9, 2, 41], "max_tokens": 8}'
    curl -sN localhost:8100/v1/completions -d \
        '{"prompt": [5, 9, 2, 41], "max_tokens": 8, "stream": true}'
    curl -s localhost:8100/metrics | head

The engines run on the card unless ``--device cpu`` asks for the CPU.
Every replica serves the same random weights (``numpy`` from seed 0,
the JAX package's ``MODEL_DIMS``), so routing is invisible to outputs.
``--roles prefill:1,decode:2`` builds role-specialized replicas
(prefill: few slots, one wide flat token budget; decode: deep slots)
instead of ``--replicas`` mixed ones, shaped as JAX's demo shapes them.
The SLO objectives come from ``PADDLE_SLO_*`` (``SloPolicy.from_env``).

``--workers N`` (replicas out of process over rpc) waits for the
distributed runtime (ROADMAP 10(e)) and ``--mesh-mp M`` (tensor-parallel
engines) for serving tensor parallelism (ROADMAP item 8): both raise
NotImplementedError.

Flags default from the env contract (``PADDLE_GATEWAY_PORT``,
``PADDLE_GATEWAY_REPLICAS``, ``PADDLE_GATEWAY_ROLES``,
``PADDLE_ROUTER_POLICY``, ``PADDLE_SERVING_MESH_MP``).
"""
from __future__ import annotations

import argparse
import os
import time


# the demo cluster's shared toy-model dims (the JAX package's)
MODEL_DIMS = {"E": 64, "H": 4, "FF": 128, "L": 2, "V": 256}


def _build_engine(seed, slots, smax, prefix_blocks, cap, role="mixed", *,
                  device=None):
    import numpy as np

    from ..inference.serving import ServingEngine
    from ..inference.telemetry import SloPolicy
    from ..weights import from_jax_state, random_state

    E, H, FF, L, V = (MODEL_DIMS[k] for k in ("E", "H", "FF", "L", "V"))
    mods = from_jax_state(*random_state(np.random.default_rng(seed),
                                        E, H, FF, L, V), device=device)
    kw = dict(num_slots=slots, max_seq_len=smax, prefill_cap=cap,
              prefix_cache_blocks=prefix_blocks, role=role,
              slo=SloPolicy.from_env(), device=device)
    if role == "prefill":
        # prompt-crunching shape: few slots, one wide flat token
        # budget — the whole batch is prefill chunks, decode never
        # competes for the budget on this engine
        kw.update(num_slots=max(2, slots // 2), flat_budget=True,
                  token_budget=4 * cap, decode_chunk=1)
    elif role == "decode":
        # token-pump shape: deep slot count, small per-step budget —
        # many resident sessions, short steps, low inter-token jitter
        kw.update(num_slots=2 * slots, token_budget=2 * slots)
    return ServingEngine(*mods, **kw)


def _parse_roles(spec):
    """'prefill:1,decode:2' -> ["prefill", "decode", "decode"]. The
    pool must be able to both place prompts and decode them: at least
    one prefill-capable AND one decode-capable entry."""
    roles = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, cnt = part.partition(":")
        name = name.strip()
        if name not in ("prefill", "decode", "mixed"):
            raise SystemExit(
                f"--roles: unknown role {name!r} (want prefill, "
                "decode, or mixed)")
        try:
            n = int(cnt)
        except ValueError:
            raise SystemExit(f"--roles: bad count in {part!r}")
        if n < 1:
            raise SystemExit(f"--roles: count must be >= 1 in {part!r}")
        roles.extend([name] * n)
    if not any(r in ("prefill", "mixed") for r in roles):
        raise SystemExit("--roles: no prefill-capable replica — "
                         "prompts would have nowhere to land")
    if not any(r in ("decode", "mixed") for r in roles):
        raise SystemExit("--roles: no decode-capable replica — "
                         "prefilled sessions would have nowhere to go")
    return roles


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving_cluster",
        description="demo cluster: N replicas behind the gateway")
    ap.add_argument("--replicas", type=int, default=int(os.environ.get(
        "PADDLE_GATEWAY_REPLICAS", "2")))
    ap.add_argument("--port", type=int, default=int(os.environ.get(
        "PADDLE_GATEWAY_PORT", "8100")))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--prefill-cap", type=int, default=64)
    ap.add_argument("--prefix-blocks", type=int, default=64)
    ap.add_argument("--policy", default=None,
                    help="router policy (default: PADDLE_ROUTER_POLICY "
                         "or prefix_affinity)")
    ap.add_argument("--workers", type=int, default=0,
                    help="out-of-process rpc workers (not ported yet: "
                         "ROADMAP 10(e))")
    ap.add_argument("--mesh-mp", type=int, default=int(os.environ.get(
        "PADDLE_SERVING_MESH_MP", "0") or 0),
        help="tensor-parallel engines (not ported yet: ROADMAP item 8)")
    ap.add_argument("--roles", default=os.environ.get(
        "PADDLE_GATEWAY_ROLES", ""),
        help="disaggregated pool spec 'prefill:1,decode:2' — builds "
             "role-specialized replicas (prefill: flat-budget wide; "
             "decode: deep slots) instead of --replicas mixed ones")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda; "
                         "'cpu' asks for the CPU)")
    args = ap.parse_args(argv)
    role_list = _parse_roles(args.roles) if args.roles else None
    if args.workers > 0:
        raise NotImplementedError(
            "--workers: out-of-process replicas need the distributed "
            "runtime's rpc and launcher gang (ROADMAP 10(e)); run the "
            "replicas in process (--replicas / --roles)")
    if args.mesh_mp > 1:
        raise NotImplementedError(
            "--mesh-mp: tensor-parallel serving engines are ROADMAP "
            "item 8")

    from .gateway import Gateway
    from .replica import LocalReplica
    from .router import Router

    roles = role_list or ["mixed"] * args.replicas
    replicas = [
        LocalReplica(f"{role}{i}" if role_list else f"replica{i}",
                     _build_engine(0, args.slots, args.max_seq_len,
                                   args.prefix_blocks, args.prefill_cap,
                                   role=role, device=args.device))
        for i, role in enumerate(roles)]
    n_label = (f"{len(roles)} replicas ({args.roles})"
               if role_list else f"{args.replicas} replicas")
    router = Router(replicas, policy=args.policy)
    gw = Gateway(router, port=args.port).start_background()
    print(f"serving_cluster: {n_label} on "
          f"http://127.0.0.1:{gw.port} (policy {router.policy}) — "
          "Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()
        for r in replicas:
            r.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
