"""Stacked-weight sharding-table check of the port (the counterpart of
the repository's ``tools/check_sharding_spec.py``, which checks the JAX
package's), runnable as
``python -m paddle_tpu_torch.tools.check_sharding_spec [--device cpu]``
and from a test.

The serving step's weights live in one stacked dict
(``FusedDecoder._stacked``), placed per
``generation.STACKED_PARAM_SPECS`` under a weight-shard mesh. This check
makes that table structural:

  0. int4 pack structure: every contracted axis (qkv_w's and f1_w's E,
     lin_w's nh*hd, f2_w's FFN) packs to half its length in int8 bytes,
     with a scale for each weight;
  1. key coverage, both ways: every key the stack emits (fp, int8 and
     int4 flavors) has an entry, and the table has no entry no flavor
     emits;
  2. spec sanity: each entry shards only axes within the array's rank,
     and only on the 'mp' axis;
  3. placement truth on an mp=2 mesh (both shards on the check's
     device): every stacked array lands with exactly its table's split,
     the scales of the column-parallel weights (qkv_w_s, f1_w_s) shard
     with them, and the per-device bytes drop below the dense stack's.

The port's fleet state is saved and restored around the mesh probe. The
decoder runs on the card unless ``--device cpu`` asks for the CPU. Exit
code 0 means the table covers the stack.
"""
from __future__ import annotations

import math
import sys


def _build_decoder(device):
    import numpy as np

    from ..inference.generation import FusedDecoder
    from ..weights import from_jax_state, random_state

    V, E, H, FF, L = 64, 32, 4, 64, 2
    mods = from_jax_state(*random_state(np.random.default_rng(3),
                                        E, H, FF, L, V), device=device)
    return {q: FusedDecoder(*mods, max_seq_len=64, weight_quant=q,
                            device=device)
            for q in ("none", "int8", "int4")}


def main(argv=None):
    import argparse

    from ..distributed.fleet import _fleet_state
    from ..distributed.fleet.base.topology import _HYBRID_GROUP
    from ..inference.generation import STACKED_PARAM_SPECS
    from ..parallel import init_serving_mesh
    from ..parallel.serving_mesh import ShardedTensor

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.check_sharding_spec")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' asks for "
                         "the CPU)")
    args = ap.parse_args(argv)
    failures = []
    decs = _build_decoder(args.device)
    prior_hcg = _HYBRID_GROUP[0]
    prior_fleet = dict(_fleet_state)
    try:
        _HYBRID_GROUP[0] = None
        _fleet_state.update(strategy=None, hcg=None)
        stacks = {q: dict(d._stacked()) for q, d in decs.items()}

        # ---- 0. int4 pack structure
        f = decs["int4"].fmt
        e_dim = int(f.qkv_weights[0].shape[-1])
        ff_dim = int(f.ffn1_weights[0].shape[-1])
        heads = f.num_heads * f.head_dim
        i4 = stacks["int4"]
        for k, axis, full_len in (("qkv_w", 2, e_dim), ("lin_w", 1, heads),
                                  ("f1_w", 1, e_dim), ("f2_w", 1, ff_dim)):
            a = i4[k]
            if str(a.dtype) != "torch.int8":
                failures.append(
                    f"int4 stack key {k!r} has dtype {a.dtype}, expected "
                    "int8 bytes holding two nibbles")
            if a.shape[axis] * 2 != full_len:
                failures.append(
                    f"int4 stack key {k!r} axis {axis} is "
                    f"{a.shape[axis]}, expected the packed half of "
                    f"{full_len} — the contracted axis did not pack")
        for k in ("qkv_w_s", "lin_w_s", "f1_w_s", "f2_w_s"):
            if k not in i4:
                failures.append(
                    f"int4 stack lost its scale {k!r} — dequant cannot "
                    "be applied without it")

        # ---- 1. key coverage, both ways
        emitted = set()
        for flavor, stk in stacks.items():
            emitted |= set(stk)
            for k in sorted(stk):
                if k not in STACKED_PARAM_SPECS:
                    failures.append(
                        f"stacked key {k!r} ({flavor} flavor) has no "
                        "generation.STACKED_PARAM_SPECS entry — add one "
                        "(sharded on 'mp' or the replicated ()) so "
                        "placement under a mesh stays intentional")
        for k in sorted(set(STACKED_PARAM_SPECS) - emitted):
            failures.append(
                f"STACKED_PARAM_SPECS carries dead entry {k!r} — no "
                "weight flavor emits it")

        # ---- 2. spec sanity against the real array ranks
        for flavor, stk in stacks.items():
            for k, a in sorted(stk.items()):
                for dim, name in enumerate(STACKED_PARAM_SPECS.get(k, ())):
                    if name is None:
                        continue
                    if dim >= a.dim():
                        failures.append(
                            f"spec for {k!r} shards axis {dim} but the "
                            f"{flavor} array has rank {a.dim()} (shape "
                            f"{tuple(a.shape)})")
                    if name != "mp":
                        failures.append(
                            f"spec for {k!r} uses mesh axis {name!r} — "
                            "the serving mesh shards weights on 'mp' "
                            "only")

        # ---- 3. placement truth on an mp=2 mesh
        dev = str(decs["none"].device)
        mesh = init_serving_mesh(2, devices=[dev] * 2)
        sharded_any = {}
        for flavor, d in decs.items():
            for k, a in sorted(d._stacked().items()):
                spec = STACKED_PARAM_SPECS.get(k)
                if spec is None:
                    continue                    # reported above
                if not isinstance(a, ShardedTensor):
                    failures.append(
                        f"{flavor} stack key {k!r} was not placed on the "
                        "mesh")
                    continue
                full, local = tuple(a.shape), a.shard_shape()
                want = list(full)
                for dim, name in enumerate(spec):
                    if name is not None and dim < len(want):
                        want[dim] //= mesh.shape[name]
                if local != tuple(want):
                    failures.append(
                        f"{flavor} stack key {k!r} placed as {local} per "
                        f"device (full {full}) — its spec {spec} demands "
                        f"{tuple(want)}; the table and the placement "
                        "have diverged")
                if any(tuple(s.shape) != local or not s.is_contiguous()
                       for s in a.shards):
                    failures.append(
                        f"{flavor} stack key {k!r}: a shard is not a "
                        f"contiguous {local}")
                sharded_any[k] = sharded_any.get(k, False) or local != full
        for k in ("qkv_w_s", "f1_w_s"):
            if k in sharded_any and not sharded_any[k]:
                failures.append(
                    f"scale {k!r} stayed replicated while its column-"
                    "parallel weight shards")
        stk = decs["none"]._stacked()
        dense = sum(math.prod(a.shape) * a.element_size()
                    for a in stk.values())
        per_dev = sum(math.prod(a.shard_shape()) * a.element_size()
                      for a in stk.values())
        if not per_dev < dense:
            failures.append(
                f"mp=2 placement holds {per_dev} bytes per device of a "
                f"{dense}-byte dense stack — nothing sharded")
    finally:
        _HYBRID_GROUP[0] = prior_hcg
        _fleet_state.clear()
        _fleet_state.update(prior_fleet)

    if failures:
        print(f"check_sharding_spec: {len(failures)} failure(s)")
        for f_ in failures:
            print(f"  - {f_}")
        return 1
    print(
        f"check_sharding_spec: ok ({len(emitted)} stacked keys across "
        "fp+int8+int4 flavors covered by STACKED_PARAM_SPECS; specs "
        "rank-checked; int4 contracted axes pack to whole-byte halves; "
        "mp=2 placement matches the table exactly; column-parallel "
        "quant scales shard with their weights)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
