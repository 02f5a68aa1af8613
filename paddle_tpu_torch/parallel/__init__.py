"""paddle_tpu_torch.parallel — the serving mesh and context parallelism
over the hybrid mesh.

Counterpart of ``paddle_tpu/parallel/__init__.py``'s ``current_mesh``,
``init_serving_mesh``, ``data_spec``, ``shard_batch`` and its
context-parallel exports (``parallel/context_parallel.py``). The serving
mesh is the port's own single-controller mesh
(``serving_mesh.ServingMesh``): one process drives ``mp`` shards, as
JAX's serving engine drives ``mp`` devices. ``shard_batch`` gives this
process its slice of a global batch, as JAX's places each device's.
JAX's placement calls (``apply_shardings``, ``with_spec``) have no
counterpart: the port's sharded state is explicit
(``distributed.sharding``).
"""
from __future__ import annotations

from .context_parallel import (make_ring_attention_fn,
                               make_ulysses_attention_fn, ring_attention,
                               ulysses_attention)
from .serving_mesh import ServingMesh, ShardedTensor

__all__ = ["current_mesh", "init_serving_mesh", "data_spec", "shard_batch",
           "mesh_degree", "ring_attention",
           "ulysses_attention", "make_ring_attention_fn",
           "make_ulysses_attention_fn", "ShardedTensor"]


def current_mesh():
    """The active hybrid mesh that ``fleet.init`` built, or None: a
    ``ServingMesh`` under a model-parallel degree (its degree is
    ``mesh.shape["mp"]``), else a ``DeviceMesh`` with axes pp, dp,
    sharding, sep, mp."""
    from ..distributed.fleet.base.topology import _HYBRID_GROUP
    hcg = _HYBRID_GROUP[0]
    return hcg.mesh if hcg is not None else None


def init_serving_mesh(mp=None, *, num_heads=None, ffn_dim=None,
                      head_dim=None, weight_quant=None, devices=None):
    """Stand up (or reuse) a pure tensor-parallel mesh for serving:
    dp=pp=sharding=1, mp as given (default: ``PADDLE_SERVING_MESH_MP``;
    unset/0/1 = no mesh, returns whatever mesh is already active).
    Idempotent: an active mesh of the requested degree is returned as it
    is; a conflicting one raises.

    ``num_heads`` / ``ffn_dim`` validate the layout up front (the KV pool
    and qkv/out-proj shard by head, the FFN weights by column); with
    ``weight_quant='int4'`` (and ``head_dim``) the int4-packed halves of
    the row-parallel contracted axes must divide mp too. The port's
    extra, ``devices``, lists the devices the mesh may use (default every
    visible CUDA device); shard ``i`` runs on ``devices[i]``, and a list
    may name one card several times (``["cuda:0"] * 2`` runs mp=2 on one
    card, ``["cpu"] * 8`` mirrors the JAX tests' 8 host devices)."""
    import os
    if mp is None:
        mp = int(os.environ.get("PADDLE_SERVING_MESH_MP", "0") or 0)
    mp = int(mp)
    mesh = current_mesh()
    if mp <= 1:
        return mesh
    if num_heads is not None and num_heads % mp:
        raise ValueError(
            f"init_serving_mesh(mp={mp}): num_heads={num_heads} is not "
            f"divisible by mp — the qkv/out-proj weights and the KV "
            "pool shard by head over 'mp'; pick mp from the divisors "
            f"of {num_heads}")
    if ffn_dim is not None and ffn_dim % mp:
        raise ValueError(
            f"init_serving_mesh(mp={mp}): ffn_dim={ffn_dim} is not "
            "divisible by mp — the FFN weights shard by column over "
            f"'mp'; pick mp from the divisors of {ffn_dim}")
    if weight_quant == "int4":
        if ffn_dim is not None and (ffn_dim % 2 or (ffn_dim // 2) % mp):
            raise ValueError(
                f"init_serving_mesh(mp={mp}, weight_quant='int4'): "
                f"ffn_dim={ffn_dim} must be even AND its packed half "
                f"{ffn_dim // 2} divisible by mp — the row-parallel "
                "FFN-2 stack shards its int4-PACKED contracted axis, "
                "and a shard boundary must land on a whole byte")
        if num_heads is not None and head_dim is not None:
            hh = num_heads * head_dim
            if hh % 2 or (hh // 2) % mp:
                raise ValueError(
                    f"init_serving_mesh(mp={mp}, weight_quant='int4'): "
                    f"num_heads*head_dim={hh} must be even AND its "
                    f"packed half {hh // 2} divisible by mp — the "
                    "row-parallel out-proj stack shards its "
                    "int4-PACKED contracted axis in whole bytes")
    if mesh is not None:
        have = mesh.shape["mp"] if isinstance(mesh, ServingMesh) else 1
        if have == mp:
            return mesh
        raise RuntimeError(
            f"init_serving_mesh(mp={mp}): a mesh with mp={have} is "
            "already active — one process, one hybrid topology (reset "
            "fleet state before re-initializing)")
    if devices is None:
        import torch
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < mp:
        raise RuntimeError(
            f"init_serving_mesh(mp={mp}) needs >= {mp} devices, found "
            f"{len(devices)} — pass devices= (a card may be named more "
            f"than once: devices=['cuda:0'] * {mp} runs every shard on "
            "one card)")
    if len(devices) % mp:
        raise RuntimeError(
            f"init_serving_mesh(mp={mp}): device count "
            f"{len(devices)} is not divisible by mp — a ragged "
            "mesh cannot be built; pick mp from the divisors of the "
            "device count (or adjust devices=)")
    from ..distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": mp,
                               "pp_degree": 1, "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy,
               device=str(devices[0]), devices=devices[:mp])
    return current_mesh()


def _valid_spec(arr, spec, mesh) -> bool:
    """Whether ``spec`` (one mesh axis name or None per leading axis of
    ``arr``) shards only axes that exist and divide the mesh's degree."""
    if spec is None:
        return False
    for dim, name in enumerate(spec):
        if name is None:
            continue
        if dim >= len(arr.shape) or arr.shape[dim] % mesh.shape[name]:
            return False
    return True


def mesh_degree(mesh, axis) -> int:
    """The size of ``mesh``'s ``axis`` (1 without a mesh or that axis)."""
    if mesh is None:
        return 1
    if isinstance(mesh, ServingMesh):
        return dict(mesh.shape).get(axis, 1)
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis)] if axis in names else 1


def data_spec(ndim: int, mesh=None):
    """The batch's layout, JAX's spec as a tuple: dim 0 over the dp and
    sharding axes together (both consume distinct data), dp the major."""
    return (("dp", "sharding"), *([None] * (ndim - 1)))


def shard_batch(x, mesh=None):
    """This process's rows of the global batch ``x`` under ``data_spec``:
    the ``dp_rank * sharding + sharding_rank``-th of ``dp * sharding``
    equal slices of dim 0. ``x`` as it is without a mesh, or where dim 0
    does not divide (as JAX leaves it)."""
    mesh = mesh or current_mesh()
    dp, sh = mesh_degree(mesh, "dp"), mesh_degree(mesh, "sharding")
    total = dp * sh
    if total == 1 or x.shape[0] % total:
        return x
    idx = mesh.get_local_rank("dp") * sh + mesh.get_local_rank("sharding")
    rows = x.shape[0] // total
    return x[idx * rows:(idx + 1) * rows]
