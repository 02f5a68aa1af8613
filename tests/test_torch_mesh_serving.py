"""The port's tensor-parallel serving engine on an mp=2 CPU mesh, against
the port's own single-device engine and the JAX package's mp=2 engine.

``parallel.init_serving_mesh(2, devices=["cpu"] * 8)`` mirrors the JAX
conftest's 8 host devices; both shards then live on the CPU and run the
same per-shard code a two-card run does. Held here, as JAX's
``tests/test_mesh_serving.py`` holds its engine:

- token parity: mp=2 equals mp=1 for every flavor (greedy with and
  without a prefix cache, sampled, spec, int4, int4 with an int8 pool)
  under the row budget, the flat budget and the phase scheduler, and
  equals JAX's mp=2 engine on the same numpy weights (the shard gauges
  equal JAX's too);
- the kernel path: the paged attention wrapper sees H/mp heads a call;
- validation: ``init_serving_mesh`` and the engine raise or warn in
  JAX's cases with JAX's messages;
- the shard gauges (``kv_shard_count`` x ``kv_shard_pool_bytes`` is the
  pool, ``(per_dev - repl) x mp + repl`` the dense weight bytes);
- placement per ``STACKED_PARAM_SPECS``: int8 / int4 scales shard with
  their weights, int4's packed row-parallel axes split in whole bytes,
  an indivisible vocab (V=97) replicates the head, ``mesh_weights=False``
  replicates the stacks.

The JAX package's phase engine prefills by its masked scan under a mesh
(its flash kernel cannot run under GSPMD), the port's by its flash
kernel per shard; the two agree on fp and weight-only flavors, and the
phase scheduler with an int8 pool is held to the port's mp=1 engine.
"""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.parallel import ShardedTensor, init_serving_mesh
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 32, 4, 64, 2, 98
BASE = dict(num_slots=2, max_seq_len=128, prefill_cap=8, decode_chunk=2)
CPU8 = ["cpu"] * 8
GAUGES = ("kv_shard_count", "kv_shard_heads", "kv_shard_pool_bytes",
          "weight_shard_count", "weight_bytes_per_device",
          "weight_bytes_replicated")


def _reset_port_fleet():
    from paddle_tpu_torch.distributed.fleet import _fleet_state
    from paddle_tpu_torch.distributed.fleet.base.topology import (
        _HYBRID_GROUP)
    _HYBRID_GROUP[0] = None
    _fleet_state.update(strategy=None, hcg=None)


def _reset_jax_fleet():
    from paddle_tpu.distributed.fleet import _fleet_state
    from paddle_tpu.distributed.fleet.base.topology import _HYBRID_GROUP
    _HYBRID_GROUP[0] = None
    _fleet_state.update(strategy=None, hcg=None, initialized=False)


@pytest.fixture(autouse=True)
def _port_fleet():
    """Each test starts and ends without the port's serving mesh (the
    conftest resets only JAX's fleet state)."""
    _reset_port_fleet()
    yield
    _reset_port_fleet()


def _state(v=V, seed=1):
    return random_state(np.random.default_rng(seed), E, H, FF, L, v)


@pytest.fixture(scope="module")
def tmods():
    return from_jax_state(*_state(), device="cpu")


def _reqs(seed=11, n=5, vocab=V):
    """JAX's request mix: a shared 24-token prefix in two waves (the
    second adopts what the first published)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, vocab, (24,)).astype(np.int32)
    wave2 = [(np.concatenate([shared, rng.randint(
        1, vocab, (rng.randint(2, 9),)).astype(np.int32)]), 8)
        for _ in range(n - 1)]
    return [[(shared.copy(), 8)], wave2]


def _drive(eng, waves):
    toks = []
    for wave in waves:
        rids = [eng.submit(p, max_new_tokens=m) for p, m in wave]
        eng.run()
        toks += [eng.results[r]["tokens"].tolist() for r in rids]
    return toks


def _port_run(tmods, mp, waves=None, **kw):
    """(tokens, engine) of the port's engine at mp (1: no mesh)."""
    from paddle_tpu_torch.core import rng
    _reset_port_fleet()
    if mp > 1:
        init_serving_mesh(mp, devices=CPU8)
    rng.seed(3)
    eng = ServingEngine(*tmods, device="cpu", **BASE, **kw)
    return _drive(eng, waves or _reqs()), eng


PFX = {"prefix_cache_blocks": 16}
FLAVORS = {
    "greedy": {},
    "prefix": PFX,
    "sampled": dict(PFX, do_sample=True, top_k=8, temperature=0.7),
    "spec": dict(PFX, spec_k=2),
    "int4": {"weight_quant": "int4"},
    "int4-kv8": {"weight_quant": "int4", "kv_quant": "int8"},
}
SCHEDULERS = {"row": {}, "flat": {"flat_budget": True, "token_budget": 16},
              "phase": {"token_budget": 0}}
# (scheduler, flavor) pairs held to the JAX package's mp=2 engine here;
# tests/test_torch_mesh_quant.py holds the rest (the suite's time is
# shared out over files)
JAX_CASES = ("row-prefix", "row-sampled", "row-spec", "flat-prefix")


def _kwargs(case):
    sched, flavor = case.split("-", 1)
    return dict(SCHEDULERS[sched], **FLAVORS[flavor])


def run_jax(cases):
    """The JAX package's mp=2 engine on the same numpy weights, once per
    case: {case: (tokens, shard gauges)}."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    from paddle_tpu.nn.layer.common import Embedding, Linear
    from paddle_tpu.parallel import init_serving_mesh as jax_mesh
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    for lay, sd in zip(jmods, _state()):
        lay.set_state_dict(sd)
    jmods[0].eval()
    out = {}
    try:
        for case in cases:
            _reset_jax_fleet()
            jax_mesh(2)
            paddle.seed(3)
            eng = JaxEngine(*jmods, **BASE, **_kwargs(case))
            toks = _drive(eng, _reqs())
            m = eng.metrics()
            out[case] = (toks, {k: m[k] for k in GAUGES})
    finally:
        _reset_jax_fleet()
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return run_jax(JAX_CASES)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
def test_mesh_matches_single_device(tmods, sched, flavor,
                                    serving_metrics_ok):
    """Neither the head-sharded pool nor the weight placement shows in the
    tokens: mp=2 equals mp=1 for every flavor under every scheduler."""
    kw = dict(SCHEDULERS[sched], **FLAVORS[flavor])
    want, _ = _port_run(tmods, 1, **kw)
    got, eng = _port_run(tmods, 2, **kw)
    assert got == want
    assert len({t for toks in got for t in toks}) > 8
    assert isinstance(eng._caches["kv"], ShardedTensor)
    m = serving_metrics_ok(eng)
    assert (m["kv_shard_count"], m["weight_shard_count"]) == (2, 2)
    if "prefix_cache_blocks" in kw:
        assert m["prefix_hits"] > 0          # the cache participated


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_matches_jax(tmods, jax_runs, case):
    """The port's mp=2 engine gives the JAX mp=2 engine's tokens and shard
    gauges on the same weights and requests."""
    want, jgauges = jax_runs[case]
    got, eng = _port_run(tmods, 2, **_kwargs(case))
    assert got == want
    m = eng.metrics()
    assert {k: m[k] for k in GAUGES} == jgauges
    assert jgauges["kv_shard_count"] == jgauges["weight_shard_count"] == 2


def test_paged_kernel_sees_shard_heads(tmods, monkeypatch):
    """Parity alone cannot tell the per-shard kernel from a whole-head
    fallback: the paged attention wrapper is called once per shard and
    layer pass, each call on H/mp heads of its shard's pool."""
    from paddle_tpu_torch.ops import decode_attention as da
    heads = []
    real = da.decode_attention_paged

    def spy(qt, pool, *a, **k):
        heads.append((qt.shape[1], pool.shape[3]))
        return real(qt, pool, *a, **k)
    monkeypatch.setattr(da, "decode_attention_paged", spy)
    _port_run(tmods, 2)
    assert heads and set(heads) == {(H // 2, H // 2)}
    assert len(heads) % (2 * L) == 0


# ---------------------------------------------------------- validation

def test_explicit_paged_indivisible_heads_raises(tmods):
    init_serving_mesh(8, devices=CPU8)                 # H=4 % 8 != 0
    with pytest.raises(ValueError, match="num_heads % mp"):
        ServingEngine(*tmods, device="cpu", paged=True, **BASE)


def test_default_indivisible_heads_downgrades_with_warnings(tmods):
    """The default falls back to the dense ring (and the weights stay
    replicated), each with JAX's RuntimeWarning; the dense engine then
    refuses int4 and a pool budget, as JAX's does."""
    init_serving_mesh(8, devices=CPU8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = ServingEngine(*tmods, device="cpu", **BASE)
    assert not eng.paged
    msgs = [str(x.message) for x in w if x.category is RuntimeWarning]
    assert any("paged KV pool disabled" in m and "not divisible" in m
               for m in msgs)
    assert any("weight sharding disabled" in m for m in msgs)
    assert eng.metrics()["kv_shard_count"] is None
    assert eng.metrics()["weight_shard_count"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="dense KV ring"):
            ServingEngine(*tmods, device="cpu", weight_quant="int4", **BASE)
        with pytest.raises(ValueError, match="DENSE layout"):
            ServingEngine(*tmods, device="cpu", kv_pool_blocks=8, **BASE)


def test_init_paged_cache_indivisible_raises(tmods):
    from paddle_tpu_torch.inference import FusedDecoder
    from paddle_tpu_torch.inference.paged_kv import BlockPool
    init_serving_mesh(8, devices=CPU8)
    dec = FusedDecoder(*tmods, 64, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        dec.init_paged_cache(BlockPool(8, 8, dec.smax))


def test_dense_prefix_cache_off_under_mesh(tmods, serving_metrics_ok):
    """A shared dense prefix cache is off under a mesh (warned once) and
    every admission counts as a miss; the tokens are the mp=1 engine's."""
    from paddle_tpu_torch.inference.prefix_cache import PrefixCache
    want, _ = _port_run(tmods, 1, paged=False)
    init_serving_mesh(2, devices=CPU8)
    eng = ServingEngine(*tmods, device="cpu", prefix_cache=PrefixCache(
        16, 8), **BASE)
    with pytest.warns(RuntimeWarning, match="dense prefix cache disabled"):
        got = _drive(eng, _reqs())
    assert got == want
    m = serving_metrics_ok(eng)
    assert (m["prefix_hits"], m["prefix_misses"]) == (0, 5)
    assert m["kv_shard_count"] is None and m["weight_shard_count"] == 2


INIT_ERRORS = {
    "conflict": (dict(mp=4), RuntimeError, "already active"),
    "heads": (dict(mp=8, num_heads=4, ffn_dim=FF), ValueError,
              "num_heads=4"),
    "ffn": (dict(mp=4, num_heads=8, ffn_dim=66), ValueError, "ffn_dim=66"),
    "device_count": (dict(mp=3, num_heads=3, ffn_dim=66 * 3), RuntimeError,
                     "device count"),
    "too_few": (dict(mp=2, devices=["cpu"]), RuntimeError,
                "needs >= 2 devices.*devices="),
    "int4_ffn_half": (dict(mp=2, num_heads=4, head_dim=8, ffn_dim=2,
                           weight_quant="int4"), ValueError, "packed half"),
    "int4_proj_half": (dict(mp=2, num_heads=2, head_dim=1, ffn_dim=64,
                            weight_quant="int4"), ValueError, "packed half"),
}


@pytest.mark.parametrize("case", sorted(INIT_ERRORS))
def test_init_serving_mesh_refuses(case):
    """JAX's refusals with JAX's messages; a refused call touches no fleet
    state (the conflict case stands one mesh up first)."""
    from paddle_tpu_torch.parallel import current_mesh
    kw, err, match = INIT_ERRORS[case]
    if case == "conflict":
        init_serving_mesh(2, devices=CPU8)
    kw = dict(kw)
    kw.setdefault("devices", CPU8)
    with pytest.raises(err, match=match):
        init_serving_mesh(kw.pop("mp"), **kw)
    if case != "conflict":
        assert current_mesh() is None


def test_init_serving_mesh_idempotent_and_noop():
    from paddle_tpu_torch.parallel import current_mesh
    assert init_serving_mesh(0) is None and init_serving_mesh(1) is None
    mesh = init_serving_mesh(2, num_heads=H, ffn_dim=FF, head_dim=E // H,
                             weight_quant="int4", devices=CPU8)
    assert mesh.shape["mp"] == 2 and current_mesh() is mesh
    assert [str(d) for d in mesh.devices] == ["cpu", "cpu"]
    assert init_serving_mesh(2) is mesh and init_serving_mesh(1) is mesh


def test_fleet_mp_degree_is_the_controller_view():
    """fleet.init with mp_degree 2 (every other degree 1) builds the serving
    mesh, and the model-parallel group is the controller's: rank 0 of 2.
    An mp degree combined with dp still raises, naming 10(e)."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_model_parallel_rank() == 0
    assert hcg.get_model_parallel_world_size() == 2
    assert hcg.get_model_parallel_group().ranks == [0, 1]
    assert hcg.mesh.shape["mp"] == 2
    _reset_port_fleet()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        fleet.init(is_collective=True, strategy=strategy, device="cpu")


# ---------------------------------------------------------- gauges

def test_shard_gauges(tmods, serving_metrics_ok):
    """kv_shard_count x kv_shard_pool_bytes is the pool, each shard a
    contiguous [L, 2, NB, H/2, Bt, D] of its own; (per_dev - repl) x 2 +
    repl is the dense weight bytes, and per-device bytes drop below it."""
    _, eng = _port_run(tmods, 2, kv_quant="int8")
    m = serving_metrics_ok(eng)
    assert (m["kv_shard_count"], m["kv_shard_heads"]) == (2, H // 2)
    kv, sc = eng._caches["kv"], eng._caches["sc"]
    assert kv.axis == sc.axis == 3
    pool = sum(int(t.nbytes) for c in (kv, sc) for t in c.shards)
    assert m["kv_shard_pool_bytes"] * 2 == pool
    nb = eng.pool.num_blocks
    assert [tuple(t.shape) for t in kv.shards] == \
        [(L, 2, nb, H // 2, 8, E // H)] * 2
    assert all(t.is_contiguous() for t in kv.shards + sc.shards)
    assert kv.shards[0].data_ptr() != kv.shards[1].data_ptr()
    dense = sum(int(np.prod(a.shape)) * a.element_size()
                for a in eng._weight_arrays())
    dev, repl = m["weight_bytes_per_device"], m["weight_bytes_replicated"]
    assert (dev - repl) * 2 + repl == dense
    assert repl < dev < dense


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_unsharded_gauges(tmods, paged):
    _, eng = _port_run(tmods, 1, paged=paged)
    m = eng.metrics()
    dense = sum(int(np.prod(a.shape)) * a.element_size()
                for a in eng._weight_arrays())
    assert m["weight_shard_count"] == 1
    assert m["weight_bytes_per_device"] == m["weight_bytes_replicated"] \
        == dense
    if paged:
        assert (m["kv_shard_count"], m["kv_shard_heads"]) == (1, H)
        assert m["kv_shard_pool_bytes"] == int(eng._caches["kv"].nbytes)
    else:
        assert m["kv_shard_count"] is m["kv_shard_heads"] is \
            m["kv_shard_pool_bytes"] is None


# ---------------------------------------------------------- placement

def _want_local(mesh, spec, full):
    want = list(full)
    for dim, name in enumerate(spec):
        if name is not None:
            want[dim] //= mesh.shape[name]
    return tuple(want)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_stack_placed_per_spec_table(tmods, quant):
    """Every stacked key splits as its spec says; int8 and int4 scales of
    the column-parallel weights shard with them, the row-parallel ones
    stay replicated, and int4's packed row-parallel axes split in whole
    bytes."""
    from paddle_tpu_torch.inference import FusedDecoder
    from paddle_tpu_torch.inference.generation import STACKED_PARAM_SPECS
    mesh = init_serving_mesh(2, devices=CPU8)
    stk = FusedDecoder(*tmods, 64, weight_quant=quant,
                       device="cpu")._stacked()
    for k, a in stk.items():
        assert isinstance(a, ShardedTensor), k
        assert a.shard_shape() == _want_local(
            mesh, STACKED_PARAM_SPECS[k], tuple(a.shape)), k
    assert stk["qkv_w"].shard_shape()[1] * 2 == 3 * E
    assert stk["f1_w"].shard_shape()[2] * 2 == FF
    assert stk["ln_s"].shard_shape() == tuple(stk["ln_s"].shape)
    if quant:
        for k in ("qkv_w_s", "f1_w_s"):
            assert stk[k].shard_shape()[-1] * 2 == stk[k].shape[-1], k
        for k in ("lin_w_s", "f2_w_s"):
            assert stk[k].axis is None, k
    if quant == "int4":
        for k, full_len in (("lin_w", E), ("f2_w", FF)):
            a = stk[k]
            assert a.dtype == torch.int8 and a.shape[1] * 2 == full_len
            assert a.shard_shape()[1] * 2 == a.shape[1]
        assert stk["qkv_w"].shape[-1] * 2 == E


@pytest.mark.parametrize("vocab", [V, 97])
def test_head_vocab_shards_or_replicates(vocab):
    """A Linear head splits its vocab axis when V divides mp and stays
    replicated when it does not (V=97, JAX's documented fallback), while
    the layer stacks shard either way; the logits reach the sampler
    whole, so the tokens are the mp=1 engine's."""
    mods = from_jax_state(*_state(vocab, seed=5), device="cpu")
    waves = _reqs(vocab=vocab)
    want, _ = _port_run(mods, 1, waves)
    got, eng = _port_run(mods, 2, waves)
    assert got == want
    arrs = eng.dec._head_arrays()
    assert all(isinstance(a, ShardedTensor) for a in arrs)
    split = vocab % 2 == 0
    assert all((a.axis is not None) == split for a in arrs)
    m = eng.metrics()
    assert m["weight_shard_count"] == 2
    dense = sum(int(np.prod(a.shape)) * a.element_size()
                for a in eng._weight_arrays())
    assert m["weight_bytes_per_device"] < dense


def test_mesh_weights_opt_out_replicates(tmods):
    """mesh_weights=False (JAX's weight opt-out) keeps the stacks and the
    head replicated; the pool still shards by head and the tokens are the
    mp=1 engine's."""
    want, _ = _port_run(tmods, 1)
    got, eng = _port_run(tmods, 2, mesh_weights=False)
    assert got == want
    assert eng.dec._weight_shard_mesh() is None
    assert not any(isinstance(a, ShardedTensor)
                   for a in eng.dec._stacked().values())
    m = eng.metrics()
    assert (m["weight_shard_count"], m["kv_shard_count"]) == (1, 2)
    assert m["weight_bytes_per_device"] == m["weight_bytes_replicated"]
