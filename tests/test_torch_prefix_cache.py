"""The port's prefix caching against the JAX package's, on the CPU.

The host stores (``PrefixStore``, ``PagedPrefixStore`` over a
``BlockPool``) through one seeded sequence of inserts, matches, pins,
releases, evictions and reclaims: the same chains and ``stats`` as
JAX's. The dense ``PrefixCache``'s publish and adopt on the same numpy
rings, fp and int8 with its scales: the same pool and adopted rows, bit
for bit. The engine with template-sharing prompts under the row, flat
and phase schedulers, over the pool (``prefix_cache_blocks=``, the
zero-copy hits) and the ring (dense, copied hits), and kv8-w4: tokens,
``prefix_hits``, ``prefix_misses`` and the prefill tokens saved and
computed equal the JAX engine's (the budget schedulers' cold gang of one
template misses alike; the phase scheduler publishes a miss before the
next request of its admission looks up). ``generate_fused(prefix_cache=)``
equals JAX's on its second, adopting call, and a dense engine hits the
blocks it published. Every engine passes the metric reconciliations.
The bench toy model (E=64, H=4, FF=128, L=2, V=256, fp32).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (BlockPool, PagedPrefixCache,
                                        PagedPrefixStore, PrefixCache,
                                        PrefixStore, ServingEngine)
from paddle_tpu_torch.inference.generation import generate_fused
from paddle_tpu_torch.weights import from_jax_state, random_state

E, H, FF, L, V = 64, 4, 128, 2, 256


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


def _store_ops(rng, n_ops=60):
    """A seeded sequence of prompts over three templates (shared first
    blocks, a few distinct tails) with the op each gets."""
    tmpl = [rng.integers(0, 9, 12) for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        t = tmpl[rng.integers(3)]
        cut = int(rng.integers(2, 13))
        toks = np.concatenate([t[:cut], rng.integers(0, 9, rng.integers(6))])
        ops.append((["insert", "match", "pin"][rng.integers(3)], toks))
    return ops


def _blocks(chain):
    return [n.block for n in chain]


def test_stores_match_jax():
    """Dense and paged stores through one op sequence with a budget small
    enough to evict: equal chains, pins and stats at every step; the
    paged store's pool refcounts and reclaims equal too."""
    from paddle_tpu.inference import paged_kv as jpk
    from paddle_tpu.inference import prefix_cache as jpc
    ops = _store_ops(np.random.default_rng(3))
    js, ts = jpc.PrefixStore(6, 3), PrefixStore(6, 3)
    jpool, tpool = jpk.BlockPool(24, 4, 32), BlockPool(24, 4, 32)
    jps = jpk.PagedPrefixStore(5, 4, jpool)
    tps = PagedPrefixStore(5, 4, tpool)
    pins = []
    for op, toks in ops:
        if op == "insert":
            got = [(n.block, new) for n, new in ts.insert(toks)]
            assert got == [(n.block, new) for n, new in js.insert(toks)]
            nb = -(-toks.size // 4)
            ids = tpool.alloc(nb)
            assert ids == jpool.alloc(nb)
            if ids is not None:
                got = [(n.block, new) for n, new in tps.publish(toks, ids)]
                assert got == [(n.block, new)
                               for n, new in jps.publish(toks, ids)]
                tpool.deref(ids)
                jpool.deref(ids)
        elif op == "match":
            assert _blocks(ts.match(toks)) == _blocks(js.match(toks))
            assert _blocks(tps.match(toks)) == _blocks(jps.match(toks))
        else:
            pins.append((ts.match(toks), js.match(toks)))
            ts.acquire(pins[-1][0])
            js.acquire(pins[-1][1])
            if len(pins) > 2:
                t_old, j_old = pins.pop(0)
                ts.release(t_old)
                js.release(j_old)
        assert ts.stats() == js.stats()
        assert tps.stats() == jps.stats()
        np.testing.assert_array_equal(tpool.refcounts, jpool.refcounts)
    assert ts.stats()["evictions"] > 0 and tps.stats()["evictions"] > 0
    assert tps.reclaim(3) == jps.reclaim(3)
    assert tps.stats() == jps.stats() and tpool.free_count == jpool.free_count


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_dense_publish_adopt_match_jax(int8):
    """PrefixCache.publish copies a ring row's full blocks into the pool,
    adopt copies a chain into another row: the pool and the adopted ring
    equal JAX's on the same numpy rings, bit for bit (scales too)."""
    import jax.numpy as jnp
    from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
    r = np.random.default_rng(5)
    shape = (2, 2, 3, 2, 32, 4)                   # [L, 2, B, H, Smax, D]
    kv = (r.integers(-127, 128, shape).astype(np.int8) if int8
          else r.standard_normal(shape).astype(np.float32))
    sc = r.random(shape[:4] + (1, 32)).astype(np.float32)
    prompt = r.integers(0, 50, 23)                # 5 full blocks of 4

    def jring(a):
        return (jnp.asarray(a), jnp.asarray(sc)) if int8 else jnp.asarray(a)
    tring = {"kv": torch.from_numpy(kv.copy())}
    if int8:
        tring["sc"] = torch.from_numpy(sc.copy())
    jpc, tpc = JaxCache(8, 4), PrefixCache(8, 4)
    assert tpc.publish(tring, 1, prompt) == jpc.publish(jring(kv), 1,
                                                        prompt) == 5
    jpool = jpc._pool if int8 else (jpc._pool,)
    tpool = [tpc._pool["kv"]] + ([tpc._pool["sc"]] if int8 else [])
    for a, b in zip(jpool, tpool):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    later = np.concatenate([prompt[:14], r.integers(50, 60, 9)])
    tn, jn = tpc.lookup(later), jpc.lookup(later)
    assert _blocks(tn) == _blocks(jn) and len(tn) == 3
    zeros = np.zeros_like(kv)
    want = jpc.adopt(jring(zeros), 2, jn)
    tz = {"kv": torch.from_numpy(zeros.copy())}
    if int8:
        tz["sc"] = torch.from_numpy(sc.copy())
    got = tpc.adopt(tz, 2, tn)
    for a, b in zip(want if int8 else (want,), got.values()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tpc.store.stats() == jpc.store.stats()


def _template_requests(n=5):
    """n prompts sharing a 40-token template, each with its own suffix."""
    r = np.random.default_rng(1)
    tmpl = r.integers(0, V, 40)
    return [(np.concatenate([tmpl, r.integers(0, V, k)]), m)
            for k, m in zip((5, 9, 3, 12, 7), (5, 4, 6, 4, 5))][:n]


def _serve(eng, reqs):
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    eng.run()
    return [eng.results[r]["tokens"].tolist() for r in rids]


PREFIX_COUNTERS = ("prefix_hits", "prefix_misses", "prefill_tokens_saved",
                   "prefill_tokens_computed", "tokens_emitted",
                   "decode_steps", "budget_steps", "budget_tokens_used")
CACHE16 = {"prefix_cache_blocks": 12, "prefill_cap": 16}
ENGINES = {
    "row": CACHE16,
    "flat": {**CACHE16, "flat_budget": True},
    "phase": {**CACHE16, "token_budget": 0},
    "dense-phase": {**CACHE16, "paged": False, "token_budget": 0},
    # JAX takes its int8 pool kernels at Bt % 32 == 0
    "kv8w4-row": {"prefix_cache_blocks": 6, "prefill_cap": 32,
                  "kv_quant": "int8", "weight_quant": "int4"},
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_prefix_hits_match_jax(models, name, serving_metrics_ok):
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    kw, reqs = ENGINES[name], _template_requests()
    jeng = JaxEngine(*jmods, num_slots=2, max_seq_len=128, **kw)
    want = _serve(jeng, reqs)
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                        **kw)
    assert _serve(eng, reqs) == want
    m, jm = serving_metrics_ok(eng), jeng.metrics()
    assert {k: m[k] for k in PREFIX_COUNTERS} == \
        {k: jm[k] for k in PREFIX_COUNTERS}
    assert m["prefix_store"] == jm["prefix_store"]
    # budget: the first gang of two misses; phase: only the first request
    assert m["prefix_hits"] == (4 if kw.get("token_budget") == 0 else 3)
    assert isinstance(eng.prefix_cache,
                      PagedPrefixCache if eng.paged else PrefixCache)
    if eng.paged:
        # every slot let go: only the store's pins stay in the pool
        assert m["kv_blocks_used"] == m["prefix_store"]["blocks_used"]


def test_generate_publishes_for_an_engine(models, serving_metrics_ok):
    """generate_fused(prefix_cache=) twice on one PrefixCache (the second
    call adopts) equals JAX's, and a dense engine sharing the cache hits
    the blocks generate published, with JAX's tokens and counters."""
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    r = np.random.default_rng(8)
    ids = r.integers(0, V, (2, 21))
    ids[1, :12] = ids[0, :12]                     # three shared blocks
    jpc, tpc = JaxCache(16, 4), PrefixCache(16, 4)
    jdec = JaxDecoder(*jmods, 64)
    for _ in range(2):
        want = np.asarray(jdec.generate(ids, 8, prefix_cache=jpc)._data)
        got = generate_fused(*tmods[:1], ids, *tmods[1:], max_new_tokens=8,
                             max_seq_len=64, prefix_cache=tpc, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert tpc.store.stats() == jpc.store.stats()
    assert tpc.store.stats()["match_hits"] == 2   # the second call's rows
    reqs = [(ids[0], 6), (np.concatenate([ids[1, :16], [7, 9]]), 5)]
    jeng = JaxEngine(*jmods, num_slots=2, max_seq_len=64, decode_chunk=2,
                     prefill_cap=4, prefix_cache=jpc)
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=64, decode_chunk=2,
                        prefill_cap=4, prefix_cache=tpc, device="cpu")
    assert not eng.paged                          # a shared cache is dense
    assert _serve(eng, reqs) == _serve(jeng, reqs)
    m = serving_metrics_ok(eng)
    assert m["prefix_hits"] == jeng.metrics()["prefix_hits"] == 2
    assert m["prefill_tokens_saved"] == \
        jeng.metrics()["prefill_tokens_saved"] == 20 + 16


def test_constructor_rules_follow_jax(models):
    """JAX's ValueErrors: a shared dense cache with paged=True, a paged
    cache passed as prefix_cache=, and mismatched block sizes."""
    _, tmods = models
    for kw, match in (({"prefix_cache": PrefixCache(4, 64), "paged": True},
                       "cannot back a paged"),
                      ({"prefix_cache": PrefixCache(4, 32)}, "must align"),
                      ({"prefix_cache": PagedPrefixCache(
                          4, 64, BlockPool(8, 64, 128))}, "shareable dense")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(*tmods, num_slots=2, max_seq_len=128,
                          device="cpu", **kw)
