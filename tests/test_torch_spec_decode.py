"""The port's speculative decoding against the JAX package's, on the CPU.

The host pieces (``NGramDrafter``, ``propose_claims``, ``greedy_accept``,
``filtered_probs``, ``rejection_sample`` under one RandomState seed)
equal JAX's on seeded inputs. ``FusedDecoder._build_verify_core``'s K+1
logits over a ring, with the speculative presence of the repetition
penalty and min_length, within TOLERANCES["logits_fp32"] of JAX's verify
core with equal argmax. The engine with ``spec_k`` 2 and 4 on prompts
that repeat a pattern (so the drafter proposes), greedy and sampled (per
request repetition penalties in two cases), under the row, flat and phase
schedulers over the pool and the ring, and with prefix caching: tokens,
``draft_proposed`` / ``draft_accepted`` and the budget counters equal
the JAX engine's; greedy tokens equal the port's spec-off tokens.
``generate_fused(spec_k=)`` greedy, sampled (PADDLE_TPU_PRNG_IMPL=
threefry2x32, as ``generate``'s keys need), with eos, and with
``prefix_cache=`` equals JAX's. Every engine passes the metric
reconciliations. The bench toy model (E=64, H=4, FF=128, L=2, V=256,
fp32).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.inference import (FusedDecoder, NGramDrafter,
                                        PrefixCache, ServingEngine)
from paddle_tpu_torch.inference import spec_decode as tsd
from paddle_tpu_torch.inference.generation import generate_fused
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SMAX = 128
SAMPLE = {"do_sample": True, "top_k": 20, "top_p": 0.9, "temperature": 0.8}


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


@pytest.fixture(scope="module")
def jax_rng_restored():
    from paddle_tpu.core import rng as jrng
    saved = (jrng.get_rng_state(), jrng.get_seed())
    yield
    jrng.set_rng_state(saved[0])
    jrng._rng.seed_value = saved[1]


def test_drafter_and_claims_match_jax():
    from paddle_tpu.inference import spec_decode as jsd
    r = np.random.default_rng(2)
    for k, lo, hi in ((4, 1, 3), (2, 2, 2), (8, 1, 4)):
        jd, td = jsd.NGramDrafter(k, hi, lo), NGramDrafter(k, hi, lo)
        ctx = np.tile(r.integers(0, 6, 5), 3)
        jd.reset(ctx)
        td.reset(ctx)
        for _ in range(12):
            want = jd.propose()
            np.testing.assert_array_equal(td.propose(), want)
            acc = r.integers(0, 6, r.integers(1, 4))
            jd.update(acc)
            td.update(acc)
        assert (td.propose_calls, td.propose_hits, td.context_len) == \
            (jd.propose_calls, jd.propose_hits, jd.context_len)
    drafters = [(jsd.NGramDrafter(4), NGramDrafter(4)) for _ in range(4)]
    for i, (jd, td) in enumerate(drafters):
        ctx = np.tile(r.integers(0, 5, 3 + i), 2)
        jd.reset(ctx)
        td.reset(ctx)
    remaining = np.array([9, 2, 1, 6])
    for col_cap in (None, 3):
        want = jsd.propose_claims([d[0] for d in drafters], [0, 1, 2, 3], 4,
                                  remaining, col_cap)
        got = tsd.propose_claims([d[1] for d in drafters], [0, 1, 2, 3], 4,
                                 remaining, col_cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tsd.truncate_emitted([3, 7, 2, 7], 3, 7) == \
        jsd.truncate_emitted([3, 7, 2, 7], 3, 7)
    for k in (0, 1, 2, 8):
        assert tsd.validate_spec_k(k) == jsd.validate_spec_k(k)
    for k in (3, -2):
        with pytest.raises(ValueError, match="power of two"):
            tsd.validate_spec_k(k)


def test_acceptance_matches_jax():
    """greedy_accept, filtered_probs over four filters, and
    rejection_sample's tokens under equal RandomState seeds."""
    from paddle_tpu.inference import spec_decode as jsd
    r = np.random.default_rng(3)
    logits = (r.standard_normal((5, 40)) * 2).astype(np.float32)
    for flt in ((0, 1.0, 1.0), (8, 1.0, 0.7), (0, 0.9, 1.2), (5, 0.8, 0.8)):
        want = jsd.filtered_probs(logits, *flt)
        np.testing.assert_array_equal(tsd.filtered_probs(logits, *flt), want)
    greedy = logits.argmax(-1)
    for draft in (greedy[:4], np.r_[greedy[:2], (greedy[2] + 1) % 40, 0],
                  greedy[:0]):
        assert tsd.greedy_accept(draft, greedy) == \
            jsd.greedy_accept(draft, greedy)
    probs = jsd.filtered_probs(logits, 0, 1.0, 0.5)
    for seed in range(20):
        draft = np.where(r.random(4) < 0.7, probs[:4].argmax(-1),
                         r.integers(0, 40, 4))
        want = jsd.rejection_sample(draft, probs, np.random.RandomState(seed))
        got = tsd.rejection_sample(draft, probs, np.random.RandomState(seed))
        assert got == want


@pytest.mark.parametrize("rep_on", [False, True], ids=["plain", "penalty"])
def test_verify_core_matches_jax(models, rep_on):
    """Three rows over a ring (drafts 2, 0 and an inactive row; one row at
    min_length with its eos among the drafts): the K+1 logits within
    logits_fp32 and the argmax chain equal; the valid positions' K/V
    land in the ring as JAX's."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    jmods, tmods = models
    k, b = 4, 3
    r = np.random.default_rng(9)
    ring = (r.standard_normal((L, 2, b, H, SMAX, E // H)) * 0.5).astype(
        np.float32)
    toks = r.integers(0, V, (b, k + 1)).astype(np.int32)
    lens = np.array([40, 7, 90], np.int32)
    dlen = np.array([2, 0, 4], np.int32)
    active = np.array([True, True, False])
    nt = np.array([3, 1, 0], np.int32)
    eos = np.array([int(toks[0, 2]), -1, 5], np.int32)
    min_len = np.array([5, 0, 0], np.int32)
    rep_pen = np.array([1.3, 0.8, 1.0], np.float32)
    presence = r.random((b, V)) < 0.05
    jdec = JaxDecoder(*jmods, SMAX)
    verify = jax.jit(jdec._build_verify_core(k, rep_on))
    args = [jnp.asarray(a) for a in (toks, lens, dlen, active, nt, eos,
                                     min_len, rep_pen, presence)]
    jring, want = verify(jdec._stacked(),
                         [p._data for p in jdec._embed_params],
                         [p._data for p in jdec._head_params],
                         jnp.asarray(ring), *args)
    tdec = FusedDecoder(*tmods, SMAX, device="cpu")
    caches = {"kv": torch.from_numpy(ring.copy())}
    targs = [torch.from_numpy(np.asarray(a)) for a in (
        toks, lens, dlen, active, nt, eos, min_len, rep_pen, presence)]
    targs = [a.long() if a.dtype == torch.int32 else a for a in targs]
    with torch.no_grad():
        got = tdec._build_verify_core(k, rep_on)(tdec._stacked(), caches,
                                                 *targs)
        chain = tdec._build_verify_core(k, rep_on, greedy_out=True)(
            tdec._stacked(), {"kv": torch.from_numpy(ring.copy())}, *targs)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["logits_fp32"])
    np.testing.assert_array_equal(chain.numpy(), want.argmax(-1))
    assert (got.numpy()[0, :2, eos[0]] < -1e29).all()   # min_length holds
    np.testing.assert_allclose(caches["kv"].numpy(), np.asarray(jring),
                               **TOLERANCES["logits_fp32"])


def _spec_requests():
    """Prompts that repeat a short pattern, long enough generations for
    the toy model's greedy output to repeat too: the drafter proposes."""
    r = np.random.default_rng(2)
    cores = [r.integers(0, V, 4 + j) for j in range(3)]
    return [(np.tile(cores[i % 3], 3), 16 + 4 * (i % 3)) for i in range(6)]


def _serve(eng, reqs, pens=None):
    rids = [eng.submit(p, max_new_tokens=m,
                       **({"repetition_penalty": pens[i]} if pens else {}))
            for i, (p, m) in enumerate(reqs)]
    eng.run()
    return [eng.results[r]["tokens"].tolist() for r in rids]


SPEC_COUNTERS = ("draft_proposed", "draft_accepted", "decode_steps",
                 "tokens_emitted", "budget_steps", "budget_tokens_used",
                 "budget_draft_tokens", "budget_padding_tokens",
                 "prefix_hits", "prefix_misses", "prefill_tokens_saved")
PENALTIES = [1.3, 1.0, 0.8, 2.0, 1.1, 1.0]
PEN = {"enable_repetition_penalty": True}
ENGINES = {
    "flat-k2": {"spec_k": 2, "flat_budget": True, "prefill_cap": 16},
    "phase-k4": {"spec_k": 4, "token_budget": 0},
    "row-k4-prefix": {"spec_k": 4, "prefix_cache_blocks": 8,
                      "prefill_cap": 4},
    "sampled-row-k4-pen": {**SAMPLE, **PEN, "spec_k": 4},
    "sampled-flat-k2": {**SAMPLE, "spec_k": 2, "flat_budget": True,
                        "prefill_cap": 16},
    "sampled-dense-phase-k4-pen": {**SAMPLE, **PEN, "spec_k": 4,
                                   "token_budget": 0, "paged": False},
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_spec_matches_jax(models, jax_rng_restored, name,
                                 serving_metrics_ok):
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    kw = dict(ENGINES[name], decode_chunk=2)
    reqs = _spec_requests()
    pens = PENALTIES if kw.get("enable_repetition_penalty") else None
    paddle.seed(5)
    jeng = JaxEngine(*jmods, num_slots=3, max_seq_len=SMAX, **kw)
    want = _serve(jeng, reqs, pens)
    trng.seed(5)
    eng = ServingEngine(*tmods, num_slots=3, max_seq_len=SMAX, device="cpu",
                        **kw)
    got = _serve(eng, reqs, pens)
    assert got == want
    m, jm = serving_metrics_ok(eng), jeng.metrics()
    assert {k: m[k] for k in SPEC_COUNTERS} == \
        {k: jm[k] for k in SPEC_COUNTERS}
    assert m["draft_proposed"] > 0
    if not kw.get("do_sample"):
        assert m["draft_accepted"] > 0
        off = ServingEngine(*tmods, num_slots=3, max_seq_len=SMAX,
                            device="cpu", **dict(kw, spec_k=0))
        assert _serve(off, reqs) == got          # greedy: spec changes nothing


def test_engine_spec_refuses_like_jax(models):
    _, tmods = models
    with pytest.raises(ValueError, match="power of two"):
        ServingEngine(*tmods, num_slots=2, max_seq_len=SMAX, device="cpu",
                      spec_k=3)
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=SMAX, device="cpu",
                        spec_k=8)
    # a row's input token and 8 drafts fit the budget block's columns
    assert eng._budget_cols == 16 and eng.token_budget == 2 * 16
    assert len(eng._drafters) == 2


GENERATE = {
    "eos-k2": {"spec_k": 2, "eos_token_id": "early"},
    "sampled-k4-pen": {**SAMPLE, "spec_k": 4, "repetition_penalty": 1.2,
                       "min_length": 3},
    "prefix-k4": {"spec_k": 4, "prefix_cache": True},
}


@pytest.fixture(scope="module")
def jax_decoder(models):
    """One JAX decoder for every generate case: its compiled steps are
    cached per decoder."""
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    return JaxDecoder(*models[0], SMAX)


@pytest.mark.parametrize("name", list(GENERATE))
def test_generate_spec_matches_jax(models, jax_decoder, jax_rng_restored,
                                   name, monkeypatch):
    import paddle_tpu as paddle
    from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
    monkeypatch.setenv("PADDLE_TPU_PRNG_IMPL", "threefry2x32")
    _, tmods = models
    r = np.random.default_rng(10)
    ids = np.stack([np.tile(r.integers(0, V, 6), 2) for _ in range(2)])
    kw = dict(GENERATE[name])
    tdec = FusedDecoder(*tmods, SMAX, device="cpu")
    if kw.get("eos_token_id") == "early":
        # row 0's tenth token without speculation
        kw["eos_token_id"] = int(tdec.generate(ids, 24)[0, 12 + 9])
    calls = 2 if kw.pop("prefix_cache", False) else 1
    jpc, tpc = JaxCache(16, 4), PrefixCache(16, 4)
    for _ in range(calls):
        pc = {"prefix_cache": (jpc, tpc)} if calls == 2 else {}
        paddle.seed(7)
        want = np.asarray(jax_decoder.generate(
            ids, 24, **kw, **{k: v[0] for k, v in pc.items()})._data)
        trng.seed(7)
        got = generate_fused(*tmods[:1], ids, *tmods[1:], max_new_tokens=24,
                             max_seq_len=SMAX, device="cpu", **kw,
                             **{k: v[1] for k, v in pc.items()}).numpy()
        np.testing.assert_array_equal(got, want)
    if not kw.get("do_sample"):
        # greedy: the spec-off tokens, cut at the last row's first eos
        np.testing.assert_array_equal(got, tdec.generate(
            ids, 24, eos_token_id=kw.get("eos_token_id")).numpy())
    if calls == 2:
        assert tpc.store.stats() == jpc.store.stats()
        assert tpc.store.stats()["match_hits"] == 2
