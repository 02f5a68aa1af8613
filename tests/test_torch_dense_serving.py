"""The port's ServingEngine(paged=False) against the JAX package's, on the
CPU.

With ``paged=False`` the KV cache is a dense ring of one Smax-position
row per slot. The same requests (prompts longer than the C=16 budget
columns, an eos, a min_length that suppresses it) go through the JAX
engine with ``paged=False`` and the port's, toy model, fp32: greedy
tokens identical, budget counters and telemetry step kinds equal, under
the row budget, ``flat_budget=True`` and ``token_budget=0``, fp, and the
row budget and the phase scheduler over an int8 ring (each quantized
flavor held to the JAX engine of the same flavor). The reconciliations
of check_serving_metrics that apply to an engine without a pool hold,
and ``weight_quant="int4"`` with ``paged=False`` raises JAX's ValueError.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256


@pytest.fixture(scope="module")
def models():
    """The toy model's JAX layers and the port's, from one numpy state."""
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


def _requests():
    rng = np.random.default_rng(13)
    # (prompt length, max_new_tokens, eos, min_length)
    spec = [(5, 6, None, 0), (40, 5, None, 0), (3, 8, None, 0),
            (33, 7, None, 0), (17, 9, 144, 0), (9, 8, 144, 8)]
    return [(rng.integers(0, V, n), m, eos, ml) for n, m, eos, ml in spec]


def _serve(eng, reqs):
    rids = [eng.submit(p, max_new_tokens=m, eos_token_id=eos, min_length=ml)
            for p, m, eos, ml in reqs]
    eng.run()
    return [eng.results[r]["tokens"].tolist() for r in rids]


BUDGET_COUNTERS = ("budget_steps", "budget_tokens_used",
                   "budget_prefill_tokens", "budget_decode_tokens",
                   "budget_padding_tokens", "decode_steps",
                   "tokens_emitted", "requests_finished")

CASES = {"row": {}, "flat": {"flat_budget": True},
         "phase": {"token_budget": 0},
         "row-kv8": {"kv_quant": "int8"},
         "phase-kv8": {"token_budget": 0, "kv_quant": "int8"}}


@pytest.mark.parametrize("case", list(CASES))
def test_dense_engine_matches_jax(models, case, serving_metrics_ok):
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    reqs = _requests()
    kwargs = dict(CASES[case], paged=False)
    jeng = JaxEngine(*jmods, num_slots=3, max_seq_len=128, **kwargs)
    want = _serve(jeng, reqs)
    eng = ServingEngine(*tmods, num_slots=3, max_seq_len=128, device="cpu",
                        **kwargs)
    got = _serve(eng, reqs)
    assert got == want
    assert len({t for toks in got for t in toks}) > 10
    m, jm = serving_metrics_ok(eng), jeng.metrics()
    assert {k: m[k] for k in BUDGET_COUNTERS} == \
        {k: jm[k] for k in BUDGET_COUNTERS}
    assert [st["kind"] for st in eng.telemetry.steps] == \
        [st["kind"] for st in jeng.telemetry.steps]
    assert m["requests_finished"] == len(reqs)
    assert eng.pool is None and eng._tables is None
    for k in ("kv_blocks_total", "kv_blocks_used", "kv_blocks_free",
              "kv_shard_count", "kv_shard_heads", "kv_shard_pool_bytes"):
        assert m[k] is None and jm[k] is None, k
    if case.startswith("phase"):
        assert m["budget_steps"] == 0
    else:
        assert m["budget_steps"] > 0
    ring = eng._caches["kv"]
    assert ring.shape == (L, 2, 3, H, 128, E // H)
    assert ("sc" in eng._caches) == case.endswith("kv8")


def test_dense_engine_int4_weights_raise(models):
    """JAX refuses int4 packed weights on a dense ring; so does the
    port, in the constructor."""
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    with pytest.raises(ValueError, match="dense"):
        JaxEngine(*jmods, num_slots=2, max_seq_len=128, paged=False,
                  weight_quant="int4")
    with pytest.raises(ValueError, match="dense"):
        ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                      paged=False, weight_quant="int4")


def test_dense_engine_int8_weights(models, serving_metrics_ok):
    """Weight-only int8 over a ring: the row and phase schedulers agree
    (the ring holds fp K/V, so bulk prefill attends what decode does)."""
    _, tmods = models
    reqs = _requests()[:4]
    outs = [_serve(ServingEngine(*tmods, num_slots=3, max_seq_len=128,
                                 device="cpu", paged=False,
                                 weight_quant="int8", **kw), reqs)
            for kw in ({}, {"token_budget": 0})]
    assert outs[0] == outs[1]
