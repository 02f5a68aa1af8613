"""The port's quantized ServingEngine against the JAX package's, on the CPU.

Quantization changes logits, so a quantized flavor is never held to fp
tokens: each is held to the JAX engine of the same flavor on the same
requests (identical greedy tokens, equal budget counters and step
kinds), and, within the port, to itself across the row budget and
``flat_budget=True`` (and ``token_budget=0`` under weight-only
quantization: with an int8 pool the phase scheduler's bulk prefill is a
computation of its own, held to the JAX phase engine). The int8 pool
runs at ``prefill_cap=32`` (pool block Bt = 32) so that the JAX engine
takes its int8 Pallas kernels, which need Bt % 32 == 0; the port's
kernels take every block size. Also the metric reconciliations of
check_serving_metrics (the pool bytes count the scales).
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
    state = random_state(np.random.default_rng(1), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


def _requests():
    rng = np.random.default_rng(12)
    # (prompt length, max_new_tokens, eos, min_length): prompts longer
    # than the budget columns, an eos and a min_length that suppresses it
    spec = [(5, 6, None, 0), (40, 5, None, 0), (33, 7, None, 0),
            (3, 8, None, 0), (17, 9, 144, 0), (9, 8, 144, 8)]
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

SCHEDULERS = {"row": {}, "flat": {"flat_budget": True},
              "phase": {"token_budget": 0}}

# (scheduler, flavor) pairs held to the JAX engine
JAX_CASES = {
    "row-kv8": ("row", {"kv_quant": "int8", "prefill_cap": 32}),
    "row-w4": ("row", {"weight_quant": "int4"}),
    "flat-kv8-w4": ("flat", {"kv_quant": "int8", "weight_quant": "int4",
                             "prefill_cap": 32}),
    "phase-kv8-w8": ("phase", {"kv_quant": "int8", "weight_quant": "int8",
                               "prefill_cap": 32}),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_quantized_engine_matches_jax(models, case, serving_metrics_ok):
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    jmods, tmods = models
    sched, flavor = JAX_CASES[case]
    kwargs = dict(SCHEDULERS[sched], **flavor)
    reqs = _requests()
    jeng = JaxEngine(*jmods, num_slots=4, max_seq_len=128, **kwargs)
    want = _serve(jeng, reqs)
    eng = ServingEngine(*tmods, num_slots=4, max_seq_len=128, device="cpu",
                        **kwargs)
    got = _serve(eng, reqs)
    assert got == want
    assert len({t for toks in got for t in toks}) > 10
    assert len(got[-1]) == 8                 # min_length held eos off
    m, jm = serving_metrics_ok(eng), jeng.metrics()
    assert {k: m[k] for k in BUDGET_COUNTERS} == \
        {k: jm[k] for k in BUDGET_COUNTERS}
    assert [st["kind"] for st in eng.telemetry.steps] == \
        [st["kind"] for st in jeng.telemetry.steps]
    assert m["kv_shard_pool_bytes"] == jm["kv_shard_pool_bytes"]
    assert m["kv_blocks_used"] == 0
    caches = eng._caches
    if flavor.get("kv_quant") == "int8":
        assert caches["kv"].dtype == torch.int8 and "sc" in caches
    else:
        assert set(caches) == {"kv"}
    wq = flavor.get("weight_quant")
    assert eng.dec._stacked()["f1_w"].dtype == (
        torch.int8 if wq else torch.float32)


FLAVORS = {"kv8": {"kv_quant": "int8"}, "w8": {"weight_quant": "int8"},
           "w4": {"weight_quant": "int4"},
           "kv8-w4": {"kv_quant": "int8", "weight_quant": "int4"}}


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_quantized_schedulers_agree(models, flavor, serving_metrics_ok):
    """Within one flavor the port's row and flat engines give identical
    greedy tokens (the layout is invisible), and so does the phase
    engine under weight-only quantization. Under an int8 pool the phase
    scheduler is a computation of its own, as in the JAX engine: its bulk
    prefill attends the prompt over exact K/V and quantizes only what it
    writes, where the budget schedulers' prefill chunks attend the int8
    pool; it is held to the JAX phase engine above instead."""
    _, tmods = models
    reqs = _requests()
    outs = {}
    for name, kw in SCHEDULERS.items():
        eng = ServingEngine(*tmods, num_slots=4, max_seq_len=128,
                            device="cpu", prefill_cap=32, **kw,
                            **FLAVORS[flavor])
        outs[name] = _serve(eng, reqs)
        serving_metrics_ok(eng)
    assert outs["flat"] == outs["row"]
    if "kv_quant" not in FLAVORS[flavor]:
        assert outs["phase"] == outs["row"]
