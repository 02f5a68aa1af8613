"""The port's ServingEngine with sampling and the repetition penalty,
against the JAX package's engine on the CPU.

The bench toy model (E=64, H=4, FF=128, L=2, V=256, fp32) from one numpy
state on both sides; both global key streams seeded alike before the
engines are built, so every request draws the same seed at ``submit``
(``_host_seed(next_key())``) and its n-th token the same key
fold_in(PRNGKey(seed), n). The sampled tokens must be identical to the
JAX engine's under the row budget, the flat budget and the phase
scheduler over the paged pool, the row budget over the dense ring and
the row budget with kv_quant="int8", weight_quant="int4"; the three
schedulers identical to each other (JAX's scheduling invariance). The
schedulers' runs take per-request repetition penalties
(``enable_repetition_penalty``), the two flavors none. Every engine
passes the metric reconciliations. Rotary
embeddings, the activations and the int8 head are in
``test_torch_serving_options.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SAMPLE = {"do_sample": True, "top_k": 20, "top_p": 0.9, "temperature": 0.8}
SCHEDULERS = {"row": {}, "flat": {"flat_budget": True, "prefill_cap": 16},
              "phase": {"token_budget": 0}}


def _build(act="gelu"):
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L, activation=act,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    state = random_state(np.random.default_rng(4), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, activation=act, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _build()


def _requests(n=4):
    rng = np.random.default_rng(21)
    # (prompt length, max_new_tokens, eos, min_length): two prompts longer
    # than the 16 budget columns, an eos and a min_length that suppresses
    # it; two padded prompt lengths for the phase scheduler's bulk pass
    spec = [(20, 6, None, 0), (5, 7, None, 0), (24, 6, 144, 0),
            (7, 8, 144, 8)][:n]
    return [(rng.integers(0, V, k), m, eos, ml) for k, m, eos, ml in spec]


def _serve(eng, reqs, pens=None):
    rids = [eng.submit(p, max_new_tokens=m, eos_token_id=eos, min_length=ml,
                       **({"repetition_penalty": pens[i]} if pens else {}))
            for i, (p, m, eos, ml) in enumerate(reqs)]
    eng.run()
    return [eng.results[r]["tokens"].tolist() for r in rids]


def _both(jmods, tmods, kwargs, reqs, pens=None, seed=5):
    """(JAX tokens, port tokens, port engine): both streams seeded with
    ``seed`` before each engine is built and served."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    paddle.seed(seed)
    want = _serve(JaxEngine(*jmods, num_slots=3, max_seq_len=128, **kwargs),
                  reqs, pens)
    trng.seed(seed)
    eng = ServingEngine(*tmods, num_slots=3, max_seq_len=128, device="cpu",
                        **kwargs)
    return want, _serve(eng, reqs, pens), eng


@pytest.fixture(scope="module")
def jax_rng_restored():
    from paddle_tpu.core import rng as jrng
    saved = (jrng.get_rng_state(), jrng.get_seed())
    yield
    jrng.set_rng_state(saved[0])
    jrng._rng.seed_value = saved[1]


# each request's repetition penalty (1.0: none)
PENALTIES = [1.3, 1.0, 0.8, 2.0]


@pytest.fixture(scope="module")
def sampled(models, jax_rng_restored):
    """Each scheduler's sampled tokens with per-request repetition
    penalties, JAX's and the port's."""
    jmods, tmods = models
    return {name: _both(jmods, tmods, {**SAMPLE, **kw,
                                       "enable_repetition_penalty": True},
                        _requests(), PENALTIES)
            for name, kw in SCHEDULERS.items()}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_sampled_tokens_match_jax(sampled, name, serving_metrics_ok):
    want, got, eng = sampled[name]
    assert got == want
    # sampled, not greedy: the streams are not degenerate
    assert len({t for toks in got for t in toks}) > 12
    m = serving_metrics_ok(eng)
    assert m["requests_finished"] == len(got)
    assert not eng._presence.any()        # every finished slot cleared


def test_schedulers_are_invariant(sampled):
    """A request's tokens depend on its seed and position only."""
    row = sampled["row"][1]
    assert sampled["flat"][1] == row and sampled["phase"][1] == row


@pytest.mark.parametrize("kwargs,n", [
    ({"paged": False}, 4),
    ({"kv_quant": "int8", "weight_quant": "int4", "prefill_cap": 32}, 2),
], ids=["dense", "kv8-w4"])
def test_sampled_flavors_match_jax(models, sampled, kwargs, n,
                                   serving_metrics_ok, jax_rng_restored):
    """Sampled without the penalty, over the first n requests (the int8
    flavor's interpret-mode JAX kernels are slow); they draw the same
    seeds as in the penalized runs, whose tokens the penalty changed."""
    jmods, tmods = models
    want, got, eng = _both(jmods, tmods, {**SAMPLE, **kwargs},
                           _requests(n))
    assert got == want
    serving_metrics_ok(eng)
    if n == len(PENALTIES):
        assert got != sampled["row"][1]
