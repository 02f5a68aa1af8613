"""The port's ServingEngine with rotary embeddings, each activation and
the int8 LM head, against the JAX package's engine on the CPU.

The models, requests and seeding of ``test_torch_sampled_serving.py``:
tokens identical to the JAX engine's with ``use_rotary`` (greedy under
the phase scheduler, sampled under the flat budget, whose stream rotates
each token at its own position), with a FusedMultiTransformer built with
silu,
and with head_quant="int8" (JAX: PADDLE_TPU_DECODE_INT8_HEAD=1), each
engine through the metric reconciliations; every elementwise activation
of jax.nn the FFN may name against jax.nn's at its defaults, and any
other name refused with JAX's AttributeError. A greedy engine draws no
seed from the global key stream, a sampling one draws one a request.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference.generation import ACTIVATIONS
from test_torch_sampled_serving import (SAMPLE, _both, _build, _requests,
                                        _serve)

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return _build()


@pytest.fixture(scope="module")
def jax_rng_restored():
    from paddle_tpu.core import rng as jrng
    saved = (jrng.get_rng_state(), jrng.get_seed())
    yield
    jrng.set_rng_state(saved[0])
    jrng._rng.seed_value = saved[1]


@pytest.mark.parametrize("kwargs", [
    {"token_budget": 0},
    {**SAMPLE, "flat_budget": True, "prefill_cap": 16}],
    ids=["greedy-phase", "sampled-flat"])
def test_rotary_matches_jax(models, kwargs, serving_metrics_ok,
                            jax_rng_restored):
    """Greedy under the phase scheduler (the bulk prefill rotates the
    prompt at positions 0..), sampled under the flat budget (its stream
    rotates each token at its own position); the decode chunks rotate
    each row at its own."""
    jmods, tmods = models
    want, got, eng = _both(jmods, tmods, {**kwargs, "use_rotary": True},
                           _requests())
    assert got == want
    serving_metrics_ok(eng)


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
def test_activations_match_jax(act):
    """Each elementwise activation of jax.nn the FFN may name, at jax.nn's
    defaults, on values across both signs and past relu6's clip."""
    import jax
    import torch
    x = np.linspace(-9, 9, 1001, dtype=np.float32)
    want = np.asarray(getattr(jax.nn, act)(x))
    got = ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_silu_engine_matches_jax(serving_metrics_ok, jax_rng_restored):
    """A FusedMultiTransformer built with another activation serves it."""
    jmods, tmods = _build("silu")
    want, got, eng = _both(jmods, tmods, SAMPLE, _requests())
    assert got == want
    serving_metrics_ok(eng)


def test_unknown_activation_raises(models):
    _, tmods = models
    tmods[0].activation = "gelu_new"
    try:
        with pytest.raises(AttributeError, match="gelu_new"):
            ServingEngine(*tmods, num_slots=2, max_seq_len=128,
                          device="cpu")
    finally:
        tmods[0].activation = "gelu"


def test_int8_head_matches_jax(models, monkeypatch, serving_metrics_ok,
                               jax_rng_restored):
    jmods, tmods = models
    monkeypatch.setenv("PADDLE_TPU_DECODE_INT8_HEAD", "1")
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    reqs = _requests()
    paddle.seed(5)
    want = _serve(JaxEngine(*jmods, num_slots=3, max_seq_len=128, **SAMPLE),
                  reqs)
    monkeypatch.delenv("PADDLE_TPU_DECODE_INT8_HEAD")
    trng.seed(5)
    eng = ServingEngine(*tmods, num_slots=3, max_seq_len=128, device="cpu",
                        head_quant="int8", **SAMPLE)
    assert _serve(eng, reqs) == want
    serving_metrics_ok(eng)


def test_greedy_draws_no_seed(models):
    """A greedy engine leaves the global stream where it was; a sampling
    one draws one key per request."""
    _, tmods = models
    trng.seed(3)
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu")
    eng.submit(np.arange(4), max_new_tokens=2)
    first = trng.next_key()
    trng.seed(3)
    assert (trng.next_key() == first).all()
    eng = ServingEngine(*tmods, num_slots=2, max_seq_len=128, device="cpu",
                        do_sample=True)
    trng.seed(3)
    eng.submit(np.arange(4), max_new_tokens=2)
    assert not (trng.next_key() == first).all()
    with pytest.raises(ValueError, match="enable_repetition_penalty"):
        eng.submit(np.arange(4), max_new_tokens=2, repetition_penalty=1.2)
