"""The port's ``generate_fused`` with every decoding option this slice
ports, against the JAX package's ``FusedDecoder.generate`` on the CPU.

The bench toy model (E=64, H=4, FF=128, L=2, V=256, fp32) from one numpy
state on both sides. Tokens identical to JAX's with:
- sampling (top_k, top_p, temperature, with eos), under
  PADDLE_TPU_PRNG_IMPL=threefry2x32: ``generate`` draws its keys with
  ``next_key()``, and JAX's default rbg keys draw bits no port can
  reproduce (ROADMAP Queue 3); both streams seeded alike;
- min_length with repetition_penalty, sampled;
- rotary embeddings (``use_rotary``);
- the int8 LM head (``head_quant="int8"``; JAX:
  PADDLE_TPU_DECODE_INT8_HEAD=1);
- beam search (num_beams 2 and 4, length_penalty 1.0 and 0.6, with an
  eos that beams reach; ``chip_smoke.py`` phase 3b runs them without);
- whole-prompt bulk prefill (``bulk_prefill=True``; JAX:
  PADDLE_TPU_BULK_PREFILL=1), fp, and rotary over an int8 ring.
The per-step logits behind them within TOLERANCES["logits_fp32"]: a
rotary decode step and block over a ring, the rotary bulk prefill, and
the int8 head. JAX's refusals of option combinations are the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.inference import FusedDecoder
from paddle_tpu_torch.inference import generation as tg
from paddle_tpu_torch.inference.generation import generate_fused
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SMAX = 128
SAMPLE = {"do_sample": True, "top_k": 30, "top_p": 0.9, "temperature": 0.8}


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    state = random_state(np.random.default_rng(6), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(7).integers(0, V, (2, 16))


@pytest.fixture
def seeded(monkeypatch):
    """Both global streams on threefry2x32 keys from seed 11; the JAX
    package's key restored afterwards."""
    import paddle_tpu as paddle
    from paddle_tpu.core import rng as jrng
    saved = (jrng.get_rng_state(), jrng.get_seed())
    monkeypatch.setenv("PADDLE_TPU_PRNG_IMPL", "threefry2x32")
    paddle.seed(11)
    trng.seed(11)
    yield
    jrng.set_rng_state(saved[0])
    jrng._rng.seed_value = saved[1]


_JAX_DECODERS = {}


def _jax_generate(jmods, ids, max_new, use_rotary=False, **kw):
    """JAX's generate, on one decoder a (rotary, kv_quant) flavor: a
    decoder keeps its compiled prefill and decode scans across calls."""
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    kv_quant = kw.pop("kv_quant", None)
    key = (id(jmods), use_rotary, kv_quant)
    if key not in _JAX_DECODERS:
        _JAX_DECODERS[key] = JaxDecoder(*jmods, ids.shape[1] + max_new,
                                        use_rotary=use_rotary,
                                        kv_quant=kv_quant)
    return np.asarray(_JAX_DECODERS[key].generate(ids, max_new, **kw)._data)


def _port_generate(tmods, ids, max_new, **kw):
    return generate_fused(tmods[0], ids, *tmods[1:], max_new_tokens=max_new,
                          device="cpu", **kw).numpy()


@pytest.fixture(scope="module")
def greedy(models, prompts):
    """The port's greedy tokens (no eos; JAX's are the same,
    ``test_torch_generate.py``), for the eos picks below."""
    return _port_generate(models[1], prompts, 9)[:, 16:]


def _early_eos(gen):
    """A token row 0 emits early that row 1 also emits within its first
    ten: an eos both rows reach."""
    for j in range(1, 10):
        if gen[0, j] in gen[1, :10]:
            return int(gen[0, j])
    return int(gen[0, 2])


def test_sampled_generate_matches_jax(models, prompts, greedy, seeded):
    jmods, tmods = models
    kw = dict(SAMPLE, eos_token_id=_early_eos(greedy))
    want = _jax_generate(jmods, prompts, 9, **kw)
    got = _port_generate(tmods, prompts, 9, **kw)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[:, 16:], greedy[:, :got.shape[1] - 16])
    # the draws consumed the same keys on both sides
    from paddle_tpu.core import rng as jrng
    from paddle_tpu.inference.generation import _host_seed
    assert _host_seed(jrng.next_key()) == tg._host_seed(trng.next_key())


def test_min_length_and_repetition_penalty_match_jax(models, prompts,
                                                     greedy, seeded):
    jmods, tmods = models
    kw = dict(SAMPLE, min_length=4, eos_token_id=int(greedy[0, 1]),
              repetition_penalty=1.5)
    want = _jax_generate(jmods, prompts, 9, **kw)
    got = _port_generate(tmods, prompts, 9, **kw)
    np.testing.assert_array_equal(got, want)
    assert not (got[:, 16:20] == kw["eos_token_id"]).any()


def test_rotary_generate_matches_jax(models, prompts):
    jmods, tmods = models
    want = _jax_generate(jmods, prompts, 9, use_rotary=True)
    got = _port_generate(tmods, prompts, 9, use_rotary=True)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[:, 16:25], _port_generate(
        tmods, prompts, 9)[:, 16:])                    # rotary matters


def test_int8_head_generate_matches_jax(models, prompts, monkeypatch,
                                        seeded):
    jmods, tmods = models
    monkeypatch.setenv("PADDLE_TPU_DECODE_INT8_HEAD", "1")
    want = _jax_generate(jmods, prompts, 9, **SAMPLE)
    monkeypatch.delenv("PADDLE_TPU_DECODE_INT8_HEAD")
    got = _port_generate(tmods, prompts, 9, head_quant="int8", **SAMPLE)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,lp", [(2, 1.0), (4, 0.6)],
                         ids=["k2-lp1", "k4-lp0.6"])
def test_beams_match_jax(models, prompts, greedy, k, lp):
    jmods, tmods = models
    kw = dict(num_beams=k, length_penalty=lp,
              eos_token_id=_early_eos(greedy))
    want = _jax_generate(jmods, prompts, 9, **kw)
    got = _port_generate(tmods, prompts, 9, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"kv_quant": "int8",
                                     "use_rotary": True}],
                         ids=["fp", "kv8-rotary"])
def test_bulk_prefill_matches_jax(models, prompts, kw, monkeypatch):
    jmods, tmods = models
    monkeypatch.setenv("PADDLE_TPU_BULK_PREFILL", "1")
    want = _jax_generate(jmods, prompts, 9, **kw)
    got = _port_generate(tmods, prompts, 9, bulk_prefill=True, **kw)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------ per-step logits behind them
def _jax_core(jmods, **kw):
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    dec = JaxDecoder(*jmods, SMAX, **kw)
    core = dec._build_step_core(False, 0, 1.0, 1.0)
    return (dec, core, [p._data for p in dec._embed_params],
            [p._data for p in dec._head_params])


def test_rotary_steps_match_jax(models):
    """A rotary decode step at per-row positions and a rotary [B, 4]
    block over a ring, and the rotary bulk prefill: logits within
    logits_fp32 of JAX's, the rings alike."""
    jmods, tmods = models
    rng = np.random.default_rng(13)
    ring = rng.standard_normal((L, 2, 3, H, SMAX, E // H)).astype(np.float32)
    dec, core, e_arrays, h_arrays = _jax_core(jmods, use_rotary=True)
    tdec = FusedDecoder(*tmods, SMAX, use_rotary=True, device="cpu")
    tok = np.array([5, 77, 200], np.int32)
    t = np.array([70, 9, 0], np.int32)
    x, jring = jax.jit(core.hidden)(dec._stacked(), e_arrays,
                                    jnp.asarray(ring), jnp.asarray(tok),
                                    jnp.asarray(t))
    caches = FusedDecoder.ring_caches(torch.from_numpy(ring.copy()))
    with torch.no_grad():
        xt = tdec.hidden(tdec._stacked(), caches,
                         torch.from_numpy(tok).long(), torch.from_numpy(t))
        np.testing.assert_allclose(
            tdec.head_logits(xt).numpy(),
            np.asarray(core.head_logits(h_arrays, x)),
            **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(caches["kv"].numpy(), np.asarray(jring),
                               **TOLERANCES["logits_fp32"])
    toks = rng.integers(0, V, (3, 4)).astype(np.int32)
    mask = np.ones((3, 4), bool)
    x, _ = jax.jit(core.spec_hidden)(dec._stacked(), e_arrays,
                                     jnp.asarray(ring), jnp.asarray(toks),
                                     jnp.asarray(t), jnp.asarray(mask))
    caches = FusedDecoder.ring_caches(torch.from_numpy(ring.copy()))
    with torch.no_grad():
        xt = tdec.spec_hidden(tdec._stacked(), caches,
                              torch.from_numpy(toks).long(),
                              torch.from_numpy(t).long(),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(xt.numpy(), np.asarray(x),
                               **TOLERANCES["logits_fp32"])
    ids = rng.integers(0, V, (2, 19)).astype(np.int32)
    x, kv = jax.jit(core.bulk_hidden)(dec._stacked(), e_arrays,
                                      jnp.asarray(ids))
    with torch.no_grad():
        xt, kvt = tdec.bulk_hidden(tdec._stacked(),
                                   torch.from_numpy(ids).long())
    np.testing.assert_allclose(xt.numpy(), np.asarray(x),
                               **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(kvt.numpy(), np.asarray(kv),
                               **TOLERANCES["logits_fp32"])


def test_int8_head_logits_match_jax(models, monkeypatch):
    """head_quant="int8": the quantized head bit-equal to JAX's
    _maybe_quant_head, its logits within logits_fp32."""
    jmods, tmods = models
    monkeypatch.setenv("PADDLE_TPU_DECODE_INT8_HEAD", "1")
    dec, core, _, h_arrays = _jax_core(jmods)
    jq = dec._maybe_quant_head(h_arrays)
    tdec = FusedDecoder(*tmods, SMAX, head_quant="int8", device="cpu")
    q, s, bias = tdec._head_int8()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq[0]))
    np.testing.assert_allclose(s.numpy(), np.asarray(jq[1]),
                               **TOLERANCES["kv_int8_scales"])
    assert bias is None
    x = np.random.default_rng(14).standard_normal((3, 1, E)).astype(
        np.float32)
    with torch.no_grad():
        got = tdec.head_logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(core.head_logits(jq, x)),
                               **TOLERANCES["logits_fp32"])


@pytest.mark.parametrize("kw,err", [
    ({"num_beams": 2, "do_sample": True}, ValueError),
    ({"num_beams": 2, "min_length": 2}, NotImplementedError),
    ({"num_beams": 2, "repetition_penalty": 1.2}, NotImplementedError),
    ({"num_beams": 2, "spec_k": 2}, ValueError)],
    ids=["beams-sample", "beams-min_length", "beams-penalty", "beams-spec"])
def test_option_combinations_refused_as_jax(models, prompts, kw, err):
    jmods, tmods = models
    with pytest.raises(err):
        _jax_generate(jmods, prompts, 4, **dict(kw))
    with pytest.raises(err):
        _port_generate(tmods, prompts, 4, **kw)


def test_decoder_options_validated(models):
    _, tmods = models
    with pytest.raises(NotImplementedError, match="rotary"):
        FusedDecoder(*tmods, SMAX, True, 500000.0, device="cpu")
    with pytest.raises(ValueError, match="head_quant"):
        FusedDecoder(*tmods, SMAX, head_quant="int4", device="cpu")
