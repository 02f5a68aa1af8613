"""``generate`` and the step cores under the port's mp=2 CPU mesh against
the JAX package's, a slot's state across layouts, the model-parallel RNG
tracker, and the sharding-table check.

- ``generate_fused`` under ``fleet.init(mp_degree=2)`` gives JAX's mp=2
  tokens over the fp and the int8 ring (JAX's ``TestFusedDecodeTP``),
  its ring attention a kernel call per shard on H/mp heads; beams, spec
  and sampling under the mesh give the mp=1 tokens;
- one hidden step over a head-sharded ring gives JAX's mp=2 logits within
  TOLERANCES["logits_fp32"] and writes the same ring;
- a slot exported by an mp=2 engine imports into an mp=1 engine and into
  JAX's, and JAX's mp=2 export into the port's mp=2 engine, each
  finishing as the unmigrated run;
- ``core.rng``'s tracker against JAX's (under threefry keys, the words
  compare): the seeds it registers, the stream switching and restoring,
  and its errors;
- ``python -m paddle_tpu_torch.tools.check_sharding_spec`` exits 0.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference import FusedDecoder, ServingEngine
from paddle_tpu_torch.inference.generation import generate_fused
from paddle_tpu_torch.parallel import ShardedTensor, init_serving_mesh
from paddle_tpu_torch.weights import from_jax_state
from test_torch_mesh_serving import (BASE, CPU8, E, FF, H, L, V,  # noqa: F401
                                     _port_fleet, _reset_jax_fleet,
                                     _reset_port_fleet, _state)

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

SMAX = 128
HD = E // H


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
    for lay, sd in zip(jmods, _state(seed=7)):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*_state(seed=7), device="cpu")


def _jax_fleet_mp2():
    from paddle_tpu.distributed import fleet as jfleet
    _reset_jax_fleet()
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=strategy)


def _port_fleet_mp2():
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "kv8"])
def test_generate_fused_under_fleet_mp2(models, int8, monkeypatch):
    """JAX's mp=2 tokens over a head-sharded ring, the stacked kernel
    called per shard on H/2 heads (never on all H), and the mp=1 tokens."""
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    from paddle_tpu_torch.ops import decode_attention as da
    jmods, tmods = models
    ids = np.random.RandomState(9).randint(1, V, (2, 5)).astype(np.int32)
    quant = {"kv_quant": "int8"} if int8 else {}
    try:
        _jax_fleet_mp2()
        want = np.asarray(JaxDecoder(*jmods, SMAX, **quant).generate(
            ids, 6)._data)
    finally:
        _reset_jax_fleet()
    ref = generate_fused(tmods[0], ids, *tmods[1:], max_new_tokens=6,
                         max_seq_len=SMAX, device="cpu", **quant).numpy()
    name = "decode_attention_stacked_i8" if int8 \
        else "decode_attention_stacked"
    heads, real = [], getattr(da, name)

    def spy(qt, *a, **k):
        heads.append(qt.shape[1])
        return real(qt, *a, **k)
    monkeypatch.setattr(da, name, spy)
    _port_fleet_mp2()
    got = generate_fused(tmods[0], ids, *tmods[1:], max_new_tokens=6,
                         max_seq_len=SMAX, device="cpu", **quant).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert heads and set(heads) == {H // 2}


GEN_OPTIONS = {"beams": dict(num_beams=3), "spec": dict(spec_k=2),
               "sampled": dict(do_sample=True, top_k=6, temperature=0.8),
               "eos": dict(eos_token_id=7, min_length=3)}


@pytest.mark.parametrize("opt", sorted(GEN_OPTIONS))
def test_generate_options_under_mesh(models, opt):
    """Beams reorder every shard's ring rows, spec verifies over the
    sharded ring, sampling draws from the gathered logits: the mp=1
    tokens. The prefix cache is ignored under the mesh, as in JAX."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.inference.prefix_cache import PrefixCache
    _, tmods = models
    ids = np.random.RandomState(4).randint(1, V, (2, 17))
    outs = []
    for mp in (1, 2):
        _reset_port_fleet()
        if mp > 1:
            init_serving_mesh(2, devices=CPU8)
        dec = FusedDecoder(*tmods, SMAX, device="cpu")
        rng.seed(11)
        pc = PrefixCache(8, 8) if mp > 1 else None
        outs.append(dec.generate(ids, 10, prefix_cache=pc,
                                 **GEN_OPTIONS[opt]).numpy())
        if pc is not None:
            assert pc.store.stats()["blocks_used"] == 0
    np.testing.assert_array_equal(outs[1], outs[0])


def test_hidden_step_matches_jax_mp2(models):
    """One decode step (per-row positions, a row at Smax whose write
    drops) over a head-sharded ring: JAX's mp=2 logits, the ring written
    alike, each shard's part of it contiguous."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    jmods, tmods = models
    rng = np.random.default_rng(8)
    ring = rng.standard_normal((L, 2, 3, H, SMAX, HD)).astype(np.float32)
    tok = np.array([5, 77, 20], np.int32)
    t = np.array([70, 9, SMAX], np.int32)
    try:
        _jax_fleet_mp2()
        dec = JaxDecoder(*jmods, SMAX)
        core = dec._build_step_core(False, 0, 1.0, 1.0)
        h_arrays = dec._maybe_quant_head([p._data for p in dec._head_params])
        x, jc = jax.jit(core.hidden)(
            dec._stacked(), [p._data for p in dec._embed_params],
            jnp.asarray(ring), jnp.asarray(tok), jnp.asarray(t))
        want = np.asarray(core.head_logits(h_arrays, x))
        jring = np.asarray(jc)
    finally:
        _reset_jax_fleet()
    mesh = init_serving_mesh(2, devices=CPU8)
    tdec = FusedDecoder(*tmods, SMAX, device="cpu")
    kv = ShardedTensor.split(torch.from_numpy(ring), 3, mesh.devices)
    with torch.no_grad():
        xt = tdec.hidden(tdec._stacked(), {"kv": kv},
                         torch.from_numpy(tok).long(), torch.from_numpy(t))
        got = tdec.head_logits(xt).numpy()
    assert got.shape == (3, 1, V)
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(kv.gather().numpy(), jring,
                               **TOLERANCES["logits_fp32"])
    assert all(s.is_contiguous() and s.shape[3] == H // 2
               for s in kv.shards)


# ---------------------------------------------------- slot state across

X = np.random.RandomState(21).randint(1, V, (19,)).astype(np.int32)


def _mid_decode(eng, n=14, at=5):
    rid = eng.submit(X, max_new_tokens=n)
    while eng.poll(rid)["n_tokens"] < at:
        eng.step()
    return eng.export_slot(rid)


def _finish(eng, state):
    rid = eng.import_slot(state)
    eng.run()
    return eng.results[rid]["tokens"].tolist()


@pytest.fixture(scope="module")
def jax_states(models):
    """A JAX mp=2 engine's mid-decode export of X, and a JAX mp=1 engine
    to import into."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine
    from paddle_tpu.parallel import init_serving_mesh as jax_mesh
    jmods, _ = models
    try:
        _reset_jax_fleet()
        jax_mesh(2)
        paddle.seed(3)
        state = _mid_decode(JaxEngine(*jmods, **BASE))
    finally:
        _reset_jax_fleet()
    return state, JaxEngine(*jmods, **BASE)


def test_slot_state_crosses_layouts(models, jax_states, serving_metrics_ok):
    """The state format is full heads whatever the layout: mp=2 -> mp=1,
    mp=2 -> JAX mp=1 and JAX mp=2 -> mp=2 each finish as the unmigrated
    single-device run."""
    _, tmods = models
    want = ServingEngine(*tmods, device="cpu", **BASE)
    rid = want.submit(X, max_new_tokens=14)
    want.run()
    want = want.results[rid]["tokens"].tolist()
    jstate, jeng1 = jax_states
    init_serving_mesh(2, devices=CPU8)
    src = ServingEngine(*tmods, device="cpu", **BASE)
    state = _mid_decode(src)
    assert state["kv"][0]["kv"].shape[3] == H       # full heads
    dst2 = ServingEngine(*tmods, device="cpu", **BASE)
    assert _finish(dst2, jstate) == want
    serving_metrics_ok(dst2)
    _reset_port_fleet()
    assert _finish(ServingEngine(*tmods, device="cpu", **BASE),
                   state) == want
    assert _finish(jeng1, state) == want


# ------------------------------------------------------ the RNG tracker

def test_rng_tracker_matches_jax(monkeypatch):
    """Under threefry keys (JAX's default rbg keys do not reproduce) the
    tracker registers seed + 1024 (+ the model-parallel rank, 0 for the
    controller), switches the draws to its stream and back, and keeps
    where the stream got to, word for word with JAX's."""
    import jax
    from paddle_tpu.core import rng as jrng
    from paddle_tpu_torch.core import rng as trng
    monkeypatch.setenv("PADDLE_TPU_PRNG_IMPL", "threefry2x32")

    def words(k):
        return (np.asarray(jax.random.key_data(k)).astype(np.int64)
                if not torch.is_tensor(k) else k.numpy())
    _port_fleet_mp2()
    draws = []
    for r in (jrng, trng):
        r.model_parallel_random_seed(7)
        tr = r.get_rng_state_tracker()
        assert tr.seeds_ == {7 + 1024}
        assert set(tr.get_states_tracker()) == {r.MODEL_PARALLEL_RNG}
        seq = [words(r.get_rng_state())]
        with tr.rng_state():
            seq += [words(r.next_key()), words(r.next_key())]
        seq.append(words(r.next_key()))
        with tr.rng_state(r.MODEL_PARALLEL_RNG):
            seq.append(words(r.next_key()))
        r.set_rng_state(5)
        seq.append(words(r.get_rng_state()))
        draws.append(seq)
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(draws[1][1], draws[1][3])


@pytest.mark.parametrize("case", ["seed", "name", "missing"])
def test_rng_tracker_errors(case):
    """JAX's errors: a seed or a name registered twice, an unknown
    stream."""
    from paddle_tpu.core.rng import RNGStatesTracker as JaxTracker
    from paddle_tpu_torch.core.rng import RNGStatesTracker
    for cls in (JaxTracker, RNGStatesTracker):
        tr = cls()
        tr.add("a", 1)
        with pytest.raises(ValueError) as err:
            if case == "seed":
                tr.add("b", 1)
            elif case == "name":
                tr.add("a", 2)
            else:
                with tr.rng_state("b"):
                    pass
        msg = {"seed": "seed 1 already exists",
               "name": "state a already exists",
               "missing": "state b does not exist"}[case]
        assert str(err.value) == msg


def test_sharding_spec_tool(capsys):
    """``python -m paddle_tpu_torch.tools.check_sharding_spec``: every
    stacked key has a spec, the specs fit, mp=2 placement matches."""
    from paddle_tpu_torch.tools import check_sharding_spec
    rc = check_sharding_spec.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "check_sharding_spec: ok" in out
