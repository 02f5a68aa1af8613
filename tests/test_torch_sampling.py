"""The port's sampler against JAX's, on the CPU.

``paddle_tpu_torch.core.rng`` against ``jax._src.prng`` / ``jax.random``
(``jax_threefry_partitionable`` on, as jax 0.9.0 sets it): the
threefry2x32 words, ``PRNGKey``, ``fold_in`` and split word for word;
the random words and uniforms of fp32, bf16 and fp16 draws bit for bit,
one key over [V] or [B, V] and one key per row; gumbel noise within
TOLERANCES["gumbel"] ulps (a log is XLA's on one side, PyTorch's on the
other). ``inference.generation``'s ``_filter_logits`` masks against
JAX's compiled ``_filter_logits``, and ``_sample_rows`` /
``_sample_next`` tokens against JAX's on the same logits, over
several (top_k, top_p, temperature) in the three dtypes; the penalties;
and the global key stream (``seed`` / ``next_key`` / ``_host_seed``)
under JAX's default ``rbg`` keys and under ``threefry2x32``.

bf16 top-p follows XLA's excess precision: the softmax's denominator
sums the fp32 exponentials, never rounded to bf16 (ROADMAP Queue 3, J,
closed); its masks equal JAX's in every row at V 256 to 50304.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random
from jax._src import prng as jprng

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.inference import generation as tg

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
BITS = {"fp32": 32, "bf16": 8, "fp16": 16}     # the words each dtype draws
# (top_k, top_p, temperature)
FILTERS = [(50, 1.0, 0.8), (0, 0.95, 0.8), (40, 0.9, 0.7), (0, 0.5, 1.3),
           (7, 1.0, 1.0)]


def _jax(a, dt=None):
    return jnp.asarray(a) if dt is None else jnp.asarray(a).astype(dt)


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name in ("bfloat16", "float16") else a


def _words(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture
def jax_rng_state():
    """Restore the JAX package's global key after a test moves it."""
    from paddle_tpu.core import rng as jrng
    saved = (jrng.get_rng_state(), jrng.get_seed())
    yield
    jrng.set_rng_state(saved[0])
    jrng._rng.seed_value = saved[1]


def test_threefry_words_match_jax():
    r = np.random.default_rng(0)
    k = r.integers(0, 2 ** 32, (6, 2), dtype=np.uint64).astype(np.uint32)
    c = r.integers(0, 2 ** 32, (2, 333), dtype=np.uint64).astype(np.uint32)
    for k1, k2 in k:
        want = jprng.threefry2x32_p.bind(jnp.uint32(k1), jnp.uint32(k2),
                                         _jax(c[0]), _jax(c[1]))
        got = rng.threefry2x32(torch.tensor(int(k1)), torch.tensor(int(k2)),
                               _words(c[0]), _words(c[1]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 31 + 3, 2 ** 33 + 5,
                                  -1])
def test_key_fold_in_split_match_jax(seed):
    key = random.PRNGKey(seed)
    tkey = rng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key))
    for data in (0, 1, 12345, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(tkey, data).numpy(),
            np.asarray(random.key_data(random.fold_in(key, data))))
    for num in (2, 5):
        np.testing.assert_array_equal(rng.split(tkey, num).numpy(),
                                      np.asarray(random.split(key, num)))
    seeds = np.array([seed & 0x7FFFFFFF, 3, 9], np.int32)
    nts = np.array([0, 5, 77], np.int32)
    want = jax.vmap(lambda s, n: random.fold_in(random.PRNGKey(s), n))(
        _jax(seeds), _jax(nts))
    got = rng.fold_in(rng.prng_key(torch.from_numpy(seeds)),
                      torch.from_numpy(nts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ulps(got, want, dt):
    """|got - want| in units of the spacing of max(|want|, 1) in dtype
    ``dt``."""
    w = np.asarray(want, np.float32)
    sp = np.spacing(np.maximum(np.abs(w), 1).astype(dt)).astype(np.float32)
    return np.abs(np.asarray(got, np.float32) - w) / sp


@pytest.mark.parametrize("shape", [(256,), (5, 256)], ids=["V", "BV"])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_bits_uniform_gumbel_match_jax(dname, shape):
    jdt, tdt = DTYPES[dname]
    ndt = {"fp32": np.float32, "bf16": jnp.bfloat16,
           "fp16": np.float16}[dname]
    key, tkey = random.PRNGKey(123), rng.prng_key(123)
    width = BITS[dname]
    want = random.bits(key, shape, {8: jnp.uint8, 16: jnp.uint16,
                                    32: jnp.uint32}[width])
    np.testing.assert_array_equal(
        rng.random_bits(tkey, width, shape).numpy(), np.asarray(want))
    tiny = float(jnp.finfo(jdt).tiny)
    want = random.uniform(key, shape, jdt, minval=tiny, maxval=1.0)
    got = rng.uniform(tkey, shape, tdt, tiny, 1.0)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    want = random.gumbel(key, shape, jdt)
    got = rng.gumbel(tkey, shape, tdt)
    assert _ulps(got.float().numpy(), _np(want), ndt).max() <= \
        TOLERANCES["gumbel"]["ulps"]
    if len(shape) == 2:                     # one key per row (a vmap)
        seeds = np.arange(shape[0], dtype=np.int32) * 1000 + 5
        nts = np.arange(shape[0], dtype=np.int32)
        keys = rng.fold_in(rng.prng_key(torch.from_numpy(seeds)),
                           torch.from_numpy(nts))
        want = jax.vmap(lambda s, n: random.uniform(
            random.fold_in(random.PRNGKey(s), n), shape[1:], jdt,
            minval=tiny, maxval=1.0))(_jax(seeds), _jax(nts))
        got = rng.uniform(keys, shape, tdt, tiny, 1.0)
        np.testing.assert_array_equal(got.float().numpy(), _np(want))


def _logits(r, b, v, dt):
    return _jax((r.standard_normal((b, v)) * 3).astype(np.float32), dt)


def _torch(a, tdt):
    return torch.from_numpy(_np(a)).to(tdt)


@pytest.mark.parametrize("flt", FILTERS, ids=lambda f: "k%s-p%s-t%s" % f)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_filter_logits_match_jax(dname, flt):
    """The filtered logits JAX's compiled ``_filter_logits`` gives (its
    serving cores are compiled), value for value, in every dtype."""
    from paddle_tpu.inference import generation as jg
    jdt, tdt = DTYPES[dname]
    jf = jax.jit(jg._filter_logits, static_argnums=(1, 2, 3, 4))
    r = np.random.default_rng(5)
    for v in (256, 1000):
        lg = _logits(r, 48, v, jdt)
        want = _np(jf(lg, True, *flt))
        got = tg._filter_logits(_torch(lg, tdt), True, *flt)
        np.testing.assert_array_equal(got.float().numpy(), want)
    x = _torch(lg, tdt)
    assert tg._filter_logits(x, False, *flt) is x       # greedy: untouched


@pytest.mark.parametrize("v", [256, 1000, 5000, 50304])
def test_top_p_masks_match_jax_in_every_row(v):
    """Queue 3's fault J: bf16 top-p masks equal JAX's compiled ones in
    every row (XLA sums the softmax's fp32 exponentials unrounded), at
    top_p 0.95 and 0.9; fp32 and fp16 stay exact."""
    from paddle_tpu.inference import generation as jg
    jf = jax.jit(jg._filter_logits, static_argnums=(1, 2, 3, 4))
    r = np.random.default_rng(v)
    for dname, (jdt, tdt) in DTYPES.items():
        for top_p in (0.95, 0.9):
            neg = _np(_jax(tg.NEG_INF, jdt))
            lg = _logits(r, 24, v, jdt)
            want = _np(jf(lg, True, 0, top_p, 0.8)) == neg
            got = tg._filter_logits(_torch(lg, tdt), True, 0, top_p, 0.8)
            mask = got.float().numpy() == neg
            bad = np.flatnonzero((mask != want).any(-1))
            assert bad.size == 0, (dname, top_p, bad)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_sample_rows_and_next_match_jax(dname):
    from paddle_tpu.inference import generation as jg
    jdt, tdt = DTYPES[dname]
    r = np.random.default_rng(8)
    b, v = 8, 256
    seeds = r.integers(0, 2 ** 31, b).astype(np.int32)
    nt = r.integers(0, 100, b).astype(np.int32)
    for flt in FILTERS[1:4]:
        lg = _logits(r, b, v, jdt)
        rows = jax.jit(jg._sample_rows, static_argnums=(1, 2, 3, 4))(
            lg, True, *flt, _jax(seeds), _jax(nt))
        got = tg._sample_rows(_torch(lg, tdt), True, *flt,
                              torch.from_numpy(seeds), torch.from_numpy(nt))
        key = random.PRNGKey(int(seeds[0]))
        nxt = jax.jit(jg._sample_next, static_argnums=(1, 2, 3, 4))(
            lg, True, *flt, key)
        got_n = tg._sample_next(_torch(lg, tdt), True, *flt,
                                rng.prng_key(int(seeds[0])))
        np.testing.assert_array_equal(got.numpy(), np.asarray(rows))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(nxt))
    # greedy: the argmax, whatever the keys
    lg = _logits(r, b, v, jdt)
    np.testing.assert_array_equal(
        tg._sample_rows(_torch(lg, tdt), False, 5, 0.5, 2.0, None,
                        None).numpy(), np.asarray(jnp.argmax(lg, -1)))


@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_penalties_match_jax(dname):
    from paddle_tpu.inference import generation as jg
    from paddle_tpu.inference.serving import _penalize_slots as jslots
    jdt, tdt = DTYPES[dname]
    r = np.random.default_rng(9)
    b, v = 4, 64
    lg = _logits(r, b, v, jdt)
    ids = r.integers(0, v, (b, 12))
    pres = jg._presence_from(_jax(ids), v)
    tpres = tg._presence_from(torch.from_numpy(ids), v)
    np.testing.assert_array_equal(tpres.numpy(), np.asarray(pres))
    for nt, ml in ((0, 3), (3, 3)):
        want = jax.jit(jg._penalize, static_argnums=(2, 3, 4, 5))(
            lg, pres, 1.3, nt, ml, 7)
        got = tg._penalize(_torch(lg, tdt), tpres, 1.3, nt, ml, 7)
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    pen = np.array([1.0, 1.2, 0.8, 2.0], np.float32)
    nt = np.array([0, 2, 5, 1])
    ml = np.array([3, 1, 9, 0])
    eos = np.array([4, -1, 9, 2])
    want = jax.jit(jslots)(lg, pres, _jax(pen), _jax(nt), _jax(ml),
                           _jax(eos))
    got = tg._penalize_slots(_torch(lg, tdt), tpres, torch.from_numpy(pen),
                             *map(torch.from_numpy, (nt, ml, eos)))
    assert got.dtype == torch.float32         # promoted, as JAX's
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("impl", ["rbg", "threefry2x32"])
def test_key_stream_matches_jax(impl, monkeypatch, jax_rng_state):
    """The request seeds a sampling engine draws: ``_host_seed(next_key())``
    after ``seed(7)``, equal under JAX's default rbg keys (their halves
    split with threefry) and under threefry2x32, whose keys are equal
    word for word."""
    import paddle_tpu as paddle
    from paddle_tpu.core import rng as jrng
    from paddle_tpu.inference import generation as jg
    monkeypatch.setenv("PADDLE_TPU_PRNG_IMPL", impl)
    paddle.seed(7)
    rng.seed(7)
    assert rng.get_seed() == jrng.get_seed() == 7
    want, got = [], []
    for _ in range(6):
        jk, tk = jrng.next_key(), rng.next_key()
        want.append(jg._host_seed(jk))
        got.append(tg._host_seed(tk))
        if impl == "threefry2x32":
            np.testing.assert_array_equal(
                tk.numpy(), np.asarray(random.key_data(jk)))
    assert got == want
    if impl == "rbg":
        assert want[:3] == [1914721983, 296138210, 985358043]
