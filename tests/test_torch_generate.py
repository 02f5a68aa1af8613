"""The port's one-shot generation over the dense KV ring against the JAX
package's, on the CPU.

``generate_fused`` / ``FusedDecoder.generate`` of the port must give the
JAX ``FusedDecoder.generate``'s greedy tokens exactly on the seeded toy
model (E=64, H=4, FF=128, L=2, V=256, fp32): a 70-token prompt (JAX
prefills it in chunks of 64 + 4 + 2), an eos hit mid-run with the trim at
the last row's first eos, min_length suppressing that eos, the int8 ring,
int8 and int4 weights, and the fused write+attend kernels
(``cache_write_kernel=True``; JAX: PADDLE_TPU_KERNEL_CACHE_WRITE=1). The
step cores over a ring (``hidden`` at one position or per-row positions,
``spec_hidden``'s budget block, ``flat_hidden``'s stream) must give the
JAX logits within TOLERANCES["logits_fp32"] and write the same ring.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference import FusedDecoder
from paddle_tpu_torch.inference.generation import generate_fused
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SMAX = 128


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
    state = random_state(np.random.default_rng(2), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(3).integers(0, V, (2, 70))


def _jax_generate(jmods, ids, max_new, **kw):
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    quant = {k: kw.pop(k) for k in ("weight_quant", "kv_quant") if k in kw}
    dec = JaxDecoder(*jmods, ids.shape[1] + max_new, **quant)
    return np.asarray(dec.generate(ids, max_new, **kw)._data)


@pytest.fixture(scope="module")
def fp_tokens(models, prompts):
    """The port's and JAX's greedy tokens without eos, fp."""
    jmods, tmods = models
    want = _jax_generate(jmods, prompts, 12)
    got = generate_fused(*tmods[:1], prompts, *tmods[1:],
                         max_new_tokens=12, device="cpu").numpy()
    return got, want


def test_generate_matches_jax(fp_tokens, prompts):
    got, want = fp_tokens
    assert got.shape == want.shape == (2, 70 + 12)
    assert np.array_equal(got[:, :70], prompts)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 70:].ravel())) > 4      # not a degenerate stream


def _shared_early_token(gen):
    """A token both rows emit within their first 10 generated tokens,
    first in row 0 at step >= 1: an eos that finishes every row before
    the 12th token."""
    for j in range(1, 10):
        if gen[0, j] in gen[1, :10]:
            return int(gen[0, j])
    raise AssertionError(f"no shared early token in {gen[:, :10]}")


@pytest.mark.parametrize("min_length", [0, 6], ids=["eos", "min_length"])
def test_eos_and_min_length_match_jax(models, prompts, fp_tokens,
                                      min_length):
    jmods, tmods = models
    eos = _shared_early_token(fp_tokens[0][:, 70:])
    want = _jax_generate(jmods, prompts, 12, eos_token_id=eos,
                         min_length=min_length)
    got = generate_fused(*tmods[:1], prompts, *tmods[1:],
                         max_new_tokens=12, eos_token_id=eos,
                         min_length=min_length, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    gen = got[:, 70:]
    if min_length == 0:
        # every row hit eos and the output ends at the last row's first
        # one: trimmed below the 12 new tokens, rows after eos hold eos
        assert gen.shape[1] < 12
        first = np.argmax(gen == eos, axis=1)
        assert (gen == eos).any(axis=1).all()
        assert gen.shape[1] == first.max() + 1
        assert all((gen[r, first[r]:] == eos).all() for r in range(2))
    else:
        assert not (gen[:, :min_length] == eos).any()


@pytest.mark.parametrize("flavor", [
    {"kv_quant": "int8"}, {"weight_quant": "int8"},
    {"weight_quant": "int4"}, {"cache_write_kernel": True},
    {"cache_write_kernel": True, "kv_quant": "int8"},
], ids=["kv8", "w8", "w4", "write_kernel", "write_kernel_kv8"])
def test_generate_flavors_match_jax(models, prompts, flavor, monkeypatch):
    """Each flavor against the JAX decoder of the same flavor (never
    against fp tokens: quantization changes logits)."""
    jmods, tmods = models
    kw = dict(flavor)
    if kw.pop("cache_write_kernel", False):
        monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_WRITE", "1")
    ids = prompts[:, :21]
    want = _jax_generate(jmods, ids, 10, **kw)
    got = generate_fused(*tmods[:1], ids, *tmods[1:], max_new_tokens=10,
                         device="cpu", **flavor).numpy()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------- step cores over a ring
def _jax_core(jmods, **quant):
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    dec = JaxDecoder(*jmods, SMAX, **quant)
    core = dec._build_step_core(False, 0, 1.0, 1.0)
    return (dec, core, [p._data for p in dec._embed_params],
            [p._data for p in dec._head_params])


def _ring(seed, int8):
    """A random ring of 3 rows (int8: values and positive scales)."""
    rng = np.random.default_rng(seed)
    shape = (L, 2, 3, H, SMAX, E // H)
    if int8:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(0.002, 0.05, shape[:4] + (1, SMAX)).astype(
                    np.float32))
    return (rng.standard_normal(shape).astype(np.float32),)


def _as_jax(ring):
    return tuple(map(jnp.asarray, ring)) if len(ring) == 2 \
        else jnp.asarray(ring[0])


def _as_torch(ring):
    return FusedDecoder.ring_caches(
        tuple(torch.from_numpy(a.copy()) for a in ring) if len(ring) == 2
        else torch.from_numpy(ring[0].copy()))


def _check_ring(caches, jc):
    jc = jc if isinstance(jc, tuple) else (jc,)
    np.testing.assert_allclose(caches["kv"].numpy().astype(np.float32),
                               np.asarray(jc[0]).astype(np.float32),
                               **TOLERANCES["logits_fp32"])
    if "sc" in caches:
        np.testing.assert_allclose(caches["sc"].numpy(), np.asarray(jc[1]),
                                   **TOLERANCES["kv_int8_scales"])


@pytest.mark.parametrize("t_kind", ["scalar", "per_row", "per_row_full"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "kv8"])
def test_hidden_step_over_a_ring_matches_jax(models, int8, t_kind):
    """One decode step's logits and ring; per_row_full puts a row at Smax,
    whose write drops."""
    jmods, tmods = models
    quant = {"kv_quant": "int8"} if int8 else {}
    ring = _ring(7 + int8, int8)
    tok = np.array([5, 77, 200], np.int32)
    t = {"scalar": 70, "per_row": np.array([70, 9, 0], np.int32),
         "per_row_full": np.array([127, 9, SMAX], np.int32)}[t_kind]
    dec, core, e_arrays, h_arrays = _jax_core(jmods, **quant)
    x, jc = jax.jit(core.hidden)(dec._stacked(), e_arrays, _as_jax(ring),
                                 jnp.asarray(tok), jnp.asarray(t))
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = FusedDecoder(*tmods, SMAX, device="cpu", **quant)
    caches = _as_torch(ring)
    with torch.no_grad():
        xt = tdec.hidden(tdec._stacked(), caches,
                         torch.from_numpy(tok).long(),
                         t if t_kind == "scalar" else torch.from_numpy(t))
        got = tdec.head_logits(xt).numpy()
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])
    _check_ring(caches, jc)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "kv8"])
def test_fused_write_step_matches_jax(models, int8, monkeypatch):
    """cache_write_kernel=True: the step through the fused write+attend
    kernels' plain versions against JAX's with
    PADDLE_TPU_KERNEL_CACHE_WRITE=1, a row at Smax included (its write
    drops); the rings of the fused and the write-then-read step equal
    JAX's."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_WRITE", "1")
    jmods, tmods = models
    quant = {"kv_quant": "int8"} if int8 else {}
    ring = _ring(11 + int8, int8)
    tok = np.array([5, 77, 200], np.int32)
    t = np.array([127, 9, SMAX], np.int32)
    dec, core, e_arrays, h_arrays = _jax_core(jmods, **quant)
    x, jc = jax.jit(core.hidden)(dec._stacked(), e_arrays, _as_jax(ring),
                                 jnp.asarray(tok), jnp.asarray(t))
    want = np.asarray(core.head_logits(h_arrays, x))
    got = {}
    for fused in (True, False):
        tdec = FusedDecoder(*tmods, SMAX, device="cpu",
                            cache_write_kernel=fused, **quant)
        caches = _as_torch(ring)
        with torch.no_grad():
            xt = tdec.hidden(tdec._stacked(), caches,
                             torch.from_numpy(tok).long(),
                             torch.from_numpy(t))
            got[fused] = tdec.head_logits(xt).numpy()
        _check_ring(caches, jc)
    np.testing.assert_allclose(got[True], want, **TOLERANCES["logits_fp32"])
    # below a full row the fused step is write-then-read (at Smax the
    # fused kernel still attends the dropped token; the read cannot)
    np.testing.assert_allclose(got[True][:2], got[False][:2],
                               **TOLERANCES["logits_fp32"])


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "kv8"])
def test_budget_block_over_a_ring_matches_jax(models, int8):
    jmods, tmods = models
    quant = {"kv_quant": "int8"} if int8 else {}
    ring = _ring(13 + int8, int8)
    rng = np.random.default_rng(5)
    c = 16
    toks = rng.integers(0, V, (3, c)).astype(np.int32)
    lens = np.array([60, 3, SMAX - 8], np.int32)
    seg = np.array([16, 1, 12], np.int32)
    offs = np.arange(c)[None, :]
    valid = (offs < seg[:, None]) & (lens[:, None] + offs < SMAX)
    dec, core, e_arrays, h_arrays = _jax_core(jmods, **quant)
    x, jc = jax.jit(core.spec_hidden)(
        dec._stacked(), e_arrays, _as_jax(ring), jnp.asarray(toks),
        jnp.asarray(lens), jnp.asarray(valid))
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = FusedDecoder(*tmods, SMAX, device="cpu", **quant)
    caches = _as_torch(ring)
    with torch.no_grad():
        xt = tdec.spec_hidden(tdec._stacked(), caches,
                              torch.from_numpy(toks).long(),
                              torch.from_numpy(lens).long(),
                              torch.from_numpy(valid))
        got = tdec.head_logits(xt).numpy()
    # positions past Smax were never written or attended: compare the
    # valid columns (row 2 holds 8 of its 12)
    np.testing.assert_allclose(got[valid], want[valid],
                               **TOLERANCES["logits_fp32"])
    _check_ring(caches, jc)


def test_flat_stream_over_a_ring_matches_jax(models):
    """The flat budget's stream over a ring: a 3-row decode region (row 2
    idle: the pad sentinel) and two aligned prefill segments, whose
    attention is the plain flat attention over the ring."""
    jmods, tmods = models
    ring = _ring(17, False)
    b, align = 3, 8
    dec_tok, dec_pos = [11, 12, 0], [40, 5, 0]
    segs = [(0, 41, 5), (1, 6, 11)]          # (slot, base, n)
    ts = 24
    toks = np.zeros(b + ts, np.int32)
    tslot = np.full(b + ts, b, np.int32)
    tpos = np.zeros(b + ts, np.int32)
    toks[:2], tslot[:2], tpos[:2] = dec_tok[:2], [0, 1], dec_pos[:2]
    cslot, cbase, cn = (np.zeros(ts // align, np.int32) for _ in range(3))
    rng = np.random.default_rng(19)
    st = 0
    for s, base, n in segs:
        sl = slice(b + st, b + st + n)
        toks[sl] = rng.integers(0, V, n)
        tslot[sl], tpos[sl] = s, base + np.arange(n)
        for ci in range(st // align, (st + n - 1) // align + 1):
            cslot[ci], cbase[ci] = s, base + ci * align - st
            cn[ci] = min(n - (ci * align - st), align)
        st = -(-(st + n) // align) * align
    dec, core, e_arrays, _ = _jax_core(jmods)
    x, jc = jax.jit(core.flat_hidden, static_argnums=(7,))(
        dec._stacked(), e_arrays, jnp.asarray(ring[0]),
        *map(jnp.asarray, (toks, tslot, tpos)),
        tuple(map(jnp.asarray, (cslot, cbase, cn))), b)
    tdec = FusedDecoder(*tmods, SMAX, device="cpu")
    caches = _as_torch(ring)
    with torch.no_grad():
        xt = tdec.flat_hidden(
            tdec._stacked(), caches,
            *(torch.from_numpy(a).long() for a in (toks, tslot, tpos)),
            tuple(map(torch.from_numpy, (cslot, cbase, cn))), b)
    real = tslot < b
    np.testing.assert_allclose(xt.numpy()[0, real], np.asarray(x)[0, real],
                               **TOLERANCES["logits_fp32"])
    _check_ring(caches, jc)


# --------------------------------------------------------------- surface
def test_init_cache_layouts(models):
    _, tmods = models
    ring = FusedDecoder(*tmods, 100, device="cpu").init_cache(3)
    assert ring.shape == (L, 2, 3, H, 128, E // H)
    assert ring.dtype == torch.float32 and not ring.any()
    kv, sc = FusedDecoder(*tmods, 100, device="cpu",
                          kv_quant="int8").init_cache(3)
    assert kv.dtype == torch.int8 and kv.shape == ring.shape
    assert sc.dtype == torch.float32 and sc.shape == (L, 2, 3, H, 1, 128)


def test_generate_validates(models, prompts):
    _, tmods = models
    with pytest.raises(ValueError, match="max_seq_len"):
        generate_fused(*tmods[:1], prompts, *tmods[1:], max_new_tokens=60,
                       max_seq_len=100, device="cpu")
    dec = FusedDecoder(*tmods, 128, device="cpu")
    out = dec.generate(torch.from_numpy(prompts[:1, :3]), max_new_tokens=1)
    assert out.dtype == torch.int64 and out.shape == (1, 4)
