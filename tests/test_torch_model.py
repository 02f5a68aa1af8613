"""The port's model pieces against the JAX package's, on the CPU.

The weight bridge must be exact (every parameter bit-equal), the stacked
layout bit-equal to the JAX ``FusedDecoder._stacked()`` (qkv fused
head-major), and one decode step (``hidden``), one token-budget block
(``spec_hidden``) and one flat budget stream (``flat_hidden``) must give
the JAX logits within atol = rtol = 1e-4 (TOLERANCES["logits_fp32"]) and
write the same K/V into the pool; the bulk prefill (``bulk_hidden``) must
give the JAX hidden states and K/V stack within the same tolerance.
Bench toy dims: E=64, H=4, FF=128, L=2, V=256, fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference import FusedDecoder as TorchDecoder
from paddle_tpu_torch.weights import from_jax_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
SMAX, BT = 128, 64


def _jax_models(seed=0):
    """The bench toy model (bench_serving._build_model's dims) with every
    parameter redrawn from numpy: LN scales near 1, nonzero biases,
    matrices scaled by 1/sqrt(fan_in)."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    embed = Embedding(V, E)
    fmt = FusedMultiTransformer(E, H, FF, num_layers=L,
                                normalize_before=True)
    head = Linear(E, V, bias_attr=False)
    rng = np.random.default_rng(seed)
    for lay in (fmt, embed, head):
        sd = {}
        for k, v in lay.state_dict().items():
            shape = tuple(v.shape)
            z = rng.standard_normal(shape)
            if "scales" in k:
                a = 1 + 0.1 * z
            elif "biases" in k:
                a = 0.1 * z
            elif lay is embed:
                a = z
            else:
                a = z / np.sqrt(shape[-2])
            sd[k] = a.astype(np.float32)
        lay.set_state_dict(sd)
    fmt.eval()
    return fmt, embed, head


def _numpy_state(*layers):
    return [{k: np.asarray(v._data) for k, v in lay.state_dict().items()}
            for lay in layers]


@pytest.fixture(scope="module")
def models():
    jmods = _jax_models()
    tmods = from_jax_state(*_numpy_state(*jmods), device="cpu")
    return jmods, tmods


def test_bridge_is_exact(models):
    jmods, tmods = models
    for jl, tl in zip(jmods, tmods):
        want = _numpy_state(jl)[0]
        got = dict(tl.named_parameters())
        assert set(got) == set(want)
        for k, arr in want.items():
            t = got[k]
            assert t.dtype == torch.float32 and not t.requires_grad
            assert np.array_equal(t.numpy(), arr), k


def test_bridge_carries_bf16_bits():
    jmods = _jax_models(seed=3)
    for lay in jmods:
        lay.bfloat16()
    states = _numpy_state(*jmods)
    tmods = from_jax_state(*states, device="cpu")
    for st, tl in zip(states, tmods):
        for k, p in tl.named_parameters():
            assert p.dtype == torch.bfloat16
            assert np.array_equal(p.view(torch.int16).numpy(),
                                  st[k].view(np.int16)), k


def test_stacked_matches_jax_bit_for_bit(models):
    from paddle_tpu.inference.generation import FusedDecoder
    jmods, tmods = models
    want = FusedDecoder(*jmods, SMAX)._stacked()
    got = TorchDecoder(*tmods, SMAX, device="cpu")._stacked()
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["qkv_w"].shape == (L, H * 3 * (E // H), E)


def _pool_and_tables(seed):
    """A random pool [L, 2, NB, H, Bt, D]; slot 0 maps two blocks, slot 1
    one block, slot 2 nothing (a freed slot: its writes must drop)."""
    rng = np.random.default_rng(seed)
    nb = 6
    pool = rng.standard_normal((L, 2, nb, H, BT, E // H)).astype(np.float32)
    tables = np.full((3, SMAX // BT), nb, np.int32)
    tables[0] = [4, 1]
    tables[1, 0] = 3
    return pool, tables


def _jax_core(jmods):
    from paddle_tpu.inference.generation import FusedDecoder
    dec = FusedDecoder(*jmods, SMAX)
    core = dec._build_step_core(False, 0, 1.0, 1.0)
    e_arrays = [p._data for p in dec._embed_params]
    h_arrays = [p._data for p in dec._head_params]
    return dec, core, e_arrays, h_arrays


def _torch_caches(pool, tables):
    return {"kv": torch.from_numpy(pool.copy()),
            "tbl": torch.from_numpy(tables)}


def test_hidden_step_matches_jax(models):
    jmods, tmods = models
    pool, tables = _pool_and_tables(1)
    tok = np.array([5, 77, 200], np.int32)
    t = np.array([70, 9, 0], np.int32)
    dec, core, e_arrays, h_arrays = _jax_core(jmods)
    x, jc = jax.jit(core.hidden)(dec._stacked(), e_arrays,
                                 {"kv": jnp.asarray(pool),
                                  "tbl": jnp.asarray(tables)},
                                 jnp.asarray(tok), jnp.asarray(t))
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = TorchDecoder(*tmods, SMAX, device="cpu")
    caches = _torch_caches(pool, tables)
    with torch.no_grad():
        xt = tdec.hidden(tdec._stacked(), caches,
                         torch.from_numpy(tok).long(),
                         torch.from_numpy(t).long())
        got = tdec.head_logits(xt).numpy()
    assert got.shape == want.shape == (3, 1, V)
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(caches["kv"].numpy(), np.asarray(jc["kv"]),
                               **TOLERANCES["logits_fp32"])
    # slot 2's write resolved to the sentinel and dropped: the pool's
    # last block (the read clamp's target) is untouched
    assert np.array_equal(caches["kv"].numpy()[:, :, -1], pool[:, :, -1])


def test_budget_block_matches_jax(models):
    jmods, tmods = models
    pool, tables = _pool_and_tables(2)
    rng = np.random.default_rng(5)
    c = 16
    toks = rng.integers(0, V, (3, c)).astype(np.int32)
    lens = np.array([60, 3, 0], np.int32)
    seg = np.array([16, 1, 0], np.int32)
    offs = np.arange(c)[None, :]
    valid = (offs < seg[:, None]) & (lens[:, None] + offs < SMAX)
    dec, core, e_arrays, h_arrays = _jax_core(jmods)
    x, jc = jax.jit(core.spec_hidden)(
        dec._stacked(), e_arrays,
        {"kv": jnp.asarray(pool), "tbl": jnp.asarray(tables)},
        jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(valid))
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = TorchDecoder(*tmods, SMAX, device="cpu")
    caches = _torch_caches(pool, tables)
    with torch.no_grad():
        xt = tdec.spec_hidden(tdec._stacked(), caches,
                              torch.from_numpy(toks).long(),
                              torch.from_numpy(lens).long(),
                              torch.from_numpy(valid))
        got = tdec.head_logits(xt).numpy()
    assert got.shape == want.shape == (3, c, V)
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(caches["kv"].numpy(), np.asarray(jc["kv"]),
                               **TOLERANCES["logits_fp32"])


def test_budget_core_tokens_match_jax(models):
    """The whole budget dispatch: block sample + 3 trailing decode steps,
    with a prefill row finishing its prompt, a decode row near max_nt,
    an eos hit and a min_length that suppresses it."""
    jmods, tmods = models
    pool, tables = _pool_and_tables(3)
    c, tail = 16, 3
    rng = np.random.default_rng(9)
    toks = rng.integers(0, V, (3, c)).astype(np.int32)
    lens = np.array([50, 3, 0], np.int32)
    seg = np.array([10, 1, 0], np.int32)
    gen0 = np.array([9, 0, c], np.int32)
    nt = np.array([0, 4, 0], np.int32)
    max_nt = np.array([8, 6, 1], np.int32)
    eos = np.array([-1, 7, -1], np.int32)
    min_len = np.array([0, 5, 0], np.int32)
    dec, _, e_arrays, h_arrays = _jax_core(jmods)
    budget = jax.jit(dec._build_budget_core(c, scan_tail=tail))
    jres = budget(dec._stacked(), e_arrays, h_arrays,
                  {"kv": jnp.asarray(pool), "tbl": jnp.asarray(tables)},
                  *map(jnp.asarray, (toks, lens, seg, gen0, nt, max_nt,
                                     eos, min_len)),
                  jnp.ones(3, jnp.float32), jnp.zeros((3, 1), bool),
                  jnp.zeros(3, jnp.int32))
    _, tok0, emit0, (ys_t, ys_e), tok, lens2, active, nt2, _ = jres
    tdec = TorchDecoder(*tmods, SMAX, device="cpu")
    with torch.no_grad():
        got = tdec._build_budget_core(c, scan_tail=tail)(
            tdec._stacked(), _torch_caches(pool, tables),
            *(torch.from_numpy(a).long() for a in (
                toks, lens, seg, gen0, nt, max_nt, eos, min_len)))
    want = (tok0, emit0, ys_t, ys_e, tok, lens2, active, nt2)
    flat = got[:2] + got[2] + got[3:]
    for g, w in zip(flat, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_flat_hidden_matches_jax(models):
    """One flat stream over the 3-slot pool: slot 0 decodes at 70 in the
    decode region, slot 1 prefills a 13-token segment from position 3
    (two chunks, the second partial), slot 2 is idle (sentinel), and the
    segment region ends in a pad chunk."""
    jmods, tmods = models
    pool, tables = _pool_and_tables(4)
    b, fc = 3, 8
    rng = np.random.default_rng(13)
    t = b + 3 * fc
    toks = rng.integers(0, V, t).astype(np.int32)
    tslot = np.full(t, b, np.int32)
    tpos = np.zeros(t, np.int32)
    tslot[0], tpos[0] = 0, 70
    tslot[b:b + 13] = 1
    tpos[b:b + 13] = 3 + np.arange(13)
    cslot = np.array([1, 1, 0], np.int32)
    cbase = np.array([3, 11, 0], np.int32)
    cn = np.array([8, 5, 0], np.int32)
    dec, core, e_arrays, h_arrays = _jax_core(jmods)
    x, jc = jax.jit(core.flat_hidden, static_argnums=(7,))(
        dec._stacked(), e_arrays,
        {"kv": jnp.asarray(pool), "tbl": jnp.asarray(tables)},
        *map(jnp.asarray, (toks, tslot, tpos)),
        tuple(map(jnp.asarray, (cslot, cbase, cn))), b)
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = TorchDecoder(*tmods, SMAX, device="cpu")
    caches = _torch_caches(pool, tables)
    with torch.no_grad():
        xt = tdec.flat_hidden(
            tdec._stacked(), caches,
            *(torch.from_numpy(a).long() for a in (toks, tslot, tpos)),
            tuple(map(torch.from_numpy, (cslot, cbase, cn))), b)
        got = tdec.head_logits(xt).numpy()
    assert got.shape == want.shape == (1, t, V)
    # the decode row and the segment tokens (pad tokens' outputs are
    # discarded by the engine)
    rows = [0] + list(range(b, b + 13))
    np.testing.assert_allclose(got[0, rows], want[0, rows],
                               **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(caches["kv"].numpy(), np.asarray(jc["kv"]),
                               **TOLERANCES["logits_fp32"])
    assert np.array_equal(caches["kv"].numpy()[:, :, -1], pool[:, :, -1])


def test_bulk_hidden_matches_jax(models):
    jmods, tmods = models
    rng = np.random.default_rng(21)
    toks = rng.integers(0, V, (2, 37)).astype(np.int32)
    dec, core, e_arrays, _ = _jax_core(jmods)
    x, kv_all = jax.jit(core.bulk_hidden)(dec._stacked(), e_arrays,
                                          jnp.asarray(toks))
    tdec = TorchDecoder(*tmods, SMAX, device="cpu")
    with torch.no_grad():
        xt, kvt = tdec.bulk_hidden(tdec._stacked(),
                                   torch.from_numpy(toks).long())
    assert xt.shape == x.shape == (2, 37, E)
    assert kvt.shape == kv_all.shape == (L, 2, 2, H, 37, E // H)
    np.testing.assert_allclose(xt.numpy(), np.asarray(x),
                               **TOLERANCES["logits_fp32"])
    np.testing.assert_allclose(kvt.numpy(), np.asarray(kv_all),
                               **TOLERANCES["logits_fp32"])
