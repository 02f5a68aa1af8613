"""The port's quantized model pieces against the JAX package's, on the CPU.

The absmax recipes (``_absmax_int8``, ``_absmax_int4``, ``_pack_int4``)
and the int8 and int4 ``_stacked()`` dicts must be bit-equal to JAX's.
One decode step (``hidden``) and one token-budget block
(``spec_hidden``) over an int8 pool must give the JAX logits within
TOLERANCES["logits_fp32"]; the pool they write is compared dequantized:
scales within TOLERANCES["kv_int8_scales"] and each value within one
quantization step, since a K/V value computed by XLA and by torch in
fp32 may straddle a rounding edge and take the neighbouring int8 code.
The byte counts of the int8 pool and of the quantized stacks are exact
and hold the JAX engine's gates. Bench toy dims: E=64, H=4, FF=128, L=2,
V=256, fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference import FusedDecoder as TorchDecoder
from paddle_tpu_torch.inference import generation as tg
from paddle_tpu_torch.inference.paged_kv import BlockPool
from paddle_tpu_torch.weights import from_jax_state, random_state

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

E, H, FF, L, V = 64, 4, 128, 2, 256
D = E // H
SMAX, BT = 128, 64


def _models():
    """The toy model's JAX layers and the port's, from one numpy state."""
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import FusedMultiTransformer
    from paddle_tpu.nn.layer.common import Embedding, Linear
    paddle.seed(0)
    jmods = (FusedMultiTransformer(E, H, FF, num_layers=L,
                                   normalize_before=True),
             Embedding(V, E), Linear(E, V, bias_attr=False))
    state = random_state(np.random.default_rng(0), E, H, FF, L, V)
    for lay, sd in zip(jmods, state):
        lay.set_state_dict(sd)
    jmods[0].eval()
    return jmods, from_jax_state(*state, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def _recipe_input():
    """[3, 40, 24] fp32 with an all-zero slice along each axis tested and
    values exactly on .5 steps of the int8 grid."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    w[0, 5] = 0
    w[1, :, 3] = 0
    w[2, 0] = np.arange(24) - 11.5       # along the last axis: int8
    w[2, 0, 0] = 127.0                   # scale 1, the others on .5
    w[2, :, 1] = 0                       # along axis 1: int4 scale 1
    w[2, :14, 1] = np.arange(14) - 6.5
    w[2, 14, 1] = 7.0
    return w


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("recipe", ["_absmax_int8", "_absmax_int4"])
def test_absmax_recipes_are_bit_exact(recipe, axis):
    from paddle_tpu.inference import generation as jg
    w = _recipe_input()
    qj, sj = getattr(jg, recipe)(jnp.asarray(w), axis)
    qt, st = getattr(tg, recipe)(torch.from_numpy(w), axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("axis", [0, 1])
def test_pack_int4_is_bit_exact_on_every_nibble_pair(axis):
    from paddle_tpu.inference import generation as jg
    from paddle_tpu_torch.ops.fused_dequant_matmul import unpack_int4
    pairs = np.array([[a, b] for a in range(-7, 8) for b in range(-7, 8)],
                     np.int8)                          # [225, 2]
    q = np.ascontiguousarray(pairs.T if axis == 0 else pairs)
    want = np.asarray(jg._pack_int4(jnp.asarray(q), axis))
    got = tg._pack_int4(torch.from_numpy(q), axis)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's unpack inverts it
    packed = got if axis == 0 else got.T
    np.testing.assert_array_equal(unpack_int4(packed).numpy(),
                                  q if axis == 0 else q.T)
    with pytest.raises(ValueError, match="odd"):
        tg._pack_int4(torch.zeros(3, 4, dtype=torch.int8), 0)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_stacked_matches_jax_bit_for_bit(models, mode):
    from paddle_tpu.inference.generation import FusedDecoder
    jmods, tmods = models
    want = FusedDecoder(*jmods, SMAX, weight_quant=mode)._stacked()
    tdec = TorchDecoder(*tmods, SMAX, weight_quant=mode, device="cpu")
    got = tdec._stacked()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"int8": torch.int8, "float32": torch.float32}[
            str(np.asarray(want[k]).dtype)], k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert tdec._stacked() is got            # cached
    assert tdec._weight_quant_mode() == mode


def _int8_pool(seed):
    """A random int8 pool [L, 2, NB, H, Bt, D] with its scales; slot 0
    maps two blocks, slot 1 one, slot 2 nothing (its writes drop)."""
    rng = np.random.default_rng(seed)
    nb = 6
    kv = rng.integers(-127, 128, (L, 2, nb, H, BT, D)).astype(np.int8)
    sc = rng.uniform(0.005, 0.03, (L, 2, nb, H, 1, BT)).astype(np.float32)
    tables = np.full((3, SMAX // BT), nb, np.int32)
    tables[0] = [4, 1]
    tables[1, 0] = 3
    return kv, sc, tables


def _jax_core(jmods, weight_quant):
    from paddle_tpu.inference.generation import FusedDecoder
    dec = FusedDecoder(*jmods, SMAX, weight_quant=weight_quant,
                       kv_quant="int8")
    core = dec._build_step_core(False, 0, 1.0, 1.0)
    return (dec, core, [p._data for p in dec._embed_params],
            [p._data for p in dec._head_params])


def _check_pool(caches, jc, kv0, sc0):
    """The written pool against JAX's: scales within kv_int8_scales, each
    dequantized value within one quantization step, and what was not
    written (the sentinel's clamp target, the last block) untouched."""
    got_kv, got_sc = caches["kv"].numpy(), caches["sc"].numpy()
    want_kv, want_sc = np.asarray(jc["kv"]), np.asarray(jc["sc"])
    np.testing.assert_allclose(got_sc, want_sc,
                               **TOLERANCES["kv_int8_scales"])
    step = np.maximum(got_sc, want_sc).swapaxes(-1, -2)     # per position
    diff = np.abs(got_kv * got_sc.swapaxes(-1, -2)
                  - want_kv * want_sc.swapaxes(-1, -2))
    assert (diff <= step * (1 + 1e-5) + 1e-7).all()
    assert (got_kv == want_kv).mean() > 0.99
    assert not np.array_equal(got_kv, kv0)                   # rows landed
    assert np.array_equal(got_kv[:, :, -1], kv0[:, :, -1])
    assert np.array_equal(got_sc[:, :, -1], sc0[:, :, -1])


@pytest.mark.parametrize("weight_quant", [None, "int4"])
def test_hidden_step_int8_pool_matches_jax(models, weight_quant):
    jmods, tmods = models
    kv, sc, tables = _int8_pool(1)
    tok = np.array([5, 77, 200], np.int32)
    t = np.array([70, 9, 0], np.int32)
    dec, core, e_arrays, h_arrays = _jax_core(jmods, weight_quant)
    x, jc = jax.jit(core.hidden)(
        dec._stacked(), e_arrays,
        {"kv": jnp.asarray(kv), "sc": jnp.asarray(sc),
         "tbl": jnp.asarray(tables)}, jnp.asarray(tok), jnp.asarray(t))
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = TorchDecoder(*tmods, SMAX, weight_quant=weight_quant,
                        kv_quant="int8", device="cpu")
    caches = {"kv": torch.from_numpy(kv.copy()),
              "sc": torch.from_numpy(sc.copy()),
              "tbl": torch.from_numpy(tables)}
    with torch.no_grad():
        xt = tdec.hidden(tdec._stacked(), caches,
                         torch.from_numpy(tok).long(),
                         torch.from_numpy(t).long())
        got = tdec.head_logits(xt).numpy()
    assert got.shape == want.shape == (3, 1, V)
    np.testing.assert_allclose(got, want, **TOLERANCES["logits_fp32"])
    _check_pool(caches, jc, kv, sc)


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_budget_block_int8_pool_matches_jax(models, weight_quant):
    jmods, tmods = models
    kv, sc, tables = _int8_pool(2)
    rng = np.random.default_rng(5)
    c = 16
    toks = rng.integers(0, V, (3, c)).astype(np.int32)
    lens = np.array([60, 3, 0], np.int32)
    seg = np.array([16, 1, 0], np.int32)
    offs = np.arange(c)[None, :]
    valid = (offs < seg[:, None]) & (lens[:, None] + offs < SMAX)
    dec, core, e_arrays, h_arrays = _jax_core(jmods, weight_quant)
    x, jc = jax.jit(core.spec_hidden)(
        dec._stacked(), e_arrays,
        {"kv": jnp.asarray(kv), "sc": jnp.asarray(sc),
         "tbl": jnp.asarray(tables)},
        jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(valid))
    want = np.asarray(core.head_logits(h_arrays, x))
    tdec = TorchDecoder(*tmods, SMAX, weight_quant=weight_quant,
                        kv_quant="int8", device="cpu")
    caches = {"kv": torch.from_numpy(kv.copy()),
              "sc": torch.from_numpy(sc.copy()),
              "tbl": torch.from_numpy(tables)}
    with torch.no_grad():
        xt = tdec.spec_hidden(tdec._stacked(), caches,
                              torch.from_numpy(toks).long(),
                              torch.from_numpy(lens).long(),
                              torch.from_numpy(valid))
        got = tdec.head_logits(xt).numpy()
    assert got.shape == want.shape == (3, c, V)
    # row 2 writes nothing and attends nothing valid; rows 0 and 1's
    # valid columns are what the engine reads
    for r, n in ((0, 16), (1, 1)):
        np.testing.assert_allclose(got[r, :n], want[r, :n],
                                   **TOLERANCES["logits_fp32"])
    _check_pool(caches, jc, kv, sc)


def test_quantized_bytes_are_exact_and_hold_the_gates(models):
    """The int8 pool plus scales, and the int8 and int4 stacks, have
    exactly the bytes their shapes give, and hold the JAX gates against
    the fp32 flavors: pool <= 1/2, int8 stack <= 1/2, int4 <= 1/4."""
    _, tmods = models
    pool = BlockPool(8, BT, SMAX)

    def dec(**kw):
        return TorchDecoder(*tmods, SMAX, device="cpu", **kw)
    fp_pool = dec().init_paged_cache(pool)
    i8_pool = dec(kv_quant="int8").init_paged_cache(pool)
    assert i8_pool["kv"].dtype == torch.int8
    assert tuple(i8_pool["sc"].shape) == (L, 2, 8, H, 1, BT)
    pos = L * 2 * 8 * H * BT
    assert fp_pool["kv"].nbytes == pos * D * 4
    i8_bytes = i8_pool["kv"].nbytes + i8_pool["sc"].nbytes
    assert i8_bytes == pos * (D + 4) <= fp_pool["kv"].nbytes / 2

    def nbytes(stk):
        return sum(a.numel() * a.element_size() for a in stk.values())
    fp = nbytes(dec()._stacked())
    fp_bias_ln = L * 4 * (3 * E + E + FF + E + 4 * E)   # biases + LN
    mats = L * (3 * E * E + E * E + E * FF + FF * E)     # matrix elements
    scales = L * 4 * (3 * E + E + FF + E)                # [L, 1, O] fp32
    assert fp == fp_bias_ln + 4 * mats
    b8 = nbytes(dec(weight_quant="int8")._stacked())
    b4 = nbytes(dec(weight_quant="int4")._stacked())
    assert b8 == fp_bias_ln + mats + scales
    assert b4 == fp_bias_ln + mats // 2 + scales
    assert b8 <= fp / 2 and b4 <= fp / 4
