"""The port's quantized kernels' plain versions against the JAX package's.

``decode_attention_paged_i8_reference``,
``decode_attention_paged_flat_i8_reference`` and
``fused_dequant_matmul_reference`` (what the wrappers compute on CPU
tensors) are held to ``paddle_tpu.ops.pallas.decode_attention.
decode_attention_paged_i8`` / ``decode_attention_paged_flat_i8`` and
``paddle_tpu.ops.pallas.fused_dequant_matmul.fused_dequant_matmul``
(Pallas in interpret mode off-TPU) on the same numpy inputs, fp32:
attention within TOLERANCES["attention_fp32"], the matmul within
TOLERANCES["matmul_fp32"]. The CUDA kernels themselves are compared with
the plain versions on the card (the ``cuda`` tests here, and
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged_flat_i8 as jax_flat_i8
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged_i8 as jax_paged_i8
from paddle_tpu.ops.pallas.fused_dequant_matmul import \
    fused_dequant_matmul as jax_fused_dequant_matmul
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.inference.generation import _absmax_int4, _pack_int4
from paddle_tpu_torch.inference.paged_kv import flat_gather_view
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import fused_dequant_matmul as fdm

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, BT, NBLK, L, LAYER = 4, 4, 16, 32, 4, 2, 1


def _pool_i8(rng, nb, hk, bt):
    """A random int8 pool [L, 2, NB, Hk, Bt, D] and positive fp32 scales
    [L, 2, NB, Hk, 1, Bt] (a few all-zero rows among them)."""
    pool = rng.integers(-127, 128, (L, 2, nb, hk, bt, D)).astype(np.int8)
    sc = rng.uniform(0.002, 0.05, (L, 2, nb, hk, 1, bt)).astype(np.float32)
    pool[:, :, 0, :, :3] = 0
    return pool, sc


def _paged_inputs(seed, sq, group):
    """Ragged lens (an empty row, a row ending on a block edge), each
    row's blocks in shuffled order, the sentinel NB past them and once
    inside a row's range (it reads block NB - 1)."""
    rng = np.random.default_rng(seed)
    hk = H // group
    lens = np.array([0, 2 * BT - sq, 23, 3 * BT + 5], np.int32)
    nb = B * NBLK + 1
    perm = rng.permutation(nb)
    tables = np.full((B, NBLK), nb, np.int32)
    k = 0
    for r in range(B):
        need = min((int(lens[r]) + sq - 1) // BT + 1, NBLK)
        tables[r, :need] = perm[k:k + need]
        k += need
    tables[2, 0] = nb
    qt = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    pool, sc = _pool_i8(rng, nb, hk, BT)
    return qt, pool, sc, tables, lens


@pytest.mark.parametrize("sq", [1, 16])
@pytest.mark.parametrize("group", [1, 2])
def test_paged_i8_reference_matches_jax(sq, group):
    qt, pool, sc, tables, lens = _paged_inputs(sq * 10 + group, sq, group)
    want = np.asarray(jax_paged_i8(*map(jnp.asarray, (qt, pool, sc, tables)),
                                   LAYER, jnp.asarray(lens)))
    args = (torch.from_numpy(qt), torch.from_numpy(pool),
            torch.from_numpy(sc), torch.from_numpy(tables), LAYER,
            torch.from_numpy(lens))
    got = da.decode_attention_paged_i8_reference(*args)
    assert got.shape == (B, H, sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    assert np.abs(got.numpy()[0]).sum() > 0
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = da.LAUNCHES["decode_attention_paged_i8"]
    assert torch.equal(da.decode_attention_paged_i8(*args), got)
    assert da.LAUNCHES["decode_attention_paged_i8"] == before


# (slot, base, n) per FLAT_CHUNK chunk: an aligned full chunk, a partial
# chunk, an unaligned base whose chunk straddles a block edge (at Bt 32
# and 64), a pad chunk, a chunk whose range holds an unmapped table entry,
# and a short chunk deep in another slot
FLAT_CHUNKS = [(0, 0, 8), (0, 8, 5), (1, 60, 8), (2, 0, 0), (2, 70, 3),
               (1, 130, 2)]
FLAT_NBLK_POS = 192


def _flat_inputs(seed, bt, group):
    rng = np.random.default_rng(seed)
    hk = H // group
    nslots, nblk = 3, FLAT_NBLK_POS // bt
    top = [0] * nslots
    for s, base, n in FLAT_CHUNKS:
        top[s] = max(top[s], base + max(n, 1))
    nb = nslots * nblk + 1
    perm = rng.permutation(nb)
    tables = np.full((nslots, nblk), nb, np.int32)
    k = 0
    for s in range(nslots):
        need = min(-(-top[s] // bt), nblk)
        tables[s, :need] = perm[k:k + need]
        k += need
    tables[2, 70 // bt] = nb          # read through the NB - 1 clamp
    q = rng.standard_normal((8 * len(FLAT_CHUNKS), H, D)).astype(np.float32)
    pool, sc = _pool_i8(rng, nb, hk, bt)
    cslot, cbase, cn = (np.array(col, np.int32) for col in zip(*FLAT_CHUNKS))
    return q, pool, sc, tables, cslot, cbase, cn


@pytest.mark.parametrize("bt", [32, 64])
@pytest.mark.parametrize("group", [1, 2])
def test_flat_i8_reference_matches_jax(bt, group):
    inputs = _flat_inputs(bt + group, bt, group)
    want = np.asarray(jax_flat_i8(*map(jnp.asarray, inputs), LAYER))
    args = (*map(torch.from_numpy, inputs), LAYER)
    got = da.decode_attention_paged_flat_i8_reference(*args)
    assert got.shape == inputs[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    # rows past each chunk's count, and the whole pad chunk, are exactly 0
    for ci, (_, _, n) in enumerate(FLAT_CHUNKS):
        rows = got.numpy()[8 * ci:8 * ci + 8]
        assert not rows[n:].any() and (n == 0 or rows[:n].any())
    before = da.LAUNCHES["decode_attention_paged_flat_i8"]
    assert torch.equal(da.decode_attention_paged_flat_i8(*args), got)
    assert da.LAUNCHES["decode_attention_paged_flat_i8"] == before


def test_flat_gather_view_dequantizes_as_jax():
    from paddle_tpu.inference.paged_kv import \
        flat_gather_view as jax_flat_gather_view
    _, pool, sc, tables, cslot, _, _ = _flat_inputs(3, 32, 2)
    smax = tables.shape[1] * 32
    want = np.asarray(jax_flat_gather_view(
        jnp.asarray(pool[LAYER]), jnp.asarray(tables), jnp.asarray(cslot),
        smax, jnp.asarray(sc[LAYER])))
    got = flat_gather_view(torch.from_numpy(pool[LAYER]),
                           torch.from_numpy(tables),
                           torch.from_numpy(cslot).long(), smax,
                           torch.from_numpy(sc[LAYER]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["pool_fp", "scales_shape", "scales_dtype",
                                 "layer", "flat_ragged_t"])
def test_i8_wrappers_reject_what_the_kernels_do_not_take(bad):
    qt, pool, sc, tables, lens = map(torch.from_numpy, _paged_inputs(0, 1, 1))
    args = [qt, pool, sc, tables, LAYER, lens]
    fn = da.decode_attention_paged_i8
    if bad == "pool_fp":
        args[1] = pool.float()
    elif bad == "scales_shape":
        args[2] = sc[..., :-1]
    elif bad == "scales_dtype":
        args[2] = sc.double()
    elif bad == "layer":
        args[4] = L
    else:
        q, pool, sc, tables, cslot, cbase, cn = map(
            torch.from_numpy, _flat_inputs(0, 32, 1))
        fn = da.decode_attention_paged_flat_i8
        args = [q[:-3], pool, sc, tables, cslot, cbase, cn, LAYER]
    with pytest.raises(ValueError):
        fn(*args)


def test_i8_is_supported_takes_every_engine_block_size():
    ok = da.paged_i8_is_supported
    assert ok((8, 16, 12, 64), (12, 2, 128, 12, 64, 64), torch.bfloat16)
    assert ok((8, 1, 12, 64), (12, 2, 128, 6, 16, 64), torch.float32)
    assert not ok((8, 129, 12, 64), (12, 2, 128, 12, 64, 64), torch.float32)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 5, 64, 64), torch.float32)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 12, 48, 64), torch.float32)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 12, 64, 64), torch.int8)
    okf = da.paged_flat_i8_is_supported
    assert okf(72, 12, 64, (12, 2, 128, 12, 16, 64), torch.bfloat16)
    assert not okf(12, 12, 64, (12, 2, 128, 12, 64, 64), torch.float32)


# ----------------------------------------------------- fused dequant-matmul
# the toy model's four (K, O): qkv (E -> 3E), lin (E -> E), f1 (E -> FF),
# f2 (FF -> E)
MM_SHAPES = {"qkv": (64, 192), "lin": (64, 64), "f1": (64, 128),
             "f2": (128, 64)}


def _packed(seed, k, o, transposed):
    """int4 weights quantized and packed as ``_stacked`` packs them:
    [K/2, O] contiguous (q4_right), or the transpose of a packed [O, K/2]
    (q4_left, what qkv_of hands the kernel); scales [1, O]."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32))
    if transposed:
        q, s = _absmax_int4(w.T.contiguous(), -1)
        return _pack_int4(q, -1).T, s.T
    q, s = _absmax_int4(w, 0)
    return _pack_int4(q, 0), s


@pytest.mark.parametrize("m", [1, 5, 8, 37])
@pytest.mark.parametrize("name", sorted(MM_SHAPES))
def test_fused_dequant_matmul_reference_matches_jax(m, name):
    k, o = MM_SHAPES[name]
    wp, s = _packed(m + k + o, k, o, transposed=name == "qkv")
    assert wp.is_contiguous() != (name == "qkv")
    a = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jax_fused_dequant_matmul(
        jnp.asarray(a), jnp.asarray(wp.numpy()), jnp.asarray(s.numpy())))
    got = fdm.fused_dequant_matmul_reference(torch.from_numpy(a), wp, s)
    assert got.shape == (m, o) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["matmul_fp32"])
    before = fdm.LAUNCHES["fused_dequant_matmul"]
    assert torch.equal(fdm.fused_dequant_matmul(torch.from_numpy(a), wp, s),
                       got)
    assert fdm.LAUNCHES["fused_dequant_matmul"] == before


def test_fused_dequant_matmul_takes_a_3d_activation():
    k, o = MM_SHAPES["f2"]
    wp, s = _packed(1, k, o, transposed=False)
    a = np.random.default_rng(2).standard_normal((2, 7, k)).astype(
        np.float32)
    want = np.asarray(jax_fused_dequant_matmul(
        jnp.asarray(a), jnp.asarray(wp.numpy()),
        jnp.asarray(s.numpy().reshape(-1))))
    got = fdm.fused_dequant_matmul(torch.from_numpy(a), wp, s.reshape(-1))
    assert got.shape == (2, 7, o)
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["matmul_fp32"])


@pytest.mark.parametrize("bad", ["w_dtype", "k_mismatch", "scales_len"])
def test_fused_dequant_matmul_rejects(bad):
    wp, s = _packed(0, 64, 32, transposed=False)
    a = torch.zeros(3, 64)
    if bad == "w_dtype":
        wp = wp.float()
    elif bad == "k_mismatch":
        a = torch.zeros(3, 62)
    else:
        s = s[:, :-1]
    with pytest.raises(ValueError):
        fdm.fused_dequant_matmul(a, wp, s)


def test_fused_dequant_matmul_is_supported():
    ok = fdm.fused_dequant_matmul_is_supported
    assert ok(8, 768, 2304) and ok(37, 6, 5) and ok(1, 2, 1)
    assert not ok(8, 767, 2304) and not ok(0, 768, 8)


# ------------------------------------------------------------- on the card
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_i8_kernels_match_reference_on_card(dtype):
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = getattr(torch, dtype)
    tol = TOLERANCES["attention_fp32" if dtype == "float32"
                     else "attention_bf16"]
    qt, pool, sc, tables, lens = _paged_inputs(7, 16, 2)
    args = (torch.from_numpy(qt).cuda().to(tdt),
            *(torch.from_numpy(x).cuda() for x in (pool, sc, tables)),
            LAYER, torch.from_numpy(lens).cuda())
    torch.testing.assert_close(
        da.decode_attention_paged_i8(*args).float(),
        da.decode_attention_paged_i8_reference(*args).float(), **tol)
    q, *rest = _flat_inputs(5, 32, 2)
    args = (torch.from_numpy(q).cuda().to(tdt),
            *(torch.from_numpy(x).cuda() for x in rest), LAYER)
    torch.testing.assert_close(
        da.decode_attention_paged_flat_i8(*args).float(),
        da.decode_attention_paged_flat_i8_reference(*args).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dequant_matmul_matches_reference_on_card(dtype):
    _on_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = getattr(torch, dtype)
    for name, (k, o) in MM_SHAPES.items():
        wp, s = _packed(3, k, o, transposed=name == "qkv")
        a = torch.randn(37, k).to(tdt).cuda()
        got = fdm.fused_dequant_matmul(a, wp.cuda(), s.cuda())
        want = fdm.fused_dequant_matmul_reference(a, wp.cuda(), s.cuda())
        torch.testing.assert_close(
            got.float(), want.float(),
            **TOLERANCES["matmul_fp32" if dtype == "float32"
                         else "matmul_bf16"])
