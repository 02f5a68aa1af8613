"""The port's paged decode attention against the JAX package's.

The plain PyTorch versions (what the port's wrappers compute on CPU
tensors) are held to ``paddle_tpu.ops.pallas.decode_attention.
decode_attention_paged`` and ``decode_attention_paged_flat`` (Pallas in
interpret mode off-TPU) on the same numpy inputs, fp32, atol = rtol =
1e-5 (TOLERANCES["attention_fp32"]). The CUDA kernels themselves are
compared with the plain versions on the card (the ``cuda`` tests here,
and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged as jax_decode_attention_paged
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged_flat as jax_decode_attention_paged_flat
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, BT, NBLK, L, LAYER = 4, 4, 16, 16, 4, 2, 1


def _inputs(seed, sq, group, dtype=np.float32):
    """Ragged lens (an empty row, a row ending exactly on a block edge),
    each row's blocks in shuffled order, the sentinel NB past them and
    once inside a row's range (it reads block NB - 1)."""
    rng = np.random.default_rng(seed)
    hk = H // group
    lens = np.array([0, BT - sq if sq <= BT else 2 * BT - sq, 23, 37],
                    np.int32)
    nb = B * NBLK + 1
    perm = rng.permutation(nb)
    tables = np.full((B, NBLK), nb, np.int32)
    k = 0
    for r in range(B):
        need = min((int(lens[r]) + sq - 1) // BT + 1, NBLK)
        tables[r, :need] = perm[k:k + need]
        k += need
    tables[2, 0] = nb
    qt = rng.standard_normal((B, H, sq, D)).astype(dtype)
    pool = rng.standard_normal((L, 2, nb, hk, BT, D)).astype(dtype)
    return qt, pool, tables, lens


@pytest.mark.parametrize("sq", [1, 5, 16])
@pytest.mark.parametrize("group", [1, 2])
def test_reference_matches_jax(sq, group):
    qt, pool, tables, lens = _inputs(sq * 10 + group, sq, group)
    want = np.asarray(jax_decode_attention_paged(
        jnp.asarray(qt), jnp.asarray(pool), jnp.asarray(tables), LAYER,
        jnp.asarray(lens)))
    args = (torch.from_numpy(qt), torch.from_numpy(pool),
            torch.from_numpy(tables), LAYER, torch.from_numpy(lens))
    got = da.decode_attention_paged_reference(*args)
    assert got.shape == (B, H, sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    # the empty row still attends its own new token: nothing is all-zero
    assert np.abs(got.numpy()[0]).sum() > 0
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = da.LAUNCHES["decode_attention_paged"]
    assert torch.equal(da.decode_attention_paged(*args), got)
    assert da.LAUNCHES["decode_attention_paged"] == before


@pytest.mark.parametrize("bad", ["tables_dtype", "lens_shape", "layer",
                                 "pool_dtype", "sq"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    qt, pool, tables, lens = _inputs(0, 1, 1)
    args = [torch.from_numpy(qt), torch.from_numpy(pool),
            torch.from_numpy(tables), LAYER, torch.from_numpy(lens)]
    if bad == "tables_dtype":
        args[2] = args[2].long()
    elif bad == "lens_shape":
        args[4] = args[4][:2]
    elif bad == "layer":
        args[3] = L
    elif bad == "pool_dtype":
        args[1] = args[1].double()
    else:
        args[0] = torch.zeros(B, H, 129, D)
    with pytest.raises(ValueError):
        da.decode_attention_paged(*args)


def test_paged_is_supported():
    ok = da.paged_is_supported
    assert ok((8, 16, 12, 64), (12, 2, 128, 12, 64, 64), torch.bfloat16,
              cache_dtype=torch.bfloat16)
    assert ok((8, 1, 12, 64), (12, 2, 128, 6, 16, 64), torch.float32)
    assert not ok((8, 129, 12, 64), (12, 2, 128, 12, 64, 64), torch.float32)
    assert not ok((8, 1, 12, 320), (12, 2, 128, 12, 64, 320), torch.float32)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 5, 64, 64), torch.float32)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 12, 48, 64), torch.float32)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 12, 64, 64), torch.float32,
                  cache_dtype=torch.bfloat16)
    assert not ok((8, 1, 12, 64), (12, 2, 128, 12, 64, 64), torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_reference_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    qt, pool, tables, lens = _inputs(7, 16, 2)
    args = (torch.from_numpy(qt).cuda().to(tdt),
            torch.from_numpy(pool).cuda().to(tdt),
            torch.from_numpy(tables).cuda(), LAYER,
            torch.from_numpy(lens).cuda())
    got = da.decode_attention_paged(*args)
    want = da.decode_attention_paged_reference(*args)
    tol = TOLERANCES["attention_fp32" if dtype == "float32"
                     else "attention_bf16"]
    torch.testing.assert_close(got.float(), want.float(), **tol)


# ---------------------------------------------------------------- flat
# (slot, base, n) per FLAT_CHUNK chunk: an aligned full chunk, a partial
# chunk, an unaligned base whose chunk straddles a block edge, a pad chunk
# (n = 0, slot already clamped by the caller), a chunk whose range holds
# an unmapped table entry, and a short chunk deep in another slot
FLAT_CHUNKS = [(0, 0, 8), (0, 8, 5), (1, 13, 8), (2, 0, 0), (2, 21, 3),
               (1, 40, 2)]
FLAT_NBLK = 6


def _flat_inputs(seed, bt, group):
    rng = np.random.default_rng(seed)
    hk = H // group
    nslots = 3
    top = [0] * nslots
    for s, base, n in FLAT_CHUNKS:
        top[s] = max(top[s], base + max(n, 1))
    nb = nslots * FLAT_NBLK + 1
    perm = rng.permutation(nb)
    tables = np.full((nslots, FLAT_NBLK), nb, np.int32)
    k = 0
    for s in range(nslots):
        need = min(-(-top[s] // bt), FLAT_NBLK)
        tables[s, :need] = perm[k:k + need]
        k += need
    tables[2, 21 // bt] = nb          # read through the NB - 1 clamp
    t = 8 * len(FLAT_CHUNKS)
    q = rng.standard_normal((t, H, D)).astype(np.float32)
    pool = rng.standard_normal((L, 2, nb, hk, bt, D)).astype(np.float32)
    cslot, cbase, cn = (np.array(col, np.int32)
                        for col in zip(*FLAT_CHUNKS))
    return q, pool, tables, cslot, cbase, cn


@pytest.mark.parametrize("bt", [8, 16])
@pytest.mark.parametrize("group", [1, 2])
def test_flat_reference_matches_jax(bt, group):
    q, pool, tables, cslot, cbase, cn = _flat_inputs(bt + group, bt, group)
    want = np.asarray(jax_decode_attention_paged_flat(
        *map(jnp.asarray, (q, pool, tables, cslot, cbase, cn)), LAYER))
    args = (torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(tables), torch.from_numpy(cslot),
            torch.from_numpy(cbase), torch.from_numpy(cn), LAYER)
    got = da.decode_attention_paged_flat_reference(*args)
    assert got.shape == q.shape and got.dtype == torch.float32
    # the whole stream, pad rows included
    np.testing.assert_allclose(got.numpy(), want,
                               **TOLERANCES["attention_fp32"])
    # rows past each chunk's count, and the whole pad chunk, are exactly 0
    for ci, (_, _, n) in enumerate(FLAT_CHUNKS):
        rows = got.numpy()[8 * ci:8 * ci + 8]
        assert not rows[n:].any() and (n == 0 or rows[:n].any())
    before = da.LAUNCHES["decode_attention_paged_flat"]
    assert torch.equal(da.decode_attention_paged_flat(*args), got)
    assert da.LAUNCHES["decode_attention_paged_flat"] == before


@pytest.mark.parametrize("bad", ["ragged_t", "meta_dtype", "meta_shape",
                                 "layer", "pool_dtype"])
def test_flat_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, pool, tables, cslot, cbase, cn = _flat_inputs(0, 8, 1)
    args = [torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(tables), torch.from_numpy(cslot),
            torch.from_numpy(cbase), torch.from_numpy(cn), LAYER]
    if bad == "ragged_t":
        args[0] = args[0][:-3]
    elif bad == "meta_dtype":
        args[4] = args[4].long()
    elif bad == "meta_shape":
        args[5] = args[5][:-1]
    elif bad == "layer":
        args[6] = L
    else:
        args[1] = args[1].double()
    with pytest.raises(ValueError):
        da.decode_attention_paged_flat(*args)


def test_paged_flat_is_supported():
    ok = da.paged_flat_is_supported
    pool = (12, 2, 128, 12, 64, 64)
    assert ok(72, 12, 64, pool, torch.bfloat16, cache_dtype=torch.bfloat16)
    assert ok(8, 12, 64, (12, 2, 128, 6, 16, 64), torch.float32)
    assert not ok(4, 12, 64, pool, torch.float32)
    assert not ok(12, 12, 64, pool, torch.float32)
    assert not ok(8, 12, 64, (12, 2, 128, 12, 48, 64), torch.float32)
    assert not ok(8, 12, 64, pool, torch.float32,
                  cache_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_kernel_matches_reference_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    q, pool, tables, cslot, cbase, cn = _flat_inputs(5, 16, 2)
    args = (torch.from_numpy(q).cuda().to(tdt),
            torch.from_numpy(pool).cuda().to(tdt),
            *(torch.from_numpy(a).cuda() for a in (tables, cslot, cbase, cn)),
            LAYER)
    got = da.decode_attention_paged_flat(*args)
    want = da.decode_attention_paged_flat_reference(*args)
    tol = TOLERANCES["attention_fp32" if dtype == "float32"
                     else "attention_bf16"]
    torch.testing.assert_close(got.float(), want.float(), **tol)
