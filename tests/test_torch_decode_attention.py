"""The port's paged decode attention against the JAX package's.

The plain PyTorch version (what the port's wrapper computes on CPU
tensors) is held to ``paddle_tpu.ops.pallas.decode_attention.
decode_attention_paged`` (Pallas in interpret mode off-TPU) on the same
numpy inputs, fp32, atol = rtol = 1e-5 (TOLERANCES["attention_fp32"]).
The CUDA kernel itself is compared with the plain version on the card
(the ``cuda`` test here, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention_paged as jax_decode_attention_paged
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

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
