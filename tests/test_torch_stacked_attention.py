"""The port's dense-ring (stacked) attentions against the JAX package's.

The plain versions of ``decode_attention_stacked``, ``_stacked_i8``,
``_stacked_write`` and ``_stacked_i8_write`` (what the wrappers compute on
CPU tensors) are held to the functions of the same names in
``paddle_tpu.ops.pallas.decode_attention`` (Pallas in interpret mode
off-TPU) on the same numpy inputs, fp32, within
TOLERANCES["attention_fp32"]: Sq 1/4/16, GQA groups 1 and 2, Smax 128
and 256 (the JAX kernel's two block sizes), lens at 0, mid-ring and at
the last position. After a write the ring must equal JAX's: fp rows and
int8 values exactly, int8 scales within TOLERANCES["kv_int8_scales"]; a
full row (lens == Smax) drops its write and still attends the new token.
The CUDA kernels are compared with the plain versions on the card (the
``cuda`` test here, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.ops import decode_attention as da

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

B, H, D, L, LAYER = 4, 4, 16, 2, 1


def _lens(smax, sq):
    # an empty row, a row whose last query lands on the ring's last
    # position, rows mid-ring (one crossing the 128 edge when Smax = 256)
    return np.array([0, smax - sq, 37, smax // 2 + 5], np.int32)


def _ring(rng, smax, hk, int8=False):
    shape = (L, 2, B, hk, smax, D)
    if not int8:
        return rng.standard_normal(shape).astype(np.float32), None
    ring = rng.integers(-127, 128, shape).astype(np.int8)
    sc = rng.uniform(0.002, 0.05, shape[:4] + (1, smax)).astype(np.float32)
    return ring, sc


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("smax", [128, 256])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("sq", [1, 4, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "i8"])
def test_stacked_reference_matches_jax(int8, sq, group, smax):
    rng = np.random.default_rng(sq * 100 + group * 10 + smax + int8)
    ring, sc = _ring(rng, smax, H // group, int8)
    qt = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    lens = _lens(smax, sq)
    if int8:
        want = jda.decode_attention_stacked_i8(
            *map(jnp.asarray, (qt, ring, sc)), LAYER, jnp.asarray(lens))
        args = (*_t(qt, ring, sc), LAYER, *_t(lens))
        ref, wrap = (da.decode_attention_stacked_i8_reference,
                     da.decode_attention_stacked_i8)
    else:
        want = jda.decode_attention_stacked(
            *map(jnp.asarray, (qt, ring)), LAYER, jnp.asarray(lens))
        args = (*_t(qt, ring), LAYER, *_t(lens))
        ref, wrap = (da.decode_attention_stacked_reference,
                     da.decode_attention_stacked)
    got = ref(*args)
    assert got.shape == (B, H, sq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOLERANCES["attention_fp32"])
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = dict(da.LAUNCHES)
    assert torch.equal(wrap(*args), got)
    assert da.LAUNCHES == before


@pytest.mark.parametrize("smax", [128, 256])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "i8"])
def test_stacked_write_reference_matches_jax(int8, group, smax):
    """lens 0, Smax - 1, mid-ring and Smax (the dropped write)."""
    rng = np.random.default_rng(group * 10 + smax + int8)
    hk = H // group
    ring, sc = _ring(rng, smax, hk, int8)
    qt = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kv_new = rng.standard_normal((2, B, hk, 1, D)).astype(np.float32)
    kv_new[1, 2] = 0.0                         # an all-zero row: scale 0
    lens = np.array([0, smax - 1, 37, smax], np.int32)
    if int8:
        jring, jsc, want = jda.decode_attention_stacked_i8_write(
            *map(jnp.asarray, (qt, kv_new, ring, sc)), LAYER,
            jnp.asarray(lens))
        tq, tkv, tring, tsc, tlens = _t(qt, kv_new, ring, sc, lens)
        got_ring, got_sc, got = da.decode_attention_stacked_i8_write(
            tq, tkv, tring, tsc, LAYER, tlens)
        assert got_sc is tsc
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                   **TOLERANCES["kv_int8_scales"])
    else:
        jring, want = jda.decode_attention_stacked_write(
            *map(jnp.asarray, (qt, kv_new, ring)), LAYER, jnp.asarray(lens))
        tq, tkv, tring, tlens = _t(qt, kv_new, ring, lens)
        got_ring, got = da.decode_attention_stacked_write(
            tq, tkv, tring, LAYER, tlens)
    # the write lands in place; values exactly as JAX's (int8 included)
    assert got_ring is tring
    np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
    changed = (tring.numpy() != ring).any(axis=(0, 1, 3, 5))   # [B, Smax]
    assert not changed[3].any()                # lens == Smax: dropped
    assert changed[:3].sum() >= 2              # rows 0, 1, 2 landed
    assert got.shape == (B, H, 1, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOLERANCES["attention_fp32"])


def test_write_equals_write_then_read():
    """Below a full row the fused write's attention is the plain
    write-then-read's: the stacked read after the rows landed."""
    rng = np.random.default_rng(5)
    ring, _ = _ring(rng, 128, 2)
    qt, kv_new = _t(rng.standard_normal((B, H, 1, D)).astype(np.float32),
                    rng.standard_normal((2, B, 2, 1, D)).astype(np.float32))
    lens = torch.tensor([0, 127, 37, 64], dtype=torch.int32)
    tring = torch.from_numpy(ring.copy())
    _, fused = da.decode_attention_stacked_write(qt, kv_new, tring, LAYER,
                                                 lens)
    read = da.decode_attention_stacked(qt, tring, LAYER, lens)
    torch.testing.assert_close(fused, read, **TOLERANCES["attention_fp32"])


@pytest.mark.parametrize("q_shape,c_shape,dtype,cdtype", [
    ((4, 1, 12, 64), (12, 2, 4, 12, 1024, 64), "float32", None),
    ((4, 16, 12, 64), (12, 2, 4, 6, 256, 64), "bfloat16", "bfloat16"),
    ((4, 129, 12, 64), (12, 2, 4, 12, 1024, 64), "float32", None),
    ((4, 1, 12, 320), (12, 2, 4, 12, 1024, 320), "float32", None),
    ((4, 1, 12, 64), (12, 2, 4, 5, 1024, 64), "float32", None),
    ((4, 1, 12, 64), (12, 2, 4, 12, 1000, 64), "float32", None),
    ((4, 1, 12, 64), (12, 2, 4, 12, 1024, 64), "float32", "bfloat16"),
], ids=["decode", "block_gqa", "sq129", "d320", "hk5", "smax1000",
        "mixed"])
def test_stacked_gates_agree_with_jax(q_shape, c_shape, dtype, cdtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tcd = None if cdtype is None else getattr(torch, cdtype)
    jcd = None if cdtype is None else getattr(jnp, cdtype)
    assert da.stacked_is_supported(q_shape, c_shape, tdt, tcd) == \
        jda.stacked_is_supported(q_shape, c_shape, jdt, jcd)
    assert da.stacked_i8_is_supported(q_shape, c_shape, tdt) == \
        jda.stacked_i8_is_supported(q_shape, c_shape, jdt)
    assert da.stacked_write_is_supported(q_shape, c_shape, tdt, tcd) == \
        jda.stacked_write_is_supported(q_shape, c_shape, jdt, jcd)
    assert da.stacked_i8_write_is_supported(q_shape, c_shape, tdt) == \
        jda.stacked_i8_write_is_supported(q_shape, c_shape, jdt)


@pytest.mark.parametrize("bad", ["mixed_dtype", "sq129", "write_sq2",
                                 "ring_fp_for_i8", "scales_shape", "layer",
                                 "kv_new_shape", "batch"])
def test_stacked_wrappers_reject_what_the_kernels_do_not_take(bad):
    rng = np.random.default_rng(0)
    ring, sc = _t(*_ring(rng, 128, H, int8=True))
    fp_ring = torch.from_numpy(_ring(rng, 128, H)[0])
    qt = torch.zeros(B, H, 1, D)
    kv_new = torch.zeros(2, B, H, 1, D)
    lens = torch.zeros(B, dtype=torch.int32)
    calls = {
        "mixed_dtype": lambda: da.decode_attention_stacked(
            qt.double(), fp_ring, LAYER, lens),
        "sq129": lambda: da.decode_attention_stacked(
            torch.zeros(B, H, 129, D), fp_ring, LAYER, lens),
        "write_sq2": lambda: da.decode_attention_stacked_write(
            torch.zeros(B, H, 2, D), kv_new, fp_ring, LAYER, lens),
        "ring_fp_for_i8": lambda: da.decode_attention_stacked_i8(
            qt, fp_ring, sc, LAYER, lens),
        "scales_shape": lambda: da.decode_attention_stacked_i8_write(
            qt, kv_new, ring, sc[..., :-1], LAYER, lens),
        "layer": lambda: da.decode_attention_stacked(qt, fp_ring, L, lens),
        "kv_new_shape": lambda: da.decode_attention_stacked_write(
            qt, kv_new[:, :2], fp_ring, LAYER, lens),
        "batch": lambda: da.decode_attention_stacked(
            qt[:2], fp_ring, LAYER, lens[:2]),
    }
    with pytest.raises(ValueError):
        calls[bad]()


def test_jax_rejects_mixed_dtypes_too():
    with pytest.raises(ValueError):
        jda.decode_attention_stacked(
            jnp.zeros((B, H, 1, D), jnp.bfloat16),
            jnp.zeros((L, 2, B, H, 128, D), jnp.float32), 0,
            jnp.zeros((B,), jnp.int32))


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_kernels_match_reference_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    tdt = getattr(torch, dtype)
    tol = TOLERANCES["attention_fp32" if dtype == "float32"
                     else "attention_bf16"]
    rng = np.random.default_rng(3)
    ring, _ = _ring(rng, 256, 2)
    ring8, sc = _ring(rng, 256, 2, int8=True)
    qt = torch.randn(B, H, 16, D).to(tdt).cuda()
    lens = torch.from_numpy(_lens(256, 16)).cuda()
    fp = torch.from_numpy(ring).to(tdt).cuda()
    i8 = [torch.from_numpy(x).cuda() for x in (ring8, sc)]
    torch.testing.assert_close(
        da.decode_attention_stacked(qt, fp, LAYER, lens).float(),
        da.decode_attention_stacked_reference(qt, fp, LAYER, lens).float(),
        **tol)
    torch.testing.assert_close(
        da.decode_attention_stacked_i8(qt, *i8, LAYER, lens).float(),
        da.decode_attention_stacked_i8_reference(qt, *i8, LAYER,
                                                 lens).float(), **tol)
    q1, kv_new = qt[:, :, :1].contiguous(), torch.randn(2, B, 2, 1, D).cuda()
    lens = torch.tensor([0, 255, 37, 256], dtype=torch.int32).cuda()
    fp2, i82 = fp.clone(), [x.clone() for x in i8]
    _, got = da.decode_attention_stacked_write(q1, kv_new, fp, LAYER, lens)
    _, want = da.decode_attention_stacked_write_reference(q1, kv_new, fp2,
                                                          LAYER, lens)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(fp, fp2)
    *_, got = da.decode_attention_stacked_i8_write(q1, kv_new, *i8, LAYER,
                                                   lens)
    *_, want = da.decode_attention_stacked_i8_write_reference(
        q1, kv_new, *i82, LAYER, lens)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert all(torch.equal(a, b) for a, b in zip(i8, i82))
