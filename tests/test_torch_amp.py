"""The port's ``amp`` against the JAX package's, on the CPU.

- O1: inside ``auto_cast`` the output dtypes of ``F.linear`` and
  ``F.fused_concat_linear`` equal JAX's (bf16 and fp16; fp32 outside it,
  or with ``linear`` on the custom black list), and their values agree
  within TOLERANCES["matmul_bf16"]; a LayerNorm fed a bf16 activation
  with fp32 weights takes the composite on both sides and gives JAX's
  dtype; the white and black lists and the state accessors equal JAX's.
- O2: ``decorate`` casts the same parameters (a ``Linear`` and a
  ``LayerNorm``) to bf16 and turns on ``multi_precision``; the masters
  are seeded from the rounded values, as JAX's are, and after three
  AdamW steps equal JAX's within TOLERANCES["optimizer_fp32"].
- ``GradScaler``: the loss scale after each of eight steps, two of them
  with an inf injected into a gradient (skipped steps), equal to JAX's,
  and the parameters after them; ``state_dict`` / ``load_state_dict``.
- ``check_numerics``: JAX's NaN / inf counts, raising by default and
  printing under a ``CHECK_NAN_INF`` checker.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import common as jcommon
from paddle_tpu.nn.layer import norm as jnorm
from paddle_tpu.tensor.tensor import Tensor as JaxTensor
from paddle_tpu_torch import TOLERANCES, amp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm
from paddle_tpu_torch.optimizer import SGD, AdamW

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["optimizer_fp32"]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("level, dtype, black", [
    ("O1", "bfloat16", None), ("O1", "float16", None),
    ("O2", "bfloat16", None), ("O1", "bfloat16", ["linear"])])
def test_linear_casts_match_jax(level, dtype, black):
    x, w1, w2, b1, b2 = _arrays(0, (3, 8), (8, 4), (8, 6), (4,), (6,))
    jx, jw1, jw2, jb1, jb2 = map(paddle.to_tensor, (x, w1, w2, b1, b2))
    tx, tw1, tw2, tb1, tb2 = map(torch.from_numpy, (x, w1, w2, b1, b2))
    with jamp.auto_cast(level=level, dtype=dtype,
                        custom_black_list=black):
        jouts = (JF.linear(jx, jw1, jb1),
                 JF.fused_concat_linear(jx, [jw1, jw2], [jb1, jb2]))
    with amp.auto_cast(level=level, dtype=dtype, custom_black_list=black):
        assert amp.is_auto_cast_enabled()
        assert amp.get_amp_dtype() == getattr(torch, dtype)
        touts = (F.linear(tx, tw1, tb1),
                 F.fused_concat_linear(tx, [tw1, tw2], [tb1, tb2]))
    assert not amp.is_auto_cast_enabled()
    for j, t in zip(jouts, touts):
        assert _dtype_name(t) == str(j.dtype)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j._data.astype(jnp.float32)),
                                   **TOLERANCES["matmul_bf16"])
    assert F.linear(tx, tw1, tb1).dtype == torch.float32


def test_lists_and_layer_norm_route_match_jax():
    """The lists, and O1's LayerNorm of a bf16 activation with fp32
    weights: the composite on both sides, in JAX's dtype."""
    with jamp.auto_cast(custom_white_list=["softmax"]), \
            amp.auto_cast(custom_white_list=["softmax"]):
        assert amp.white_list() == jamp.white_list()
        assert amp.black_list() == jamp.black_list()
    x, w = _arrays(1, (4, 8), (8, 8))
    jl, tl = jnorm.LayerNorm(8), LayerNorm(8)
    with jamp.auto_cast():
        jy = jl(JF.linear(paddle.to_tensor(x), paddle.to_tensor(w)))
    with amp.auto_cast():
        ty = tl(F.linear(torch.from_numpy(x), torch.from_numpy(w)))
    assert _dtype_name(ty) == str(jy.dtype)
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy._data.astype(jnp.float32)),
                               **TOLERANCES["layer_norm_bf16"])
    assert amp.is_bfloat16_supported("cpu") and amp.is_float16_supported(
        "cpu")


def _models(seed):
    """A JAX Linear + LayerNorm and the port's holding the same values."""
    w, b, g, beta = _arrays(seed, (6, 4), (4,), (4,), (4,))
    jlin, jln = jcommon.Linear(6, 4), jnorm.LayerNorm(4)
    jlin.set_state_dict({"weight": w, "bias": b})
    jln.set_state_dict({"weight": 1 + 0.1 * g, "bias": 0.1 * beta})
    tlin = Linear(6, 4, device="cpu", trainable=True)
    tln = LayerNorm(4)
    with torch.no_grad():
        for p, a in ((tlin.weight, w), (tlin.bias, b),
                     (tln.weight, 1 + 0.1 * g), (tln.bias, 0.1 * beta)):
            p.copy_(torch.from_numpy(np.asarray(a, np.float32)))
    tmodel = torch.nn.Sequential(tlin, tln)
    return (jlin, jln), tmodel


def test_decorate_o2_masters_match_jax(monkeypatch):
    """O2: a Linear and a LayerNorm cast to bf16, ``multi_precision``
    on; three AdamW steps on a loss through the Linear under
    ``auto_cast(level="O2")`` (a bf16 product on both sides), then the
    masters (seeded from the bf16 values) within
    TOLERANCES["optimizer_fp32"] of JAX's and the bf16 parameters within
    ["optimizer_bf16_params"]."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_EAGER_STEP", "0")
    (jlin, jln), tmodel = _models(2)
    jopt = paddle.optimizer.AdamW(0.01, parameters=jlin.parameters())
    topt = AdamW(0.01, parameters=tmodel[0].named_parameters())
    jlin, jopt = jamp.decorate(jlin, jopt, level="O2", dtype="bfloat16")
    jln = jamp.decorate(jln, level="O2", dtype="bfloat16")
    tmodel, topt = amp.decorate(tmodel, topt, level="O2", dtype="bfloat16")
    assert topt._multi_precision and jopt._multi_precision
    assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
    assert all(p.dtype == jnp.bfloat16 for p in jln.parameters())
    x, c = _arrays(3, (5, 6), (5, 4))
    for _ in range(3):
        with jamp.auto_cast(level="O2"):
            jy = jlin(paddle.to_tensor(x)).astype("float32")
        (jy * paddle.to_tensor(c)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        with amp.auto_cast(level="O2"):
            ty = tmodel[0](torch.from_numpy(x)).float()
        (ty * torch.from_numpy(c)).sum().backward()
        topt.step()
        topt.clear_grad()
    for jp, tp in zip(jlin.parameters(), tmodel[0].parameters()):
        np.testing.assert_allclose(
            topt._master_weights[id(tp)].numpy(),
            np.asarray(jopt._master_weights[id(jp)]._data), **TOL)
        np.testing.assert_allclose(
            tp.detach().float().numpy(),
            np.asarray(jp._data.astype(jnp.float32)),
            **TOLERANCES["optimizer_bf16_params"])


def test_o2_masters_come_from_the_rounded_values():
    """The fp32 master of a parameter cast by ``decorate`` is the bf16
    value (what JAX's lazy ``_seed_master`` reads), not the fp32 weight
    before the cast."""
    w = torch.nn.Parameter(torch.tensor([1.0 + 2 ** -10, -3.0001]))
    model = torch.nn.Module()
    model.w = w
    opt = SGD(0.0, parameters=[w])
    amp.decorate(model, opt, level="O2")
    w.grad = torch.zeros(2, dtype=torch.bfloat16)
    opt.step()
    master = opt._master_weights[id(w)]
    assert torch.equal(master, w.detach().float())
    assert master[0].item() == 1.0


def test_grad_scaler_matches_jax(monkeypatch):
    """Eight SGD steps under a GradScaler (init 2^4, growth every 2
    finite steps), an inf injected into a gradient at steps 3 and 4
    (skipped, and the scale halved each time): the scale after each
    step and the parameters at the end equal JAX's."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_EAGER_STEP", "0")
    (jlin, _), tmodel = _models(4)
    tlin = tmodel[0]
    jopt = paddle.optimizer.SGD(0.1, parameters=jlin.parameters())
    topt = SGD(0.1, parameters=tlin.named_parameters())
    kw = {"init_loss_scaling": 16.0, "incr_every_n_steps": 2}
    jsc, tsc = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    x, = _arrays(5, (3, 6))
    scales = []
    for step in range(8):
        jl = jsc.scale(jlin(paddle.to_tensor(x)).sum())
        tl = tsc.scale(tlin(torch.from_numpy(x)).sum())
        jl.backward()
        tl.backward()
        if step in (3, 4):
            g = np.asarray(jlin.weight.grad._data).copy()
            g[0, 0] = np.inf
            jlin.weight.grad = JaxTensor(jnp.asarray(g))
            tlin.weight.grad[0, 0] = float("inf")
        jsc.step(jopt)
        tsc.step(topt)
        jsc.update()
        tsc.update()
        jopt.clear_grad()
        topt.clear_grad()
        scales.append((jsc.get_loss_scaling(), tsc.get_loss_scaling()))
    assert [t for _, t in scales] == [j for j, _ in scales]
    assert [t for _, t in scales] == [16, 32, 32, 16, 8, 8, 16, 16]
    for jp, tp in zip(jlin.parameters(), tlin.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)
    fresh = amp.GradScaler()
    fresh.load_state_dict(tsc.state_dict())
    assert fresh.state_dict() == {**tsc.state_dict(),
                                  **{k: fresh.state_dict()[k] for k in (
                                      "incr_ratio", "decr_ratio",
                                      "incr_every_n_steps",
                                      "decr_every_n_nan_or_inf")}}
    assert fresh.get_loss_scaling() == 16


def test_check_numerics_matches_jax(capsys):
    from paddle_tpu.amp import debugging as jdbg
    from paddle_tpu_torch.amp import debugging as tdbg
    a = np.array([1.0, np.nan, np.inf, -np.inf, np.nan, 2.0], np.float32)
    with pytest.raises(FloatingPointError, match="nan=2 inf=2"):
        tdbg.check_numerics(torch.from_numpy(a), "op", "x")
    with pytest.raises(FloatingPointError, match="nan=2 inf=2"):
        jdbg.check_numerics(paddle.to_tensor(a), "op", "x")
    cfg = tdbg.TensorCheckerConfig(debug_mode=tdbg.DebugMode.CHECK_NAN_INF)
    tdbg.enable_tensor_checker(cfg)
    try:
        n_nan, n_inf = tdbg.check_numerics(torch.from_numpy(a), "op", "x")
    finally:
        tdbg.disable_tensor_checker()
    assert (int(n_nan), int(n_inf)) == (2, 2)
    assert "nan=2 inf=2" in capsys.readouterr().out
    clean = tdbg.check_numerics(torch.ones(3))
    assert [int(c) for c in clean] == [0, 0]
    assert not torch.is_anomaly_enabled()
