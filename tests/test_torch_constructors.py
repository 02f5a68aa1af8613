"""The port's layer constructors and two functional signatures against the
JAX package's, on the CPU: each builds the JAX object and the port's from
the same arguments, in JAX's positional order where the port once took
its own, and compares the parameters and the output.

- ``incubate.nn.FusedMultiTransformer``: JAX's parameters and defaults
  (``dropout_rate`` second after ``dim_feedforward``, ``num_layers=-1``
  meaning one layer), its layer count and its output through the JAX
  state;
- ``nn.Linear``, ``nn.Embedding``, ``nn.LayerNorm``, ``nn.RMSNorm``:
  JAX's order, ``bias_attr=False`` / ``weight_attr=False`` dropping the
  parameter, ``padding_idx`` zeroing its row and its ids' outputs;
- ``FusedDecoder``'s ``rope_base`` (sixth, as in JAX), ``F.linear`` and
  ``F.layer_norm`` with ``name=``.

Arguments that the port has not ported (an initializer in a ``ParamAttr``,
``sparse=True``, ``*_attrs``) raise NotImplementedError naming ROADMAP
item 10(e). Values at TOLERANCES["logits_fp32"].
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import common as jcommon
from paddle_tpu.nn.layer import norm as jnorm
from paddle_tpu.nn.utils_ import ParamAttr
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import FusedDecoder
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Embedding, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm, RMSNorm
from paddle_tpu_torch.weights import from_jax_state

TOL = TOLERANCES["logits_fp32"]


def _state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _load(tlayer, state):
    tlayer.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()})


def _redraw(jlayer, seed):
    """Every parameter of the JAX layer redrawn from numpy (nonzero
    biases, scales near 1), so a dropped or misplaced parameter shows."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jlayer.state_dict().items():
        z = rng.standard_normal(tuple(v.shape))
        sd[k] = ((1 + 0.1 * z) if "scale" in k else 0.1 * z
                 if "bias" in k else z / np.sqrt(v.shape[-1])).astype(
            np.float32)
    jlayer.set_state_dict(sd)
    return sd


@pytest.mark.parametrize("args, kwargs", [
    ((64, 4, 256), {}),
    ((64, 4, 256), {"num_layers": -1}),
    ((64, 4, 256, 0.0, "gelu"), {}),
    ((64, 4, 256, 0.0, "gelu", False), {"epsilon": 1e-6}),
    ((64, 4, 256), {"dropout_rate": 0.0, "num_layers": 2, "nranks": 1,
                    "trans_qkvw": True, "ring_id": -1, "name": "fmt"}),
])
def test_fused_multi_transformer_matches_jax(args, kwargs):
    """The layer count, activation, normalize_before and epsilon JAX's
    arguments give, and the output of the port's layer holding JAX's
    state (a forward without caches)."""
    paddle.seed(0)
    jmod = JaxFMT(*args, **kwargs)
    tmod = FusedMultiTransformer(*args, **kwargs, device="cpu")
    assert tmod.num_layers == jmod.num_layers >= 1
    assert len(tmod.qkv_weights) == len(jmod.qkv_weights)
    for attr in ("activation", "normalize_before", "epsilon"):
        assert getattr(tmod, attr) == getattr(jmod, attr), attr
    state = _redraw(jmod, 1)
    jmod.eval()
    _load(tmod, state)
    tmod.eval()
    xs = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jmod(paddle.to_tensor(xs)).numpy()
    got = tmod(torch.from_numpy(xs)).numpy()
    assert not np.allclose(got, xs)               # the layers ran
    np.testing.assert_allclose(got, want, **TOL)
    # the bridge builds the same stack from the state alone
    bridged = from_jax_state(state, {"weight": np.zeros((8, 64), np.float32)},
                             {"weight": np.zeros((64, 8), np.float32)},
                             activation=jmod.activation,
                             normalize_before=jmod.normalize_before,
                             epsilon=jmod.epsilon, device="cpu")[0]
    np.testing.assert_allclose(bridged(torch.from_numpy(xs)).numpy(), want,
                               **TOL)


def test_fused_multi_transformer_refuses_attrs():
    with pytest.raises(NotImplementedError, match="10\\(e\\)"):
        FusedMultiTransformer(64, 4, 256, qkv_weight_attrs=[None, None],
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ffn2_bias_attrs"):
        FusedMultiTransformer(64, 4, 256, 0.0, "gelu", True, *[None] * 11,
                              [ParamAttr()], device="cpu")


@pytest.mark.parametrize("args, kwargs", [
    ((4, 8, None, False), {}),
    ((4, 8), {"weight_attr": None}),
    ((4, 8, None, None, "fc"), {}),
    ((4, 8), {"bias_attr": ParamAttr(name="b")}),
])
def test_linear_matches_jax(args, kwargs):
    paddle.seed(0)
    jl = jcommon.Linear(*args, **kwargs)
    tl = Linear(*args, **kwargs, device="cpu")
    assert (tl.bias is None) == (jl.bias is None)
    state = _redraw(jl, 3)
    assert set(dict(tl.named_parameters())) == set(state)
    _load(tl, state)
    x = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


@pytest.mark.parametrize("args, kwargs", [
    ((8,), {"bias_attr": False}),
    ((8, 1e-5, None, False), {}),
    ((8, 1e-5, False), {}),
    ((8, 1e-6, None, None, "ln"), {}),
])
def test_layer_norm_matches_jax(args, kwargs):
    """Fresh parameters (ones, zeros, or none) equal JAX's, and so does
    the output."""
    jl = jnorm.LayerNorm(*args, **kwargs)
    tl = LayerNorm(*args, **kwargs, device="cpu")
    for name in ("weight", "bias"):
        jp, tp = getattr(jl, name), getattr(tl, name)
        assert (tp is None) == (jp is None), name
        if tp is not None:
            np.testing.assert_array_equal(tp.detach().numpy(),
                                          np.asarray(jp._data))
    x = np.random.default_rng(5).standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


def test_rms_norm_matches_jax():
    jl = jnorm.RMSNorm(8, 1e-5, "rms")
    tl = RMSNorm(8, 1e-5, "rms", device="cpu")
    assert tl.epsilon == jl.epsilon
    x = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **TOL)


@pytest.mark.parametrize("padding_idx", [None, 0, 7])
def test_embedding_matches_jax(padding_idx):
    """The padding row starts at zero, and its ids give zeros even where
    the row holds values (JAX masks the lookup); in JAX's order."""
    paddle.seed(0)
    jl = jcommon.Embedding(10, 4, padding_idx)
    tl = Embedding(10, 4, padding_idx, False, None, "emb", device="cpu")
    assert tl.padding_idx == jl.padding_idx
    if padding_idx is not None:
        assert not np.asarray(jl.weight._data)[padding_idx].any()
        assert not tl.weight[padding_idx].any()
    state = {"weight": np.random.default_rng(7).standard_normal(
        (10, 4)).astype(np.float32)}
    jl.set_state_dict(state)
    _load(tl, state)
    ids = np.array([[0, 3, 7], [7, 9, 0]], np.int64)
    want = jl(paddle.to_tensor(ids)).numpy()
    got = tl(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if padding_idx is not None:
        assert not got[ids == padding_idx].any()


def test_unported_arguments_raise():
    from paddle_tpu.nn.initializer import Constant
    init = ParamAttr(initializer=Constant(0.5))
    for build in (lambda: Linear(4, 8, init, device="cpu"),
                  lambda: Linear(4, 8, None, init, device="cpu"),
                  lambda: Embedding(10, 4, None, True, device="cpu"),
                  lambda: Embedding(10, 4, weight_attr=init, device="cpu")):
        with pytest.raises(NotImplementedError, match="10\\(e\\)"):
            build()


def test_functional_name_arguments():
    rng = np.random.default_rng(8)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((3, 4), (4, 5)))
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        F.linear(*map(torch.from_numpy, (x, w, b)), name="fc").numpy(),
        JF.linear(*map(paddle.to_tensor, (x, w, b)), name="fc").numpy(),
        **TOL)
    g, beta = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        F.layer_norm(torch.from_numpy(x), 4, torch.from_numpy(g),
                     torch.from_numpy(beta), 1e-5, name="ln").numpy(),
        JF.layer_norm(paddle.to_tensor(x), 4, paddle.to_tensor(g),
                      paddle.to_tensor(beta), 1e-5, name="ln").numpy(),
        **TOL)


def test_fused_decoder_takes_rope_base_sixth():
    """JAX's (fmt, embed, head, max_seq_len, use_rotary, rope_base,
    weight_quant, kv_quant): the seventh positional is weight_quant on
    both sides, and the stacked weights are bit-equal."""
    from paddle_tpu.inference.generation import FusedDecoder as JaxDecoder
    paddle.seed(0)
    jmods = (JaxFMT(64, 4, 128, num_layers=2), jcommon.Embedding(32, 64),
             jcommon.Linear(64, 32, bias_attr=False))
    for i, m in enumerate(jmods):
        _redraw(m, 10 + i)
    tmods = from_jax_state(*(_state(m) for m in jmods), device="cpu")
    for quant in (None, "int8"):
        jdec = JaxDecoder(*jmods, 128, False, 10000.0, quant)
        tdec = FusedDecoder(*tmods, 128, False, 10000.0, quant,
                            device="cpu")
        assert tdec._weight_quant_mode() == jdec._weight_quant_mode()
        want = jdec._stacked()
        got = tdec._stacked()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    with pytest.raises(NotImplementedError, match="item 3"):
        FusedDecoder(*tmods, 128, True, 500000.0, device="cpu")
