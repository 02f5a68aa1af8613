"""The port's ``nn.functional`` signatures and modes against the JAX
package's: ``scaled_dot_product_attention`` and ``dropout`` take JAX's
parameters in JAX's order (the port's generator keyword-only after them),
``training=False`` zeroes attention dropout, and dropout's
``downscale_in_infer`` mode and ``axis`` compute what JAX computes. Masks
come from different generators, so in training the kept values, the
scale and the mask's shape are compared, not the mask itself; inference
is compared exactly. Held to ``TOLERANCES["attention_fp32"]``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import TOLERANCES
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

TOL = TOLERANCES["attention_fp32"]


def _qkv(seed=0, b=2, s=16, h=4, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_in_jax_positional_order(causal):
    """(query, key, value, attn_mask, dropout_p, is_causal, training):
    with training False, dropout_p 0.5 is no dropout, as in JAX."""
    q, k, v = _qkv(int(causal))
    want = JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)), None, 0.5, causal, False).numpy()
    got = F.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), None, 0.5, causal, False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = F.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), is_causal=causal)
    assert torch.equal(got, plain)


def test_sdpa_training_false_zeroes_dropout():
    q, k, v = map(torch.from_numpy, _qkv(3))
    mask = torch.ones((16, 16), dtype=torch.bool).tril()
    for kw in ({"is_causal": True}, {"attn_mask": mask}):
        off = F.scaled_dot_product_attention(q, k, v, dropout_p=0.7,
                                             training=False, **kw)
        assert torch.equal(off, F.scaled_dot_product_attention(q, k, v,
                                                               **kw))
        on = F.scaled_dot_product_attention(
            q, k, v, dropout_p=0.7, generator=torch.Generator().manual_seed(
                1), **kw)
        assert not torch.allclose(on, off)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_inference_matches_jax(mode):
    """JAX's positional order (x, p, axis, training, mode): inference is
    the identity under upscale_in_train and x (1 - p) under
    downscale_in_infer."""
    x = np.random.default_rng(0).standard_normal((4, 6, 8)).astype(
        np.float32)
    want = JF.dropout(paddle.to_tensor(x), 0.3, None, False, mode).numpy()
    got = F.dropout(torch.from_numpy(x), 0.3, None, False, mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    layer = Dropout(0.3, mode=mode).eval()
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_training_keeps_what_jax_keeps(mode):
    """In training both zero a share p and keep the rest scaled by 1 / (1
    - p) under upscale_in_train, unscaled under downscale_in_infer."""
    p = 0.4
    x = np.random.default_rng(1).uniform(1, 2, (64, 64)).astype(np.float32)
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    paddle.seed(0)
    for out in (JF.dropout(paddle.to_tensor(x), p, training=True,
                           mode=mode).numpy(),
                F.dropout(torch.from_numpy(x), p, training=True, mode=mode,
                          generator=torch.Generator().manual_seed(0)
                          ).numpy()):
        kept = out != 0
        np.testing.assert_allclose(out[kept], x[kept] * scale, **TOL)
        assert abs(kept.mean() - (1 - p)) < 0.04


@pytest.mark.parametrize("axis", [1, [0, 2]])
def test_dropout_axis_broadcasts_the_mask(axis):
    """With ``axis`` the mask is drawn over those dims only and broadcast
    over the others, as in JAX."""
    x = np.ones((6, 5, 7), np.float32)
    paddle.seed(0)
    for out in (JF.dropout(paddle.to_tensor(x), 0.5, axis=axis).numpy(),
                F.dropout(torch.from_numpy(x), 0.5, axis=axis,
                          generator=torch.Generator().manual_seed(2)
                          ).numpy()):
        axes = [axis] if isinstance(axis, int) else axis
        other = tuple(i for i in range(3) if i not in axes)
        kept = out != 0
        assert (kept == kept.any(axis=other, keepdims=True)).all()
        assert 0 < kept.mean() < 1


def test_dropout_generator_is_keyword_only():
    x = torch.ones(8, 8)
    a, b = (F.dropout(x, 0.5, generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        F.dropout(x, 0.5, None, True, "upscale_in_train", None,
                  torch.Generator())
