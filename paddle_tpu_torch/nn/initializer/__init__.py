"""Initializers. Counterpart of ``paddle_tpu/nn/initializer/__init__.py``.

Each initializer is a callable ``(shape, dtype) -> tensor`` with JAX's
parameters. Where JAX draws from its global key, the port draws from an
explicit ``generator`` (a CPU ``torch.Generator``; None: PyTorch's
default), always on the CPU in fp32, so a seed gives the same values on
every device; the result is then cast to ``dtype`` and moved to
``device`` (keyword-only, the port's own). The draws cannot be bit-equal
to JAX's key-based ones: the tests hold their bounds and moments, and
``_fans`` and ``calculate_gain`` to JAX's numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "calculate_gain"]


def _dtype(dtype):
    """A torch dtype from a torch dtype or its name (``"float32"``)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _fans(shape):
    """(fan_in, fan_out) of a parameter of ``shape`` in Paddle's layouts:
    a matrix [in, out]; a conv weight [out_c, in_c, *k]."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        neg = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + neg ** 2))
    return gains.get(nonlinearity, 1.0)


class Initializer:
    def __call__(self, shape, dtype=torch.float32, *, generator=None,
                 device=None):
        out = self._draw(tuple(int(s) for s in shape), generator)
        return out.to(device=device, dtype=_dtype(dtype))

    def _draw(self, shape, generator):
        """The fp32 values on the CPU."""
        raise NotImplementedError


def _normal(shape, generator):
    return torch.empty(shape).normal_(generator=generator)


def _uniform(shape, low, high, generator):
    return torch.empty(shape).uniform_(low, high, generator=generator)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, generator):
        return torch.full(shape, float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, generator):
        return self.mean + self.std * _normal(shape, generator)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z a standard normal truncated to [a, b] (in
    standard units, as ``jax.random.truncated_normal`` takes them)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, shape, generator):
        z = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, self.a,
                                        self.b, generator=generator)
        return self.mean + self.std * z


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, shape, generator):
        return _uniform(shape, self.low, self.high, generator)


def _fan_pair(init, shape):
    fi, fo = _fans(shape)
    return (init.fan_in if init.fan_in is not None else fi,
            init.fan_out if init.fan_out is not None else fo)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, generator):
        fi, fo = _fan_pair(self, shape)
        return self.gain * math.sqrt(2.0 / (fi + fo)) * _normal(shape,
                                                                generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, generator):
        fi, fo = _fan_pair(self, shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = calculate_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        return std * _normal(shape, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = calculate_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, generator)


class Assign(Initializer):
    """The given values (a numpy array, a tensor or a list), reshaped to
    ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, *, generator=None,
                 device=None):
        v = self.value
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)))
        return t.to(device=device, dtype=_dtype(dtype)).reshape(tuple(shape))


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal`` (column axis last), scaled by
    ``gain``: the parameter as a matrix [prod(shape[:-1]), shape[-1]] has
    orthonormal columns (rows, when it is wide), the Q of a normal draw's
    QR with R's diagonal signs folded in."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _draw(self, shape, generator):
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        wide = n_rows < n_cols
        a = _normal((n_cols, n_rows) if wide else (n_rows, n_cols),
                    generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if wide:
            q = q.T
        return self.gain * q.reshape(shape)


class Dirac(Initializer):
    """A conv weight [out_c, in_c, *k] that passes each of the first
    ``min(out_c / groups, in_c)`` channels of every group through: ones
    at the kernel's centre."""

    def __init__(self, groups=1):
        self.groups = groups

    def _draw(self, shape, generator):
        arr = torch.zeros(shape)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(per, ic)):
                arr[(g * per + i, i, *centers)] = 1.0
        return arr
