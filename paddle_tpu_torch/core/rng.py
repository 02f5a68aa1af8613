"""The global key stream and the threefry draws the samplers take.

Counterpart of ``paddle_tpu/core/rng.py`` (``seed``, ``get_seed``,
``next_key``) and of the pieces of JAX's ``threefry2x32`` PRNG the
serving samplers draw from, written so that the same key gives the same
32-bit words, uniforms and categorical draws as JAX on the same logits:

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds (rotations
  13, 15, 26, 6 / 17, 29, 16, 24, key parity 0x1BD11BDA);
- ``prng_key`` (JAX's ``PRNGKey``), ``fold_in`` and ``split`` (the
  fold-like split of the partitionable mode);
- ``random_bits`` (one counter per element of the flattened shape, the
  word ``bits1 ^ bits2``, narrowed to 8 or 16 bits by truncation),
  ``uniform`` (the mantissa trick in the draw's dtype: 8-bit words when
  the dtype has fewer than 8 mantissa bits, bf16), ``gumbel`` (``-log(-
  log(u))`` over u in [tiny, 1), as XLA compiles it) and
  ``categorical`` (argmax of gumbel plus logits).

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words (uint32
has too few ops on CUDA); every operation masks back to 32 bits. The
global key is a threefry key: JAX's default ``rbg`` keys split their two
halves with threefry too, so the keys ``next_key`` returns have JAX's
last word (the one ``inference.generation._host_seed`` reads) under
either implementation.
The global key lives on the CPU; the draws run on the device of the
logits.

The model-parallel streams are JAX's (Fleet's ``RNGStatesTracker``):
``get_rng_state`` / ``set_rng_state`` read and replace the global key,
the tracker keeps named keys that ``rng_state(name)`` swaps in for the
draws of a block, and ``model_parallel_random_seed`` seeds the global
stream and the ``model_parallel_rng`` stream (seed + 1024 + the model-
parallel rank, which is 0 for the serving mesh's single controller).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "get_seed", "next_key", "get_rng_state", "set_rng_state",
           "RNGStatesTracker", "get_rng_state_tracker", "MODEL_PARALLEL_RNG",
           "model_parallel_random_seed"]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (bits of the dtype, mantissa bits, the bit pattern of 1.0, bit width
# of the integer view) of each float dtype a draw takes
_FLOAT_BITS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
               torch.bfloat16: (16, 7, 0x3F80, torch.int16),
               torch.float16: (16, 10, 0x3C00, torch.int16)}


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counters (x1, x2) under key words (k1,
    k2): int64 tensors of 32-bit words, broadcast together. Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (x1 + k1) & MASK32, (x2 + k2) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(s, device=None):
    """JAX's ``PRNGKey(s)`` with 64-bit ints off: the words (0, s mod
    2^32). ``s`` is an int or an integer tensor (one key per element)."""
    s = torch.as_tensor(s, dtype=torch.int64, device=device) & MASK32
    return torch.stack([torch.zeros_like(s), s], -1)


def fold_in(key, data):
    """JAX's ``fold_in``: the hash of the counter pair (0, data) under
    ``key``. ``key`` [..., 2] and ``data`` (an int or an integer tensor
    of the batch shape) broadcast."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], -1)


def split(key, num=2):
    """JAX's ``split`` in the partitionable mode: key i is the hash of
    the counter pair (0, i). Returns [num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], -1)


def random_bits(key, bit_width, shape):
    """JAX's threefry ``random_bits`` in the partitionable mode: element
    j of the flattened ``shape`` hashes the counter pair (0, j) and keeps
    ``bits1 ^ bits2``, truncated to ``bit_width`` (8, 16 or 32) bits.
    ``key`` is one key [2], or one key per row [B, 2] for a ``shape``
    [B, ...] whose rows count from 0 each (JAX's vmap of one row's
    draw)."""
    shape = tuple(shape)
    if key.dim() == 1:
        n = 1
        for d in shape:
            n *= d
        cnt = torch.arange(n, dtype=torch.int64,
                           device=key.device).reshape(shape)
        k1, k2 = key[0], key[1]
    else:
        n = 1
        for d in shape[1:]:
            n *= d
        cnt = torch.arange(n, dtype=torch.int64,
                           device=key.device).reshape(shape[1:])
        extra = (1,) * (len(shape) - 1)
        k1 = key[:, 0].reshape((-1,) + extra)
        k2 = key[:, 1].reshape((-1,) + extra)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    bits = (b1 ^ b2).expand(shape)
    return bits & ((1 << bit_width) - 1)


def _unit_floats(key, shape, dtype):
    """Random mantissa bits under the exponent of 1.0, minus 1: floats in
    [0, 1) in ``dtype``. A dtype with fewer than 8 mantissa bits (bf16)
    draws 8-bit words."""
    nbits, nmant, one, view = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape)
    fbits = (bits >> (rng_bits - nmant)) | one
    return fbits.to(view).view(dtype) - torch.ones((), dtype=dtype,
                                                   device=key.device)


def uniform(key, shape, dtype, minval, maxval):
    """JAX's ``_uniform`` with bounds given at run time: ``_unit_floats``
    scaled to [minval, maxval) in ``dtype`` and floored at minval."""
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, _unit_floats(key, shape, dtype) * (hi - lo)
                         + lo)


def gumbel(key, shape, dtype):
    """JAX's ``gumbel`` in its default mode "low", as XLA compiles it:
    ``-log(-log(u))`` with u = max(tiny, floats). The bounds of its
    uniform are constants there, so XLA folds ``(x - 1) * (1 - tiny) +
    tiny`` into ``x - 1``: 1 - tiny and -1 + tiny round to 1 and -1 in
    every float dtype. That is exact in fp32 and bf16 and drops fp16's
    ``+ tiny`` (2^-14 on steps of 2^-10); the port draws what JAX's
    compiled samplers draw."""
    floats = _unit_floats(key, shape, dtype)
    tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype,
                      device=key.device)
    return -torch.log(-torch.log(torch.maximum(tiny, floats)))


def categorical(key, logits):
    """JAX's ``categorical`` over the last axis: argmax of gumbel noise in
    the logits' dtype plus the logits. ``key`` is one key [2] whose
    counters run over the whole flattened [..., V] (JAX's one call over a
    batch), or one key per row [B, 2] for logits [B, V] (JAX's vmap of
    one call per row)."""
    g = gumbel(key.to(logits.device), logits.shape, logits.dtype)
    return (g + logits).argmax(-1)


class _RngState(threading.local):
    def __init__(self):
        self.key = None
        self.seed_value = 0

    def ensure(self):
        if self.key is None:
            self.key = prng_key(self.seed_value)
        return self.key


_rng = _RngState()


def seed(s):
    """Reset the global key to ``PRNGKey(s)``. Returns the key."""
    _rng.key = prng_key(int(s))
    _rng.seed_value = int(s)
    return _rng.key


def get_seed():
    return _rng.seed_value


def next_key():
    """A fresh subkey: the global key splits in two, keeps the first half
    and returns the second, as JAX's does."""
    k1, k2 = split(_rng.ensure())
    _rng.key = k1
    return k2


def get_rng_state():
    """The global key (int64 [2], its two 32-bit words)."""
    return _rng.ensure()


def set_rng_state(state):
    """Replace the global key: an int seeds ``PRNGKey(state)``, a key is
    taken as it is."""
    _rng.key = prng_key(state) if isinstance(state, int) else state


class RNGStatesTracker:
    """Named key streams (model-parallel dropout determinism): ``add``
    registers a stream under its own seed, ``rng_state(name)`` makes the
    global stream draw from it for a block and keeps where it got to."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_.clear()
        self.seeds_.clear()

    def add(self, name, seed_):
        if seed_ in self.seeds_:
            raise ValueError(f"seed {seed_} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed_)
        self.states_[name] = prng_key(seed_)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        orig = _rng.ensure()
        _rng.key = self.states_[name]
        try:
            yield
        finally:
            self.states_[name] = _rng.key
            _rng.key = orig


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER


MODEL_PARALLEL_RNG = "model_parallel_rng"


def model_parallel_random_seed(seed_=100):
    """Seed the global stream (and Python's ``random``) with ``seed_`` and
    register the model-parallel stream at seed_ + 1024 + the model-
    parallel rank (0 without a hybrid group, and for the serving mesh's
    controller)."""
    import random as _pyrandom
    from ..distributed.fleet.base.topology import _HYBRID_GROUP
    local_seed = seed_ + 1024
    if _HYBRID_GROUP[0] is not None:
        local_seed += _HYBRID_GROUP[0].get_model_parallel_rank()
    _RNG_TRACKER.reset()
    seed(seed_)
    _pyrandom.seed(seed_)
    _RNG_TRACKER.add(MODEL_PARALLEL_RNG, local_seed)
