"""paddle.save / paddle.load. Counterpart of ``paddle_tpu/framework/io.py``,
whose format this copies: a pickle of nested dicts, lists and tuples
with every tensor as a numpy array, so each framework reads the other's
files. A bf16 tensor is stored as numpy's bfloat16 (``ml_dtypes``, JAX's
dtype) where that is installed, else as fp32; ``load`` returns CPU
tensors (``return_numpy=True``: the arrays).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


def _bf16_numpy():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bf16 = _bf16_numpy()
        if bf16 is None:
            return t.float().numpy()
        return t.contiguous().view(torch.int16).numpy().view(bf16)
    return t.numpy()


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return _to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _to_tensor(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _from_saved(obj):
    if isinstance(obj, np.ndarray):
        return _to_tensor(obj)
    if isinstance(obj, dict):
        return {k: _from_saved(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_saved(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_from_saved(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if configs.get("return_numpy", False):
        return obj
    return _from_saved(obj)
