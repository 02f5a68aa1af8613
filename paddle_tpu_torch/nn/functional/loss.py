"""``cross_entropy``. Counterpart of ``paddle_tpu/nn/functional/loss.py``'s
``cross_entropy``, all of it: hard or soft labels, class weights, label
smoothing, ``use_softmax=False`` (the input is then probabilities) and
any class ``axis``."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]

_REDUCTIONS = ("mean", "sum", "none")


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    return out.sum() if reduction == "sum" else out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) over the class axis ``axis``, in fp32, in the
    JAX package's parameter order and arithmetic.

    Hard labels (integers, of input's shape without the class axis or
    with it as 1): per row logsumexp minus the gathered logit (never a
    full log-softmax or one-hot); an out-of-range label gives a zero
    term (the smoothing term still applies) and stays in the mean's
    count, ``ignore_index`` zeroes a term and drops it from the count.
    ``label_smoothing`` eps: (1 - eps) of that plus eps times the mean
    over classes of -log-softmax. ``weight`` [C] scales each term by its
    label's class weight, and ``"mean"`` then divides by the weights of
    the counted rows. Soft labels (a distribution over the class axis,
    smoothed toward uniform by eps): the sum over classes of -target
    log p; ``"mean"`` is over rows, and ``weight`` is unused, as in JAX.
    ``reduction``: ``"mean"``, ``"sum"`` or ``"none"``."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"cross_entropy: reduction must be one of "
                         f"{_REDUCTIONS}, got {reduction!r}")
    lg = input.float()
    ax = axis % lg.dim()
    n_class = lg.shape[ax]
    if soft_label:
        tgt = label.float()
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / n_class
        if use_softmax:
            loss = torch.logsumexp(lg, ax) * tgt.sum(ax) - (tgt * lg).sum(ax)
        else:
            loss = -(tgt * torch.log(lg.clamp(min=1e-15))).sum(ax)
        return _reduce(loss, reduction)
    ids = label if label.dim() < lg.dim() else label.squeeze(ax)
    ids = ids.long()
    in_range = (ids >= 0) & (ids < n_class)
    safe = ids.clamp(0, n_class - 1)
    zero = torch.zeros((), device=lg.device)

    def gather(arr):
        return arr.gather(ax, safe.unsqueeze(ax)).squeeze(ax)

    if use_softmax:
        lse = torch.logsumexp(lg, ax)
        loss = torch.where(in_range, lse - gather(lg), zero)
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss + label_smoothing * (
                lse - lg.mean(ax))
    else:
        logp = torch.log(lg.clamp(min=1e-15))
        loss = torch.where(in_range, -gather(logp), zero)
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss \
                - label_smoothing * logp.mean(ax)
    valid = ids != ignore_index
    loss = torch.where(valid, loss, zero)
    if weight is not None:
        wt = weight.float()[safe]
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.clamp(torch.where(valid, wt, zero).sum(),
                                            min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return _reduce(loss, reduction)
