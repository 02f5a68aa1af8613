"""``cross_entropy`` over hard labels. Counterpart of
``paddle_tpu/nn/functional/loss.py`` (its hard-label softmax branch)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]

_REDUCTIONS = ("mean", "sum", "none")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of logits ``input`` [..., C] against integer
    ``label`` [...] (or [..., 1]), in the JAX package's parameter order:
    per row fp32 logsumexp minus the gathered logit, never a full
    log-softmax or one-hot. An out-of-range label gives a zero term;
    ``ignore_index`` zeroes a term and drops it from the mean's count.
    ``reduction``: ``"mean"`` (the sum over the count of labels that are
    not ``ignore_index``, floored at 1; out-of-range labels stay in it),
    ``"sum"``, or ``"none"`` (the per-row terms, [...]).

    Class weights, soft labels, ``use_softmax=False``, label smoothing and
    an ``axis`` other than the last are not ported yet (ROADMAP Queue 1
    item 10(e)) and raise NotImplementedError."""
    for what, off in (("weight", weight is not None),
                      ("soft_label=True", soft_label),
                      ("use_softmax=False", not use_softmax),
                      ("label_smoothing > 0", label_smoothing > 0),
                      (f"axis={axis}", axis not in (-1, input.dim() - 1))):
        if off:
            raise NotImplementedError(
                f"cross_entropy: {what} is not ported yet (ROADMAP Queue 1 "
                "item 10(e)); the port takes hard labels over the last axis")
    if reduction not in _REDUCTIONS:
        raise ValueError(f"cross_entropy: reduction must be one of "
                         f"{_REDUCTIONS}, got {reduction!r}")
    lg = input.float()
    n_class = lg.shape[-1]
    ids = label.long()
    if ids.dim() == lg.dim():
        ids = ids.squeeze(-1)
    in_range = (ids >= 0) & (ids < n_class)
    picked = lg.gather(-1, ids.clamp(0, n_class - 1).unsqueeze(-1))
    zero = torch.zeros((), device=lg.device)
    loss = torch.where(in_range, torch.logsumexp(lg, -1) - picked.squeeze(-1),
                       zero)
    valid = ids != ignore_index
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return loss.sum() if reduction == "sum" else loss
