"""``cross_entropy`` over hard labels. Counterpart of
``paddle_tpu/nn/functional/loss.py`` (its hard-label softmax branch)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100):
    """Mean softmax cross entropy of logits ``input`` [..., C] against
    integer ``label`` [...]: fp32 logsumexp minus the gathered logit,
    never a full log-softmax or one-hot. An out-of-range label gives a
    zero term and stays in the mean's denominator; ``ignore_index`` drops
    a term and its count. (Soft labels, class weights, smoothing and other
    reductions are not ported: ROADMAP Queue 1 item 10.)"""
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
    return torch.where(valid, loss, zero).sum() / valid.sum().clamp(min=1)
