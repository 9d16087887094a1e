"""Cross-entropy over (vocab-parallel) logits, at tensor-parallel degree 1.

Counterpart of ``neuronx_distributed_tpu/parallel/loss.py``: a stable
log-sum-exp in fp32 with the max held out of the gradient, ``ignore_index``
masked by multiply, and label smoothing. The label logit is a gather where
the JAX package multiplies by a one-hot (the same value, without a
``(tokens, vocab)`` one-hot in memory); a label outside the vocabulary picks
0 as its all-zero one-hot row does.
"""

from __future__ import annotations

from typing import Optional

import torch


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           label_smoothing: float = 0.0,
                           ignore_index: Optional[int] = None) -> torch.Tensor:
    """Per-token cross entropy. ``logits`` (..., vocab), ``labels`` (...)
    integer. Returns the per-token loss (fp32) with ``ignore_index``
    positions zeroed."""
    vocab = logits.shape[-1]
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m.squeeze(-1)
    labels = labels.long()
    inside = (labels >= 0) & (labels < vocab)
    picked = torch.gather(logits, -1, labels.clamp(0, vocab - 1)[..., None]).squeeze(-1)
    loss = lse - torch.where(inside, picked, 0.0)
    if label_smoothing > 0.0:
        # smoothed target (1 - eps) * one_hot + eps / vocab
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (lse - logits.mean(dim=-1))
    if ignore_index is not None:
        loss = loss * (labels != ignore_index).to(loss.dtype)
    return loss


def parallel_cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                                label_smoothing: float = 0.0,
                                ignore_index: Optional[int] = None) -> torch.Tensor:
    """Mean loss over the tokens that are not ``ignore_index``."""
    loss = parallel_cross_entropy(logits, labels, label_smoothing, ignore_index)
    if ignore_index is None:
        return loss.mean()
    denom = torch.clamp((labels != ignore_index).float().sum(), min=1.0)
    return loss.sum() / denom
