"""Cross-entropy over vocab-parallel logits.

Counterpart of ``neuronx_distributed_tpu/parallel/loss.py`` (the
reference's ``_ParallelCrossEntropy``). Under a tensor-parallel ``group``
each rank holds the logits of its contiguous slice of the vocabulary (a
``gather_output=False`` head), and the loss is taken over the whole
vocabulary: a MAX all-reduce of the row max, then one SUM all-reduce of the
sum of exponentials, the label's logit (picked on the rank whose slice
holds it) and, under label smoothing, the sum of the logits. Without a
group (or at one rank) the same arithmetic runs with no collective.

The forward is a ``torch.autograd.Function`` with the reference's
backward, softmax minus the (smoothed) one-hot on the local shard only, so
no gradient crosses ranks here: the head's input region all-reduces the
hidden state's gradient. The max is held out of the gradient, as in JAX;
``ignore_index`` masks by multiply; a label outside the vocabulary picks 0,
as JAX's all-zero one-hot row does.
"""

from __future__ import annotations

from typing import Optional

import torch

from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce_max_, all_reduce_sum_
from neuronx_distributed_tpu_torch.parallel.mesh import group_rank, group_size


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, label_smoothing, ignore_index, group):
        local = logits.shape[-1]
        vocab = local * group_size(group)
        start = group_rank(group) * local
        x = logits.float()
        m = x.amax(dim=-1)
        if group is not None:
            all_reduce_max_(m, group)
        e = torch.exp(x - m[..., None])
        labels = labels.long()
        rel = labels - start
        mine = (rel >= 0) & (rel < local)
        picked = torch.gather(x, -1, rel.clamp(0, local - 1)[..., None]).squeeze(-1)
        sums = [e.sum(dim=-1), torch.where(mine, picked, 0.0)]
        if label_smoothing > 0.0:
            sums.append(x.sum(dim=-1))
        sums = torch.stack(sums)
        if group is not None:
            all_reduce_sum_(sums, group)
        lse = torch.log(sums[0]) + m
        loss = lse - sums[1]
        if label_smoothing > 0.0:
            # smoothed target (1 - eps) * one_hot + eps / vocab
            loss = (1.0 - label_smoothing) * loss + label_smoothing * (lse - sums[2] / vocab)
        keep = None
        if ignore_index is not None:
            keep = (labels != ignore_index).to(loss.dtype)
            loss = loss * keep
        ctx.save_for_backward(e, sums[0], rel, mine, keep)
        ctx.smoothing, ctx.vocab, ctx.dtype = label_smoothing, vocab, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, denom, rel, mine, keep = ctx.saved_tensors
        eps = ctx.smoothing
        grad = e / denom[..., None]
        hot = torch.where(mine, 1.0 - eps, 0.0)[..., None]
        grad.scatter_add_(-1, rel.clamp(0, e.shape[-1] - 1)[..., None], -hot)
        if eps > 0.0:
            grad -= eps / ctx.vocab
        scale = g if keep is None else g * keep
        grad *= scale[..., None]
        return grad.to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           label_smoothing: float = 0.0, ignore_index: Optional[int] = None,
                           group=None) -> torch.Tensor:
    """Per-token cross entropy. ``logits`` (..., vocab), or this rank's
    slice of the vocabulary under ``group``; ``labels`` (...) integer, in
    global vocabulary ids. Returns the per-token loss (fp32) with
    ``ignore_index`` positions zeroed, the same on every rank."""
    return _VocabParallelCrossEntropy.apply(logits, labels, float(label_smoothing),
                                            ignore_index, group)


def parallel_cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                                label_smoothing: float = 0.0,
                                ignore_index: Optional[int] = None,
                                group=None) -> torch.Tensor:
    """Mean loss over the tokens that are not ``ignore_index``."""
    loss = parallel_cross_entropy(logits, labels, label_smoothing, ignore_index, group)
    if ignore_index is None:
        return loss.mean()
    denom = torch.clamp((labels != ignore_index).float().sum(), min=1.0)
    return loss.sum() / denom
