"""MoE routers and their auxiliary losses, routing in fp32.

Counterpart of ``neuronx_distributed_tpu/moe/routing.py``: ``RouterTopK``
(softmax, the top ``k`` experts, their weights renormalised to sum 1) and
``RouterSinkhorn`` (top-1 over a fixed number of Sinkhorn balancing
iterations). Each returns ``(combine (T, E), logits (T, E))``. The router
weight is ``kernel (hidden, E)`` in fp32, as the JAX package creates it,
replicated on every rank. :func:`top_k` breaks ties as ``jax.lax.top_k``
does, lower index first (``torch.topk`` promises no order among equal
values).

Data parallelism: JAX's means and sums over tokens run over the global
batch (GSPMD), while a rank here holds its rows. Sinkhorn's column balance
sums over the tokens: with a ``group`` (the data-parallel group) that sum
is all-reduced, once an iteration, outside autograd (JAX stops the
gradient there). :func:`load_balancing_loss` is ``E * sum_e f_e * p_e``;
given the global dispatch counts, ``f`` is the global fraction and ``p``
the mean over the rank's own tokens, so the data-parallel mean of the
ranks' losses, which the train step takes, is JAX's loss on the global
batch, value and gradient (``f`` carries none; the loss is linear in
``p``). The z-loss is a mean of per-token terms and needs nothing more.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce_sum_


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of the last axis and their indices, largest
    first, equal values in index order (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_weight(hidden: int, num_experts: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((hidden, num_experts), dtype=torch.float32, device=device),
                        requires_grad=False)


class RouterTopK(nn.Module):
    """Softmax top-k router (JAX ``RouterTopK``): ``combine`` has exactly
    ``top_k`` nonzeros a row, summing to 1."""

    def __init__(self, hidden: int, num_experts: int, top_k: int = 2, device=None):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.kernel = _router_weight(hidden, num_experts, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = x.float() @ self.kernel.float()
        probs = torch.softmax(logits, dim=-1)
        _, topi = top_k(probs, self.top_k)
        mask = F.one_hot(topi, self.num_experts).to(probs.dtype).sum(dim=-2)
        gates = probs * mask
        denom = gates.sum(dim=-1, keepdim=True)
        return gates / torch.clamp_min(denom, 1e-9), logits


class RouterSinkhorn(nn.Module):
    """Top-1 router over ``num_iterations`` Sinkhorn balancing steps (JAX
    ``RouterSinkhorn``): the gate is the softmax probability of the chosen
    expert."""

    def __init__(self, hidden: int, num_experts: int, num_iterations: int = 3, device=None,
                 group=None):
        super().__init__()
        self.num_experts, self.num_iterations = num_experts, num_iterations
        self.kernel = _router_weight(hidden, num_experts, device)
        # the data-parallel group the column sums run over (None: one rank)
        self.group = group

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = x.float() @ self.kernel.float()
        with torch.no_grad():
            pi = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            for _ in range(self.num_iterations):
                col = pi.sum(dim=0, keepdim=True)
                all_reduce_sum_(col, self.group)
                pi = pi / torch.clamp_min(col, 1e-9)
                pi = pi / torch.clamp_min(pi.sum(dim=1, keepdim=True), 1e-9)
        mask = F.one_hot(torch.argmax(pi, dim=-1), self.num_experts).float()
        gate = (torch.softmax(logits, dim=-1) * mask).sum(dim=-1, keepdim=True)
        return mask * gate, logits


def load_balancing_loss(logits: torch.Tensor, combine: torch.Tensor, num_experts: int,
                        counts: Optional[torch.Tensor] = None,
                        num_tokens: Optional[int] = None) -> torch.Tensor:
    """Switch-Transformer aux loss ``E * sum_e f_e * p_e``: ``f`` the share
    of tokens dispatched to each expert, ``p`` the mean router probability.
    ``counts`` (the global dispatch counts an expert) and ``num_tokens``
    (the global token count) make ``f`` the global share; ``p`` is always
    the mean over these rows."""
    probs = torch.softmax(logits.float(), dim=-1)
    if counts is None:
        f = (combine > 0).float().mean(dim=0)
    else:
        f = counts.float() / num_tokens
    p = probs.mean(dim=0)
    return num_experts * (f * p).sum()


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE z-loss: the mean squared log-sum-exp of the router logits."""
    return torch.logsumexp(logits.float(), dim=-1).square().mean()
