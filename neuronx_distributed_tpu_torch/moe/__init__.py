"""Mixture-of-Experts for serving (``moe/routing.py``, ``moe/expert_mlps.py``,
``moe/layer.py``): the routers, the expert MLPs in their three modes and the
MoE block with the JAX package's inference dispatch."""

from neuronx_distributed_tpu_torch.moe.expert_mlps import ExpertMLPs  # noqa: F401
from neuronx_distributed_tpu_torch.moe.layer import MoE  # noqa: F401
from neuronx_distributed_tpu_torch.moe.routing import (  # noqa: F401
    RouterSinkhorn,
    RouterTopK,
    load_balancing_loss,
    router_z_loss,
    top_k,
)

__all__ = ["ExpertMLPs", "MoE", "RouterSinkhorn", "RouterTopK", "load_balancing_loss",
           "router_z_loss", "top_k"]
