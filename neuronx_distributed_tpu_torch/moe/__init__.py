"""Mixture-of-Experts (``moe/routing.py``, ``moe/expert_mlps.py``,
``moe/layer.py``): the routers and their auxiliary losses, the expert MLPs
in their three modes under expert, tensor and data parallelism, and the
MoE block with the JAX package's inference dispatch and its recorded
auxiliary losses."""

from neuronx_distributed_tpu_torch.moe.expert_mlps import ExpertMLPs, dispatch_counts  # noqa: F401
from neuronx_distributed_tpu_torch.moe.layer import (  # noqa: F401
    MoE,
    collect_aux_losses,
    record_aux_losses,
)
from neuronx_distributed_tpu_torch.moe.routing import (  # noqa: F401
    RouterSinkhorn,
    RouterTopK,
    load_balancing_loss,
    router_z_loss,
    top_k,
)

__all__ = ["ExpertMLPs", "MoE", "RouterSinkhorn", "RouterTopK", "collect_aux_losses",
           "dispatch_counts", "load_balancing_loss", "record_aux_losses", "router_z_loss",
           "top_k"]
