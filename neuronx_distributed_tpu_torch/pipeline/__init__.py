"""Pipeline parallelism: the schedules (pure logic) and the engine that runs
one rank's stage of them over p2p sends (``engine.py``)."""

from neuronx_distributed_tpu_torch.pipeline import schedules  # noqa: F401
from neuronx_distributed_tpu_torch.pipeline.engine import (  # noqa: F401
    PipelineEngine,
    microbatch,
    rank_units,
    vpp_layer_order,
)
