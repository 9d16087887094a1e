"""LoRA adapters (``lora.core``): ``LoraConfig``, ``init_lora``,
``merge_lora``, the training form (``attach_adapters``), the merged HF export
and the adapters' specs. The serving-side pool of many adapters lives in
``inference/adapters.py``, over ``init_lora`` trees."""

from neuronx_distributed_tpu_torch.lora.core import (  # noqa: F401
    LoraConfig,
    attach_adapters,
    export_merged_hf,
    init_lora,
    lora_param_specs,
    merge_lora,
)

__all__ = ["LoraConfig", "attach_adapters", "export_merged_hf", "init_lora",
           "lora_param_specs", "merge_lora"]
