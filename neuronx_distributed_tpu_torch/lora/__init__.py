"""LoRA adapters: ``LoraConfig``, ``init_lora`` and ``merge_lora``
(``lora.core``). The serving-side pool of many adapters lives in
``inference/adapters.py``, over ``init_lora`` trees."""

from neuronx_distributed_tpu_torch.lora.core import LoraConfig, init_lora, merge_lora  # noqa: F401

__all__ = ["LoraConfig", "init_lora", "merge_lora"]
