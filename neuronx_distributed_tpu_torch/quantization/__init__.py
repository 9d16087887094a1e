"""Weight-only int8 quantization of the port's state dicts
(``quantization.core``); the product with int8 weights is B5
(``kernels/w8a16.py``)."""

from neuronx_distributed_tpu_torch.quantization.core import (  # noqa: F401
    QuantizationConfig,
    dequantize_leaf,
    dequantize_params,
    quantize_leaf,
    quantize_params,
    quantize_tensor,
)

__all__ = ["QuantizationConfig", "dequantize_leaf", "dequantize_params", "quantize_leaf",
           "quantize_params", "quantize_tensor"]
