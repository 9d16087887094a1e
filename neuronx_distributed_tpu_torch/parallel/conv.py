"""Channel-parallel 2-D convolutions over a tensor-parallel group.

Counterpart of ``neuronx_distributed_tpu/parallel/conv.py`` (the reference's
``OutputChannelParallelConv2d`` and ``InputChannelParallelConv2d``). The
output-channel conv holds the rank's slice of the filter bank and its bias
(embarrassingly parallel; ``gather_output`` all-gathers the channels); the
input-channel conv contracts over the rank's slice of the input channels
and all-reduces the partial sums, then adds its replicated bias once.
Collectives come from ``parallel/mappings.py``, so the backward is
Megatron's conjugate. Without a group both are the dense conv.

Layouts are PyTorch's: activations NCHW, kernels ``(out, in, kh, kw)``
(JAX takes NHWC and HWIO). ``padding`` is ``"SAME"`` (TensorFlow's rule:
``ceil(size / stride)`` outputs, the padding split low-first) or
``"VALID"``. The conv itself is ``F.conv2d``: JAX computes it in XLA, with
no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from neuronx_distributed_tpu_torch.parallel.layers import _compute_dtype, _param, _Sharded, divide
from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_tensor_parallel_region,
    reduce_from_tensor_parallel_region,
    scatter_to_tensor_parallel_region,
)

IntPair = Union[int, Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
          padding: str) -> torch.Tensor:
    if padding == "SAME":
        pads = []
        for size, k, st in ((x.shape[-1], w.shape[-1], strides[1]),
                            (x.shape[-2], w.shape[-2], strides[0])):
            total = max((-(-size // st) - 1) * st + k - size, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.conv2d(x, w, stride=strides)


class OutputChannelParallelConv2d(_Sharded):
    """A conv with its output channels over the TP ranks: ``kernel``
    ``(features / tp, in, kh, kw)``, ``bias`` ``(features / tp,)``. The
    output stays channel-sharded unless ``gather_output``."""

    tp_shard_dims = {"kernel": 0, "bias": 0}

    def __init__(self, in_channels: int, features: int, kernel_size: IntPair = 3,
                 strides: IntPair = 1, padding: str = "SAME", use_bias: bool = True,
                 gather_output: bool = False, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None, group=None):
        super().__init__()
        self._bind(group)
        kh, kw = _pair(kernel_size)
        self.strides, self.padding = _pair(strides), padding
        self.dtype, self.gather_output = dtype, gather_output
        local = divide(features, self.tp)
        self.kernel = _param((local, in_channels, kh, kw), param_dtype, device)
        self.bias = _param((local,), param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.kernel, self.dtype)
        x = copy_to_tensor_parallel_region(x.to(dt), self.group)
        y = _conv(x, self.kernel.to(dt), self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        if self.gather_output:
            y = gather_from_tensor_parallel_region(y, self.group, 1)
        return y


class InputChannelParallelConv2d(_Sharded):
    """A conv with its input channels over the TP ranks: ``kernel``
    ``(features, in / tp, kh, kw)``, the rank's partial sums all-reduced,
    then the replicated ``bias`` added. ``input_is_parallel``: ``x`` holds
    the rank's channels (an :class:`OutputChannelParallelConv2d`'s
    ungathered output); else the rank takes its slice of a whole ``x``."""

    tp_shard_dims = {"kernel": 1, "bias": None}

    def __init__(self, in_channels: int, features: int, kernel_size: IntPair = 3,
                 strides: IntPair = 1, padding: str = "SAME", use_bias: bool = True,
                 input_is_parallel: bool = True, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None, group=None):
        super().__init__()
        self._bind(group)
        kh, kw = _pair(kernel_size)
        self.strides, self.padding = _pair(strides), padding
        self.dtype, self.input_is_parallel = dtype, input_is_parallel
        self.kernel = _param((features, divide(in_channels, self.tp), kh, kw), param_dtype,
                             device)
        self.bias = _param((features,), param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.kernel, self.dtype)
        if not self.input_is_parallel:
            x = scatter_to_tensor_parallel_region(x, self.group, 1)
        y = reduce_from_tensor_parallel_region(
            _conv(x.to(dt), self.kernel.to(dt), self.strides, self.padding), self.group)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y
