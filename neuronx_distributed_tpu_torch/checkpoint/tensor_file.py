"""safetensors files written and read with PyTorch alone.

:func:`save_safetensors` lays a file out byte for byte as
``safetensors.numpy.save_file`` does, and :func:`load_safetensors` reads any
such file into CPU tensors: the weight shards of
``inference/model_builder.py``, the HF files of ``converters/hf_llama.py``
and the payload of ``checkpoint/core.py`` go through them.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

# safetensors' dtype names in its own order: a file lays its tensors out by
# this rank, descending, then by name
_ST_DTYPES = (("BOOL", torch.bool), ("U8", torch.uint8), ("I8", torch.int8),
              ("I16", torch.int16), ("U16", torch.uint16), ("F16", torch.float16),
              ("BF16", torch.bfloat16), ("I32", torch.int32), ("U32", torch.uint32),
              ("F32", torch.float32), ("F64", torch.float64), ("I64", torch.int64),
              ("U64", torch.uint64))
_ST_NAME = {dt: name for name, dt in _ST_DTYPES}
_ST_TORCH = dict(_ST_DTYPES)
_ST_RANK = {name: i for i, (name, _) in enumerate(_ST_DTYPES)}


def _as_torch(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: its 16 bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))   # a writable copy, 0-d kept


def save_safetensors(tensors: Mapping[str, Any], path: str) -> None:
    """Write ``tensors`` (name -> tensor or array) as one safetensors file:
    a little-endian u64 header length, the JSON header (``dtype``,
    ``shape``, ``data_offsets`` per tensor, space-padded to 8 bytes), then
    the raw little-endian bytes, laid out as ``safetensors.numpy.save_file``
    lays them out."""
    items = {name: _as_torch(t).contiguous() for name, t in tensors.items()}
    for name, t in items.items():
        if t.dtype not in _ST_NAME:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
    order = sorted(items, key=lambda n: (-_ST_RANK[_ST_NAME[items[n].dtype]], n))
    header, off, blobs = {}, 0, []
    for name in order:
        t = items[name]
        # a view of the tensor's bytes, no copy: the file write reads it with
        # the interpreter lock released (a copy would hold the lock, and a
        # checkpoint writer thread would stall the training thread)
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else b""
        header[name] = {"dtype": _ST_NAME[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        off += len(raw)
        blobs.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for raw in blobs:
            fh.write(raw)


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors (name -> tensor)."""
    with open(path, "rb") as fh:
        data = fh.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_TORCH:
            raise ValueError(f"{name}: safetensors dtype {info['dtype']} is not read here")
        dt = _ST_TORCH[info["dtype"]]
        b0, b1 = info["data_offsets"]
        raw = bytearray(data[base + b0: base + b1])
        flat = (torch.frombuffer(raw, dtype=dt) if raw
                else torch.empty((0,), dtype=dt))
        out[name] = flat.reshape(info["shape"])
    return out


class SafetensorsReader:
    """One safetensors file read a tensor at a time: the header once, then
    each tensor's bytes by offset (a checkpoint piece is read only by the
    ranks whose blocks it covers)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            self.header = {k: v for k, v in json.loads(fh.read(n)).items()
                           if k != "__metadata__"}
        self.base = 8 + n

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        if info["dtype"] not in _ST_TORCH:
            raise ValueError(f"{name}: safetensors dtype {info['dtype']} is not read here")
        dt = _ST_TORCH[info["dtype"]]
        b0, b1 = info["data_offsets"]
        with open(self.path, "rb") as fh:
            fh.seek(self.base + b0)
            raw = bytearray(fh.read(b1 - b0))
        flat = torch.frombuffer(raw, dtype=dt) if raw else torch.empty((0,), dtype=dt)
        return flat.reshape(info["shape"])
