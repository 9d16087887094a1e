"""Shape-routed bundles of captured programs, their artifacts, and per-rank
weight shards.

Counterpart of ``neuronx_distributed_tpu/inference/model_builder.py``. Where
the JAX package compiles ``jax.jit(fn).lower(args).compile()`` per (key,
bucket), a program here is a :class:`CapturedProgram`: on CUDA one
``torch.cuda.CUDAGraph`` captured over static copies of its inputs, every
call a copy into those inputs and one replay; on the CPU the eager body.
The same class runs the serving runtime's programs (``causal_lm.py``: the
fused decode block, the prefill, insert and chunk-extend forwards),
speculation's round block and Medusa's tree programs.

:class:`ModelBuilder` collects ``(key, fn, example_args)`` buckets and
:meth:`ModelBuilder.trace` captures them into an :class:`NxDModel`, whose
:meth:`NxDModel.run` routes an input to the bucket it fits (an exact shape
match first, else the fewest padded elements) and pads it there.

Artifacts (:func:`save_model`/:func:`load_model`): each (key, bucket)
program is exported with ``torch.export`` to one ``.pt2`` file beside a
``manifest.json`` with the JAX manifest's fields (``file``,
``donate_argnums``); a loaded bundle serves without the model's Python code
and routes by the exported input shapes. The hand kernels are operators
PyTorch can trace (``nxdt_torch::flash_fwd``, ``nxdt_torch::paged_decode``),
so an exported body that reaches them calls them again when loaded.

Weight shards (:func:`shard_weights_to_safetensors`,
:func:`load_sharded_safetensors`): one safetensors file per rank and the
JAX package's ``shard_meta.json``, written and read here byte for byte as
``safetensors.numpy`` does, with no package beyond PyTorch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.checkpoint.tensor_file import (  # noqa: F401
    _as_torch,
    load_safetensors,
    save_safetensors,
)
from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm

# the kernel wrappers a captured body can reach: B1 (prefill, insert, extend
# and verify forwards of 128 tokens and up), B2 (paged decode steps) and B5
# (every product with int8 weights). A replay runs no Python, so it adds to
# their launch counters what one run of the body launched
KERNEL_WRAPPERS = (flash_block_forward, paged_decode_attention, w8a16_gemm)


def _route_counts() -> Dict[Callable, Dict[str, int]]:
    """A copy of each wrapper's launches by route, for those that count
    routes (B5's ``launches_by_route``)."""
    return {fn: dict(fn.launches_by_route) for fn in KERNEL_WRAPPERS
            if hasattr(fn, "launches_by_route")}


def _clone_out(tree):
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class CapturedProgram:
    """``fn(*inputs)`` over tensors as one program. On CUDA the first call
    (or :meth:`capture`) runs ``fn`` once for real on a side stream over
    static copies of the inputs (its result is that call's result; it loads
    every kernel module, the ctypes libraries included), then captures it
    as a ``torch.cuda.CUDAGraph`` in ``pool``; every later call copies its
    inputs into the static buffers, replays, and returns copies of the
    graph's outputs (another program sharing the pool may reuse their
    memory). On the CPU every call runs ``fn`` eagerly. A capture or replay
    that fails raises: nothing falls back to the eager body.

    Inputs must keep the shapes and dtypes of the first call. ``fn`` must
    read no device value on the host (a capture refuses it) and must keep
    its state in tensors that outlive the program (the graph reads and
    writes their addresses). ``launches_per_replay`` is what the warm-up
    added to each of :data:`KERNEL_WRAPPERS`' counters (``routes_per_replay``
    to their counts by route); each replay adds it again (the capture itself
    launches nothing)."""

    def __init__(self, fn: Callable, device: torch.device, pool=None, name: str = ""):
        self.fn, self.device, self.pool, self.name = fn, torch.device(device), pool, name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Tuple[torch.Tensor, ...] = ()
        self.static_out: Any = None
        self.launches_per_replay: Dict[str, int] = {}
        self.routes_per_replay: Dict[str, Dict[str, int]] = {}
        self.capture_s = 0.0

    def _load(self, args) -> None:
        if len(args) != len(self.static_in):
            raise ValueError(f"program {self.name!r} takes {len(self.static_in)} inputs, "
                             f"got {len(args)}")
        for dst, src in zip(self.static_in, args):
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"program {self.name!r} was captured at {tuple(dst.shape)} "
                                 f"{dst.dtype}, got {tuple(src.shape)} {src.dtype}")
            if src.device.type == "cpu":   # leaves from pinned memory, waits for nothing
                dst.copy_(src.pin_memory(), non_blocking=True)
            else:
                dst.copy_(src)

    def capture(self, *args):
        """Warm up on the given inputs (the real call) and capture; returns
        the warm-up's result."""
        if self.device.type != "cuda":
            raise RuntimeError("only a program on a CUDA device is captured")
        t0 = time.perf_counter()
        self.static_in = tuple(torch.empty(tuple(torch.as_tensor(a).shape),
                                           dtype=torch.as_tensor(a).dtype, device=self.device)
                               for a in args)
        self._load(args)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = {fn: fn.launches for fn in KERNEL_WRAPPERS}
        before_routes = _route_counts()
        with torch.cuda.stream(side):
            out = self.fn(*self.static_in)
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(side)
        # the caller uses the warm-up's outputs on its own stream
        pytree.tree_map(lambda t: t.record_stream(current) if isinstance(t, torch.Tensor)
                        else t, out)
        warmed = {fn: fn.launches for fn in KERNEL_WRAPPERS}
        warmed_routes = _route_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self.static_out = self.fn(*self.static_in)
        # a capture records launches but runs none: keep only the warm-up's
        self.launches_per_replay = {}
        for fn in KERNEL_WRAPPERS:
            self.launches_per_replay[fn.__name__] = warmed[fn] - before[fn]
            fn.launches = warmed[fn]
        self.routes_per_replay = {}
        for fn, counts in warmed_routes.items():
            self.routes_per_replay[fn.__name__] = {
                route: n - before_routes[fn][route] for route, n in counts.items()}
            fn.launches_by_route.update(counts)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return out

    def replay(self) -> Any:
        """One replay over what the static inputs hold; returns the graph's
        own outputs (not copies)."""
        self.graph.replay()
        for fn in KERNEL_WRAPPERS:   # the replay launched the captured kernels
            fn.launches += self.launches_per_replay.get(fn.__name__, 0)
            for route, n in self.routes_per_replay.get(fn.__name__, {}).items():
                fn.launches_by_route[route] += n
        return self.static_out

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        if self.graph is None:
            return self.capture(*args)
        self._load(args)
        return _clone_out(self.replay())


def _shapes(tree) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(x.shape) for x in pytree.tree_leaves(tree) if hasattr(x, "shape"))


def pad_to(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Right-pad with zeros to ``shape`` (the JAX package pads inputs to
    the bucket the same way)."""
    extra = [t - s for s, t in zip(x.shape, shape)]
    if any(e < 0 for e in extra):
        raise ValueError(f"cannot pad {tuple(x.shape)} down to {tuple(shape)}")
    if not any(extra):
        return x
    pads = []
    for e in reversed(extra):
        pads += [0, e]
    return torch.nn.functional.pad(x, pads)


@dataclasses.dataclass
class _Entry:
    fn: Optional[Callable]
    example_args: Tuple
    donate_argnums: Tuple[int, ...]
    program: Optional[Callable] = None


class NxDModel:
    """Shape-routed bundle of programs (JAX ``NxDModel``)."""

    def __init__(self, entries: Dict[str, List[_Entry]]):
        self._entries = entries

    def keys(self) -> List[str]:
        return list(self._entries)

    def buckets(self, key: str) -> List[Tuple[Tuple[int, ...], ...]]:
        return [_shapes(e.example_args) for e in self._entries[key]]

    def route(self, key: str, *args) -> _Entry:
        """The bucket ``args`` run in: the one whose shapes equal theirs, else
        the one that fits them (every dim at least theirs) with the fewest
        padded elements, the first of equals (JAX ``NxDModel.run``).
        Raises ``ValueError`` when none fits."""
        in_shapes = _shapes(args)
        best, best_cost = None, None
        for e in self._entries[key]:
            b_shapes = _shapes(e.example_args)
            if b_shapes == in_shapes:
                return e
            if len(b_shapes) == len(in_shapes) and all(
                    len(bs) == len(s) and all(bd >= d for bd, d in zip(bs, s))
                    for bs, s in zip(b_shapes, in_shapes)):
                cost = sum(int(np.prod(bs)) - int(np.prod(s))
                           for bs, s in zip(b_shapes, in_shapes))
                if best is None or cost < best_cost:
                    best, best_cost = e, cost
        if best is None:
            raise ValueError(f"no bucket of {key!r} fits input shapes {in_shapes}")
        return best

    def run(self, key: str, *args):
        """Route, pad each tensor argument to its bucket and run the
        bucket's program. Outputs keep the bucket's shape; callers trim."""
        e = self.route(key, *args)
        flat, spec = pytree.tree_flatten(args)
        flat_bucket = pytree.tree_leaves(e.example_args)
        padded = [pad_to(x, b.shape) if hasattr(x, "shape") and tuple(x.shape) != tuple(b.shape)
                  else x for x, b in zip(flat, flat_bucket)]
        return e.program(*pytree.tree_unflatten(padded, spec))


class ModelBuilder:
    """Collects ``(key, fn, example_args)`` buckets (JAX
    ``ModelBuilder.add(...).trace()``); several ``add`` calls with one key
    make its bucket ladder. ``donate_argnums``
    is kept for the manifest; every program here copies its inputs into its
    own buffers, so a caller's tensors are never consumed."""

    def __init__(self):
        self._entries: Dict[str, List[_Entry]] = {}

    def add(self, key: str, fn: Callable, example_args: Tuple,
            donate_argnums: Tuple[int, ...] = ()) -> "ModelBuilder":
        self._entries.setdefault(key, []).append(
            _Entry(fn=fn, example_args=tuple(example_args),
                   donate_argnums=tuple(donate_argnums)))
        return self

    def trace(self, device: DeviceLike = None) -> NxDModel:
        """Build the programs on ``device`` (CUDA unless the caller asks for
        the CPU). On CUDA each entry is captured now, on its example
        arguments, all in one graph pool (one program runs at a time); on
        the CPU each keeps its eager body."""
        dev = resolve_device(device)
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        for key, entries in self._entries.items():
            for i, e in enumerate(entries):
                flat, spec = pytree.tree_flatten(e.example_args)

                def body(*leaves, fn=e.fn, spec=spec):
                    return fn(*pytree.tree_unflatten(list(leaves), spec))

                prog = CapturedProgram(body, dev, pool, name=f"{key}_{i}")
                if dev.type == "cuda":
                    prog.capture(*(torch.as_tensor(x).to(dev) for x in flat))

                def run(*args, prog=prog):
                    return prog(*pytree.tree_leaves(args))

                e.program = run
        return NxDModel(self._entries)


# --- artifact save/load -------------------------------------------------------------


class _Exported(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def save_model(model: NxDModel, path: str) -> None:
    """Export every (key, bucket) program with ``torch.export`` to
    ``{key}_{i}.pt2`` and write the routing ``manifest.json`` (JAX
    ``save_model``'s fields). The bundle holds the programs' graphs and the
    tensors they close over; tensors passed as arguments stay arguments."""
    os.makedirs(path, exist_ok=True)
    manifest: Dict[str, List[dict]] = {}
    for key, entries in model._entries.items():
        manifest[key] = []
        for i, e in enumerate(entries):
            if e.fn is None:
                raise ValueError("save_model needs a traced model (ModelBuilder.trace), not a "
                                 "loaded one")
            with torch.no_grad():
                ep = torch.export.export(_Exported(e.fn), tuple(e.example_args))
            ep._example_inputs = None   # arguments (weights too) stay out of the file
            fname = f"{key}_{i}.pt2"
            torch.export.save(ep, os.path.join(path, fname))
            manifest[key].append({"file": fname, "donate_argnums": list(e.donate_argnums)})
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def load_model(path: str) -> NxDModel:
    """Load a saved bundle: each program runs its exported graph (no model
    code), on the device it was exported on; routing reads the exported
    input shapes."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    entries: Dict[str, List[_Entry]] = {}
    for key, items in manifest.items():
        entries[key] = []
        for item in items:
            ep = torch.export.load(os.path.join(path, item["file"]))
            vals = {n.name: n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"}
            example = tuple(torch.empty(tuple(vals[name].shape), dtype=vals[name].dtype,
                                        device="meta")
                            for name in ep.graph_signature.user_inputs)
            entries[key].append(_Entry(fn=None, example_args=example,
                                       donate_argnums=tuple(item["donate_argnums"]),
                                       program=ep.module()))
    return NxDModel(entries)


# --- weight shards as safetensors ---------------------------------------------------

def shard_weights_to_safetensors(params: Mapping[str, Any], dims: Mapping[str, int], size: int,
                                 out_dir: str, axis: str = "tp") -> None:
    """Write one safetensors file per rank of an ``axis`` of ``size`` ranks,
    rank r holding its slice of each tensor, and ``shard_meta.json``
    (``axis``, ``size``, ``dims``) for :func:`load_sharded_safetensors`.
    ``params`` is a flat name -> tensor dict; ``dims`` names each tensor's
    sharded dim (-1 or absent: replicated, every rank carries a copy). The
    port has no device mesh yet, so the sharded dim and the axis size are
    given here where the JAX package reads them off its partition specs and
    its mesh; the files are the JAX package's."""
    flat = {name: _as_torch(v) for name, v in params.items()}
    meta = {name: int(dims.get(name, -1)) for name in flat}
    for name, d in meta.items():
        if d >= 0 and flat[name].shape[d] % size != 0:
            raise ValueError(f"{name}: dim {d} ({flat[name].shape[d]}) not divisible by "
                             f"{axis} size {size} — silent truncation refused")
    os.makedirs(out_dir, exist_ok=True)
    for r in range(size):
        shard = {}
        for name, t in flat.items():
            d = meta[name]
            if d < 0:
                shard[name] = t
            else:
                n = t.shape[d] // size
                shard[name] = t.narrow(d, r * n, n)
        save_safetensors(shard, os.path.join(out_dir, f"weights_rank_{r}.safetensors"))
    with open(os.path.join(out_dir, "shard_meta.json"), "w") as fh:
        json.dump({"axis": axis, "size": size, "dims": meta}, fh)


def load_sharded_safetensors(out_dir: str) -> Dict[str, torch.Tensor]:
    """Reassemble the full weight dict (name -> CPU tensor) from the per-rank
    files (JAX- or port-written)."""
    with open(os.path.join(out_dir, "shard_meta.json")) as fh:
        meta = json.load(fh)
    shards = [load_safetensors(os.path.join(out_dir, f"weights_rank_{r}.safetensors"))
              for r in range(meta["size"])]
    out = {}
    for name, d in meta["dims"].items():
        out[name] = shards[0][name] if d < 0 else torch.cat([s[name] for s in shards], dim=d)
    return out
