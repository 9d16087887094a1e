"""Carry a flax Llama parameter tree over to the port's state dict.

The flax tree (``neuronx_distributed_tpu.models.llama.LlamaForCausalLM``,
unboxed, leaves as numpy arrays) stacks the decoder layers on a leading
axis under ``model/layers/block``; the port keeps one module per layer
under ``model.layers.{i}``. Kernels keep their ``(in, out)`` and
``(hidden, heads, head_dim)`` layouts, so the mapping is a rename plus an
unstack. ``lm_head/kernel`` is absent when ``tie_word_embeddings`` is set.

Tensor parallelism: every converter of a served family takes
``tp_rank``/``tp_size`` and returns that rank's shard, cut where the port's
TP layers shard (``parallel/layers.py``): the embedding's and
``lm_head``'s vocabulary, the Q/K/V heads, ``o_proj``'s and
``down_proj``'s fan-in, ``gate_proj``'s and ``up_proj``'s fan-out, an
expert's intermediate columns (``gate``/``up`` ``(E, H, I)`` over ``I``,
``down`` ``(E, I, H)`` over ``I``), each Medusa head's vocabulary (JAX's
``ColumnParallelLinear(gather_output=False)``; the ResBlocks are whole);
an adapter's ``A`` over fan-in on ``o_proj``/``down_proj`` and its ``B``
over fan-out elsewhere. Under ``kv_size_multiplier > 1`` the compact K/V
kernels and their adapters' ``B`` stay whole: the forward repeats their
products' heads and takes the rank's (``GQAQKVColumnParallelLinear``). An
int8 pair is the cut of the JAX tree's *global* quantization:
``qweight`` as its float weight, ``scale`` on the axes it keeps
(``inference.partition.scale_spec``), so a row-parallel weight's scale is
whole on every rank.

``lora_params_from_jax`` carries an ``init_lora`` adapter tree over the same
way: keyed by the full flax path, a leading layer axis on stacked kernels,
into the port's per-layer tree keyed by the port's weight names.
``medusa_params_from_jax`` carries a ``MedusaLlamaForCausalLM`` tree: the
Llama part as above plus each head's ``medusa_res_{i}`` (kernel and bias)
and ``medusa_head_{i}`` (kernel) under the same names.

``pipelined_llama_params_from_jax`` carries a JAX ``PipelinedLlama`` tree
(``{"embed", "layers": {"block": stacked}, "final_norm", "lm_head"}``, the
stacked axis in VPP order when ``num_chunks > 1``) to one stage's state
dict under the ``LlamaForCausalLM`` names the port's stage uses.

``mixtral_params_from_jax`` carries a ``MixtralForCausalLM`` tree: the MoE
block's ``moe/router/kernel`` and the expert tensors ``moe/experts/{gate,
up,down}`` (stacked ``(L, E, ...)``) unstack like the rest; a DBRX tree's
LayerNorms (``input_norm/ln/scale``, ``ln/bias`` where the norm has one,
and the final norm's) map to the port's ``SPLayerNorm`` names. A rank's
(ep, tp) slice of its output comes from ``parallel.partitioning.
local_state_dict``.
``gpt_neox_params_from_jax`` carries a ``GPTNeoXForCausalLM`` tree: the
biased QKV (``qkv/{q,k,v}_bias``), ``o_proj``'s and the MLP's kernels and
biases (``mlp/up``, ``mlp/down``) and the LayerNorms (``ln/scale``,
``ln/bias``). ``bert_params_from_jax`` carries a ``BertForPreTraining``
tree (``bert/...`` with its stack under ``bert/layers/block``,
``mlm_transform``, ``mlm_norm``, ``mlm_bias``, ``nsp_head``) to the port's
names. Both take ``tp_rank``/``tp_size`` as ``llama_params_from_jax`` does.

``quantized_params_from_jax`` carries a JAX ``quantize_params`` tree of
either family: each ``{qweight, scale}`` leaf becomes the port's
``X.qweight``/``X.scale`` pair, unstacked (a per-tensor 0-d scale goes to
every layer). An expert scale whose expert axis has size 1 while there are
more experts is the layout of ROADMAP C7 (the JAX package reduced the expert
axis of the stacked kernel): it raises rather than share scales across
experts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.partition import (
    ROW_PARALLEL_TARGETS,
    dim_spec,
    shard_slice,
    state_partition_specs,
)

# flax path under model/layers/block -> port name under model.layers.{i}
_LAYER_LEAVES = {
    ("attention", "qkv", "q_kernel"): "attention.qkv.q_kernel",
    ("attention", "qkv", "k_kernel"): "attention.qkv.k_kernel",
    ("attention", "qkv", "v_kernel"): "attention.qkv.v_kernel",
    ("attention", "o_proj", "kernel"): "attention.o_proj.kernel",
    ("mlp", "gate_proj", "kernel"): "mlp.gate_proj.kernel",
    ("mlp", "up_proj", "kernel"): "mlp.up_proj.kernel",
    ("mlp", "down_proj", "kernel"): "mlp.down_proj.kernel",
}
_NORMS = ("input_norm", "post_attn_norm")


# the Mixtral decoder block: Llama's attention and norms, the MoE block
_MIXTRAL_LEAVES = {
    **{k: v for k, v in _LAYER_LEAVES.items() if k[0] != "mlp"},
    ("moe", "router", "kernel"): "moe.router.kernel",
    ("moe", "experts", "gate"): "moe.experts.gate",
    ("moe", "experts", "up"): "moe.experts.up",
    ("moe", "experts", "down"): "moe.experts.down",
}


def _node(tree: Mapping[str, Any], path):
    node = tree
    for key in path:
        if key not in node:
            raise KeyError(f"flax tree has no {'/'.join(path)}")
        node = node[key]
    return node


def _get(tree: Mapping[str, Any], path) -> np.ndarray:
    return np.array(_node(tree, path))   # a writable copy: torch tensors share it


def _is_quantized(node) -> bool:
    return isinstance(node, Mapping) and "qweight" in node


def _leaf(node, name: str, out: Dict[str, torch.Tensor]) -> None:
    """An unstacked leaf: a float array, or a ``{qweight, scale}`` pair."""
    if _is_quantized(node):
        out[f"{name}.qweight"] = torch.from_numpy(np.array(node["qweight"]))
        out[f"{name}.scale"] = torch.from_numpy(np.array(node["scale"], np.float32))
    else:
        out[name] = torch.from_numpy(np.array(node))


def _stacked(node, path: str, name: str, num_layers: int, out: Dict[str, torch.Tensor]) -> None:
    """A stacked leaf ``(L, ...)`` as one entry a layer; a quantized one
    keeps its pair (a 0-d per-tensor scale goes to every layer)."""
    q = _is_quantized(node)
    stacked = np.array(node["qweight"] if q else node)
    if stacked.shape[0] != num_layers:
        raise ValueError(f"{path} stacks {stacked.shape[0]} layers, expected {num_layers}")
    scale = np.array(node["scale"], np.float32) if q else None
    if q and ".moe.experts." in f".{name}" and scale.ndim == stacked.ndim:
        if scale.shape[1] == 1 and stacked.shape[1] > 1:
            raise ValueError(
                f"{path}: scale {scale.shape} for experts {stacked.shape} shares one scale "
                f"across the expert axis (ROADMAP C7: the JAX quantize_params reduced the "
                f"expert axis of the scan-stacked kernel); quantize one scale set per expert")
    for i in range(num_layers):
        if q:
            out[f"model.layers.{i}.{name}.qweight"] = torch.from_numpy(
                np.ascontiguousarray(stacked[i]))
            # np.array, not ascontiguousarray: a 0-d scale stays 0-d
            out[f"model.layers.{i}.{name}.scale"] = torch.from_numpy(
                np.array(scale[i] if scale.ndim else scale))
        else:
            out[f"model.layers.{i}.{name}"] = torch.from_numpy(np.ascontiguousarray(stacked[i]))


def _norm_leaves(node: Mapping[str, Any]) -> Tuple[tuple, ...]:
    """A norm's weights under it: RMSNorm's ``scale``, or a LayerNorm's
    ``ln/scale`` (and ``ln/bias`` where it has one)."""
    if "ln" in node:
        return tuple(("ln", k) for k in ("scale", "bias") if k in node["ln"])
    return (("scale",),)


def _params_from_jax(tree: Mapping[str, Any], leaves: Mapping[tuple, str],
                     tie_word_embeddings: bool) -> Dict[str, torch.Tensor]:
    if "params" in tree and "model" not in tree:
        tree = tree["params"]
    block = ("model", "layers", "block")
    norm = _norm_leaves(_node(tree, block + ("input_norm",)))
    num_layers = _get(tree, block + ("input_norm",) + norm[0]).shape[0]
    out: Dict[str, torch.Tensor] = {}
    _leaf(_node(tree, ("model", "embed", "embedding")), "model.embed.embedding", out)
    for sub in _norm_leaves(_node(tree, ("model", "final_norm"))):
        _leaf(_node(tree, ("model", "final_norm") + sub),
              "model.final_norm." + ".".join(sub), out)
    leaves = {**leaves, **{(n,) + sub: ".".join((n,) + sub) for n in _NORMS for sub in norm}}
    for path, name in leaves.items():
        _stacked(_node(tree, block + path), "/".join(block + path), name, num_layers, out)
    if not tie_word_embeddings:
        _leaf(_node(tree, ("lm_head", "kernel")), "lm_head.kernel", out)
    return out


# the sharded dim of each weight of the port's Llama (and Mixtral, Medusa)
# at TP > 1, by name suffix
_TP_DIMS = {"embed.embedding": 0, "qkv.q_kernel": 1, "qkv.k_kernel": 1, "qkv.v_kernel": 1,
            "o_proj.kernel": 0, "gate_proj.kernel": 1, "up_proj.kernel": 1,
            "down_proj.kernel": 0, "lm_head.kernel": 1, "experts.gate": 2, "experts.up": 2,
            "experts.down": 1}
_MEDUSA_HEAD = re.compile(r"^medusa_head_\d+\.kernel$")


def _tp_dim(name: str, kv_size_multiplier: int):
    if _MEDUSA_HEAD.match(name):
        return 1
    for suffix, dim in _TP_DIMS.items():
        if name.endswith(suffix):
            # compact K/V kernels repeated in the forward stay replicated
            if kv_size_multiplier > 1 and suffix in ("qkv.k_kernel", "qkv.v_kernel"):
                return None
            return dim
    return None


def llama_params_from_jax(tree: Mapping[str, Any], tie_word_embeddings: bool = False,
                          tp_rank: int = 0, tp_size: int = 1,
                          kv_size_multiplier: int = 1) -> Dict[str, torch.Tensor]:
    """Flax Llama params (``{"model": ..., "lm_head": ...}``, or the
    ``{"params": ...}`` wrapper) -> state dict of the port's
    ``LlamaForCausalLM``: at ``tp_size > 1`` rank ``tp_rank``'s shard."""
    return _cut(_params_from_jax(tree, _LAYER_LEAVES, tie_word_embeddings), tp_rank, tp_size,
                kv_size_multiplier)


def _cut(out: Dict[str, torch.Tensor], tp_rank: int, tp_size: int,
         kv_size_multiplier: int = 1) -> Dict[str, torch.Tensor]:
    """Rank ``tp_rank``'s shard of a converted state dict (the whole dict
    at ``tp_size`` 1), its int8 pairs under ``state_partition_specs``."""
    if tp_size == 1:
        return out
    pairs = {k[: -len(".qweight")] for k in out if k.endswith(".qweight")}
    specs = {}
    for k, v in out.items():
        base = k.rpartition(".")[0]
        if base in pairs:
            specs[base] = dim_spec(out[f"{base}.qweight"].dim(), _tp_dim(base, kv_size_multiplier))
        else:
            specs[k] = dim_spec(v.dim(), _tp_dim(k, kv_size_multiplier))
    return {k: shard_slice(v, spec, tp_rank, tp_size).contiguous()
            for (k, v), spec in zip(out.items(), state_partition_specs(specs, out).values())}


# the GPT-NeoX decoder block: biased attention and MLP, LayerNorms
_NEOX_LEAVES = {
    **{("attention", "qkv", f"{c}_{kind}"): f"attention.qkv.{c}_{kind}"
       for c in "qkv" for kind in ("kernel", "bias")},
    **{(*path, leaf): ".".join((*path, leaf))
       for path in (("attention", "o_proj"), ("mlp", "up"), ("mlp", "down"))
       for leaf in ("kernel", "bias")},
}
_NEOX_TP_DIMS = {"embed.embedding": 0, "_kernel": 1, "_bias": 0, "o_proj.kernel": 0,
                 "mlp.up.kernel": 1, "mlp.up.bias": 0, "mlp.down.kernel": 0, "lm_head.kernel": 1}
# the BERT tree: each flax path under bert/layers/block, and the sharded
# dims of the port's weights at TP > 1 (by name suffix; the rest replicated)
_BERT_LAYER = {
    **{("attention", "qkv", f"{c}_{kind}"): f"attention.qkv.{c}_{kind}"
       for c in "qkv" for kind in ("kernel", "bias")},
    **{(*path, leaf): ".".join((*path, leaf))
       for path in (("attention", "output"), ("intermediate",), ("mlp_output",))
       for leaf in ("kernel", "bias")},
    **{(norm, "ln", leaf): f"{norm}.ln.{leaf}" for norm in ("attention_norm", "output_norm")
       for leaf in ("scale", "bias")},
}
_BERT_TP_DIMS = {"word_embeddings.embedding": 0, "_kernel": 1, "_bias": 0,
                 "attention.output.kernel": 0, "intermediate.kernel": 1,
                 "intermediate.bias": 0, "mlp_output.kernel": 0, "mlm_bias": 0}


def _shard_by_suffix(out: Dict[str, torch.Tensor], dims: Mapping[str, int], tp_rank: int,
                     tp_size: int) -> Dict[str, torch.Tensor]:
    if tp_size == 1:
        return out

    def dim(name):
        return next((d for suffix, d in dims.items() if name.endswith(suffix)), None)

    return {k: shard_slice(v, dim_spec(v.dim(), dim(k)), tp_rank, tp_size).contiguous()
            for k, v in out.items()}


def gpt_neox_params_from_jax(tree: Mapping[str, Any], tie_word_embeddings: bool = False,
                             tp_rank: int = 0, tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """Flax GPT-NeoX params -> state dict of the port's
    ``GPTNeoXForCausalLM``: at ``tp_size > 1`` rank ``tp_rank``'s shard
    (the QKV heads and their biases, ``o_proj``'s and ``down``'s fan-in,
    ``up``'s fan-out and bias, the embedding's and the head's vocabulary)."""
    out = _params_from_jax(tree, _NEOX_LEAVES, tie_word_embeddings)
    return _shard_by_suffix(out, _NEOX_TP_DIMS, tp_rank, tp_size)


def bert_params_from_jax(tree: Mapping[str, Any], tp_rank: int = 0,
                         tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """Flax ``BertForPreTraining`` params -> state dict of the port's
    ``BertForPreTraining``: at ``tp_size > 1`` rank ``tp_rank``'s shard
    (the word embedding's and ``mlm_bias``'s vocabulary, the QKV heads and
    their biases, ``attention.output``'s and ``mlp_output``'s fan-in,
    ``intermediate``'s fan-out and bias)."""
    if "params" in tree and "bert" not in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        _leaf(_node(tree, ("bert", name, "embedding")), f"bert.{name}.embedding", out)
    for path, name in (((("bert", "embed_norm", "ln"), "bert.embed_norm.ln")),
                       (("mlm_norm", "ln"), "mlm_norm.ln")):
        for leaf in ("scale", "bias"):
            _leaf(_node(tree, path + (leaf,)), f"{name}.{leaf}", out)
    for path, name in ((("bert", "pooler"), "bert.pooler"), (("mlm_transform",), "mlm_transform"),
                       (("nsp_head",), "nsp_head")):
        for leaf in ("kernel", "bias"):
            _leaf(_node(tree, path + (leaf,)), f"{name}.{leaf}", out)
    _leaf(_node(tree, ("mlm_bias",)), "mlm_bias", out)
    block = ("bert", "layers", "block")
    num_layers = _get(tree, block + ("attention_norm", "ln", "scale")).shape[0]
    layers: Dict[str, torch.Tensor] = {}
    for path, name in _BERT_LAYER.items():
        _stacked(_node(tree, block + path), "/".join(block + path), name, num_layers, layers)
    out.update({"bert." + k[len("model."):]: v for k, v in layers.items()})
    return _shard_by_suffix(out, _BERT_TP_DIMS, tp_rank, tp_size)


def mixtral_params_from_jax(tree: Mapping[str, Any], tie_word_embeddings: bool = False,
                            tp_rank: int = 0, tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """Flax Mixtral params -> state dict of the port's
    ``MixtralForCausalLM``: expert tensors ``(L, E, H, I)`` unstack to one
    ``(E, H, I)`` a layer; at ``tp_size > 1`` rank ``tp_rank``'s shard (the
    experts' intermediate columns, the router whole)."""
    return _cut(_params_from_jax(tree, _MIXTRAL_LEAVES, tie_word_embeddings), tp_rank,
                tp_size)


def quantized_params_from_jax(tree: Mapping[str, Any], tie_word_embeddings: bool = False,
                              tp_rank: int = 0, tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``quantize_params`` tree of a Llama or a Mixtral model -> the
    port's int8 state dict (``X.qweight``/``X.scale`` pairs, leaf for leaf;
    ``CausalLM`` serves it as it is); at ``tp_size > 1`` rank ``tp_rank``'s
    cut of the global pairs. Raises on a C7 expert scale, at every
    degree."""
    inner = tree["params"] if "params" in tree and "model" not in tree else tree
    moe = "moe" in _node(inner, ("model", "layers", "block"))
    return _cut(_params_from_jax(inner, _MIXTRAL_LEAVES if moe else _LAYER_LEAVES,
                                 tie_word_embeddings), tp_rank, tp_size)


_FLAX_KEY = re.compile(r"\['([^']+)'\]")


def lora_params_from_jax(tree: Mapping[str, Any], config, tp_rank: int = 0,
                         tp_size: int = 1,
                         kv_size_multiplier: int = 1) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``init_lora`` tree (``{"['model']['layers']['block']...
    ['q_kernel']": {"lora_a": (L, fan_in, r), "lora_b": (L, r, fan_out)}}``)
    -> the port's tree, one entry a layer under the port's weight name
    (``model.layers.{i}.attention.qkv.q_kernel``): the keys the serving
    pool reads as ``q``/``k``/``v`` under the fused qkv and the module name
    elsewhere. Unstacked adapters (the embedding's) keep their shapes.
    ``config`` is the adapters' ``LoraConfig``; their rank must be its
    ``r``. At ``tp_size > 1``: rank ``tp_rank``'s slices (``A`` over fan-in
    on the row-parallel targets, ``B`` over fan-out on the others; the
    compact K/V ``B`` whole under ``kv_size_multiplier > 1``, since the
    delta is computed compact, repeated, then cut to the rank's heads)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    block = ("model", "layers", "block")
    for path, ad in tree.items():
        parts = tuple(_FLAX_KEY.findall(path))
        if not parts:
            raise ValueError(f"not a flax parameter path: {path!r}")
        a = np.array(ad["lora_a"], np.float32)
        b = np.array(ad["lora_b"], np.float32)
        if a.shape[-1] != config.r:
            raise ValueError(f"{path}: rank {a.shape[-1]}, the LoraConfig says {config.r}")
        if parts[:3] == block:
            name = _LAYER_LEAVES.get(parts[3:])
            if name is None:
                raise KeyError(f"no port weight for the stacked flax path {path}")
            row = any(f"{t}." in name for t in ROW_PARALLEL_TARGETS)
            compact = kv_size_multiplier > 1 and name.endswith(("k_kernel", "v_kernel"))
            for i in range(a.shape[0]):
                ai, bi = torch.from_numpy(np.ascontiguousarray(a[i])), torch.from_numpy(
                    np.ascontiguousarray(b[i]))
                if row:
                    ai = shard_slice(ai, ("tp", None), tp_rank, tp_size).contiguous()
                elif not compact:
                    bi = shard_slice(bi, (None, "tp"), tp_rank, tp_size).contiguous()
                out[f"model.layers.{i}.{name}"] = {"lora_a": ai, "lora_b": bi}
        else:
            out[".".join(parts)] = {"lora_a": torch.from_numpy(a), "lora_b": torch.from_numpy(b)}
    return out


def medusa_params_from_jax(tree: Mapping[str, Any], tie_word_embeddings: bool = False,
                           tp_rank: int = 0, tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """Flax ``MedusaLlamaForCausalLM`` params -> state dict of the port's
    ``MedusaLlamaForCausalLM``: :func:`llama_params_from_jax` for the base
    model, then ``medusa_res_{i}.kernel``/``.bias`` and
    ``medusa_head_{i}.kernel`` for every head the tree holds; at
    ``tp_size > 1`` rank ``tp_rank``'s shard (each head over its
    vocabulary, the ResBlocks whole)."""
    if "params" in tree and "model" not in tree:
        tree = tree["params"]
    out = llama_params_from_jax(tree, tie_word_embeddings)
    heads = sorted(int(k[len("medusa_res_"):]) for k in tree if k.startswith("medusa_res_"))
    if heads != list(range(len(heads))):
        raise ValueError(f"medusa heads {heads} are not numbered 0..{len(heads) - 1}")
    for i in heads:
        out[f"medusa_res_{i}.kernel"] = torch.from_numpy(_get(tree, (f"medusa_res_{i}", "kernel")))
        out[f"medusa_res_{i}.bias"] = torch.from_numpy(_get(tree, (f"medusa_res_{i}", "bias")))
        out[f"medusa_head_{i}.kernel"] = torch.from_numpy(
            _get(tree, (f"medusa_head_{i}", "kernel")))
    return _cut(out, tp_rank, tp_size)


def pipelined_llama_params_from_jax(tree: Mapping[str, Any], num_stages: int,
                                    num_chunks: int = 1, stage: Optional[int] = None,
                                    tp_rank: int = 0, tp_size: int = 1,
                                    kv_size_multiplier: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``PipelinedLlama`` tree -> the state dict of the port's
    ``PipelinedLlama`` stage ``stage`` (None: every stage's leaves, the
    whole ``LlamaForCausalLM``), rank ``tp_rank``'s shards. The stacked
    layers are put back in canonical order (JAX
    ``canonical_layer_params``) and named by global index."""
    from neuronx_distributed_tpu_torch.pipeline.engine import stage_layers, vpp_layer_order

    if "params" in tree and "layers" not in tree:
        tree = tree["params"]
    block = _node(tree, ("layers", "block"))
    num_layers = np.asarray(_node(block, ("input_norm", "scale"))).shape[0]
    inv = np.argsort(vpp_layer_order(num_layers, num_stages, num_chunks))

    def canonical(node):
        if isinstance(node, Mapping):
            return {k: canonical(v) for k, v in node.items()}
        return np.asarray(node)[inv]

    llama = {"model": {"embed": tree["embed"], "final_norm": tree["final_norm"],
                       "layers": {"block": canonical(block)}},
             "lm_head": tree["lm_head"]}
    out = llama_params_from_jax(llama, tp_rank=tp_rank, tp_size=tp_size,
                                kv_size_multiplier=kv_size_multiplier)
    if stage is None:
        return out
    layers = {i for ids in stage_layers(num_layers, num_stages, num_chunks, stage) for i in ids}

    def mine(name: str) -> bool:
        if name.startswith("model.layers."):
            return int(name.split(".")[2]) in layers
        if name.startswith("model.embed."):
            return stage == 0
        return stage == num_stages - 1   # the final norm and the head

    return {k: v for k, v in out.items() if mine(k)}
