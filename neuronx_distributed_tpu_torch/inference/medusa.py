"""Medusa tree decoding, batch 1.

Counterpart of ``neuronx_distributed_tpu/inference/medusa.py``. Medusa adds
``H`` heads to the base model; head i predicts the token at offset i + 2.
Each round:

1. a candidate tree from the heads' top-k tokens (``medusa_choices``: node
   ``[a, b]`` is head 1's a-th choice followed by head 2's b-th);
2. one cached forward verifies the whole tree under the tree mask (a node
   sees the prefix and its ancestors) at depth RoPE positions — the
   ``chunk_ctx`` branch of ``models/llama.py``;
3. the longest tree path whose tokens match the verifier's argmax chain is
   accepted (greedy posterior);
4. the accepted tokens are replayed as a contiguous chunk from the round's
   start, which compacts the KV cache (the tree's nodes landed on other
   slots) and gives the next round's base and Medusa logits.

The three forwards (``prefill``, ``tree_step``, ``replay``) are
:class:`~neuronx_distributed_tpu_torch.inference.model_builder.CapturedProgram` s
over a KV cache the model keeps (one captured graph each on CUDA, the eager
body on the CPU); the rollbacks are written into ``cache_index`` inside
them. The candidate and posterior math runs on the host in numpy, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from neuronx_distributed_tpu_torch._device import DeviceLike, resolve_device
from neuronx_distributed_tpu_torch.inference.causal_lm import (
    GenerationResult,
    infer_prompt_lengths,
    percentile_ms,
)
from neuronx_distributed_tpu_torch.inference.model_builder import CapturedProgram
from neuronx_distributed_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
)
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear

TOPK = 10  # per-head candidate pool

# a compact default tree for 2 heads
DEFAULT_CHOICES: Tuple[Tuple[int, ...], ...] = (
    (0,), (1,), (2,), (0, 0), (0, 1), (1, 0),
)


class MedusaLlamaForCausalLM(nn.Module):
    """Llama plus Medusa heads: head i is the ResBlock ``x + silu(W x + b)``
    (``W`` zero-initialised in the JAX package, so a fresh head starts as
    the base head) followed by its own vocabulary head ``medusa_head_i``.
    Weight names follow the flax tree (``medusa_res_{i}.kernel``,
    ``.bias``, ``medusa_head_{i}.kernel``); the base head is ``lm_head`` or,
    with ``tie_word_embeddings``, the embedding."""

    def __init__(self, config: LlamaConfig, num_medusa_heads: int = 2, device=None):
        super().__init__()
        cfg = self.config = config
        self.num_medusa_heads = int(num_medusa_heads)
        self.model = LlamaModel(cfg, device)
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(cfg.hidden_size, cfg.vocab_size, use_bias=False,
                                                **kw)
        for i in range(self.num_medusa_heads):
            self.add_module(f"medusa_res_{i}", ColumnParallelLinear(
                cfg.hidden_size, cfg.hidden_size, use_bias=True, **kw))
            self.add_module(f"medusa_head_{i}", ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, use_bias=False, **kw))
        # (tree, bucket) -> the KV cache and programs of medusa_generate runs
        self._medusa_runs: Dict[tuple, dict] = {}

    _head = LlamaForCausalLM._head
    new_cache = LlamaForCausalLM.new_cache   # the decode cache at ``batch`` rows

    def medusa_heads(self, x: torch.Tensor) -> torch.Tensor:
        """The heads' logits ``(H, ...)`` over hidden states ``x``."""
        out = []
        for i in range(self.num_medusa_heads):
            r = x + nn.functional.silu(getattr(self, f"medusa_res_{i}")(x))
            out.append(getattr(self, f"medusa_head_{i}")(r))
        return torch.stack(out)

    def forward(self, input_ids: torch.Tensor, cache: Optional[KVCache] = None,
                chunk_ctx=None, heads: bool = True):
        """``(logits, medusa_logits (H, b, s, vocab))``; ``heads=False`` skips
        the Medusa projections (the tree verify needs base logits only) and
        returns ``(logits, None)``."""
        x = self.model(input_ids, cache, chunk_ctx)
        return self._head(x), (self.medusa_heads(x) if heads else None)


def generate_medusa_buffers(medusa_choices: Sequence[Sequence[int]]) -> Dict[str, Any]:
    """Static tree buffers: the node ancestry mask, each node's index into
    the candidate pool, depth positions, and per-path node indices (pad
    -1)."""
    choices = sorted((tuple(c) for c in medusa_choices), key=lambda x: (len(x), x))
    if len(set(choices)) != len(choices):
        raise ValueError("duplicate medusa choice")
    m = len(choices) + 1
    index = {(): 0}
    for i, path in enumerate(choices):
        if path[:-1] not in index:
            raise ValueError(f"choice {path} has no parent {path[:-1]} in the tree")
        if path[-1] >= TOPK:
            raise ValueError(f"choice {path} exceeds per-head top-{TOPK} pool")
        index[path] = i + 1

    attn = np.eye(m, dtype=bool)
    attn[:, 0] = True
    tree_idx = np.zeros(m, np.int32)
    pos = np.zeros(m, np.int32)
    for i, path in enumerate(choices):
        for c in range(len(path) - 1):
            attn[i + 1, index[path[: c + 1]]] = True
        # candidate pool layout: [base_top1] + head0 topk + head1 topk + ...
        tree_idx[i + 1] = 1 + (len(path) - 1) * TOPK + path[-1]
        pos[i + 1] = len(path)

    leaves = [p for p in choices
              if not any(len(q) > len(p) and q[: len(p)] == p for q in choices)]
    depth = max(len(p) for p in choices)
    retrieve = np.full((len(leaves), depth + 1), -1, np.int32)
    for r, p in enumerate(leaves):
        retrieve[r, 0] = 0
        for c in range(len(p)):
            retrieve[r, c + 1] = index[p[: c + 1]]
    return {"attn_mask": attn, "tree_indices": tree_idx, "position_ids": pos,
            "retrieve_indices": retrieve, "depth": depth, "num_nodes": m}


def generate_candidates(base_logits: np.ndarray, medusa_logits: np.ndarray,
                        buffers: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """The candidate pool and the tree's tokens. ``base_logits`` (V,),
    ``medusa_logits`` (H, V). Returns ``(tree_tokens (m,), candidates
    (paths, depth+1))``."""
    pool = [int(np.argmax(base_logits))]
    for h in range(medusa_logits.shape[0]):
        topk = np.argsort(medusa_logits[h])[::-1][:TOPK]
        pool.extend(int(t) for t in topk)
    pool_arr = np.asarray(pool, np.int64)
    tree_tokens = pool_arr[buffers["tree_indices"]]
    ri = buffers["retrieve_indices"]
    candidates = np.where(ri >= 0, tree_tokens[np.clip(ri, 0, None)], -1)
    return tree_tokens, candidates


def evaluate_posterior_greedy(path_argmax: np.ndarray, candidates: np.ndarray
                              ) -> Tuple[int, int]:
    """The longest greedy-consistent path: accept ``candidates[p, j+1]``
    while it equals the verifier's argmax at node j. Returns ``(best_path,
    accept_len)``, accept_len counting the tokens beyond the root."""
    paths, width = candidates.shape
    best, best_len = 0, 0
    for p in range(paths):
        acc = 0
        for j in range(width - 1):
            if candidates[p, j + 1] < 0 or candidates[p, j + 1] != path_argmax[p, j]:
                break
            acc += 1
        if acc > best_len:
            best, best_len = p, acc
    return best, best_len


def medusa_model(config: LlamaConfig, params: Mapping[str, Any], num_medusa_heads: int = 2,
                 device: DeviceLike = None) -> MedusaLlamaForCausalLM:
    """The decode-mode model on ``device`` (CUDA unless the caller asks for
    the CPU) from a state dict, in the config's ``param_dtype``. It keeps
    the KV cache and the captured programs of its :func:`medusa_generate`
    runs, so a second run on it replays."""
    if mesh.model_parallel_is_initialized() and mesh.get_tensor_model_parallel_size() > 1:
        raise NotImplementedError("Medusa under tensor parallelism is not ported "
                                  "(ROADMAP queue A)")
    dev = resolve_device(device)
    cfg = dataclasses.replace(config, decode=True)
    with torch.device("meta"):
        model = MedusaLlamaForCausalLM(cfg, num_medusa_heads)
    state = {k: torch.as_tensor(v).to(device=dev, dtype=cfg.param_dtype)
             for k, v in params.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def _programs(model: MedusaLlamaForCausalLM, buffers: Dict[str, Any], bucket: int) -> dict:
    """The cache and the three programs of a (tree, bucket) on ``model``."""
    key = (bucket, buffers["attn_mask"].tobytes(), buffers["position_ids"].tobytes())
    run = model._medusa_runs.get(key)
    if run is not None:
        return run
    dev = model.model.embed.embedding.device
    cache = model.new_cache(1, dev)
    chunk_ctx = (torch.as_tensor(buffers["attn_mask"], device=dev),
                 torch.as_tensor(buffers["position_ids"], device=dev))
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def last_of(x, at):
        h = x[:, at]                                            # (1, 1, hidden)
        return model._head(h)[0, 0].float(), model.medusa_heads(h)[:, 0, 0].float()

    def prefill(ids, last):
        cache.cache_index.zero_()
        with torch.no_grad():
            logits, med = last_of(model.model(ids, cache), last)
        cache.cache_index.copy_(last.to(torch.int32) + 1)
        return torch.cat([logits[None], med])                  # (1 + H, V)

    def tree_step(tree_tokens):
        with torch.no_grad():
            x = model.model(tree_tokens, cache, chunk_ctx)
            return torch.argmax(model._head(x)[0].float(), dim=-1)   # (m,)

    def replay(tokens, start, n):
        # roll back to the round's start, replay the accepted tokens, and
        # leave the length at the accepted end
        cache.cache_index.copy_(start)
        with torch.no_grad():
            logits, med = last_of(model.model(tokens, cache), n - 1)
        cache.cache_index.copy_(start + n.to(torch.int32))
        return torch.cat([logits[None], med])

    run = model._medusa_runs[key] = {
        name: CapturedProgram(fn, dev, pool, name=f"medusa_{name}")
        for name, fn in (("prefill", prefill), ("tree_step", tree_step), ("replay", replay))}
    return run


def medusa_generate(config: LlamaConfig, params: Union[Mapping[str, Any], MedusaLlamaForCausalLM],
                    prompt_ids: np.ndarray, max_new_tokens: int, num_medusa_heads: int = 2,
                    medusa_choices: Sequence[Sequence[int]] = DEFAULT_CHOICES,
                    eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                    prompt_length: Optional[int] = None, bucket: Optional[int] = None,
                    device: DeviceLike = None) -> GenerationResult:
    """Medusa tree decoding of one prompt (JAX ``medusa_generate``).
    ``params`` is the ``MedusaLlamaForCausalLM`` state dict (built on
    ``device``, CUDA unless the caller asks for the CPU) or a model from
    :func:`medusa_model`, whose programs later runs replay. ``result.stats``:
    ``rounds``, ``depth``, ``proposed``, ``accepted``, ``acceptance_rate``,
    ``tokens_per_round`` and the ``round/tree/replay_ms_p50/p90``
    percentiles."""
    if prompt_ids.shape[0] != 1:
        raise ValueError("medusa_generate handles batch size 1")
    buffers = generate_medusa_buffers(medusa_choices)
    if buffers["depth"] > num_medusa_heads:
        raise ValueError(f"tree depth {buffers['depth']} exceeds num_medusa_heads "
                         f"{num_medusa_heads}")
    model = (params if isinstance(params, MedusaLlamaForCausalLM)
             else medusa_model(config, params, num_medusa_heads, device))
    if model.num_medusa_heads != num_medusa_heads:
        raise ValueError(f"the model has {model.num_medusa_heads} heads, not {num_medusa_heads}")
    cfg = model.config
    s = prompt_ids.shape[1]
    bucket = bucket or s
    length = (int(prompt_length) if prompt_length is not None
              else int(infer_prompt_lengths(prompt_ids, pad_token_id)[0]))
    m, depth = int(buffers["num_nodes"]), int(buffers["depth"])
    if length + max_new_tokens + m > cfg.max_seq_len:
        raise ValueError("prompt + max_new_tokens + tree exceeds max_seq_len")
    ri = buffers["retrieve_indices"]
    prog = _programs(model, buffers, bucket)

    ids = np.zeros((1, bucket), np.int32)
    ids[0, :s] = prompt_ids[0]
    got = prog["prefill"](torch.from_numpy(ids),
                          torch.tensor([length - 1], dtype=torch.int64)).cpu().numpy()
    last_logits, last_med = got[0], got[1:]

    out: List[int] = []
    cur = length
    rounds = accepted_total = 0
    round_times: List[float] = []
    tree_times: List[float] = []
    replay_times: List[float] = []
    while len(out) < max_new_tokens:
        t_round = time.perf_counter()
        tree_tokens, candidates = generate_candidates(last_logits, last_med, buffers)
        # one forward verifies the whole tree; its nodes land on slots
        # cur..cur+m-1, which the replay's rollback leaves behind
        t_tree = time.perf_counter()
        node_argmax = prog["tree_step"](torch.from_numpy(tree_tokens[None].astype(np.int32))
                                        ).cpu().numpy()
        tree_times.append(time.perf_counter() - t_tree)
        path_argmax = node_argmax[np.clip(ri, 0, None)]            # (paths, depth+1)
        best, acc = evaluate_posterior_greedy(path_argmax, candidates)
        accepted = [int(t) for t in candidates[best, : acc + 1]]
        chunk = np.zeros((1, depth + 1), np.int32)
        chunk[0, : len(accepted)] = accepted
        t_replay = time.perf_counter()
        got = prog["replay"](torch.from_numpy(chunk), torch.tensor([cur], dtype=torch.int32),
                             torch.tensor([len(accepted)], dtype=torch.int64)).cpu().numpy()
        last_logits, last_med = got[0], got[1:]
        cur += len(accepted)
        replay_times.append(time.perf_counter() - t_replay)
        out.extend(accepted)
        rounds += 1
        accepted_total += acc   # tokens accepted beyond the root
        round_times.append(time.perf_counter() - t_round)
        if eos_token_id is not None and eos_token_id in accepted:
            out = out[: out.index(eos_token_id) + 1]
            break

    out = out[:max_new_tokens]
    tokens = np.zeros((1, max_new_tokens), np.int64)
    tokens[0, : len(out)] = out
    pct = percentile_ms
    stats = {
        "rounds": rounds, "depth": depth, "proposed": rounds * depth,
        "accepted": accepted_total,
        "acceptance_rate": round(accepted_total / max(rounds * depth, 1), 4),
        "tokens_per_round": round(len(out) / max(rounds, 1), 2),
        "round_ms_p50": pct(round_times, 50), "round_ms_p90": pct(round_times, 90),
        "tree_ms_p50": pct(tree_times, 50), "tree_ms_p90": pct(tree_times, 90),
        "replay_ms_p50": pct(replay_times, 50), "replay_ms_p90": pct(replay_times, 90),
    }
    return GenerationResult(tokens=tokens, lengths=np.asarray([len(out)], np.int32),
                            stats=stats)
