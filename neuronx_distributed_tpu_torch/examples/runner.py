"""Llama inference runner and latency benchmark, on the port.

Counterpart of ``examples/inference/runner.py`` of the JAX package, with its
subcommands, flags, defaults and report keys:

* ``generate`` — bucketed, KV-cached ``CausalLM`` decode of seeded prompts
  (token ids in, token ids out; ``--hf_checkpoint`` serves HF weights
  through ``converters/hf.py``);
* ``benchmark`` — p50/p90/p95/p99/p100 of context encoding (an insert of
  ``max_batch`` rows at the prompt's bucket, the ``prefill_b{bucket}``
  program) and of token generation (``CausalLM.step``), and the K-step fused
  decode block with ``--fused_chunk K``; every timed sample ends on a read
  of its result to the host, so it times the device, not the launch queue;
* ``speculate`` — draft-assisted decoding, the draft the target cut to
  ``--draft_layers`` over the target's own tensors (nothing is copied);
  ``--fused_rounds R`` runs R rounds a program call;
* ``medusa`` — Medusa tree decoding with seeded random heads, checked
  against the base model's greedy stream (exit 1 when they differ);
* ``check-accuracy`` — greedy match and logit divergence of the served
  model against a cache-free fp32 forward of its weights (or the fp32
  ``transformers`` model with ``--hf_checkpoint``); exit 1 when the greedy
  tokens diverge;
* ``serve`` — ``ServeEngine`` (or a ``Router``/``DisaggRouter`` fleet with
  ``--replicas``/``--disagg``) over a synthetic arrival trace, with the
  paged pool, chunked prefill, the pipelined loop, overload knobs, faults,
  snapshots, parking, SLOs, the autoscaler, demo adapters and grammars.

Everything runs on the card unless ``--device cpu`` is given; ``--tiny``
shrinks the model (it does not move it). Weights are seeded (generator seed
0) unless ``--hf_checkpoint`` names a checkpoint. ``--tp N`` shards over the
tensor-parallel ranks of a multi-process launch (``torchrun``'s environment
or the ``NXD_*`` trio); by default TP is 8 (2 with ``--tiny``) and never
more than the world, so one process serves at TP 1. Every subcommand and
model serves under TP: each rank builds its model on its shard of the one
global tree (int8 pairs cut from the global quantization, Mixtral's experts
over their intermediate columns, Medusa's heads over the vocabulary).

The route: over an NCCL group, or with none, every forward runs as a
captured program and ``serve`` decodes in fused blocks. A gloo group on
the card (several ranks sharing one card: NCCL refuses that) cannot run
inside a CUDA graph, so there the runner builds every model with
``capture_programs=False`` and serves with ``fused=False`` (the eager
route, logged), and refuses ``--fused_chunk`` and ``--fused_rounds``,
which are captured blocks by definition.

Llama-2-13B (the default model) on one card:

    python -m neuronx_distributed_tpu_torch.examples.runner benchmark

The CPU smoke:

    python -m neuronx_distributed_tpu_torch.examples.runner benchmark --tiny --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch._device import resolve_device
from neuronx_distributed_tpu_torch.examples.common import setup_example
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.sampling import Sampler, request_seed, split_key
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    init_params,
    llama2_13b,
)
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.mesh import capturable
from neuronx_distributed_tpu_torch.utils import get_logger

logger = get_logger("nxd.examples.inference")

_LAYER = re.compile(r"^model\.layers\.(\d+)\.")


def _model_cls(args):
    if args.model in ("mixtral", "dbrx"):
        from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM

        return MixtralForCausalLM
    return LlamaForCausalLM


def build_config(args):
    """The model's config: the tiny fp32 one with ``--tiny``, else the
    family's preset in bf16 (Llama-2-13B, Mixtral-8x7B or DBRX). The tiny
    presets take the flash kernel where the model is on the card (the
    default device) and the plain attention on the CPU."""
    flash = torch.device(args.device or "cuda").type == "cuda"
    if args.model in ("mixtral", "dbrx"):
        from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig, dbrx, mixtral_8x7b

        if args.tiny:
            return MixtralConfig(
                vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=4, num_kv_heads=4, max_seq_len=256, dtype=torch.float32,
                param_dtype=torch.float32, use_flash_attention=flash, num_experts=4, top_k=2,
                selective_loading_threshold=1.5)
        preset = dbrx if args.model == "dbrx" else mixtral_8x7b
        return preset(max_seq_len=args.max_seq_len, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, remat_policy=None)
    if args.tiny:
        return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=4, max_seq_len=256, dtype=torch.float32,
                           param_dtype=torch.float32, use_flash_attention=flash)
    return llama2_13b(max_seq_len=args.max_seq_len, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, remat_policy=None)


def _world_tp(args) -> int:
    """The tensor-parallel degree: the mesh's on a multi-process (or
    thread-rank) world, 1 on one process. An explicit ``--tp`` the world
    cannot hold is refused."""
    default = args.tensor_parallel_size or (2 if args.tiny else 8)
    world = setup_example(args, default)
    tp = mesh.get_tensor_model_parallel_size() if world > 1 else 1
    if args.tensor_parallel_size and args.tensor_parallel_size != tp:
        raise SystemExit(f"--tp {args.tensor_parallel_size} on a world of {world} process(es) "
                         f"(tensor-parallel degree {tp}): launch that many ranks")
    return tp


def captured_route(dev: torch.device, tp: int) -> bool:
    """True: every forward a captured program and fused serve blocks (no
    group, or an NCCL one); False: the eager route, which a gloo TP group
    on the card needs (its collectives cannot be captured). Logged."""
    group = mesh.get_tensor_model_parallel_group() if tp > 1 else None
    backend = mesh.group_backend(group)
    captured = capturable(dev, group)
    logger.info("route: %s (tp %d, group backend %s, device %s)",
                "captured programs, fused serve blocks" if captured else
                "eager: capture_programs=False, fused=False", tp, backend, dev.type)
    return captured


def _refuse_captured_block(args, flag: str) -> None:
    """``flag`` asks for a captured block: refused on the eager route."""
    if not captured_route(resolve_device(args.device), _world_tp(args)):
        raise SystemExit(f"{flag} runs a captured block, and the gloo tensor-parallel group on "
                         f"the card cannot be captured in a CUDA graph: drop {flag} (the eager "
                         f"route serves the same tokens) or launch over NCCL")


def _rank_params(cfg, cls, params: Mapping[str, Any], tp: int) -> Dict[str, Any]:
    """A global state dict — float, or int8 pairs (``X.qweight``/``X.scale``)
    — cut to this rank's shards (the whole dict at TP 1). Leaves already of
    the rank's shape are taken as they are (a pair by its ``qweight``)."""
    if tp == 1:
        return dict(params)
    from neuronx_distributed_tpu_torch.inference.partition import (
        local_shape,
        param_partition_specs,
        state_partition_specs,
    )
    from neuronx_distributed_tpu_torch.parallel.partitioning import local_state_dict
    from neuronx_distributed_tpu_torch.quantization.core import quantized_names

    with torch.device("meta"):
        module = cls(cfg, group=mesh.get_tensor_model_parallel_group())
    shapes = {n: t.shape for n, t in module.state_dict().items()}
    pairs = quantized_names(params) & set(shapes)
    state = {n: v for n, v in params.items()
             if n in shapes or n.rpartition(".")[0] in pairs}
    specs = state_partition_specs(param_partition_specs(module), state)
    for base in pairs:
        mine = shapes[f"{base}.qweight"] = shapes.pop(base)
        scale = f"{base}.scale"
        sshape = tuple(torch.as_tensor(state[scale]).shape)
        local = tuple(torch.as_tensor(state[f"{base}.qweight"]).shape) == tuple(mine)
        shapes[scale] = sshape if local else local_shape(sshape, specs[scale], tp)
    return local_state_dict(state, specs, mesh.tensor_model_parallel_rank(), tp, shapes)


def _require_global(cfg, cls, params: Mapping[str, Any], tp: int) -> None:
    """``--quantize`` on a float tree under TP wants every weight it
    quantizes whole: a rank's cut quantized alone takes scales of its own,
    another model than the JAX package's global quantization."""
    from neuronx_distributed_tpu_torch.quantization.core import targeted

    with torch.device("meta"):
        whole = {n: tuple(t.shape) for n, t in cls(cfg).state_dict().items()}
    for name, leaf in params.items():
        shape = tuple(torch.as_tensor(leaf).shape)
        if name in whole and targeted(name, leaf) and shape != whole[name]:
            raise SystemExit(f"--quantize at --tp {tp}: {name} has the shape {shape}, not its "
                             f"global {whole[name]}; pass the global float tree (it is "
                             f"quantized whole, then cut) or a quantized one")


def build_model(args, params: Optional[Mapping[str, Any]] = None, config=None):
    """The served ``CausalLM`` and its config. ``params``: a (global) state
    dict instead of the seeded init — float, or already an int8 tree —
    and ``config``: a config instead of :func:`build_config`'s (the seams a
    caller uses to carry weights across or to cut depth). Under TP a float
    tree with ``--quantize`` is quantized whole, then cut (the JAX package
    quantizes the global tree)."""
    dev = resolve_device(args.device)
    tp = _world_tp(args)
    cls = _model_cls(args)
    quantize = getattr(args, "quantize", False)
    captured = captured_route(dev, tp)
    cfg = config if config is not None else build_config(args)
    if args.hf_checkpoint:
        from neuronx_distributed_tpu_torch.converters.hf import FAMILIES
        from neuronx_distributed_tpu_torch.converters.hf_llama import load_hf_safetensors

        fam = FAMILIES[args.model]
        cfg = dataclasses.replace(
            fam.config_from_hf(args.hf_checkpoint), max_seq_len=args.max_seq_len,
            dtype=torch.bfloat16, param_dtype=torch.bfloat16,
            use_flash_attention=dev.type == "cuda")
        # no random init: the converted weights go to the device as they are
        params = fam.hf_to_nxd(load_hf_safetensors(args.hf_checkpoint), cfg)
    from neuronx_distributed_tpu_torch.quantization.core import (
        QuantizationConfig,
        quantize_params,
        quantized_names,
    )

    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                             model_cls=cls, tp_rank=mesh.tensor_model_parallel_rank()
                             if tp > 1 else 0, tp_size=tp,
                             quantize=QuantizationConfig() if quantize else None)
    else:
        if quantize and not quantized_names(params):
            if tp > 1:
                _require_global(cfg, cls, params, tp)
            params = quantize_params(params)   # the global weights, then the rank's cut
        params = _rank_params(cfg, cls, params, tp)
    buckets = (64, 128) if args.tiny else tuple(
        b for b in (128, 512, 2048, 4096) if b < cfg.max_seq_len)
    paged_kw: Dict[str, Any] = {}
    # the storage and kernel knobs imply paged mode
    if getattr(args, "paged_kernel", False) or getattr(args, "kv_dtype", None):
        if args.cmd != "serve":
            raise SystemExit("--paged-kernel/--kv_dtype apply to the serve subcommand only")
        args.paged = True
    if getattr(args, "paged", False):
        if args.cmd != "serve":
            raise SystemExit("--paged applies to the serve subcommand only "
                             "(generate/benchmark run the contiguous path)")
        paged_kw = dict(page_size=args.page_size, page_pool_pages=args.page_pool_pages or None,
                        prefix_cache=not args.no_prefix_cache,
                        page_dtype=getattr(args, "kv_dtype", None),
                        paged_attn_kernel=getattr(args, "paged_kernel", False))
    if getattr(args, "adapters", 0) > 0:
        if args.cmd != "serve":
            raise SystemExit("--adapters applies to the serve subcommand")
        if quantize:
            raise SystemExit("--adapters with --quantize is not supported "
                             "(adapters factorize the fp32 base kernels)")
        paged_kw.update(lora_rank=args.adapter_rank,
                        lora_slots=args.adapter_pool_slots or args.adapters + 1)
    if getattr(args, "grammar_frac", 0.0) > 0:
        if args.cmd != "serve":
            raise SystemExit("--grammar_frac applies to the serve subcommand")
        paged_kw.update(grammar_slots=args.grammar_pool_slots or args.grammars + 1,
                        grammar_states=args.grammar_states)
    lm = CausalLM(cfg, params, cls, buckets=buckets, max_batch=args.max_batch, device=dev,
                  capture_programs=captured, **paged_kw)
    return lm, cfg


# the demo grammar menu (serve --grammar_frac): g0 a bounded integer, g1 a
# compact JSON object (lowered from a schema), g2 a function-call shape
DEMO_GRAMMARS = (
    {"regex": "-?[0-9]{1,8}"},
    {"json_schema": {"type": "object", "properties": {
        "name": {"type": "string"}, "count": {"type": "integer"},
        "ok": {"type": "boolean"}}}},
    {"regex": '(get|set)\\("[a-z]{1,12}"\\)'},
)


def _sampler(args) -> Sampler:
    return Sampler(greedy=not args.sample, temperature=args.temperature,
                   top_k=args.top_k or None, top_p=args.top_p if args.top_p < 1.0 else None)


def cmd_generate(args, params=None, config=None) -> list:
    if args.fused_chunk > 1:
        _refuse_captured_block(args, "--fused_chunk")
    lm, cfg = build_model(args, params, config)
    rs = np.random.RandomState(args.seed)
    b = min(args.max_batch, 2)
    prompt_len = 16 if args.tiny else 128
    prompts = rs.randint(1, cfg.vocab_size, (b, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    lm.compile()
    logger.info("compiled in %.1fs", time.perf_counter() - t0)
    result = lm.generate(prompts, max_new_tokens=args.max_new_tokens, sampler=_sampler(args),
                         seed=args.seed, fused_chunk=args.fused_chunk)
    out = []
    for i, (toks, n) in enumerate(zip(result.tokens, result.lengths)):
        out.append({"prompt": i, "generated": toks[:n].tolist()})
        print(json.dumps(out[-1]))
    return out


def percentiles(ts) -> dict:
    """The reference benchmark's latency report."""
    arr = np.asarray(ts) * 1e3
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 2),
        "p90_ms": round(float(np.percentile(arr, 90)), 2),
        "p95_ms": round(float(np.percentile(arr, 95)), 2),
        "p99_ms": round(float(np.percentile(arr, 99)), 2),
        "p100_ms": round(float(np.max(arr)), 2),
    }


def _greedy_slots(lm: CausalLM, session, seed: int) -> None:
    """Every slot of ``session`` decoding greedily from token 0 (the slot
    state ``generate`` loads before its fused blocks)."""
    st = session.slots
    keys = [split_key(request_seed(seed, r)) for r in range(lm.max_batch)]
    st.host_field("key_lo")[:] = [k[0] for k in keys]
    st.host_field("key_hi")[:] = [k[1] for k in keys]
    st.host_field("temperature")[:] = 0.0
    st.host_field("greedy")[:] = 1
    st.host_field("eos")[:] = -1
    st.host_field("active")[:] = 1
    st.host_field("tok")[:] = 0
    st.host_field("count")[:] = 0
    st.host_field("done")[:] = 0
    st.dirty = True


def cmd_benchmark(args, params=None, config=None) -> dict:
    if args.fused_chunk > 1:
        _refuse_captured_block(args, "--fused_chunk")
    lm, cfg = build_model(args, params, config)
    lm.compile()
    rs = np.random.RandomState(args.seed)
    prompt_len = 16 if args.tiny else args.prompt_len
    bucket = lm._bucket_for(prompt_len)
    mb = lm.max_batch
    prompt = np.zeros((mb, bucket), np.int32)
    prompt[:, :prompt_len] = rs.randint(1, cfg.vocab_size, (mb, prompt_len))
    rows = np.arange(mb)
    session = lm.start_session()

    # context encoding (TTFT): the insert of every row at the bucket, its
    # first token read back (the read waits for the device)
    ttft = []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        logits = lm.insert(session, rows, prompt)
        int(torch.argmax(logits[0]))
        ttft.append(time.perf_counter() - t0)

    # token generation: chained decode steps, each read back
    tok = np.zeros((mb,), np.int32)
    float(lm.step(session, tok)[0, 0])
    decode = []
    for _ in range(args.decode_steps):
        t0 = time.perf_counter()
        logits = lm.step(session, tok)
        float(logits[0, 0])
        decode.append(time.perf_counter() - t0)

    report = {
        "model": args.model + ("_tiny" if args.tiny else ""),
        "tp": lm.tp,
        "batch": mb,
        "prompt_len": prompt_len,
        "context_encoding": percentiles(ttft),
        "token_generation": percentiles(decode),
        "decode_tokens_per_sec": round(mb / float(np.median(decode)), 1),
    }

    k = args.fused_chunk
    if k > 1:
        # the fused K-step block (one replay per K tokens): per-token time
        # on the same percentile surface; captured before the insert
        session.close()
        session = lm.start_session()
        fused = lm.compile_decode_fused(k, session=session)
        lm.insert(session, rows, prompt)
        _greedy_slots(lm, session, args.seed)
        int(fused(session)[k - 1, 0])
        fused_ts = []
        for _ in range(max(1, args.decode_steps // k)):
            t0 = time.perf_counter()
            toks = fused(session)
            int(toks[k - 1, 0])
            fused_ts.append((time.perf_counter() - t0) / k)
        report["token_generation_fused"] = percentiles(fused_ts)
        report["fused_chunk"] = k
        report["decode_tokens_per_sec_fused"] = round(mb / float(np.median(fused_ts)), 1)
    session.close()
    print(json.dumps(report))
    return report


def _draft_params(lm: CausalLM, layers: int) -> Dict[str, torch.Tensor]:
    """The target's own tensors for the draft's depth (no copy)."""
    out = {}
    for name, t in lm.model.state_dict().items():
        m = _LAYER.match(name)
        if m is None or int(m.group(1)) < layers:
            out[name] = t
    return out


def cmd_speculate(args, params=None, config=None) -> dict:
    """Assisted decoding with the target cut to ``--draft_layers`` for a
    draft; ``--fused_rounds R`` runs R rounds a program call
    (``speculative_decode_fused``), token-identical to the host loop."""
    from neuronx_distributed_tpu_torch.inference.speculative import (
        speculative_decode_fused,
        speculative_generate,
    )

    if args.top_k or args.top_p < 1.0:
        raise SystemExit("speculate supports --sample with --temperature only "
                         "(top_k/top_p acceptance is not implemented)")
    if args.fused_rounds > 0:
        _refuse_captured_block(args, "--fused_rounds")
    lm, cfg = build_model(args, params, config)
    draft_layers = (args.draft_layers if args.draft_layers is not None
                    else max(1, cfg.num_layers // 4))
    if not 1 <= draft_layers < cfg.num_layers:
        raise SystemExit(f"--draft_layers must be in [1, {cfg.num_layers - 1}] "
                         f"(target has {cfg.num_layers} layers), got {draft_layers}")
    draft_cfg = dataclasses.replace(cfg, num_layers=draft_layers)
    # over the target's TP group (the mesh's) and on its route
    draft = CausalLM(draft_cfg, _draft_params(lm, draft_layers), _model_cls(args),
                     buckets=lm.buckets, max_batch=lm.max_batch, device=lm.device,
                     capture_programs=lm.capture_programs, tp_group=lm.tp_group)
    rs = np.random.RandomState(args.seed)
    prompt_len = 16 if args.tiny else 128
    prompt = rs.randint(1, cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    if args.fused_rounds > 0:
        def run(n, seed, stats=False):
            return speculative_decode_fused(
                lm, draft, prompt, max_new_tokens=n, num_draft=args.num_draft,
                rounds_per_block=args.fused_rounds, greedy=not args.sample,
                temperature=args.temperature, seed=seed)
    else:
        def run(n, seed, stats=False):
            return speculative_generate(
                lm, draft, prompt, max_new_tokens=n, num_draft=args.num_draft,
                greedy=not args.sample, temperature=args.temperature, seed=seed,
                collect_stats=stats)
    # the warm-up builds every program outside the timed run
    run(2, args.seed + 1)
    t0 = time.perf_counter()
    result = run(args.max_new_tokens, args.seed)
    dt = time.perf_counter() - t0
    # a second short run with per-program syncs gives the draft/verify
    # percentiles (the timed run has none)
    instr = run(min(args.max_new_tokens, 16), args.seed, stats=True)
    sub = {k: v for k, v in (instr.stats or {}).items()
           if k.startswith(("draft_ms", "verify_ms"))}
    report = {
        "generated": result.tokens[0][: int(result.lengths[0])].tolist(),
        "tokens_per_sec": round(int(result.lengths[0]) / dt, 1),
        "draft_layers": draft_cfg.num_layers,
        "num_draft": args.num_draft,
        **(result.stats or {}),
        **sub,
    }
    print(json.dumps(report))
    return report


def _medusa_cls(num_heads: int = 2):
    from neuronx_distributed_tpu_torch.inference.medusa import MedusaLlamaForCausalLM

    return lambda c, group=None: MedusaLlamaForCausalLM(c, num_heads, group=group)


def medusa_init(cfg, seed: int, device, num_heads: int = 2, tp_rank: int = 0,
                tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """Seeded ``MedusaLlamaForCausalLM`` weights: the Llama part as
    ``init_params`` draws it, each head's vocabulary projection random and
    its ResBlock kernel zero (the JAX package's head init); at ``tp_size >
    1`` rank ``tp_rank``'s shard of them."""
    p = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device=device,
                    model_cls=_medusa_cls(num_heads), tp_rank=tp_rank, tp_size=tp_size)
    for i in range(num_heads):
        p[f"medusa_res_{i}.kernel"].zero_()
    return p


def cmd_medusa(args, params=None, config=None) -> dict:
    """Medusa tree decoding with random heads (acceptance near zero): the
    greedy posterior makes the output the base model's greedy stream, which
    is checked (exit 1 when it differs)."""
    from neuronx_distributed_tpu_torch.inference.medusa import (
        DEFAULT_CHOICES,
        medusa_generate,
        medusa_model,
    )

    if args.model != "llama":
        raise SystemExit("medusa supports --model llama")
    if args.hf_checkpoint or getattr(args, "quantize", False) or args.sample:
        raise SystemExit("medusa supports none of --hf_checkpoint/--quantize/--sample "
                         "(random heads, greedy posterior)")
    tp = _world_tp(args)
    dev = resolve_device(args.device)
    captured = captured_route(dev, tp)
    cfg = config if config is not None else build_config(args)
    rank = mesh.tensor_model_parallel_rank() if tp > 1 else 0
    mparams = (_rank_params(cfg, _medusa_cls(), params, tp) if params is not None
               else medusa_init(cfg, args.seed, dev, tp_rank=rank, tp_size=tp))
    rs = np.random.RandomState(args.seed)
    prompt_len = 16 if args.tiny else 128
    prompt = rs.randint(1, cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    model = medusa_model(cfg, mparams, 2, dev, capture_programs=captured)
    result = medusa_generate(cfg, model, prompt, max_new_tokens=args.max_new_tokens,
                             num_medusa_heads=2, medusa_choices=DEFAULT_CHOICES, device=dev)
    # the invariant: the output is the base model's greedy continuation
    base = {k: v for k, v in mparams.items() if not k.startswith("medusa")}
    lm = CausalLM(cfg, base, LlamaForCausalLM, buckets=(prompt_len,), max_batch=1, device=dev,
                  capture_programs=captured)
    golden = lm.generate(prompt, max_new_tokens=args.max_new_tokens)
    n = int(result.lengths[0])
    exact = bool(np.array_equal(result.tokens[0][:n], golden.tokens[0][:n]))
    report = {"generated": result.tokens[0][:n].tolist(), "matches_base_greedy": exact,
              **(result.stats or {})}
    print(json.dumps(report))
    if not exact:
        raise SystemExit(1)
    return report


def _warm_slab_inserts(lm: CausalLM, lens) -> None:
    """Build every slab insert program the trace's prompt lengths reach
    (every row count at each bucket) on a session whose state the next
    session takes over, programs and all."""
    session = lm.start_session()
    for bucket in sorted({lm._bucket_for(s) for s in lens}):
        for rows in range(1, lm.max_batch + 1):
            lm.insert(session, np.arange(rows), np.ones((rows, bucket), np.int32))
    session.close()


def cmd_serve(args, params=None, config=None) -> dict:
    """Continuous batching over a synthetic arrival trace: requests arrive
    in virtual time (decode blocks), are admitted through bucketed inserts
    (or chunks, or prefix-hit suffixes on the paged pool) and the slot pool
    advances ``--fused_steps`` tokens a program call. ``--stepwise`` runs
    the same schedule one token a call (the same streams)."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
    from neuronx_distributed_tpu_torch.inference.faults import resolve_fault_plan
    from neuronx_distributed_tpu_torch.inference.router import Router, run_router_trace
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    # sharded serving: heads and vocabulary must divide the degree (a leaf
    # that does not would not shard evenly), refused before any build
    tp = _world_tp(args)
    if tp > 1:
        cfg0 = config if config is not None else build_config(args)
        for dim_name, dim in (("num_kv_heads", cfg0.num_kv_heads),
                              ("num_heads", cfg0.num_heads),
                              ("vocab_size", cfg0.vocab_size)):
            if dim % tp:
                raise SystemExit(
                    f"serve --tp {tp}: {dim_name}={dim} is not divisible by the TP degree — "
                    f"the KV pool / grammar tables cannot shard evenly (pick a TP that "
                    f"divides heads and vocab)")

    lm, cfg = build_model(args, params, config)
    lm.compile()
    # the eager route (a gloo group on the card) decodes step by step
    fused = not args.stepwise and lm.capture_programs

    def make_adapters():
        # N seeded demo adapters over the base weights (rank r, B nonzero so
        # each moves the logits)
        from neuronx_distributed_tpu_torch.lora.core import LoraConfig, init_lora

        acfg = LoraConfig(r=args.adapter_rank)
        base = {k: v for k, v in lm.model.state_dict().items()}
        out = {}
        for i in range(args.adapters):
            ad = init_lora(base, acfg, torch.Generator().manual_seed(1000 + i))
            gen = torch.Generator().manual_seed(2000 + i)
            out[f"a{i}"] = {
                k: {"lora_a": v["lora_a"],
                    "lora_b": 0.02 * torch.randn(v["lora_b"].shape, generator=gen)}
                for k, v in sorted(ad.items())}
        return out, acfg

    adapter_reg = adapter_cfg = None
    if args.adapters:
        adapter_reg, adapter_cfg = make_adapters()
    grammar_reg = None
    if getattr(args, "grammar_frac", 0.0) > 0:
        grammar_reg = {f"g{i}": DEMO_GRAMMARS[i % len(DEMO_GRAMMARS)]
                       for i in range(args.grammars)}
    # host-memory KV tier (paged + prefix cache): pages from
    # --host_tier_bytes over the host page unit, or twice the device pool
    tier_pages = 0
    if lm.paged and not args.no_prefix_cache and not args.no_host_tier:
        if args.host_tier_bytes > 0:
            tier_pages = max(1, args.host_tier_bytes // lm.kv_page_bytes_host())
        else:
            tier_pages = 2 * lm.config.page_pool_pages
    slos = None
    if args.slo_ttft_ms or args.slo_itl_ms or args.scale_slo_ms:
        from neuronx_distributed_tpu_torch.observability import default_slos

        slos = default_slos(ttft_ms=args.slo_ttft_ms or args.scale_slo_ms,
                            itl_ms=args.slo_itl_ms, target=args.slo_target)
    autoscaler = None
    if args.autoscale:
        from neuronx_distributed_tpu_torch.inference.autoscale import (
            Autoscaler,
            AutoscalePolicy,
        )

        max_reps = args.max_replicas or max(args.replicas, args.min_replicas + 1)
        autoscaler = Autoscaler(AutoscalePolicy(
            min_replicas=args.min_replicas, max_replicas=max_reps,
            backlog_high_blocks=args.scale_up_backlog,
            up_patience_blocks=args.scale_patience_blocks,
            down_utilization=args.scale_down_util,
            down_patience_blocks=args.scale_down_idle_blocks,
            cooldown_blocks=args.scale_cooldown_blocks))
    eng_kw = dict(block_steps=args.fused_steps, fused=fused,
                  async_loop=args.async_loop, prefill_chunk_tokens=args.prefill_chunk_tokens,
                  max_queue=args.max_queue, shed_policy=args.shed_policy,
                  block_time_ms=args.block_time_ms, host_tier_pages=tier_pages,
                  park_idle_blocks=args.park_idle_blocks, park_dir=args.park_dir, slos=slos,
                  # the incident recorder reads the tracer: arming it traces
                  trace=bool(args.trace_out) or bool(args.incident_dir),
                  incident_dir=args.incident_dir)

    def export_observability(engine) -> None:
        if args.trace_out:
            engine.tracer.export_chrome(args.trace_out)
        if args.metrics_out:
            engine.metrics.dump(args.metrics_out)

    def observability_report(engine) -> dict:
        out = {}
        if getattr(engine, "_slo", None) is not None:
            out["slo"] = engine.slo_status()
        rec = getattr(engine, "incident", None)
        if rec is not None:
            out["incidents"] = {"bundles": rec.bundles, "suppressed": rec.suppressed}
        return out

    adapters_arg = (None if adapter_reg is None else
                    {n: (ad, adapter_cfg) for n, ad in adapter_reg.items()})
    # crash recovery: a snapshot left at startup is the previous run's
    # in-flight streams; restore and finish them
    if args.snapshot_path and os.path.exists(args.snapshot_path):
        engine = ServeEngine.from_snapshot(lm, args.snapshot_path, adapters=adapters_arg,
                                           grammars=grammar_reg, **eng_kw)
        completions = engine.run()
        export_observability(engine)
        os.remove(args.snapshot_path)
        report = {
            "recovered": True,
            "restored_requests": int(engine.restored_requests),
            "requests_completed": len(completions),
            "total_generated_tokens": int(sum(len(c.tokens) for c in completions)),
        }
        print(json.dumps(report))
        return report
    prompt_lens = ((8, 12, 16) if args.tiny
                   else (64, min(128, args.prompt_len), args.prompt_len))
    trace = synthetic_trace(
        args.num_requests, cfg.vocab_size, prompt_lens=prompt_lens,
        max_new_tokens=args.max_new_tokens, mean_interarrival_blocks=args.mean_interarrival,
        shared_prefix_len=args.shared_prefix_len, prefix_families=args.prefix_families,
        long_prompt_frac=args.long_prompt_frac, long_prompt_len=args.long_prompt_len,
        ttft_deadline_ms=args.ttft_deadline_ms, deadline_ms=args.deadline_ms,
        tenants=args.tenants, tenant_skew=args.tenant_skew, adapters=args.adapters,
        adapter_skew=args.adapter_skew, grammar_frac=args.grammar_frac,
        grammars=tuple(grammar_reg) if grammar_reg else (), diurnal=args.diurnal,
        diurnal_period_blocks=args.diurnal_period_blocks, burst_every=args.burst_every,
        burst_mult=args.burst_mult, seed=args.seed)
    model_keys = {"model": args.model + ("_tiny" if args.tiny else ""),
                  "max_batch": lm.max_batch, "num_requests": args.num_requests}
    if args.replicas > 1 or args.autoscale:
        # a fleet behind the Router (prefix affinity, per-tenant WFQ,
        # heartbeat failover); --crash_replica_at crashes the last replica
        # at that router block; --disagg splits prefill and decode workers
        crash_at = ([(args.crash_replica_at, args.replicas - 1)]
                    if args.crash_replica_at is not None else ())
        if args.disagg:
            from neuronx_distributed_tpu_torch.inference.disagg import (
                DisaggRouter,
                run_disagg_trace,
            )

            if not lm.paged:
                raise SystemExit("--disagg requires --paged (the handoff moves KV as physical "
                                 "pages)")
            # the whole migration path built outside the measured run
            warm_r = DisaggRouter(lm, 2, prefill_replicas=1, block_steps=args.fused_steps,
                                  fused=fused, seed=args.seed)
            for item in trace[: min(len(trace), lm.max_batch)]:
                warm_r.submit(item["prompt"], 2)
            warm_r.run(max_blocks=200)
            warm_r.close()
            router = DisaggRouter(lm, args.replicas, prefill_replicas=args.prefill_replicas,
                                  seed=args.seed, crash_at=crash_at, autoscaler=autoscaler,
                                  faults=resolve_fault_plan(args.fault_plan), **eng_kw)
            if grammar_reg:
                for n, spec in grammar_reg.items():
                    router.register_grammar(n, **spec)
            report = run_disagg_trace(router, trace)
        else:
            # an autoscaled fleet starts at the policy floor
            start_n = args.min_replicas if args.autoscale else args.replicas
            router = Router(lm, start_n, seed=args.seed, crash_at=crash_at,
                            autoscaler=autoscaler, faults=resolve_fault_plan(args.fault_plan),
                            **eng_kw)
            if adapter_reg:
                for n, ad in adapter_reg.items():
                    router.register_adapter(n, ad, adapter_cfg)
            if grammar_reg:
                for n, spec in grammar_reg.items():
                    router.register_grammar(n, **spec)
            report = run_router_trace(router, trace)
        if args.trace_out:
            router.tracer.export_chrome(args.trace_out)
        if args.metrics_out:
            router.metrics.dump(args.metrics_out)
        report.update(observability_report(router))
        if slos:
            report["slo"] = {f"replica{i}": eng.slo_status()
                             for i, eng in enumerate(router.engines)}
        report.update(model_keys)
        print(json.dumps(report))
        return report
    # every program the trace reaches (the slab's insert widths, the fused
    # block, the paged suffix widths of a warm run) built outside the
    # timed run, on the state the served engine then takes over
    if not lm.paged:
        _warm_slab_inserts(lm, {len(item["prompt"]) for item in trace})
    warm = ServeEngine(lm, block_steps=args.fused_steps, fused=fused,
                       prefill_chunk_tokens=args.prefill_chunk_tokens, seed=args.seed)
    for item in trace[: min(len(trace), lm.max_batch)]:
        warm.submit(item["prompt"], 2)
    warm.run()
    warm.close()
    engine = ServeEngine(lm, seed=args.seed, faults=resolve_fault_plan(args.fault_plan),
                         **eng_kw)
    if adapter_reg:
        for n, ad in adapter_reg.items():
            engine.register_adapter(n, ad, adapter_cfg)
    if grammar_reg:
        for n, spec in grammar_reg.items():
            engine.register_grammar(n, **spec)
    report = run_trace(engine, trace, snapshot_path=args.snapshot_path)
    export_observability(engine)
    report.update(observability_report(engine))
    report.update(model_keys)
    print(json.dumps(report))
    return report


def _full_logits(lm: CausalLM, ids: np.ndarray) -> np.ndarray:
    """The served model's logits at every position of ``ids`` (rows,
    bucket): the prefill forward of an insert over a fresh slab, its head
    over the whole bucket."""
    cache = lm.model.new_cache(ids.shape[0], lm.device)
    logits = lm._forward(torch.as_tensor(ids, device=lm.device), cache)
    return logits.float().cpu().numpy()


def cmd_check_accuracy(args, params=None, config=None) -> dict:
    """The serving stack's greedy stream and logits against a golden: the
    cache-free fp32 forward of the same weights (dequantized, or
    transformed), or with ``--hf_checkpoint`` the fp32 ``transformers``
    model. Exits 1 when the greedy tokens diverge."""
    from neuronx_distributed_tpu_torch.quantization.core import dequantize_params

    lm, cfg = build_model(args, params, config)
    lm.compile()
    rs = np.random.RandomState(args.seed)
    prompt_len = 16 if args.tiny else min(args.prompt_len, 128)
    prompt = rs.randint(1, cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    if lm.max_batch > 1:
        prompt = np.broadcast_to(prompt, (lm.max_batch, prompt_len)).copy()
    result = lm.generate(prompt, max_new_tokens=args.max_new_tokens,
                         sampler=Sampler(greedy=True), seed=0)
    served = np.asarray(result.tokens[0][: int(result.lengths[0])])
    full_seq = np.concatenate([prompt[0], served])

    if args.hf_checkpoint:
        from transformers import AutoModelForCausalLM

        hf_model = AutoModelForCausalLM.from_pretrained(args.hf_checkpoint,
                                                        torch_dtype=torch.float32)
        hf_model.eval()

        def golden_forward(ids_row: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                return hf_model(torch.from_numpy(ids_row[None]).long()).logits.numpy()[0]

        golden_name = "transformers_fp32"
    else:
        f32_cfg = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
        base = (lm.param_transform(lm._raw_params) if lm.param_transform
                else dequantize_params(lm.model.state_dict(), torch.float32))
        with torch.device("meta"):   # the served model's layout: its rank's shards
            golden = _model_cls(args)(f32_cfg, group=lm.tp_group)
        # fp32 tensors already on the device are bound as they are
        golden.load_state_dict({k: v.to(torch.float32) for k, v in base.items()},
                               strict=True, assign=True)
        golden.eval().requires_grad_(False)

        def golden_forward(ids_row: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                ids = torch.as_tensor(ids_row[None], device=lm.device)
                return lm._gather_vocab(golden(ids))[0].float().cpu().numpy()

        golden_name = "fp32"

    # one teacher-forced golden pass: while the prefixes agree it is the
    # golden's own greedy stream, so the match length reads off it
    golden_logits = golden_forward(full_seq)
    match_len = 0
    for k, tok in enumerate(served.tolist()):
        if int(np.argmax(golden_logits[prompt_len - 1 + k])) != tok:
            break
        match_len += 1
    diverged = match_len < len(served)
    # the served logits: the prefill of full_seq padded to its bucket at
    # max_batch rows, row 0's real positions only
    bucket = lm._bucket_for(len(full_seq))
    padded = np.zeros((lm.max_batch, bucket), np.int32)
    padded[:, : len(full_seq)] = full_seq
    served_logits = _full_logits(lm, padded)[0, : len(full_seq)]
    diff = np.abs(served_logits - golden_logits)
    argmax_mismatch = np.nonzero(served_logits.argmax(-1) != golden_logits.argmax(-1))[0]
    report = {
        "golden": golden_name,
        "prompt_len": int(prompt_len),
        "generated": len(served.tolist()),
        "greedy_match": not diverged,
        "match_len": match_len,
        "first_divergence": match_len if diverged else -1,
        "logit_max_abs_diff": round(float(diff.max()), 6),
        "logit_mean_abs_diff": round(float(diff.mean()), 6),
        "argmax_first_mismatch_pos": int(argmax_mismatch[0]) if argmax_mismatch.size else -1,
        "positions_checked": int(len(full_seq)),
    }
    print(json.dumps(report))
    if diverged:
        raise SystemExit(1)
    return report


COMMANDS = {"generate": cmd_generate, "benchmark": cmd_benchmark, "speculate": cmd_speculate,
            "medusa": cmd_medusa, "check-accuracy": cmd_check_accuracy, "serve": cmd_serve}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        p = sub.add_parser(name)
        p.add_argument("--tensor_parallel_size", "--tp", type=int, default=None)
        p.add_argument("--device", type=str, default=None,
                       help="torch device (default: cuda; cpu runs the kernels' plain twins)")
        p.add_argument("--tiny", action="store_true")
        p.add_argument("--hf_checkpoint", type=str, default=None)
        p.add_argument("--max_seq_len", type=int, default=4096)
        p.add_argument("--max_batch", type=int, default=1)
        p.add_argument("--max_new_tokens", type=int, default=32)
        p.add_argument("--prompt_len", type=int, default=2048)
        p.add_argument("--trials", type=int, default=10)
        p.add_argument("--decode_steps", type=int, default=50)
        p.add_argument("--sample", action="store_true",
                       help="sample with temperature/top_k/top_p (default greedy)")
        p.add_argument("--temperature", type=float, default=1.0)
        p.add_argument("--top_k", type=int, default=0)
        p.add_argument("--top_p", type=float, default=1.0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--num_draft", type=int, default=4)
        p.add_argument("--fused_chunk", type=int, default=0,
                       help="K>1: decode in K-step fused programs (one replay per K tokens)")
        p.add_argument("--fused_rounds", type=int, default=0,
                       help="speculate: R>0 runs R whole speculative rounds a program call "
                            "(speculative_decode_fused)")
        p.add_argument("--draft_layers", type=int, default=None)
        p.add_argument("--fused_steps", type=int, default=8,
                       help="serve: K decode steps a program call for the whole slot pool")
        p.add_argument("--stepwise", action="store_true",
                       help="serve: one token a program call (same schedule, same tokens)")
        p.add_argument("--async", dest="async_loop", action="store_true",
                       help="serve: pipeline the fused block loop (launch block t+1 before "
                            "reading block t; the same streams as the sync loop)")
        p.add_argument("--prefill_chunk_tokens", type=int, default=0,
                       help="serve: C>0 prefills prompts longer than C in C-token chunks "
                            "between decode blocks (the same streams)")
        p.add_argument("--long_prompt_frac", type=float, default=0.0,
                       help="serve: share of trace requests with a long prompt")
        p.add_argument("--long_prompt_len", type=int, default=0,
                       help="serve: prompt length of the long requests")
        p.add_argument("--num_requests", type=int, default=8,
                       help="serve: synthetic arrival-trace length")
        p.add_argument("--mean_interarrival", type=float, default=0.5,
                       help="serve: mean inter-arrival time in decode blocks (exponential)")
        p.add_argument("--paged", action="store_true",
                       help="serve: paged KV cache (page pool, block tables, prefix reuse)")
        p.add_argument("--page_size", type=int, default=16,
                       help="serve --paged: tokens a KV page (must divide max_seq_len)")
        p.add_argument("--page_pool_pages", type=int, default=0,
                       help="serve --paged: pool size in pages a layer (0 = slab parity)")
        p.add_argument("--paged-kernel", dest="paged_kernel", action="store_true",
                       help="serve: decode attention straight off the page pool through the "
                            "block tables (the paged decode kernel). Implies --paged.")
        p.add_argument("--kv_dtype", choices=["float32", "int8"], default=None,
                       help="serve: KV page storage dtype (int8: absmax per page x kv head, "
                            "fp32 scales). Implies --paged.")
        p.add_argument("--no_prefix_cache", action="store_true",
                       help="serve --paged: no radix prefix index")
        p.add_argument("--host_tier_bytes", type=int, default=0,
                       help="serve --paged: host-memory KV tier bytes (0 = twice the device "
                            "pool); --no_host_tier disables it")
        p.add_argument("--no_host_tier", action="store_true",
                       help="serve --paged: no host-memory KV tier")
        p.add_argument("--shared_prefix_len", type=int, default=0,
                       help="serve: one common random prefix of this many tokens before "
                            "every trace prompt")
        p.add_argument("--prefix_families", type=int, default=1,
                       help="serve: rotate through this many shared prefixes in runs of "
                            "four requests")
        p.add_argument("--ttft_deadline_ms", type=float, default=None,
                       help="serve: first-token deadline after arrival")
        p.add_argument("--deadline_ms", type=float, default=None,
                       help="serve: completion deadline (a late stream retires expired)")
        p.add_argument("--block_time_ms", type=float, default=1.0,
                       help="serve: ms of deadline budget one decode block takes")
        p.add_argument("--max_queue", type=int, default=None,
                       help="serve: bound of the arrived backlog (overflow is shed)")
        p.add_argument("--shed_policy", choices=["tail", "deadline"], default="tail",
                       help="serve: overflow victim (tail = newest, deadline = laxest)")
        p.add_argument("--snapshot_path", type=str, default=None,
                       help="serve: crash-recovery snapshot file, written every few blocks "
                            "and removed on a clean drain; if it exists at startup the "
                            "previous run's streams are restored and finished")
        p.add_argument("--park-idle-blocks", "--park_idle_blocks", dest="park_idle_blocks",
                       type=int, default=0,
                       help="serve: park a conversation idle this many blocks to --park-dir "
                            "(0 = explicit park() only)")
        p.add_argument("--park-dir", "--park_dir", dest="park_dir", type=str, default=None,
                       help="serve: directory of the durable conversation tier")
        p.add_argument("--replicas", type=int, default=1,
                       help="serve: N>1 replicas behind the Router over one model")
        p.add_argument("--disagg", action="store_true",
                       help="serve --replicas N --paged: prefill and decode workers with "
                            "checksummed KV handoffs")
        p.add_argument("--prefill_replicas", type=int, default=1,
                       help="serve --disagg: how many replicas prefill")
        p.add_argument("--autoscale", action="store_true",
                       help="serve: the SLO-driven autoscaler in the router loop")
        p.add_argument("--min_replicas", type=int, default=1,
                       help="serve --autoscale: fleet floor")
        p.add_argument("--max_replicas", type=int, default=0,
                       help="serve --autoscale: fleet ceiling (0 = max(--replicas, "
                            "--min_replicas + 1))")
        p.add_argument("--scale_slo_ms", type=float, default=None,
                       help="serve --autoscale: a TTFT objective whose burn alerts scale up")
        p.add_argument("--scale_up_backlog", type=float, default=1.0,
                       help="serve --autoscale: weighted backlog (blocks a live replica) "
                            "above which the fleet scales up")
        p.add_argument("--scale_patience_blocks", type=int, default=2,
                       help="serve --autoscale: over-threshold blocks before a scale-up")
        p.add_argument("--scale_down_util", type=float, default=0.4,
                       help="serve --autoscale: utilization below which the pool is "
                            "oversized")
        p.add_argument("--scale_down_idle_blocks", type=int, default=8,
                       help="serve --autoscale: low-utilization blocks before a scale-down")
        p.add_argument("--scale_cooldown_blocks", type=int, default=8,
                       help="serve --autoscale: least blocks between a pool's scale events")
        p.add_argument("--diurnal", type=float, default=0.0,
                       help="serve: diurnal arrival-rate amplitude in [0, 1)")
        p.add_argument("--diurnal_period_blocks", type=int, default=64,
                       help="serve --diurnal: day length in blocks")
        p.add_argument("--burst_every", type=int, default=0,
                       help="serve: every this many blocks the first quarter arrives "
                            "--burst_mult times faster")
        p.add_argument("--burst_mult", type=float, default=4.0,
                       help="serve --burst_every: burst rate multiplier")
        p.add_argument("--tenants", type=int, default=0,
                       help="serve: Zipf-skewed tenant labels (a per-tenant table)")
        p.add_argument("--tenant_skew", type=float, default=1.0,
                       help="serve --tenants: Zipf exponent (0 = uniform)")
        p.add_argument("--adapters", type=int, default=0,
                       help="serve: N>0 demo LoRA adapters served from one base model")
        p.add_argument("--adapter_rank", type=int, default=8,
                       help="serve --adapters: LoRA rank of the demo adapters")
        p.add_argument("--adapter_pool_slots", type=int, default=0,
                       help="serve --adapters: pool slots incl. the identity (0 = adapters+1)")
        p.add_argument("--adapter_skew", type=float, default=1.0,
                       help="serve --adapters: Zipf exponent of adapter popularity")
        p.add_argument("--grammar_frac", type=float, default=0.0,
                       help="serve: share of trace requests under demo grammars")
        p.add_argument("--grammars", type=int, default=3,
                       help="serve --grammar_frac: how many demo grammars")
        p.add_argument("--grammar_pool_slots", type=int, default=0,
                       help="serve --grammar_frac: pool slots incl. the identity "
                            "(0 = grammars+1)")
        p.add_argument("--grammar_states", type=int, default=96,
                       help="serve --grammar_frac: padded DFA states a pool slot")
        p.add_argument("--crash_replica_at", type=int, default=None,
                       help="serve --replicas: crash the last replica at this router block")
        p.add_argument("--trace_out", type=str, default=None,
                       help="serve: write the Chrome trace-event JSON here after the run "
                            "(turns tracing on)")
        p.add_argument("--metrics_out", type=str, default=None,
                       help="serve: write the metrics registry here (Prometheus text; a "
                            ".json path writes the JSON snapshot)")
        p.add_argument("--incident_dir", type=str, default=None,
                       help="serve: the incident flight recorder's bundle directory "
                            "(turns tracing on)")
        p.add_argument("--slo_ttft_ms", type=float, default=None,
                       help="serve: TTFT objective in wall ms")
        p.add_argument("--slo_itl_ms", type=float, default=None,
                       help="serve: inter-token latency objective in wall ms")
        p.add_argument("--slo_target", type=float, default=0.95,
                       help="serve: required good share of the SLO objectives")
        p.add_argument("--fault_plan", type=str, default=None,
                       help="serve: seeded chaos plan (a JSON object or a path to one)")
        p.add_argument("--quantize", action="store_true",
                       help="serve int8 weight-only quantized params")
        p.add_argument("--model", choices=["llama", "mixtral", "dbrx"], default="llama")
    return parser.parse_args(argv)


def main(argv=None, params: Optional[Mapping[str, Any]] = None, config=None):
    """Run one subcommand; returns its report (a list of streams for
    ``generate``). ``params``/``config``: see :func:`build_model` (for
    ``medusa``: the ``MedusaLlamaForCausalLM`` state dict)."""
    args = parse_args(argv)
    return COMMANDS[args.cmd](args, params=params, config=config)


if __name__ == "__main__":
    main()
