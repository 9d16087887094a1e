"""Serving: paged KV cache and host tier, samplers, the causal-LM runtime,
the engine, the replica fleet (router, prefill/decode disaggregation,
autoscaling), fault plans, the host-only sim model, shape-routed program
bundles, speculative decoding and Medusa tree decoding.

Submodules load on first attribute access, as in the package root."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "AutoscalePolicy": "autoscale",
    "Autoscaler": "autoscale",
    "CausalLM": "causal_lm",
    "DecodeSession": "causal_lm",
    "GenerationResult": "causal_lm",
    "DisaggRouter": "disagg",
    "KVHandoff": "disagg",
    "run_disagg_trace": "disagg",
    "Completion": "engine",
    "Rejected": "engine",
    "Request": "engine",
    "ServeEngine": "engine",
    "run_trace": "engine",
    "DispatchFailed": "faults",
    "FaultInjector": "faults",
    "FaultPlan": "faults",
    "TransientDispatchError": "faults",
    "PageAllocator": "paged_cache",
    "PagedKVCache": "paged_cache",
    "PagePoolExhausted": "paged_cache",
    "RadixPrefixIndex": "paged_cache",
    "NoLiveReplicas": "router",
    "Router": "router",
    "run_router_trace": "router",
    "PendingQueue": "schedq",
    "MedusaLlamaForCausalLM": "medusa",
    "medusa_generate": "medusa",
    "medusa_model": "medusa",
    "ModelBuilder": "model_builder",
    "NxDModel": "model_builder",
    "speculative_decode_fused": "speculative",
    "speculative_generate": "speculative",
    "Sampler": "sampling",
    "SlotSampler": "sampling",
    "SimCausalLM": "simlm",
    "synthetic_trace": "trace",
    "synthetic_trace_stream": "trace",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
