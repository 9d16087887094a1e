"""Tenants on one pool in the port's ``ServeEngine``: multi-LoRA adapters
and grammar-constrained streams, held against the JAX engine.

- The port engine against the JAX engine's synchronous loop on one
  synthetic trace whose requests carry adapters, grammars or both: the
  same greedy tokens, finish reasons, rejections (with their reasons) and
  adapter/grammar event names; the port's fused, stepwise, paged and
  pipelined engines agree with it (the pipelined loop on every stream it
  shares with the synchronous one: a grammar that ends a stream, like an
  EOS, retires it a block later there);
- adapter streams equal the streams of a model whose weights carry the
  adapter merged (``merge_lora``), and slot-0 rows beside adapter and
  grammar rows equal a ``CausalLM`` built without LoRA and grammars, bit
  for bit;
- the ``adapter`` and ``grammar`` fault seams: the same plan makes the
  same faults, repairs, retries and streams as in the JAX engine;
- a JAX version-1 snapshot taken mid-stream under an adapter and a grammar
  resumes in the port with the JAX tokens; the port's own snapshot round
  trips;
- chunked prefill under an adapter or a grammar equals one-shot; the radix
  prefix index is namespaced by adapter (no cross-adapter hit, same-adapter
  reuse kept, ``invalidate_tokens`` on ``(ns, token)`` keys);
- a full pool sheds with ``adapter_pool_exhausted``; the trace's adapter
  and grammar labels are JAX's draw for draw; ``run_trace`` carries the
  JAX report's tenancy keys.

Tiny model: 2 layers, hidden 32, 3 slots, rank-4 pool of 3 slots (two
usable for three adapters: they churn), grammar pool of 3 slots, K = 4, fp32.
"""

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.inference.faults import FaultPlan as JaxPlan
from neuronx_distributed_tpu.lora import core as jlora
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    lora_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
from neuronx_distributed_tpu_torch.inference.grammar import default_token_table, detokenize
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.lora import LoraConfig, merge_lora
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
TENANCY = dict(lora_rank=4, lora_slots=3, grammar_slots=3, grammar_states=48)
K = 4
JCFG = jlora.LoraConfig(r=4, lora_alpha=8.0)
TCFG = LoraConfig(r=4, lora_alpha=8.0)
TABLE = default_token_table(128)
SPECS = {"gnum": {"regex": "-?[0-9]{1,3}"}, "gab": {"regex": "a[ab]*b"},
         "gjson": {"json_schema": {"type": "object", "properties": {
             "a": {"type": "integer"}, "ok": {"type": "boolean"}}}}}
REGEX = {"gnum": "-?[0-9]{1,3}", "gab": "a[ab]*b",
         "gjson": '\\{"a":-?(0|[1-9][0-9]*),"ok":(true|false)\\}'}
TRACES = {"adapters": dict(adapters=3), "grammars": dict(grammar_frac=0.6, grammars=tuple(SPECS)),
          "both": dict(adapters=3, grammar_frac=0.5, grammars=tuple(SPECS))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_adapter(params, i):
    """JAX ``init_lora`` with a nonzero, adapter-distinct B (as
    ``tests/test_multilora.py`` makes its adapters)."""
    ad = jlora.init_lora(params, JCFG, jax.random.key(10 + i))
    return {k: {"lora_a": np.asarray(v["lora_a"]),
                "lora_b": np.asarray(0.05 * jax.random.normal(
                    jax.random.fold_in(jax.random.key(20 + i), j), v["lora_b"].shape))}
            for j, (k, v) in enumerate(sorted(ad.items()))}


@pytest.fixture(scope="module")
def stack():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    sd = llama_params_from_jax(params)
    jad = {f"a{i}": _jax_adapter(params, i) for i in range(3)}
    tad = {n: lora_params_from_jax(a, TCFG) for n, a in jad.items()}

    def port(weights=sd, **kw):
        return CausalLM(tcfg, weights, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    return {"contig": port(**TENANCY), "paged": port(page_size=4, **TENANCY), "plain": port(),
            "merged": {n: port(merge_lora(sd, tad[n], TCFG)) for n in ("a0", "a1")},
            "jax": JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM, **TENANCY).compile(),
            "jad": jad, "tad": tad}


def _trace(variant, n=10, seed=10):
    return synthetic_trace(n, 128, prompt_lens=(6, 9, 12), max_new_tokens=24,
                           mean_interarrival_blocks=0.7, seed=seed, **TRACES[variant])


def _register(eng, stack, jax_side=False):
    if getattr(eng.lm, "lora", False):
        for name in ("a0", "a1", "a2"):
            eng.register_adapter(name, stack["jad" if jax_side else "tad"][name],
                                 JCFG if jax_side else TCFG)
    if getattr(eng.lm, "grammar", False):
        for name, spec in SPECS.items():
            eng.register_grammar(name, **spec)


def _serve(stack, lm_key, trace, jax_side=False, faults=None, **kw):
    """Serve ``trace`` (every item submitted up front) and read back what
    the comparison needs."""
    if jax_side:
        eng = JaxEngine(stack["jax"], block_steps=K, rng=jax.random.key(42), trace=True,
                        faults=None if faults is None else JaxPlan(**faults), **kw)
    else:
        eng = ServeEngine(stack[lm_key], block_steps=K, seed=42, trace=True,
                          faults=None if faults is None else FaultPlan(**faults), **kw)
    _register(eng, stack, jax_side)
    for it in trace:
        eng.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"],
                   adapter=it.get("adapter"), grammar=it.get("grammar"))
    done = eng.run()
    names = collections.Counter(
        ev["name"] for ev in eng.tracer.events()
        if ev["name"] == "shed" or "adapter" in ev["name"] or "grammar" in ev["name"])
    return dict(eng=eng, streams={c.request_id: c.tokens.tolist() for c in done},
                reasons={c.request_id: c.finish_reason for c in done},
                rejected=sorted((r.request_id, r.reason) for r in eng.rejected), names=names)


def _pool_counts(eng, jax_side):
    out = {}
    for kind in ("adapter", "grammar"):
        pool = getattr(eng.session, kind + "s")
        for k in ("loads", "hits", "evictions", "repairs", "load_failures"):
            out[f"{kind}_{k}"] = pool.stats[k] if jax_side else getattr(pool, k)
        for k in ("rejects", "load_retries"):
            out[f"{kind}_{k}"] = (int(eng.stats[f"{kind}_{k}"]) if jax_side
                                  else getattr(eng, f"{kind}_{k}"))
    return out


def _assert_parses(trace, res):
    for rid, it in enumerate(trace):
        if it.get("grammar") is not None and rid in res["streams"]:
            text = detokenize(res["streams"][rid], TABLE)
            assert re.fullmatch(REGEX[it["grammar"]], text), (rid, it["grammar"], text)


@pytest.mark.parametrize("variant", sorted(TRACES))
def test_engine_matches_the_jax_engine(stack, variant):
    trace = _trace(variant)
    ref = _serve(stack, None, trace, jax_side=True)
    assert ref["streams"], "the JAX engine completed nothing"
    for lm_key, kw in (("contig", {}), ("paged", {}), ("contig", dict(fused=False))):
        got = _serve(stack, lm_key, trace, **kw)
        for key in ("streams", "reasons", "rejected", "names"):
            assert got[key] == ref[key], (lm_key, kw, key)
        assert _pool_counts(got["eng"], False) == _pool_counts(ref["eng"], True), (lm_key, kw)
    _assert_parses(trace, ref)
    # the trace churns both pools and fills the adapter pool
    counts = _pool_counts(ref["eng"], True)
    if variant != "adapters":
        assert {"grammar_accept", "budget"} <= set(ref["reasons"].values())
        assert counts["grammar_evictions"] >= 1
    if variant != "grammars":
        assert counts["adapter_evictions"] >= 1 and counts["adapter_rejects"] >= 1
    sync = _serve(stack, "paged", trace)
    asy = _serve(stack, "paged", trace, async_loop=True)
    shared = set(sync["streams"]) & set(asy["streams"])
    assert len(shared) >= len(trace) // 2
    assert all(asy["streams"][r] == sync["streams"][r] for r in shared)
    _assert_parses(trace, asy)
    if variant == "adapters":   # no stream ends early: the same schedule
        for key in ("streams", "reasons", "rejected"):
            assert asy[key] == sync[key], key


def test_adapter_streams_equal_merged_weights_and_base_rows_the_plain_lm(stack):
    """Greedy streams under a0 and a1 out of a mixed pool (a2 churning in)
    equal their merged models' solo ``generate``; the base request beside
    them, and a free request beside a grammar row, equal a ``CausalLM``
    without LoRA or grammars, bit for bit."""
    p = np.random.default_rng(5).integers(1, 127, (4, 8)).astype(np.int32)
    submits = [dict(prompt=p[0], max_new_tokens=6, adapter="a0"),
               dict(prompt=p[1], max_new_tokens=5, adapter="a1", arrival_block=1),
               dict(prompt=p[2], max_new_tokens=6),
               dict(prompt=p[3], max_new_tokens=7, adapter="a2", grammar="gab", arrival_block=6)]
    eng = ServeEngine(stack["contig"], block_steps=K, seed=42)
    _register(eng, stack)
    rids = [eng.submit(**s) for s in submits]
    comps = {c.request_id: c.tokens.tolist() for c in eng.run()}
    assert eng.session.adapters.evictions >= 1 and eng.adapter_rejects == 0
    for i, name in ((0, "a0"), (1, "a1")):
        g = stack["merged"][name].generate(p[i:i + 1], max_new_tokens=submits[i]["max_new_tokens"])
        assert comps[rids[i]] == g.tokens[0].tolist(), name
    plain = ServeEngine(stack["plain"], block_steps=K, seed=42)
    rid = plain.submit(p[2], 6, request_id=rids[2])
    assert {c.request_id: c.tokens.tolist() for c in plain.run()}[rid] == comps[rids[2]]
    assert re.fullmatch(REGEX["gab"], detokenize(comps[rids[3]], TABLE))


@pytest.mark.parametrize("seam", ["adapter", "grammar"])
def test_fault_seams_match_jax(stack, seam):
    """Injected load failures requeue and retry, corrupted slots are caught
    by the acquire-time check and repaired: the same faults, repairs,
    retries and streams as the JAX engine under the same plan, and the
    streams of the run without faults."""
    trace = _trace("both", seed=5)
    plan = {f"{seam}_load_fail_prob": 0.3, f"{seam}_corrupt_prob": 0.3, "seed": 1}
    ref = _serve(stack, None, trace, jax_side=True, faults=plan)
    got = _serve(stack, "paged", trace, faults=plan)
    clean = _serve(stack, "paged", trace)
    stats = dict(ref["eng"]._injector.stats)
    assert dict(got["eng"]._injector.stats) == stats
    assert stats[f"{seam}_load_faults"] >= 1 and stats[f"{seam}_corruptions"] >= 1
    counts = _pool_counts(got["eng"], False)
    assert counts == _pool_counts(ref["eng"], True)
    # every garbled slot is repaired before its pin (a verdict drawn for an
    # acquire the full pool then refuses garbles nothing)
    garbled = getattr(got["eng"].session, seam + "s").garbled
    assert counts[f"{seam}_repairs"] == garbled >= 1
    assert garbled <= stats[f"{seam}_corruptions"]
    assert counts[f"{seam}_load_retries"] == stats[f"{seam}_load_faults"]
    assert got["streams"] == ref["streams"]
    shared = set(got["streams"]) & set(clean["streams"])
    assert all(got["streams"][r] == clean["streams"][r] for r in shared)


def test_jax_snapshot_with_adapter_and_grammar_resumes_in_the_port(stack):
    """A JAX version-1 snapshot taken mid-stream (a request decoding under
    an adapter and a grammar) restored by the port finishes every stream
    with the uninterrupted JAX run's tokens; the port's own snapshot of the
    same run, through JSON, does too."""
    import json

    trace = _trace("both", n=6, seed=9)
    oracle = _serve(stack, None, trace, jax_side=True)["streams"]
    src = JaxEngine(stack["jax"], block_steps=K, rng=jax.random.key(42))
    _register(src, stack, jax_side=True)
    for it in trace:
        src.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"],
                   adapter=it.get("adapter"), grammar=it.get("grammar"))
    src.run(max_blocks=4)
    snap = json.loads(json.dumps(src.snapshot()))
    assert any(r["adapter"] and r["grammar"] and r["state"] == "decoding" and r["generated"]
               for r in snap["requests"]), "no stream mid-way under an adapter and a grammar"
    adapters = {n: (a, TCFG) for n, a in stack["tad"].items()}
    done = {c.request_id: c.tokens.tolist() for c in src.completed}
    for lm_key in ("contig", "paged"):
        eng = ServeEngine.from_snapshot(stack[lm_key], snap, adapters=adapters, grammars=SPECS)
        assert eng.restored_requests == len(snap["requests"])
        assert {**done, **{c.request_id: c.tokens.tolist() for c in eng.run()}} == oracle
    port = ServeEngine(stack["paged"], block_steps=K, seed=42)
    _register(port, stack)
    for it in trace:
        port.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"],
                    adapter=it.get("adapter"), grammar=it.get("grammar"))
    port.run(max_blocks=4)
    psnap = json.loads(json.dumps(port.snapshot()))
    assert [(r["adapter"], r["grammar"], r["grammar_state"]) for r in psnap["requests"]] == \
        [(r["adapter"], r["grammar"], r["grammar_state"]) for r in snap["requests"]]
    eng = ServeEngine.from_snapshot(stack["contig"], psnap, adapters=adapters, grammars=SPECS)
    pdone = {c.request_id: c.tokens.tolist() for c in port.completed}
    assert {**pdone, **{c.request_id: c.tokens.tolist() for c in eng.run()}} == oracle


@pytest.mark.parametrize("tenancy", [dict(adapter="a1"), dict(grammar="gab"),
                                     dict(adapter="a2", grammar="gjson")])
def test_chunked_prefill_under_tenancy_equals_one_shot(stack, tenancy):
    prompt = np.random.default_rng(9).integers(1, 127, (16,)).astype(np.int32)

    def run_one(chunk):
        eng = ServeEngine(stack["paged"], block_steps=K, seed=3, prefill_chunk_tokens=chunk)
        _register(eng, stack)
        rid = eng.submit(prompt, 24, **tenancy)
        return eng, {c.request_id: c.tokens.tolist() for c in eng.run()}[rid]

    eng, chunked = run_one(4)
    assert eng.chunk_program_calls >= 4
    assert chunked == run_one(0)[1]


def test_prefix_reuse_is_adapter_namespaced(stack):
    """A prefix planted by base traffic is not reused under an adapter
    (JAX ``test_multilora.py:349``); the same adapter reuses its own;
    ``invalidate_tokens`` drops a namespaced path by its ``(ns, token)``
    keys and leaves the base path."""
    rng = np.random.default_rng(31)
    prefix, tails = rng.integers(1, 127, (12,)), rng.integers(1, 127, (3, 4))

    def solo(adapter, rid, tail):
        eng = ServeEngine(stack["paged"], block_steps=K, seed=7)
        _register(eng, stack)
        eng.submit(np.concatenate([prefix, tail]), 6, adapter=adapter, request_id=rid)
        return eng.run()[0].tokens.tolist()

    eng = ServeEngine(stack["paged"], block_steps=K, seed=7)
    _register(eng, stack)
    pkv = eng.session.paged
    eng.submit(np.concatenate([prefix, tails[0]]), 6)
    eng.run()
    r1 = eng.submit(np.concatenate([prefix, tails[1]]), 6, adapter="a0")
    eng.run()
    assert pkv.prefix_hits == 0
    r2 = eng.submit(np.concatenate([prefix, tails[2]]), 6, adapter="a0")
    eng.run()
    assert pkv.prefix_hits == 1 and pkv.prefix_hit_tokens > 0
    comps = {c.request_id: c.tokens.tolist() for c in eng.completed}
    assert comps[r1] == solo("a0", r1, tails[1]) and comps[r2] == solo("a0", r2, tails[2])
    full = np.concatenate([prefix, tails[2]]).tolist()
    assert pkv.prefix_peek(full, ns="a0") > 0 and pkv.prefix_peek(full, ns="a1") == 0
    assert pkv.prefix.invalidate_tokens([("a0", int(t)) for t in full]) > 0
    assert pkv.prefix_peek(full, ns="a0") == 0 and pkv.prefix_peek(full) > 0
    assert pkv.prefix.invalidate_tokens([("a0", int(t)) for t in full]) == 0


def test_full_pool_sheds_with_a_retry_after(stack):
    """Two usable slots pinned by live streams: the third adapter's
    admission is shed with ``adapter_pool_exhausted``, as in the JAX
    engine; the same request admits once the pins are back."""
    p = np.random.default_rng(5).integers(1, 127, (3, 8)).astype(np.int32)
    for jax_side in (False, True):
        eng = (JaxEngine(stack["jax"], block_steps=K, rng=jax.random.key(42)) if jax_side
               else ServeEngine(stack["contig"], block_steps=K, seed=42))
        _register(eng, stack, jax_side)
        rids = [eng.submit(p[i], 4, adapter=f"a{i}") for i in range(3)]
        assert len(eng.run()) == 2 and len(eng.rejected) == 1
        rej = eng.rejected[0]
        assert rej.reason == "adapter_pool_exhausted" and rej.retry_after_blocks >= 1
        if jax_side:
            assert (rej.request_id, rej.retry_after_blocks) == want
        else:
            want = (rej.request_id, rej.retry_after_blocks)
            assert eng.adapter_rejects == 1
            victim = rids.index(rej.request_id)
            again = ServeEngine(stack["contig"], block_steps=K, seed=42)
            _register(again, stack)
            rid = again.submit(p[victim], 4, adapter=f"a{victim}")
            assert len({c.request_id: c for c in again.run()}[rid].tokens) == 4


@pytest.mark.parametrize("variant", sorted(TRACES))
def test_trace_labels_draw_as_jax(variant):
    kw = dict(prompt_lens=(5, 7), tenants=2, seed=4, **TRACES[variant])
    mine, ref = synthetic_trace(16, 128, **kw), jax_trace(16, 128, **kw)
    for a, b in zip(mine, ref):
        assert np.array_equal(a["prompt"], b["prompt"])
        for key in ("arrival_block", "tenant", "adapter", "grammar"):
            assert a.get(key) == b.get(key)
    base = synthetic_trace(16, 128, prompt_lens=(5, 7), tenants=2, seed=4)
    assert all(np.array_equal(a["prompt"], b["prompt"]) and a["tenant"] == b["tenant"]
               for a, b in zip(mine, base))


def test_run_trace_reports_the_jax_tenancy_keys(stack):
    trace = _trace("both", n=6)
    eng = ServeEngine(stack["paged"], block_steps=K, seed=42)
    _register(eng, stack)
    rep = run_trace(eng, trace)
    jeng = JaxEngine(stack["jax"], block_steps=K, rng=jax.random.key(42))
    _register(jeng, stack, jax_side=True)
    from neuronx_distributed_tpu.inference.engine import run_trace as jax_run_trace

    jrep = jax_run_trace(jeng, trace)
    for key in ("multilora", "adapter_slots", "adapters_resident", "adapter_loads",
                "adapter_evictions", "adapter_hits", "adapter_repairs", "adapter_rejects",
                "adapter_load_retries", "adapter_bytes_per_slot"):
        assert rep[key] == jrep[key], key
    s, js = rep["structured"], jrep["structured"]
    assert set(s) == set(js)
    for key in ("constrained_requests", "finish_reasons", "grammars_resident", "grammar_loads",
                "grammar_bytes_per_slot", "grammar_rejects"):
        assert s[key] == js[key], key
