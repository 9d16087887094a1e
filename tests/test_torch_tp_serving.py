"""Tensor-parallel serving in the port, held against the JAX package's TP=2
CPU mesh and against the port at TP=1 (the counterparts of
``tests/test_tp_serving.py:131, 144, 162, 189, 232``).

The port's TP=2 world is two threads in this process, each a rank over one
gloo group (``parallel.mesh.run_in_threads``); each rank builds its own
``CausalLM`` on its shard of the seeded weights and runs the same engine.
The JAX oracle runs once per module inside its own TP=2 world (the
autouse fixture tears the JAX mesh down after every test).

- paged + multi-LoRA + grammar + sampled streams at TP=2, fused and
  stepwise, equal the port at TP=1 token for token, and the greedy ones
  equal JAX at TP=2; the logits agree with both within 1e-5 (fp32);
- the capacity halving: per-rank KV bytes at most 0.55 x TP=1's,
  ``kv_bytes_global`` = TP=1's ``kv_bytes``, ``kv_page_bytes_host() == 2
  * kv_page_bytes()``;
- the disagg handoff at TP=2 equals the TP=1 oracle; a JAX TP=2 handoff
  carries full-width pages whose crc32s the port's seal reproduces, and a
  port TP=2 decode worker adopts it and decodes JAX's greedy stream;
- the async loop equals the sync loop at TP=2;
- the spec derivation equals JAX's ``leaf_partition_spec`` leaf for leaf;
- every rank makes the same decisions and streams; a foreign
  ``tp_degree`` degrades a resume and an adoption; ``run_trace`` reports
  the degree and the per-rank against global KV bytes.

Tiny model: 2 layers, hidden 32, 4 heads, 2 KV heads, vocab 128, pages of
4, K = 4, fp32. One intra-op thread.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.partition import leaf_partition_spec as jax_spec
from neuronx_distributed_tpu.lora import LoraConfig as JaxLoraConfig
from neuronx_distributed_tpu.lora import init_lora
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as psm
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model,
    neuronx_distributed_config,
)
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    lora_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference import (
    CausalLM,
    DisaggRouter,
    KVHandoff,
    Sampler,
    ServeEngine,
    run_trace,
    synthetic_trace,
)
from neuronx_distributed_tpu_torch.inference.partition import leaf_partition_spec, tp_degree
from neuronx_distributed_tpu_torch.lora import LoraConfig
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import mesh

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
K = 4
PAGE = 4
TENANCY = dict(lora_rank=4, lora_slots=3, grammar_slots=3, grammar_states=48)
LM = dict(buckets=(8, 16), max_batch=3, page_size=PAGE)
JCFG = JaxLoraConfig(r=4, lora_alpha=8.0)
TCFG = LoraConfig(r=4, lora_alpha=8.0)
SPECS = {"gnum": {"regex": "-?[0-9]{1,3}"}, "gab": {"regex": "a[ab]*b"}}
ATOL = 1e-5   # fp32 logits: the row-parallel all-reduce sums in another order


def _prompts(n, s=8, seed=5):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


P = _prompts(4)
# greedy rows of every kind (plain, adapter, grammar, both): the JAX oracle's
GREEDY = [dict(prompt=P[0], max_new_tokens=8),
          dict(prompt=P[1], max_new_tokens=6, adapter="a0", arrival_block=1),
          dict(prompt=P[2], max_new_tokens=6, grammar="gnum"),
          dict(prompt=P[3], max_new_tokens=7, grammar="gab", adapter="a1", arrival_block=2)]
# the JAX test's matrix: greedy and sampled rows side by side
MIXED = [dict(prompt=P[0], max_new_tokens=8),
         dict(prompt=P[1], max_new_tokens=6, sampler=Sampler(temperature=0.9), adapter="a0",
              arrival_block=1),
         dict(prompt=P[2], max_new_tokens=6, grammar="gnum"),
         dict(prompt=P[3], max_new_tokens=7, grammar="gab", sampler=Sampler(temperature=1.2),
              adapter="a1", arrival_block=2)]
HANDOFF_PROMPT = _prompts(1, s=13, seed=71)[0]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_adapter(params, i):
    ad = init_lora(params, JCFG, jax.random.key(10 + i))
    return {k: {"lora_a": np.asarray(v["lora_a"]),
                "lora_b": np.asarray(0.05 * jax.random.normal(
                    jax.random.fold_in(jax.random.key(20 + i), j), v["lora_b"].shape))}
            for j, (k, v) in enumerate(sorted(ad.items()))}


def _first_handoff(eng):
    while not eng.outbox:
        assert eng.step_block() or eng.outbox
    return eng.outbox[0]


@pytest.fixture(scope="module")
def oracle():
    """The JAX package at TP=2 on its CPU mesh, run once: the weights (the
    trainer's seed-0 init, value-identical at every degree), the adapters,
    the greedy streams, the logits of an insert and a step, a sealed
    handoff and its prompt's greedy stream, and the serving trees' leaf
    shapes for the spec derivation."""
    psm.destroy_model_parallel()
    psm.initialize_model_parallel(tensor_model_parallel_size=2)
    try:
        jcfg = jl.LlamaConfig(**TINY, kv_size_multiplier=1, dtype=jnp.float32,
                              remat_policy=None)
        nxd = neuronx_distributed_config(tensor_parallel_size=2)
        model = initialize_parallel_model(nxd, lambda: jl.LlamaForCausalLM(jcfg),
                                          jnp.zeros((1, 8), jnp.int32))
        params = jax.tree_util.tree_map(np.asarray, model.params)
        jlm = JaxLM(jcfg, model.params, jl.LlamaForCausalLM, **LM, **TENANCY).compile()
        ads = {f"a{i}": _jax_adapter(params, i) for i in range(2)}
        eng = JaxEngine(jlm, block_steps=K, rng=jax.random.key(42))
        for name, spec in SPECS.items():
            eng.register_grammar(name, **spec)
        for name, ad in ads.items():
            eng.register_adapter(name, ad, JCFG)
        for kw in GREEDY:
            eng.submit(**kw)
        eng.run()
        streams = {c.request_id: c.tokens.tolist() for c in eng.completed}
        sess = jlm.start_session()
        ins = np.asarray(jlm.insert(sess, np.arange(2), P[:2]))
        step = np.asarray(jlm.step(sess, np.asarray([5, 9, 0], np.int32)))[:2]
        pre = JaxEngine(jlm, block_steps=K, rng=jax.random.key(42), role="prefill")
        pre.submit(HANDOFF_PROMPT, 10)
        h = _first_handoff(pre)
        whole = JaxEngine(jlm, block_steps=K, rng=jax.random.key(42))
        whole.submit(HANDOFF_PROMPT, 10)
        whole.run()
        leaves = []
        for tree in (jlm._cache_avals(), jlm._identity_adapters(), jlm._identity_grammars()):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                p = jax.tree_util.keystr(path)
                leaves.append((p, tuple(leaf.shape), tuple(jax_spec(p, leaf.shape, 2))))
        return {"params": params, "ads": ads, "streams": streams, "insert": ins, "step": step,
                "handoff": h, "handoff_stream": whole.completed[0].tokens.tolist(),
                "leaves": leaves}
    finally:
        psm.destroy_model_parallel()


def _tcfg():
    return tl.LlamaConfig(**TINY, dtype=torch.float32)


def _lm(oracle, rank=0, tp=1, **kw):
    sd = llama_params_from_jax(oracle["params"], tp_rank=rank, tp_size=tp)
    return CausalLM(_tcfg(), sd, tl.LlamaForCausalLM, device="cpu", **{**LM, **TENANCY, **kw})


def _serve(lm, oracle, submits, **kw):
    eng = ServeEngine(lm, block_steps=K, seed=42, **kw)
    for name, spec in SPECS.items():
        eng.register_grammar(name, **spec)
    for name, ad in oracle["ads"].items():
        eng.register_adapter(name, lora_params_from_jax(ad, TCFG), TCFG)
    for s in submits:
        eng.submit(**s)
    eng.run()
    out = {c.request_id: c.tokens.tolist() for c in eng.completed}
    return out, eng


def _tp2(fn):
    return mesh.run_in_threads(2, fn)


# ------------------------------------------------ the exactness matrix

@pytest.mark.parametrize("fused", [True, False])
def test_tp2_streams_bit_identical_fused_and_stepwise(oracle, fused):
    """TP=2 paged + multi-LoRA + grammar streams, greedy and sampled, equal
    TP=1 token for token; the greedy ones equal JAX at TP=2."""
    ref, _ = _serve(_lm(oracle), oracle, MIXED, fused=fused)
    got = _tp2(lambda r: _serve(_lm(oracle, r, 2), oracle, MIXED, fused=fused)[0])
    assert got[0] == got[1] == ref
    greedy = _tp2(lambda r: _serve(_lm(oracle, r, 2), oracle, GREEDY, fused=fused)[0])
    assert greedy[0] == greedy[1] == oracle["streams"]


def test_tp2_logits_match_tp1_and_jax(oracle):
    """The next-token logits of an insert and a decode step at TP=2 (each
    rank gathers the full vocabulary) agree with TP=1 and with JAX's TP=2
    mesh within ``ATOL``."""
    def run(rank, tp):
        lm = _lm(oracle, rank, tp)
        sess = lm.start_session()
        ins = lm.insert(sess, np.arange(2), P[:2]).numpy()
        step = lm.step(sess, np.asarray([5, 9, 0], np.int32))[:2].numpy()
        return ins, step

    one = run(0, 1)
    for ins, step in _tp2(lambda r: run(r, 2)):
        for got, want, jax_want in ((ins, one[0], oracle["insert"]),
                                    (step, one[1], oracle["step"])):
            assert got.shape == (2, 128)
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
            np.testing.assert_allclose(got, jax_want, atol=ATOL, rtol=0)


def test_tp2_capacity_multiplication(oracle):
    """Per-rank KV bytes halve at TP=2 (at most 0.55 x TP=1's), the global
    footprint is TP=1's, a host page is two device pages, and every KV
    byte rides a sharded spec."""
    lm1 = _lm(oracle)
    kv1 = lm1.kv_cache_bytes()
    assert lm1.kv_page_bytes_host() == lm1.kv_page_bytes()
    assert lm1.kv_sharded_fraction() == 0.0

    def rank(r):
        lm = _lm(oracle, r, 2)
        sess = lm.start_session()
        held = sum(t.numel() * t.element_size() for t in (*sess.cache.keys, *sess.cache.values))
        return (lm.kv_cache_bytes(), lm.kv_page_bytes(), lm.kv_page_bytes_host(),
                lm.kv_sharded_fraction(), held)

    for kv2, page, host, frac, held in _tp2(rank):
        assert kv2["kv_bytes"] <= 0.55 * kv1["kv_bytes"]
        assert kv2["kv_bytes_global"] == kv1["kv_bytes"]
        assert held == kv2["kv_bytes"]
        assert host == 2 * page
        assert frac == 1.0


def test_tp2_disagg_handoff_adopt_exact(oracle):
    """A TP=2 prefill/decode split serves the TP=1 single engine's streams;
    its handoffs carry full-width pages stamped ``tp_degree`` 2. A JAX TP=2
    handoff has the same page shapes, the port's seal gives its crc32s,
    and a port TP=2 decode worker adopts it and decodes JAX's stream."""
    submits = [dict(prompt=P[0], max_new_tokens=8),
               dict(prompt=P[1], max_new_tokens=6, arrival_block=1,
                    sampler=Sampler(temperature=1.1)),
               dict(prompt=P[2], max_new_tokens=6, grammar="gnum", arrival_block=1)]
    want, _ = _serve(_lm(oracle), oracle, submits)
    jh = oracle["handoff"]

    def rank(r):
        lm = _lm(oracle, r, 2)
        router = DisaggRouter(lm, 2, prefill_replicas=1, seed=42, block_steps=K)
        for name, spec in SPECS.items():
            router.register_grammar(name, **spec)
        for s in submits:
            router.submit(**s)
        router.run(max_blocks=300)
        got = {c.request_id: c.tokens.tolist() for c in router.completed}
        pre = ServeEngine(lm, block_steps=K, seed=42, role="prefill")
        pre.submit(HANDOFF_PROMPT, 10)
        th = _first_handoff(pre)
        port_h = KVHandoff(req=th.req, first_token=jh.first_token, first_ts=0.0,
                           page_size=PAGE, payloads=[dict(p) for p in jh.payloads],
                           crcs=list(jh.crcs), tp_degree=jh.tp_degree)
        dec = ServeEngine(lm, block_steps=K, seed=42, role="decode")
        verdict = dec.adopt_handoff(port_h)
        dec.run()
        return (got, dict(router.stats), th, verdict, dec.completed[0].tokens.tolist(),
                port_h.verify())

    for got, stats, th, verdict, stream, ok in _tp2(rank):
        assert got == want
        assert stats["handoffs_sent"] == stats["handoffs_adopted"] == len(submits)
        assert stats["handoffs_degraded"] == 0
        assert th.tp_degree == 2 == jh.tp_degree
        assert [sorted(p) for p in th.payloads] == [sorted(p) for p in jh.payloads]
        assert all(t[k].shape == j[k].shape and t[k].dtype == j[k].dtype
                   for t, j in zip(th.payloads, jh.payloads) for k in t)
        assert KVHandoff(req=th.req, first_token=0, first_ts=0.0, page_size=PAGE,
                         payloads=jh.payloads).seal().crcs == list(jh.crcs)
        assert ok and verdict == "adopted"
        assert stream == oracle["handoff_stream"]


def test_tp2_async_loop_equals_sync(oracle):
    """The pipelined loop at TP=2 (max_batch 4, an EOS row, sampled rows)
    equals the synchronous loop, streams and finish reasons."""
    p = _prompts(5, seed=7)
    submits = [dict(prompt=p[0], max_new_tokens=9),
               dict(prompt=p[1], max_new_tokens=7, arrival_block=1,
                    sampler=Sampler(temperature=0.8)),
               dict(prompt=p[2], max_new_tokens=11, eos_token_id=7, arrival_block=2),
               dict(prompt=p[3], max_new_tokens=6, arrival_block=3,
                    sampler=Sampler(temperature=1.3)),
               dict(prompt=p[4], max_new_tokens=8, arrival_block=4)]

    def rank(r):
        sd = llama_params_from_jax(oracle["params"], tp_rank=r, tp_size=2)
        lm = CausalLM(_tcfg(), sd, tl.LlamaForCausalLM, device="cpu", buckets=(8, 16),
                      max_batch=4, page_size=PAGE)
        out = []
        for async_loop in (False, True):
            eng = ServeEngine(lm, block_steps=K, seed=42, async_loop=async_loop)
            for s in submits:
                eng.submit(**s)
            eng.run()
            out.append({c.request_id: (c.tokens.tolist(), c.finish_reason)
                        for c in eng.completed})
            eng.close()
        return out

    for sync, pipelined in _tp2(rank):
        assert pipelined == sync
        assert len(sync) == 5


def test_tp2_run_trace_reports_the_degree(oracle):
    """``run_trace`` at TP=2 carries the TP surface (JAX ``engine.py:4761-
    4775``): the degree, every KV byte sharded, this rank's bytes half the
    global ones and against a rank's slab."""
    trace = synthetic_trace(4, 128, prompt_lens=(6, 9), max_new_tokens=5, seed=3)

    def rank(r):
        eng = ServeEngine(_lm(oracle, r, 2), block_steps=K, seed=42)
        return run_trace(eng, trace)

    one = run_trace(ServeEngine(_lm(oracle), block_steps=K, seed=42), trace)
    assert one["tp_degree"] == 1 and one["kv_sharded_fraction"] == 0.0
    for rep in _tp2(rank):
        assert rep["tp_degree"] == 2 and rep["kv_sharded_fraction"] == 1.0
        assert rep["kv_hbm_bytes"] * 2 == rep["kv_hbm_bytes_global"] == one["kv_hbm_bytes"]
        assert rep["kv_slab_hbm_bytes"] * 2 == one["kv_slab_hbm_bytes"]
        assert rep["kv_hbm_vs_slab"] == one["kv_hbm_vs_slab"]
        assert rep["requests_completed"] == one["requests_completed"] == 4


# ------------------------------------------------ the spec layer itself

def test_partition_spec_derivation(oracle):
    """Every leaf of the JAX session's cache, adapter and grammar trees gets
    the port's spec equal to JAX's, and so do the JAX test's examples (a
    non-dividing dim stays replicated)."""
    for path, shape, want in oracle["leaves"]:
        assert leaf_partition_spec(path, shape, 2) == want, path
    # the trees reach every sharded kind: KV pools, both LoRA halves, grammar
    sharded = [p for p, _, want in oracle["leaves"] if "tp" in want]
    for kind in ("cached_key", "cached_value", "_a']", "_b']", "need", "next"):
        assert any(kind in p for p in sharded), kind
    cases = [("['cache']['cached_key']", (2, 8, 4, 2, 8)),
             ("['cache']['cached_key']", (2, 8, 4, 3, 8)),
             ("['cached_value_scale']", (2, 9, 1, 2, 1)),
             ("['lora_o_proj_a']", (2, 3, 32, 4)), ("['lora_o_proj_b']", (2, 3, 4, 32)),
             ("['lora_q_proj_b']", (2, 3, 4, 32)), ("['lora_q_proj_a']", (2, 3, 32, 4)),
             ("['lora_down_proj_a']", (2, 3, 63, 4)), ("['need']", (3, 48, 128)),
             ("['next']", (3, 48, 127)), ("['terminal']", (3, 48)),
             ("['block_table']", (3, 16))]
    for path, shape in cases:
        for tp in (1, 2):
            assert leaf_partition_spec(path, shape, tp) == tuple(jax_spec(path, shape, tp))
    # the port's own dotted names follow the same rules
    assert leaf_partition_spec("layers.1.cached_key", (9, 4, 2, 8), 2) == (None, None, "tp", None)
    # the degree the specs are taken at: the thread's mesh, 1 off it
    assert tp_degree() == 1
    assert _tp2(lambda r: tp_degree()) == [2, 2]


# ------------------------------------------------ the ranks agree

def test_tp2_ranks_decide_alike(oracle):
    """Every rank runs the same host schedule: the same streams, finish
    reasons, admissions, blocks and counters."""
    def rank(r):
        _, eng = _serve(_lm(oracle, r, 2), oracle, MIXED)
        return ({c.request_id: (c.tokens.tolist(), c.finish_reason, c.queue_blocks,
                                c.decode_blocks) for c in eng.completed},
                (eng.blocks, eng.decode_blocks, eng.inserts, eng.program_calls,
                 eng.host_fetches, eng.h2d_copies))

    a, b = _tp2(rank)
    assert a == b
    assert len(a[0]) == len(MIXED)


def test_foreign_tp_degree_degrades_resume_and_adoption(oracle, tmp_path):
    """A conversation parked at TP=1 resumes at TP=2 through a re-prefill
    (the park's ``tp_degree`` is 1), and a TP=1 handoff degrades at a TP=2
    decode worker; the resumed stream stays the TP=1 one."""
    lm1 = _lm(oracle)
    eng = ServeEngine(lm1, block_steps=K, seed=42, park_dir=str(tmp_path / "park"))
    rid = eng.submit(P[0], 12)
    eng.step_block()
    eng.step_block()
    assert eng.park(rid) == "parked"
    eng.close()
    whole, _ = _serve(lm1, oracle, [dict(prompt=P[0], max_new_tokens=12)])
    pre = ServeEngine(lm1, block_steps=K, seed=42, role="prefill")
    pre.submit(HANDOFF_PROMPT, 10)
    h1 = _first_handoff(pre)
    assert h1.tp_degree == 1
    for r in range(2):   # each rank resumes from its own copy of the store
        shutil.copytree(tmp_path / "park", tmp_path / f"r{r}")

    def rank(r):
        lm = _lm(oracle, r, 2)
        e = ServeEngine(lm, block_steps=K, seed=42, park_dir=str(tmp_path / f"r{r}"))
        out = e.submit(resume=rid)
        e.run()
        dec = ServeEngine(lm, block_steps=K, seed=42, role="decode")
        return out, e.park_replays, e.completed[0].tokens.tolist(), dec.adopt_handoff(h1)

    for out, replays, stream, verdict in _tp2(rank):
        assert out == rid and replays == 1
        assert stream == whole[0]
        assert verdict == "degraded"
