"""The host-only model (``inference/simlm.py``) and the streaming report
(``keep_completions=False``), the port's against the JAX package's.

- ``test_sched_perf.py:274``: one synthetic trace through the port's real
  paged engine and through a ``SimCausalLM`` engine of the same buckets,
  slots and pool gives the same per-request schedule (queue, TTFT and
  decode blocks, tokens delivered) and the same block totals; in the
  synchronous and the pipelined loop.
- The port's sim engine against the JAX sim engine on the same trace: the
  same tokens (the sim token function is the reference's), schedule and
  report totals; and under a seeded fault storm (pool storms, dispatch
  faults, corrupted pages, a chunked long prompt) the same decisions and
  injector stats, over 400 requests in a few seconds.
- ``test_sched_perf.py:321``: a sim engine captures no graph and launches
  no kernel; CUDA entry points fenced off, a streamed 300-request trace
  completes.
- ``test_sched_perf.py:339``: ``keep_completions=False`` changes memory,
  not outcomes: the streaming report's totals equal the retained run's,
  for the real engine and the sim one, and no completion is kept.

Exact comparisons throughout (the schedule is integer state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import FaultPlan as JaxPlan
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.inference.engine import run_trace as jax_run_trace
from neuronx_distributed_tpu.inference.engine import synthetic_trace as jax_trace
from neuronx_distributed_tpu.inference.simlm import SimCausalLM as JaxSim
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference import paged_kernel
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace, synthetic_trace_stream
from neuronx_distributed_tpu_torch.kernels import flash_attn
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
SIM = dict(max_batch=3, buckets=(8, 16), max_seq_len=64, vocab_size=128, page_size=4,
           page_pool_pages=40)
SCHEDULE_KEYS = ("blocks", "decode_blocks", "inserts", "inserted_requests",
                 "requests_completed", "total_generated_tokens", "host_ops_per_block")
STORM = dict(seed=2, pool_exhaust_prob=0.2, pool_storm_len=2, dispatch_fail_prob=0.2,
             dispatch_max_failures=2, corrupt_page_prob=0.2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def real_lm():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return CausalLM(tl.LlamaConfig(**TINY, dtype=torch.float32), sd, tl.LlamaForCausalLM,
                    buckets=(8, 16), max_batch=3, page_size=4, page_pool_pages=40, device="cpu")


def _trace(make=synthetic_trace, n=16, **kw):
    return make(n, 127, prompt_lens=(6, 10), max_new_tokens=7, mean_interarrival_blocks=0.5,
                seed=3, **kw)


def _schedule(eng):
    return sorted((c.request_id, c.queue_blocks, c.ttft_blocks, c.decode_blocks, len(c.tokens))
                  for c in eng.completed)


@pytest.mark.parametrize("async_loop", [False, True])
def test_sim_engine_schedule_matches_real_engine(real_lm, async_loop):
    """The sim model's claim: the same slot and page accounting gives the
    same schedule as the real engine's."""
    reports, scheds = {}, {}
    for name, lm in (("real", real_lm), ("sim", SimCausalLM(**SIM))):
        eng = ServeEngine(lm, block_steps=4, seed=1, async_loop=async_loop)
        reports[name] = run_trace(eng, _trace())
        scheds[name] = _schedule(eng)
    assert scheds["real"] == scheds["sim"]
    for k in SCHEDULE_KEYS:
        assert reports["real"][k] == reports["sim"][k], k


def _sim_reading(eng, jax_side):
    stat = (lambda k: eng.stats[k]) if jax_side else (lambda k: getattr(eng, k))
    return dict(
        comps={c.request_id: (c.tokens.tolist(), c.queue_blocks, c.ttft_blocks,
                              c.decode_blocks) for c in eng.completed},
        counts={k: stat(k) for k in ("decode_blocks", "inserts", "deferred_admissions",
                                     "prefill_aborts", "chunk_program_calls",
                                     "corrupt_page_replays")},
        retries=stat("dispatch_retries") if jax_side else eng.dispatch_retry_count,
        injector=None if eng._injector is None else dict(eng._injector.stats))


def test_sim_engine_matches_jax_sim_engine():
    """The port's sim engine and the JAX one on one trace: the same tokens
    (the token function is the reference's), schedule and totals."""
    jeng = JaxEngine(JaxSim(**SIM), block_steps=4)
    jrep = jax_run_trace(jeng, _trace(jax_trace))
    eng = ServeEngine(SimCausalLM(**SIM), block_steps=4)
    rep = run_trace(eng, _trace())
    assert _sim_reading(eng, False) == _sim_reading(jeng, True)
    for k in ("blocks", "decode_blocks", "inserts", "requests_completed",
              "total_generated_tokens", "queue_blocks_mean", "ttft_blocks_mean",
              "prefix_hits", "pages_in_use_peak", "page_dtype"):
        assert rep[k] == jrep[k], k


@pytest.mark.parametrize("async_loop", [False, True])
def test_sim_fault_storm_matches_jax(async_loop):
    """400 requests through a fault storm on the sim model (a chunked long
    prompt every 8th): the port's synchronous and pipelined loops decide
    as the JAX synchronous loop does, to the injector's stats."""
    knobs = dict(prompt_lens=(6, 10), max_new_tokens=9, mean_interarrival_blocks=0.3,
                 long_prompt_frac=0.125, long_prompt_len=20, seed=5)
    engine = dict(block_steps=4, prefill_chunk_tokens=8, dispatch_retries=20,
                  dispatch_backoff_s=0.0)
    jeng = JaxEngine(JaxSim(**SIM), faults=JaxPlan(**STORM), **engine)
    for it in jax_trace(400, 127, **knobs):
        jeng.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"])
    jeng.run()
    eng = ServeEngine(SimCausalLM(**SIM), faults=FaultPlan(**STORM), async_loop=async_loop,
                      **engine)
    for it in synthetic_trace(400, 127, **knobs):
        eng.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"])
    eng.run()
    got, want = _sim_reading(eng, False), _sim_reading(jeng, True)
    assert got == want
    assert len(got["comps"]) == 400 and got["counts"]["corrupt_page_replays"] > 0
    assert got["injector"]["alloc_faults"] and got["retries"] == got["injector"]["dispatch_faults"]


def test_sim_engine_launches_nothing(monkeypatch):
    """No graph, no kernel, no CUDA call: with CUDA's entry points fenced
    off a streamed 300-request trace completes, and no kernel wrapper
    counted a launch."""
    def boom(*a, **kw):
        raise AssertionError("the sim path called into CUDA")

    for name in ("synchronize", "Event", "CUDAGraph", "Stream", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (paged_kernel.paged_decode_attention.launches,
              flash_attn.flash_block_forward.launches)
    eng = ServeEngine(SimCausalLM(max_batch=4, buckets=(8, 16), page_size=4,
                                  page_pool_pages=64), block_steps=8, keep_completions=False,
                      async_loop=True)
    assert eng._fused is None and eng.capture_s < 1.0
    rep = run_trace(eng, synthetic_trace_stream(300, 32000, prompt_lens=(6, 10),
                                                max_new_tokens=8, mean_interarrival_blocks=0.1,
                                                seed=2))
    assert rep["streaming"] and rep["requests_completed"] == 300
    assert (paged_kernel.paged_decode_attention.launches,
            flash_attn.flash_block_forward.launches) == before


@pytest.mark.parametrize("sim", [False, True])
def test_streaming_report_matches_retained(real_lm, sim):
    """``keep_completions=False`` changes memory, not outcomes: the same
    completions, tokens, blocks and sheds as the retained run (a bounded
    queue sheds some), the percentiles present, nothing kept."""
    knobs = dict(prompt_lens=(6, 10), max_new_tokens=7, mean_interarrival_blocks=0.15,
                 seed=5, deadline_ms=12.0)
    reps = {}
    for keep in (True, False):
        lm = SimCausalLM(**SIM) if sim else real_lm
        eng = ServeEngine(lm, block_steps=4, max_queue=3, keep_completions=keep)
        trace = (synthetic_trace(40 if not sim else 200, 127, **knobs) if keep
                 else synthetic_trace_stream(40 if not sim else 200, 127, **knobs))
        reps[keep] = (run_trace(eng, trace), eng)
    (keep_rep, keep_eng), (stream_rep, stream_eng) = reps[True], reps[False]
    assert stream_rep["streaming"] is True and stream_eng.completed == []
    for k in ("requests_completed", "total_generated_tokens", "blocks", "decode_blocks",
              "inserts", "rejected", "expired", "ttft_blocks_mean", "queue_blocks_mean",
              "deadline_miss_rate"):
        assert stream_rep[k] == keep_rep[k], k
    assert stream_rep["rejected"] > 0 and stream_rep["deadline_miss_rate"] > 0
    assert stream_rep["requests_submitted"] == len(keep_eng.completed) + len(keep_eng.rejected)
    assert stream_rep["itl_p50_ms"] is not None and stream_rep["sched_overhead_us_per_request"] > 0
    assert stream_eng.completed_count == keep_eng.completed_count == len(keep_eng.completed)
    assert stream_eng.ontime_tokens == keep_eng.ontime_tokens
    with pytest.raises(ValueError, match="streaming runs do not snapshot"):
        run_trace(ServeEngine(SimCausalLM(**SIM), block_steps=4, keep_completions=False), [],
                  snapshot_path="x.snap")


def test_sim_engine_refuses_a_tier():
    with pytest.raises(ValueError, match="no device pages to tier"):
        ServeEngine(SimCausalLM(**SIM), block_steps=4, host_tier_pages=8)
