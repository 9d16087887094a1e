"""Independent sessions on one ``CausalLM`` (the port's fault C9, repaired).

The JAX package's ``start_session`` makes independent sessions ("multiple
concurrent sessions keep their own overflow guards",
``neuronx_distributed_tpu/inference/causal_lm.py:888-891``) and its router
builds N engines over one ``CausalLM``. The port now does the same: each
session holds a device state of its own (KV pools, slot state, grammar
tables, adapter pool, captured programs and their graph pool) while the
weights exist once.

- Two engines over one port ``CausalLM``, stepped block by block in turn,
  each serve the tokens a bare engine gives their requests alone, for the
  slab and the paged pool, fused and stepwise, greedy and sampled; the
  greedy streams equal the JAX engine's on the same seeded weights.
- One engine alone is unchanged: its streams equal the JAX engine's, and a
  later session takes over a closed one's state with its programs.
- Each live session owns its buffers; a closed session raises; the
  ``CausalLM`` keeps one spare state and frees the rest; a session's
  fused block is captured (built, on the CPU) while another session holds
  live slots; adapter pools are per session.

Tiny model: 2 layers, hidden 32, 3 slots, pages of 4, K = 4. One intra-op
thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.models import llama as tl

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
LM = dict(buckets=(8, 16), max_batch=3)
K = 4
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    sd = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params))

    def port(**kw):
        return CausalLM(tcfg, sd, tl.LlamaForCausalLM, device="cpu", **LM, **kw)

    return {"tcfg": tcfg, "sd": sd, "slab": port(), "paged": port(page_size=PAGE),
            "jax_slab": JaxLM(jcfg, params, jl.LlamaForCausalLM, **LM).compile(),
            "jax_paged": JaxLM(jcfg, params, jl.LlamaForCausalLM, page_size=PAGE,
                               **LM).compile()}


def _prompts(n, s=8, seed=2):
    return np.random.default_rng(seed).integers(1, 127, (n, s)).astype(np.int32)


def _work(seed):
    """Two greedy requests and a sampled one, staggered."""
    p = _prompts(3, seed=seed)
    return [dict(prompt=p[0], max_new_tokens=12),
            dict(prompt=_prompts(1, s=16, seed=seed + 1)[0], max_new_tokens=9, arrival_block=1,
                 sampler=Sampler(temperature=1.2)),
            dict(prompt=p[1], max_new_tokens=10, arrival_block=2)]


def _streams(eng):
    return {c.request_id: c.tokens.tolist() for c in eng.completed}


def _alone(lm, work, **kw):
    eng = ServeEngine(lm, block_steps=K, seed=42, **kw)
    for s in work:
        eng.submit(**s)
    eng.run()
    eng.close()
    return _streams(eng)


def _jax_greedy(jlm, work):
    eng = JaxEngine(jlm, block_steps=K, rng=jax.random.key(42))
    for s in work:
        if "sampler" not in s:
            eng.submit(**s)
    eng.run()
    return [c.tokens.tolist() for c in sorted(eng.completed, key=lambda c: c.request_id)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pool", ["slab", "paged"])
def test_two_engines_over_one_causal_lm_serve_side_by_side(stack, pool, fused):
    """The C9 pin: engines A and B on one ``CausalLM``, stepped in turn
    block by block (each block of one runs between two blocks of the
    other), each give the streams a bare engine serves their requests
    alone; their greedy streams equal the JAX engine's."""
    lm = stack[pool]
    work_a, work_b = _work(5), _work(11)
    want_a, want_b = _alone(lm, work_a, fused=fused), _alone(lm, work_b, fused=fused)
    a = ServeEngine(lm, block_steps=K, seed=42, fused=fused)
    b = ServeEngine(lm, block_steps=K, seed=42, fused=fused)
    assert a.session.state is not b.session.state
    for s in work_a:
        a.submit(**s)
    for s in work_b:
        b.submit(**s)
    more = [True, True]
    while any(more):
        for i, eng in enumerate((a, b)):
            if more[i]:
                more[i] = eng.step_block()
    assert _streams(a) == want_a and _streams(b) == want_b
    assert want_a != want_b
    for work, got in ((work_a, _streams(a)), (work_b, _streams(b))):
        greedy = [got[r] for r, s in enumerate(work) if "sampler" not in s]
        assert greedy == _jax_greedy(stack["jax_" + pool], work)


def test_one_engine_alone_is_unchanged_and_reuses_a_closed_state(stack):
    """One engine over one ``CausalLM`` serves the JAX engine's greedy
    streams; after it closes, the next session takes over its state: the
    same buffers and the same program objects, built once, and the same
    streams."""
    lm = stack["paged"]
    work = [s for s in _work(7) if "sampler" not in s]
    first = ServeEngine(lm, block_steps=K, seed=42)
    for s in work:
        first.submit(**s)
    first.run()
    state = first.session.state
    programs = dict(state.programs)
    fused = dict(state.fused)
    want = _streams(first)
    assert [want[r] for r in sorted(want)] == _jax_greedy(stack["jax_paged"], work)
    first.close()
    assert first.session.cache is None and first._fused is None   # no device memory held
    with pytest.raises(RuntimeError, match="closed"):
        lm.step(first.session, np.zeros(3, np.int32))
    again = ServeEngine(lm, block_steps=K, seed=42)
    assert again.session.state is state and again.capture_s < 1.0
    for s in work:
        again.submit(**s)
    again.run()
    assert _streams(again) == want
    assert all(state.programs[k] is v for k, v in programs.items())
    assert state.fused == fused
    again.close()


def test_live_sessions_own_their_buffers_and_one_spare_is_kept(stack):
    """Three live sessions hold three device states (distinct KV pools and
    slot state); closing them keeps the first closed one as the spare and
    frees the others; the next session takes the spare."""
    lm = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu",
                  page_size=PAGE, **LM)
    sessions = [lm.start_session() for _ in range(3)]
    states = [s.state for s in sessions]
    ptrs = {s.cache.keys[0].data_ptr() for s in sessions}
    assert len(ptrs) == 3 and len({id(s.slots) for s in sessions}) == 3
    assert [st.index for st in states] == [0, 1, 2]
    p = _prompts(1)
    lm.insert(sessions[0], [0], p)
    got = lm.step(sessions[0], np.array([5, 0, 0], np.int32))
    # another session's work leaves this one's cache alone
    lm.insert(sessions[1], [0], _prompts(1, seed=9))
    lm.step(sessions[1], np.array([7, 0, 0], np.int32))
    assert int(sessions[0].slots.dev_field("length")[0]) == 9
    for s in sessions:
        s.close()
        s.close()    # idempotent
    assert lm._spare is states[0]
    assert states[1].cache is None and states[2].cache is None
    again = lm.start_session()
    assert again.state is states[0] and not again.active.any()
    assert int(again.slots.dev_field("length")[0]) == 0
    fresh = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu",
                     page_size=PAGE, **LM)
    fs = fresh.start_session()
    fresh.insert(fs, [0], p)
    assert torch.equal(fresh.step(fs, np.array([5, 0, 0], np.int32)), got)
    with pytest.raises(RuntimeError, match="closed"):
        lm.insert(sessions[1], [0], p)


def test_a_dropped_session_returns_its_state(stack):
    """A session nobody holds any more gives its state back as a closed
    one does (``generate`` relies on it: its sessions reuse one state)."""
    lm = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu", **LM)
    prompts = _prompts(2)
    a = lm.generate(prompts, 6, fused_chunk=4)
    spare = lm._spare
    assert spare is not None and spare.fused
    b = lm.generate(prompts, 6, fused_chunk=4)
    assert lm._spare is spare
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_capture_while_another_session_is_live(stack):
    """A replica added to a busy fleet builds its programs while other
    sessions hold live slots: its fused block warms up on its own state
    only, and the busy session's stream is the one it serves alone."""
    lm = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu",
                  page_size=PAGE, **LM)
    work = _work(13)
    want = _alone(lm, work)
    busy = ServeEngine(lm, block_steps=K, seed=42)
    for s in work:
        busy.submit(**s)
    busy.step_block()
    busy.step_block()
    assert busy.session.active.any()
    late = ServeEngine(lm, block_steps=K, seed=42)
    assert late.session.state is not busy.session.state and late._fused is not None
    assert "session_fused_k4" in late.session.capture_ms
    late.submit(**work[0])
    busy.run()
    late.run()
    assert _streams(busy) == want
    assert _streams(late)[0] == want[0]
    # a session's fused block refuses another session's state
    with pytest.raises(RuntimeError, match="another session"):
        late._fused(busy.session)


def test_adapter_pools_are_per_session(stack):
    """Each session's adapter pool is its own buffer; a forward binds the
    pool of the session it runs for."""
    lm = CausalLM(stack["tcfg"], stack["sd"], tl.LlamaForCausalLM, device="cpu",
                  page_size=PAGE, lora_rank=2, lora_slots=3, **LM)
    a, b = lm.start_session(), lm.start_session()
    assert a.state.lora_pool.data_ptr() != b.state.lora_pool.data_ptr()
    assert a.adapters.pool.data_ptr() == a.state.lora_pool.data_ptr()
    a.state.lora_pool.fill_(1.0)
    lm.insert(b, [0], _prompts(1))
    assert lm.model.model.lora_pool is b.state.lora_pool
    assert float(b.state.lora_pool.abs().sum()) == 0.0
