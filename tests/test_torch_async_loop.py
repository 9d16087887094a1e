"""The pipelined block loop of the port's ``ServeEngine`` (``async_loop``)
against its synchronous loop, on the CPU.

Each round replays block t before it harvests block t - 1; first tokens
drawn at admission stay on the device until the next block's fetch. The
streams must equal the synchronous loop's bit for bit, greedy and sampled,
with chunked prefill off and on, on the slab and on pages, and across a
cancel. Requests that end on their budget keep the synchronous schedule
(the host predicts the budget), so there the per-request queue,
first-token and decode blocks are compared too; a request that ends on
EOS retires later (the latch is on the device). A steady block is one replay and one fetch,
any block at most one copy more. 2 layers, hidden 64, fp32, K = 4.
"""

import pytest
import torch

from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace
from neuronx_distributed_tpu_torch.models import llama as tl


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG = tl.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False,
                     dtype=torch.float32)
K = 4


@pytest.fixture(scope="module")
def lms():
    sd = tl.init_params(CFG, torch.Generator().manual_seed(0))
    mk = lambda **kw: CausalLM(CFG, sd, tl.LlamaForCausalLM, buckets=(8, 16),  # noqa: E731
                               max_batch=3, device="cpu", **kw)
    return {"slab": mk(), "paged": mk(page_size=4, paged_attn_kernel=True)}


def _workload(eos=None):
    """A trace with a long prompt every 4th request, every 3rd request
    sampled."""
    trace = synthetic_trace(9, CFG.vocab_size, prompt_lens=(5, 8, 11), max_new_tokens=7,
                            mean_interarrival_blocks=0.7, long_prompt_frac=0.25,
                            long_prompt_len=16, eos_token_id=eos, seed=5)
    for i, it in enumerate(trace):
        it["sampler"] = Sampler(temperature=0.9) if i % 3 == 2 else None
    return trace


def _serve(lm, async_loop, eos=None, cancel=None, **kw):
    """Serve the workload; ``cancel`` = n cancels the decoding request of
    the lowest id after the first round from the n-th on that has one. Returns per request (tokens, finish
    reason, queue, first-token and decode blocks), the engine, and the
    host ops of each round that decoded a block."""
    eng = ServeEngine(lm, block_steps=K, async_loop=async_loop, seed=7, **kw)
    for it in _workload(eos):
        eng.submit(it["prompt"], it["max_new_tokens"], sampler=it["sampler"],
                   eos_token_id=it["eos_token_id"], arrival_block=it["arrival_block"])
    ops, rounds = [], 0
    while True:
        before = (eng.replays, eng.host_fetches, eng.h2d_copies, eng.decode_blocks)
        if not eng.step_block():
            break
        rounds += 1
        if eng.decode_blocks > before[3]:
            ops.append(tuple(a - b for a, b in zip(
                (eng.replays, eng.host_fetches, eng.h2d_copies), before)))
        decoding = [r.request_id for i, r in enumerate(eng.slots)
                    if r is not None and i not in eng._prefilling]
        if cancel is not None and rounds >= cancel and decoding:
            assert eng.cancel(min(decoding))
            cancel = None
    res = {c.request_id: (c.tokens.tolist(), c.finish_reason, c.queue_blocks, c.ttft_blocks,
                          c.decode_blocks) for c in eng.completed}
    return res, eng, ops


@pytest.mark.parametrize("mode", ["slab", "paged"])
@pytest.mark.parametrize("chunk", [0, 5])
def test_async_streams_and_schedule_equal_sync(lms, mode, chunk):
    sync, _, _ = _serve(lms[mode], False, prefill_chunk_tokens=chunk)
    got, eng, ops = _serve(lms[mode], True, prefill_chunk_tokens=chunk)
    assert got == sync
    assert len(got) == 9 and eng.cancelled == 0
    assert not eng._inflight and not eng._tail and not eng._first_pending


def test_async_eos_streams_equal_sync(lms):
    """Streams ending on EOS (token 3 is common under these weights): the
    same tokens and finish reasons. The device latches EOS, so such a
    stream retires later than in the synchronous loop: one block, two when
    the EOS is its first token (drawn at admission, known to the host after
    the next block's fetch); later admissions move with it."""
    sync, _, _ = _serve(lms["paged"], False, eos=3, prefill_chunk_tokens=5)
    got, _, _ = _serve(lms["paged"], True, eos=3, prefill_chunk_tokens=5)
    assert {r: v[:2] for r, v in got.items()} == {r: v[:2] for r, v in sync.items()}
    eos = [r for r, v in got.items() if v[1] == "eos"]
    assert eos
    for r in eos:
        assert 1 <= got[r][4] - sync[r][4] <= (2 if len(got[r][0]) == 1 else 1)


@pytest.mark.parametrize("chunk", [0, 5])
def test_async_cancel_equals_sync(lms, chunk):
    """Cancelling a decoding request mid-run: the pipelined loop drains
    first, so the partial stream and every other stream equal the
    synchronous loop's."""
    sync, _, _ = _serve(lms["paged"], False, cancel=4, prefill_chunk_tokens=chunk)
    got, eng, _ = _serve(lms["paged"], True, cancel=4, prefill_chunk_tokens=chunk)
    assert got == sync
    (cut,) = [v for v in got.values() if v[1] == "cancelled"]
    assert 0 < len(cut[0]) < 7
    assert eng.cancelled == 1


def test_async_host_ops_a_block(lms):
    """A steady pipelined block is one replay and one fetch (first tokens
    ride the block's fetch); a block after an admission or retirement adds
    one copy of the changed slots."""
    _, eng, ops = _serve(lms["paged"], True, prefill_chunk_tokens=5)
    steady = [o for o in ops if o[2] == 0]
    assert steady and all(o == (1, 1, 0) for o in steady)
    assert all(o[:2] == (1, 1) and o[2] <= 1 for o in ops)
    assert eng.host_fetches == eng.decode_blocks == eng.replays


def test_async_loop_requires_fused(lms):
    with pytest.raises(ValueError, match="async_loop requires fused"):
        ServeEngine(lms["slab"], block_steps=K, fused=False, async_loop=True)


def test_async_page_reserve_is_two_blocks(lms):
    assert ServeEngine(lms["paged"], block_steps=K, async_loop=True)._reserve_slack() == 2 * K
    assert ServeEngine(lms["paged"], block_steps=K)._reserve_slack() == K
