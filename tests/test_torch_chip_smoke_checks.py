"""The checks ``chip_smoke.py`` holds the attention kernels to, on the CPU.

The fp64 evaluations that the card's outputs are also held against are
compared with the JAX package's kernels (Pallas, in interpret mode on the
CPU) on the same seeded inputs:

- ``bwd_exact`` with ``flash_block_grads`` under external statistics: with
  fp32 operands neither side rounds p or dS, so only the summation
  precision differs (atol 2e-5 on gradients of about 1, as
  ``test_torch_flash_backward.py``);
- ``fwd_exact`` with ``flash_block_forward`` (out and LSE; pad rows, pad
  keys, causal and non-causal): fp32 operands, so p is not rounded either
  (atol 1e-5 on outputs and LSEs of about 1);
- ``decode_exact`` with ``paged_decode_attention`` on bf16 and int8 pools
  with fp32 queries: both read the same pool values (int8 dequantized in
  fp32 by the same multiply) and the kernel sums in fp32 (atol 1e-5).

``held`` is pinned on hand-made tensors: an element beyond its limit
against the twin passes only where it lies within the limit of the fp64
value.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import paged_kernel as jpk
from neuronx_distributed_tpu.kernels import flash_attn as jfa

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_exact_matches_jax_block_grads(smoke, causal):
    b, h, hk, sq, sk, d, blk = 1, 4, 2, 128, 128, 32, 64
    rng = np.random.default_rng(21)
    q, do = (rng.standard_normal((b * h, sq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b * hk, sk, d), dtype=np.float32) for _ in range(2))
    lse = (rng.standard_normal((b * h, sq)) + 6.0).astype(np.float32)
    delta = rng.standard_normal((b * h, sq)).astype(np.float32)
    kpos = np.arange(sk, dtype=np.int32).reshape(b, 1, sk)
    qpos = (np.arange(sq, dtype=np.int32) if causal
            else np.full(sq, sk - 1, np.int32)).reshape(b, 1, sq)
    lanes = lambda a: np.broadcast_to(a[..., None], (*a.shape, 128))  # noqa: E731
    want = jfa.flash_block_grads(*map(jnp.asarray, (q, k, v, do)), jnp.asarray(lanes(lse)),
                                 jnp.asarray(lanes(delta)), jnp.asarray(qpos),
                                 jnp.asarray(kpos), d ** -0.5, blk, blk, h // hk, h)
    got = smoke.bwd_exact(*map(torch.from_numpy, (q, k, v, do, lse, delta, qpos, kpos)),
                          d ** -0.5, blk, blk, h // hk, h, chunk=48)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_exact_matches_jax_block_forward(smoke, causal):
    b, h, hk, sq, sk, d, blk = 2, 4, 2, 128, 192, 32, 64
    rng = np.random.default_rng(22)
    q = rng.standard_normal((b * h, sq, d), dtype=np.float32)
    k, v = (rng.standard_normal((b * hk, sk, d), dtype=np.float32) for _ in range(2))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    qpos = np.tile((np.arange(sq, dtype=np.int32) + (sk - sq)) if causal
                   else np.full(sq, sk - 1, np.int32), (b, 1))
    qpos[0, -3:] = -1                          # pad query rows: out 0, LSE -1e30
    kpos[1, 70:75] = 2**30                     # INVALID_POS keys
    qpos, kpos = qpos.reshape(b, 1, sq), kpos.reshape(b, 1, sk)
    want_out, want_lse = jfa.flash_block_forward(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                                                 d ** -0.5, blk, blk, h // hk, h)
    got_out, got_lse = smoke.fwd_exact(*map(torch.from_numpy, (q, k, v, qpos, kpos)),
                                       d ** -0.5, blk, blk, h // hk, h)
    assert got_out.dtype == torch.float64
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-5)
    assert float(got_out[0, -3:].abs().max()) == 0.0
    assert float(got_lse[0, -1]) == -1e30


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_decode_exact_matches_jax_paged_decode(smoke, pool):
    b, n_q, n_kv, hd, ps, pages, ppseq = 3, 8, 2, 32, 8, 20, 5
    rng = np.random.default_rng(23)
    q = rng.standard_normal((b, 1, n_q, hd), dtype=np.float32)
    kf, vf = (rng.standard_normal((pages, ps, n_kv, hd), dtype=np.float32) * 2
              for _ in range(2))
    table = rng.permutation(pages)[: b * ppseq].reshape(b, ppseq).astype(np.int32)
    cache_len = np.array([0, 13, ps * ppseq - 1], np.int32)
    jkw, tkw = {}, {}
    if pool == "int8":
        kq, ks = jpk.quantize_kv_pages(jnp.asarray(kf))
        vq, vs = jpk.quantize_kv_pages(jnp.asarray(vf))
        jk, jv = kq, vq
        tk, tv = torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(vq))
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = dict(k_scale=torch.from_numpy(np.array(ks)), v_scale=torch.from_numpy(np.array(vs)))
    else:
        jk, jv = jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16)
        tk, tv = torch.from_numpy(kf).bfloat16(), torch.from_numpy(vf).bfloat16()
    want = jpk.paged_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(table),
                                      jnp.asarray(cache_len), **jkw)
    got = smoke.decode_exact(torch.from_numpy(q), tk, tv, torch.from_numpy(table),
                             torch.from_numpy(cache_len), **tkw)
    assert got.dtype == torch.float64 and got.shape == (b, 1, n_q, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_held_excuses_only_what_the_fp64_value_backs(smoke):
    rel, floor = 2.0 ** -7, 1e-3
    exact = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64)
    twin = torch.tensor([1.0, 0.51, 0.25])       # the twin is off at element 1
    good = torch.tensor([1.0, 0.5, 0.25])        # the kernel is right there
    r = smoke.held(good, twin, floor, rel, exact=exact)
    assert r["ok"] and r["floor_needed"] == 0.0
    assert r["floor_needed_vs_twin"] == pytest.approx(0.01 - rel * 0.51, rel=1e-4)
    assert r["vs_exact"]["twin"]["max_abs_err"] == pytest.approx(0.01, rel=1e-4)
    bad = torch.tensor([1.0, 0.5, 0.26])         # off both twin and fp64 at element 2
    r = smoke.held(bad, twin, floor, rel, exact=exact)
    assert not r["ok"]
    assert r["floor_needed"] == pytest.approx(0.01 - rel * 0.25, rel=1e-4)
    assert not smoke.held(good, twin, floor, rel)["ok"]   # without fp64, the twin decides


def test_trace_latency_reads_ttft_and_gaps_from_arrival(smoke):
    """The trace phase's latency summary on hand-made completions: TTFT is
    first token minus arrival, per kind (short below ``long_len``), p50 the
    upper middle and max; the largest gap is taken over short requests
    only."""
    from neuronx_distributed_tpu_torch.inference.engine import Completion

    def comp(rid, plen, ts):
        return Completion(request_id=rid, tokens=np.zeros(len(ts), np.int64), prompt_len=plen,
                          queue_blocks=0, decode_blocks=0, token_ts=np.asarray(ts))

    done = [comp(0, 64, [1.0, 1.1, 1.2]), comp(1, 128, [2.0, 2.5]),
            comp(2, 3072, [3.0, 4.0]), comp(3, 384, [1.5, 1.52, 1.9])]
    arrival = {0: 0.9, 1: 1.0, 2: 1.0, 3: 1.4}
    r = smoke.trace_latency(done, arrival, 3072)
    assert r["ttft_ms_p50_short"] == pytest.approx(100.0)      # sorted 100, 100, 1000
    assert r["ttft_ms_max_short"] == pytest.approx(1000.0)
    assert r["ttft_ms_p50_long"] == r["ttft_ms_max_long"] == pytest.approx(2000.0)
    assert r["max_gap_ms_short"] == pytest.approx(500.0)       # the long one's 1 s gap is not
    r = smoke.trace_latency(done[:1], arrival, 32)
    assert r["ttft_ms_p50_short"] is None and r["max_gap_ms_short"] is None
    assert r["ttft_ms_max_long"] == pytest.approx(100.0)


def test_chunk_flash_case_is_the_last_chunk_of_a_long_prompt(smoke):
    """B1 at the chunk shape: 32 query heads of 512 queries at positions
    2560..3071, 8 kv heads over positions 0..4095 whose keys past 3071 are
    zero (unwritten), the 1/sqrt(128) scale and the extend's (512, 512)
    blocks; the JAX flash forward on the same (fp32) operands agrees with
    the port's twin."""
    args = smoke.chunk_flash_case("cpu")
    q, k, v, qpos, kpos, sm, bq, bk, group, h = args
    assert tuple(q.shape) == (32, 512, 128) and tuple(k.shape) == tuple(v.shape) == (8, 4096, 128)
    assert q.dtype == torch.bfloat16
    assert qpos.flatten().tolist() == list(range(2560, 3072))
    assert kpos.flatten().tolist() == list(range(4096))
    assert float(k[:, 3072:].abs().max()) == float(v[:, 3072:].abs().max()) == 0.0
    assert float(k[:, :3072].abs().max()) > 0
    assert (sm, bq, bk, group, h) == (128 ** -0.5, 512, 512, 4, 32)
    assert smoke.CHUNK_QPOS0 + smoke.CHUNK_LEN == smoke.TRACE_KNOBS["long_prompt_len"]
    assert smoke.TRACE_CHUNK == smoke.CHUNK_LEN
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward_plain

    # a cut of the case (4 heads, the keys a query can see and one past)
    qs, ks, vs = q[:4].float(), k[:1, :3200].float(), v[:1, :3200].float()
    kp = kpos[..., :3200].contiguous()
    got, got_lse = flash_block_forward_plain(qs, ks, vs, qpos, kp, sm, bq, 64, 4, 4)
    want, want_lse = jfa.flash_block_forward(
        *(jnp.asarray(t.numpy()) for t in (qs, ks, vs, qpos, kp)), sm, bq, 64, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-5)


def test_head_dim_floors_widen_only_above_128(smoke):
    narrow, wide = smoke.head_dim_floors(96), smoke.head_dim_floors(256)
    assert narrow["dq"] == smoke.TOL_DQ_FLOOR and narrow["paged"] == smoke.TOL_PAGED_FLOOR
    assert wide["dq"] == smoke.TOL_DQ_FLOOR_WIDE and wide["dk"] == smoke.TOL_DK_FLOOR_WIDE
    assert wide["out"] == narrow["out"] and wide["dv"] == narrow["dv"]
    assert smoke.head_dim_floors(160) == wide
    assert set(smoke.HEAD_DIM_CASES) >= {160, 256}


def _overload_passes(changes=()):
    """Three fabricated overload passes that hold every gate; ``changes``
    maps ``(label, key)`` to a value that breaks one."""
    def one(traced, async_loop):
        st = dict(async_loop=async_loop, traced=traced, submitted=6, completed=4, rejected_n=2,
                  streams={0: [5, 6, 7], 1: [], 2: [8], 3: [9, 9]},
                  schedule={0: (0, 0, 2), 1: (3, 3, 0), 2: (1, 1, 1), 3: (0, 0, 2)},
                  finish={0: "budget", 1: "expired", 2: "expired", 3: "budget"},
                  expired={1: 0, 2: 1},
                  rejected=[(4, "queue_full", 2, 8), (5, "queue_full", 3, 8)],
                  launches={"flash_block_forward": 12, "paged_decode_attention": 96},
                  host_ops=[2, 3, 2], steady_ok=True, blocks_ok=True, queue_full=2,
                  partial_expiries=1, ontime=2)
        if traced:
            st.update(dropped=0, tok_events_match=True, chrome="ok", queued_expiries=1,
                      deadline_evictions=1)
        return st

    passes = {"d": one(True, False), "e": one(True, True), "f": one(False, True)}
    for (label, key), value in dict(changes).items():
        passes[label][key] = value
    return passes


def test_overload_gates_hold_on_a_good_run(smoke):
    assert smoke.overload_gates(_overload_passes()) == []


@pytest.mark.parametrize("label,key,value,says", [
    ("d", "deadline_evictions", 0, "no eviction by deadline"),
    ("d", "queue_full", 0, "no shed to a full queue"),
    ("d", "queued_expiries", 0, "no expiry in the queue"),
    ("d", "partial_expiries", 0, "no decoding expiry with a partial stream"),
    ("d", "ontime", 0, "no on-time completion"),
    ("e", "schedule", {0: (0, 0, 3), 1: (3, 3, 0), 2: (1, 1, 1), 3: (0, 0, 2)},
     "(e) schedule differ"),
    ("f", "streams", {0: [5, 6, 7], 1: [], 2: [8], 3: [9, 8]}, "(f) streams differ"),
    ("f", "rejected", [(4, "queue_full", 2, 8)], "(f) rejected differ"),
    ("e", "expired", {1: 0}, "(e) expired differ"),
    ("e", "finish", {0: "budget", 1: "expired", 2: "budget", 3: "budget"}, "(e) finish differ"),
    ("e", "dropped", 3, "dropped 3 events"),
    ("d", "tok_events_match", False, "tok events differ"),
    ("e", "chrome", "event 4 out of order", "exported trace refused"),
    ("d", "steady_ok", False, "host ops a decode block"),
    ("e", "blocks_ok", False, "host ops a decode block"),
    ("f", "launches", {"flash_block_forward": 0, "paged_decode_attention": 96},
     "(f) never launched flash_block_forward"),
    ("d", "completed", 3, "3 completed + 2 rejected != 6 submitted"),
])
def test_overload_gates_catch_each_fault(smoke, label, key, value, says):
    """A missing shed, eviction or expiry, a pass whose decisions differ
    from (d)'s, a dropped or mismatched trace event, a refused export, too
    many host ops, a kernel not launched, or a lost request: each fails the
    overload phase, and the message says which."""
    problems = smoke.overload_gates(_overload_passes({(label, key): value}))
    assert len(problems) >= 1 and any(says in p for p in problems), problems


def test_overload_trace_budgets(smoke):
    """Budgets are blocks times the fixed block time; a short prompt's TTFT
    budget is a quarter of a long one's, the completion budget the same
    for every request; the draws are the trace phase's generator's."""
    trace = smoke.overload_trace(128256)
    assert len(trace) == smoke.OVERLOAD_REQUESTS == 48
    long_len = smoke.OVERLOAD_KNOBS["long_prompt_len"]
    ttft = smoke.OVERLOAD_TTFT_BLOCKS * smoke.OVERLOAD_BLOCK_MS
    for it in trace:
        want = ttft if it["prompt"].size == long_len else ttft / 4
        assert it["ttft_deadline_ms"] == want
        assert it["deadline_ms"] == smoke.OVERLOAD_DEADLINE_BLOCKS * smoke.OVERLOAD_BLOCK_MS
    assert sum(it["prompt"].size == long_len for it in trace) == 12
    assert {it["tenant"] for it in trace} == {"t0", "t1"}
    assert smoke.OVERLOAD_ENGINE["block_time_ms"] == smoke.OVERLOAD_BLOCK_MS


def test_overload_schedule_meets_the_coverage_gates_on_the_cpu(smoke):
    """The overload phase's schedule is a function of its trace alone
    (greedy, no EOS, a fixed block time): served by a one-layer model at
    the phase's scheduling shape (4096-token context, pages of 16, 8 slots,
    buckets 128/512/4096, K = 8, chunks of 512, ``max_queue=8``; the
    prompts' ids folded into a 512-token vocabulary, which moves no
    decision), pass (d) sheds to a full queue, evicts by deadline, expires
    in the queue and mid-decode, completes on time, and a steady decode
    block is one replay and one fetch, with the counts the card's run
    gives (``PERF.md``). One intra-op thread: the test shares the CPU."""
    from neuronx_distributed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=512, hidden_size=16, intermediate_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, max_seq_len=4096, dtype=torch.float32)
    lm = smoke.trace_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
    trace = smoke.overload_trace(128256)
    for it in trace:
        it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        st = smoke.overload_pass(lm, "cpu", trace, False, True, ())
    finally:
        torch.set_num_threads(threads)
    launches = dict(flash_block_forward=1, paged_decode_attention=1)   # the CPU runs the twins
    passes = {label: {**st, "launches": launches} for label in ("d", "e", "f")}
    assert smoke.overload_gates(passes) == []
    counts = {k: st[k] for k in ("completed", "rejected_n", "ontime", "expired_n",
                                 "queued_expiries", "partial_expiries", "deadline_evictions",
                                 "decode_blocks")}
    assert counts == dict(completed=28, rejected_n=20, ontime=17, expired_n=11,
                          queued_expiries=10, partial_expiries=1, deadline_evictions=7,
                          decode_blocks=25)
    assert st["report"]["shed_policy"] == "deadline" and st["report"]["per_tenant"]


def _recovery_passes(smoke, changes=()):
    """Seven fabricated recovery passes that hold every gate; ``changes``
    maps ``(label, key)`` to a value that breaks one."""
    n, full = smoke.RECOVERY_REQUESTS, smoke.RECOVERY_KNOBS["max_new_tokens"]
    streams = {r: [r + 1] * full for r in range(n)}
    # chaos streams: (g)'s up to each stream's first replay, then drift
    chaos = {r: t[:10] + [0] * (full - 10) for r, t in streams.items()}

    def one(label, **kw):
        st = dict(launches={"flash_block_forward": 5, "paged_decode_attention": 64},
                  steady_ok=True, blocks_ok=True, host_ops=[2, 3], nonfinite_logits=0,
                  counts=dict(smoke.RECOVERY_PREDICTED[label]), streams=dict(streams),
                  schedule={r: (0, 0, 8) for r in range(n)}, first_replays={},
                  requests=n, generated_tokens=n * full)
        st.update(kw)
        return st

    passes = {label: one(label) for label in ("g", "h", "l")}
    for label in ("i", "j"):
        passes[label] = one(label, streams=dict(chaos), first_replays={0: 10, 3: 4})
    passes["m"] = one("m", streams={}, schedule={})
    passes["k"] = dict(launches={"flash_block_forward": 5, "paged_decode_attention": 64},
                       nonfinite_logits=0, counts=dict(smoke.RECOVERY_PREDICTED["k"]),
                       before={r: streams[r] for r in range(9)},
                       after={r: [7] * full for r in range(9, n)},
                       at_snapshot={r: streams[r][:20] for r in range(9, n)},
                       snapshot_saved=True, file_removed=True, capture_s=0.0,
                       restored_requests=n - 9)
    for (label, key), value in dict(changes).items():
        passes[label][key] = value
    return passes


def test_recovery_gates_hold_on_a_good_run(smoke):
    assert smoke.recovery_gates(_recovery_passes(smoke), smoke.RECOVERY_PREDICTED) == []


def _with(counts, **kw):
    return {**counts, **kw}


@pytest.mark.parametrize("label,key,value,says", [
    ("h", "streams", {0: [9]}, "(h) streams differ"),
    ("l", "schedule", {0: (1, 1, 8)}, "(l) schedule differ"),
    ("j", "streams", {0: [1] * 64}, "(i) and (j) streams differ"),
    ("j", "first_replays", {0: 9, 3: 4}, "(i) and (j) first_replays differ"),
    ("i", "streams", {0: [1] * 63}, "not every request completed"),
    ("g", "counts", "decode_blocks=35", "counts"),
    ("i", "counts", "tier_restore_failures=0", "no tier failure or checksum failure"),
    ("i", "counts", "corrupt_page_replays=0", "no corrupt-page replay"),
    ("h", "counts", "dispatch_retries=0", "(h) retried no dispatch"),
    ("k", "file_removed", False, "survived the clean drain"),
    ("k", "capture_s", 1.5, "captured again"),
    ("k", "after", {}, "cover every request"),
    ("k", "at_snapshot", {20: [99]}, "before the snapshot differ"),
    ("l", "counts", "corrupt_page_replays=1", "pass (l):"),
    ("m", "generated_tokens", 5, "(m) totals differ"),
    ("j", "launches", {"flash_block_forward": 0, "paged_decode_attention": 64},
     "(j) never launched flash_block_forward"),
    ("h", "blocks_ok", False, "host ops a decode block"),
    ("k", "nonfinite_logits", 2, "non-finite"),
])
def test_recovery_gates_catch_each_fault(smoke, label, key, value, says):
    """A pass whose streams, schedule or decisions leave (g)'s or each
    other's where they must not, a seam that never fired, a count the CPU
    did not predict, a crash that lost a request or kept its file or
    captured again, a repair that replayed, a kernel not launched or too
    many host ops: each fails the recovery phase, and the message says
    which."""
    passes = _recovery_passes(smoke)
    if key == "counts":
        name, n = value.split("=")
        value = _with(passes[label]["counts"], **{name: int(n)})
    problems = smoke.recovery_gates(_recovery_passes(smoke, {(label, key): value}),
                                    smoke.RECOVERY_PREDICTED)
    assert len(problems) >= 1 and any(says in p for p in problems), problems


def test_before_replay_counts_tokens_and_names_the_streams_that_differ(smoke):
    """``before_replay`` reads each chaos stream up to its first replay
    against the reference, and names a differing stream with its first
    insert in each pass."""
    ref = dict(streams={0: [1, 2, 3, 4], 1: [5, 6, 7, 8]}, admitted={0: (0, [0]), 1: (0, [1])})
    chaos = dict(streams={0: [1, 2, 9, 9], 1: [5, 7, 7, 7]}, first_replays={0: 2, 1: 3},
                 admitted={0: (0, [0]), 1: (1, [1, 2])})
    assert smoke.before_replay(chaos, ref) == dict(tokens=5, equal=4,
                                                   differ={1: ((1, [1, 2]), (0, [1]))})


def test_recovery_trace_brings_each_prefix_back(smoke):
    """The recovery trace: 32 requests in runs of four over four 512-token
    prefixes, so each prefix comes back once (the tier's hit), arrivals
    the trace phase's generator gives."""
    trace = smoke.recovery_trace(128256)
    assert len(trace) == smoke.RECOVERY_REQUESTS == 32
    heads = [tuple(it["prompt"][:512]) for it in trace]
    assert len(set(heads)) == 4
    assert all(heads[i] == heads[i + 16] for i in range(16))
    assert {it["prompt"].size - 512 for it in trace} == {64, 128, 256, 384}
    assert smoke.RECOVERY_CHAOS_RETRIES > smoke.RECOVERY_DISPATCH_PLAN["dispatch_max_failures"]


def test_recovery_chaos_pass_meets_its_coverage_on_the_cpu(smoke, tmp_path):
    """Passes (g) and (i) of the recovery phase are functions of the trace
    and the plan alone (greedy, no EOS): served by a one-layer model at the
    phase's scheduling shape (4096-token context, pages of 16, 8 slots,
    buckets 128/512/4096, K = 8, the 300-page pool and 256-page tier; the
    prompts' ids folded into a 512-token vocabulary, which moves no
    decision), (i) fires every seam, keeps a decode block's host ops,
    completes every request with its 64 tokens, gives exactly the counts
    the card's run is held to (``RECOVERY_PREDICTED``;
    ``scripts/recovery_rehearsal.py`` reads every pass's), and in fp32
    every token a stream delivered before its first replay is (g)'s. One
    intra-op thread: the test shares the CPU."""
    from neuronx_distributed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=512, hidden_size=16, intermediate_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, max_seq_len=4096, dtype=torch.float32)
    lm = smoke.recovery_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
    trace = smoke.recovery_trace(128256)
    for it in trace:
        it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        passes = smoke.recovery_passes(lm, "cpu", (), tmp_path / "r.snap", trace=trace,
                                       labels=("g", "i"))
    finally:
        torch.set_num_threads(threads)
    st = passes["i"]
    assert smoke.recovery_coverage(st) == []
    assert passes["g"]["counts"] == smoke.RECOVERY_PREDICTED["g"]
    pre = smoke.before_replay(st, passes["g"])
    assert pre["differ"] == {} and pre["equal"] == pre["tokens"] > 0
    assert {k: st["counts"][k] for k in smoke.RECOVERY_COUNT_KEYS} == smoke.RECOVERY_PREDICTED["i"]
    assert st["steady_ok"] and st["blocks_ok"] and st["first_replays"]
    assert len(st["streams"]) == 32 and all(len(t) == 64 for t in st["streams"].values())


# --- phase 4e: tenants ---------------------------------------------------------------


def _tenant_trace():
    """Four requests over two 256-token prefixes: a0 and a1 on prefix X,
    a0 again on X (its hit is a0's own), a1 on prefix Y."""
    x, y = np.arange(1, 300), np.arange(1000, 1300)
    return [{"adapter": a, "prompt": p} for a, p in (("a0", x), ("a1", x), ("a0", x),
                                                      ("a1", y))]


def _tenant_passes(smoke, changes=()):
    base = dict(adapter_repairs=0, adapter_garbled=0, adapter_load_retries=0, grammar_loads=2,
                grammar_hits=1, grammar_evictions=0, grammar_rejects=0, grammar_repairs=0,
                grammar_garbled=0, grammar_load_retries=0)
    counts = {**smoke.TENANT_PREDICTED["o"], **base, "completed": 4, "rejected": 0}
    streams = {r: [r + 1] * 64 for r in range(4)}
    admitted = {0: (0, [0, 1], 0), 1: (0, [0, 1], 0), 2: (1, [2], 256), 3: (2, [3], 0)}

    def run(**kw):
        return {**dict(launches={"flash_block_forward": 4, "paged_decode_attention": 64},
                       nonfinite_logits=0, steady_ok=True, blocks_ok=True, host_ops=[2],
                       submitted=4,
                       counts=dict(counts), parsed=0, constrained=0, capture_s=0.0,
                       streams=dict(streams), schedule={r: (0, 0, 8) for r in range(4)},
                       rejected=[], admitted=dict(admitted), finish_reasons={"budget": 4},
                       fault_stats=None), **kw}

    grammar = dict(parsed=2, constrained=2, finish_reasons={"budget": 2, "grammar_accept": 2})
    passes = {"n": dict(streams={0: [5, 6]}, launches={"paged_decode_attention": 8},
                        steady_ok=True, blocks_ok=True),
              "o": run(), "p": run(), "q": run(**grammar), "r": run(**grammar),
              "s": run(**grammar)}
    passes["s"]["counts"].update(adapter_repairs=2, adapter_garbled=2, adapter_load_retries=1,
                                 grammar_repairs=1, grammar_garbled=1, grammar_load_retries=1)
    passes["s"]["fault_stats"] = dict(adapter_load_faults=1, adapter_corruptions=3,
                                      grammar_load_faults=1, grammar_corruptions=1)
    for (label, key), value in dict(changes).items():
        passes[label][key] = value
    return passes


def _tenant_gates(smoke, passes):
    predicted = {label: {**want, "completed": 4, "rejected": 0}
                 for label, want in smoke.TENANT_PREDICTED.items()}
    return smoke.tenant_gates(passes, predicted, {0: [5, 6]}, {"o": _tenant_trace()})


def test_tenant_gates_hold_on_a_good_run(smoke):
    assert _tenant_gates(smoke, _tenant_passes(smoke)) == []


@pytest.mark.parametrize("label,key,value,says", [
    ("n", "streams", {0: [5, 7]}, "(n) tokens differ from trace pass (a)"),
    ("o", "counts", "adapter_hits=20", "(o) counts"),
    ("p", "streams", {0: [9]}, "(o) and (p) streams differ"),
    ("p", "rejected", [(3, "adapter_pool_exhausted")], "(o) and (p) rejected differ"),
    ("o", "admitted", {0: (0, [0], 0), 3: (1, [3], 256)}, "reused a prefix across adapters"),
    ("q", "parsed", 1, "1 of 2 constrained streams parse"),
    ("s", "parsed", 0, "(s): 0 of 2"),
    ("q", "finish_reasons", {"budget": 4}, "(q) finish reasons"),
    ("r", "streams", {0: [1] * 64, 1: [9] * 64, 2: [3] * 64, 3: [4] * 64},
     "(r) streams differ from (q)'s"),
    ("s", "counts", "adapter_repairs=1", "adapter slots garbled"),
    ("s", "counts", "grammar_load_retries=0", "grammar load faults"),
    ("q", "counts", "rejected=1", "rejected != 4 submitted"),
    ("r", "capture_s", 1.2, "(r) captured again"),
    ("o", "launches", {"flash_block_forward": 0}, "(o) never launched"),
    ("p", "blocks_ok", False, "host ops a decode block"),
    ("q", "nonfinite_logits", 1, "non-finite"),
])
def test_tenant_gates_catch_each_fault(smoke, label, key, value, says):
    """A pass whose tokens leave trace pass (a)'s or (o)'s or (q)'s where
    they must not, a count the CPU did not predict, a cross-adapter prefix
    hit, a stream that does not parse, a missing finish reason, a garbled
    slot not repaired, a load fault not retried, a request neither
    completed nor rejected, a second capture, a kernel not launched, too
    many host ops or a non-finite logit: each fails the tenants phase, and
    the message says which."""
    passes = _tenant_passes(smoke)
    if key == "counts":
        name, n = value.split("=")
        value = {**passes[label]["counts"], name: int(n)}
    problems = _tenant_gates(smoke, _tenant_passes(smoke, {(label, key): value}))
    assert len(problems) >= 1 and any(says in p for p in problems), problems


def test_tenant_traces_share_their_requests(smoke):
    """The adapter trace (o) and the grammar trace (q): 32 requests, the
    same prompts, arrivals and adapters (their labels come from streams of
    their own), eight adapters over two 256-token prefixes; half the
    requests carry a grammar, every grammar some."""
    o, q = smoke.tenant_trace(128256, False), smoke.tenant_trace(128256, True)
    assert len(o) == len(q) == smoke.TENANT_REQUESTS == 32
    for a, b in zip(o, q):
        assert np.array_equal(a["prompt"], b["prompt"])
        assert (a["adapter"], a["arrival_block"]) == (b["adapter"], b["arrival_block"])
        assert "grammar" not in a
    assert {it["adapter"] for it in o} <= {f"a{i}" for i in range(8)}
    assert len({tuple(it["prompt"][:256]) for it in o}) == 2
    assert {it.get("grammar") for it in q} == set(smoke.TENANT_GRAMMARS) | {None}
    assert set(smoke.tenant_regex()) == set(smoke.TENANT_GRAMMARS)


def test_tenant_schedule_meets_the_prediction_on_the_cpu(smoke):
    """Pass (o) is a function of the trace alone (greedy, no EOS, no
    grammar): served by a one-layer model at the phase's scheduling shape
    (the tenants ``CausalLM``: 4096-token context, pages of 16, 8 slots,
    buckets 128/512/4096, five usable adapter slots; the prompts' ids folded
    into a 512-token vocabulary), it gives exactly the counts the card's
    run is held to (``TENANT_PREDICTED``; ``scripts/tenants_rehearsal.py``
    reads every pass's), its prefix hits are same-adapter, and the pipelined
    pass (p) makes the same decisions. One intra-op thread."""
    from neuronx_distributed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=512, hidden_size=16, intermediate_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, max_seq_len=4096, dtype=torch.float32)
    lm = smoke.tenant_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
    trace = smoke.tenant_trace(128256, False)
    for it in trace:
        it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
    adapters = smoke.tenant_adapters(cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        o, p = (smoke.tenant_pass(lm, "cpu", trace, adapters, a, None, ()) for a in (False, True))
    finally:
        torch.set_num_threads(threads)
    assert {k: o["counts"][k] for k in smoke.TENANT_COUNT_KEYS} == smoke.TENANT_PREDICTED["o"]
    assert smoke.same_adapter_hits(o, trace)
    assert (o["streams"], o["schedule"], o["rejected"]) == \
        (p["streams"], p["schedule"], p["rejected"])
    assert o["steady_ok"] and o["blocks_ok"] and p["steady_ok"] and p["blocks_ok"]


def test_lora_layer_check_on_the_cpu(smoke):
    """Pass (t) at a small width on the CPU: the pooled adapter equals the
    merged weights within the tolerance the card is held to, and slot-0
    rows are the layer without LoRA, bit for bit."""
    from neuronx_distributed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_layers=2,
                         num_heads=4, num_kv_heads=2, dtype=torch.float32)
    got = smoke.lora_layer_check(cfg, "cpu")
    assert got["max_abs_err"] <= smoke.TOL_LORA_LAYER and got["base_bit_identical"]
    assert got["delta_max_abs"] > 100 * smoke.TOL_LORA_LAYER
