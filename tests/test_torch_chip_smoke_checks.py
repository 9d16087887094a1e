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
    ("e", "attribution", ["request 2: phases {} do not sum"], "(e) attribution: request 2"),
])
def test_overload_gates_catch_each_fault(smoke, label, key, value, says):
    """A missing shed, eviction or expiry, a pass whose decisions differ
    from (d)'s, a dropped or mismatched trace event, a refused export, too
    many host ops, a kernel not launched, a lost request, or a request
    whose attribution does not sum: each fails the overload phase, and the
    message says which."""
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
    ("i", "attribution", ["request 4: segments [] do not tile"], "(i) attribution: request 4"),
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
    ("s", "attribution", ["request 7: phases {} do not sum"], "(s) attribution: request 7"),
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


# --- phase 4f: parking -------------------------------------------------------------


def _park_passes(smoke, changes=()):
    """Fabricated passes of the park phase that every gate accepts, with
    ``changes`` ((label, key) -> value) applied."""
    n = len(smoke.PARK_LENS)
    streams = {rid: [rid] * smoke.PARK_NEW_TOKENS for rid in range(n)}

    def one(label):
        counts = dict(smoke.PARK_PREDICTED[label])
        parks = [dict(op="park", rid=rid, freed=True) for rid in range(n)] if label != "u" else []
        return dict(requests=n, streams=dict(streams), launches={"flash_block_forward": 3},
                    steady_ok=True, blocks_ok=True, host_ops=[2, 3], nonfinite_logits=0,
                    attribution=[], records=parks,
                    degraded=[0, 2, 3, 4, 5, 6, 7] if label == "x" else [],
                    park_resume_blocks={rid: 2 for rid in range(n)}, counts=counts,
                    slo={"ttft": {}} if label in ("v", "x") else None,
                    incidents=["slo_burn"] if label == "x" else [], incident_problems=[])

    passes = {label: one(label) for label in smoke.PARK_PASSES}
    for (label, key), value in dict(changes).items():
        passes[label][key] = value
    return passes


def test_park_gates_hold_on_a_good_run(smoke):
    assert smoke.park_gates(_park_passes(smoke), smoke.PARK_PREDICTED) == []


def _streams_with(smoke, rid, tokens):
    n = len(smoke.PARK_LENS)
    out = {r: [r] * smoke.PARK_NEW_TOKENS for r in range(n)}
    out[rid] = tokens
    return out


@pytest.mark.parametrize("label,key,value,says", [
    ("v", "streams", "1:flip", "(v) streams differ from pass (u)'s"),
    ("w", "streams", "5:flip", "(w) streams differ from pass (u)'s"),
    ("y", "streams", "0:short", "(y): not every session completed"),
    ("x", "streams", "1:flip", "resumed exactly differs"),
    ("v", "degraded", [3], "(v) degraded [3]"),
    ("x", "counts", "park_replays=6", "(x) counts"),
    ("x", "counts", "resumed=2", "(x) counts"),
    ("x", "counts", "fault_stats=torn0", "(x) counts"),
    ("w", "records", [dict(op="park", rid=0, freed=False)], "kept device or host pages"),
    ("v", "attribution", ["request 3: phases {} do not sum"], "(v) attribution: request 3"),
    ("v", "park_resume_blocks", {0: 2, 1: 0}, "no park_resume phase"),
    ("x", "slo", None, "(x) has no SLO status"),
    ("x", "incident_problems", ["incident_000_manual_b1.json: bad"], "incident bundle"),
    ("x", "incidents", [], "dumped no incident bundle"),
    ("v", "steady_ok", False, "host ops a decode block"),
    ("u", "launches", {"paged_decode_attention": 0}, "(u) never launched"),
    ("w", "requests", 7, "(w): not every session"),
])
def test_park_gates_catch_each_fault(smoke, label, key, value, says):
    """A pass whose exact resumes leave (u)'s tokens, a degraded resume
    where none may degrade, counts the CPU did not predict, a park that
    left pages behind, an attribution that does not sum, a parked session
    with no park_resume phase, a missing SLO status or a bad incident
    bundle, too many host ops, a kernel not launched or a lost session:
    each fails the park phase, and the message says which."""
    passes = _park_passes(smoke)
    if key == "streams":
        rid, how = value.split(":")
        rid = int(rid)
        toks = [rid] * smoke.PARK_NEW_TOKENS
        value = _streams_with(smoke, rid, toks[:-1] + [toks[-1] + 1] if how == "flip"
                              else toks[:10])
    if key == "counts":
        name, n = value.split("=")
        value = dict(passes[label]["counts"])
        if n == "torn0":
            value["fault_stats"] = {**value["fault_stats"], "park_torn_manifests": 0}
        else:
            value[name] = int(n)
    problems = smoke.park_gates(_park_passes(smoke, {(label, key): value}), smoke.PARK_PREDICTED)
    assert len(problems) >= 1 and any(says in p for p in problems), problems


def test_park_gates_want_every_rung_and_exact_cpu_replays(smoke):
    """(x) must fire every rung of the ladder; on the CPU (``exact_degraded``)
    its degraded sessions are held to (u)'s tokens as well."""
    x = _park_passes(smoke)["x"]
    x["counts"] = dict(x["counts"], store={**x["counts"]["store"], "torn_parks": 0})
    problems = smoke.park_gates({**_park_passes(smoke), "x": x}, {})
    assert any("no torn manifest" in p for p in problems), problems
    bad = _park_passes(smoke, {("x", "streams"): _streams_with(smoke, 2, [9] * 96)})
    assert smoke.park_gates(bad, smoke.PARK_PREDICTED) == []
    assert any("(x) streams differ" in p
               for p in smoke.park_gates(bad, smoke.PARK_PREDICTED, exact_degraded=True))


def test_attribution_problems_catch_a_doctored_attribution(smoke):
    """The invariant check accepts a tiling attribution and names the
    request whose phases do not sum to its span or whose segments leave a
    gap."""
    good = {"origin_block": 2, "end_block": 9, "phases_blocks": {"queued": 3, "decode": 4},
            "segments": [dict(phase="queued", start_block=2, end_block=5),
                         dict(phase="decode", start_block=5, end_block=9)]}
    assert smoke.attribution_problems({7: good}) == []
    short = dict(good, phases_blocks={"queued": 3, "decode": 3})
    gap = dict(good, segments=[dict(phase="queued", start_block=2, end_block=5),
                               dict(phase="decode", start_block=6, end_block=9)])
    for bad in (short, gap):
        problems = smoke.attribution_problems({7: good, 8: bad})
        assert problems and all(p.startswith("request 8") for p in problems), problems


def test_attribution_check_reads_a_parked_trace(smoke, tmp_path):
    """On a traced sim-free run with a park and a resume, every request is
    attributed, none with a problem, and the parked one pays its blocks
    parked as ``park_resume``."""
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=128, hidden_size=16, intermediate_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, max_seq_len=64, dtype=torch.float32)
    lm = CausalLM(cfg, tl.init_params(cfg, torch.Generator().manual_seed(0)),
                  tl.LlamaForCausalLM, device="cpu", buckets=(8, 16), max_batch=2, page_size=4)
    eng = ServeEngine(lm, block_steps=4, trace=True, park_dir=str(tmp_path / "park"))
    p = np.random.default_rng(1).integers(1, 127, (2, 8)).astype(np.int32)
    a, b = eng.submit(p[0], 16), eng.submit(p[1], 16)
    eng.step_block()
    eng.park(a)
    eng.step_block()
    eng.step_block()
    eng.submit(resume=a)
    eng.run()
    problems, atts = smoke.attribution_check(eng.tracer)
    assert problems == [] and sorted(atts) == [a, b]
    assert atts[a]["phases_blocks"]["park_resume"] == 2
    assert "park_resume" not in atts[b]["phases_blocks"]


def test_park_trace_sessions(smoke):
    """Eight sessions arriving one a block, six 512-token and two
    3072-token prompts, 96 new tokens each, no EOS; the draws are seeded."""
    trace = smoke.park_trace(128256)
    assert [len(it["prompt"]) for it in trace] == list(smoke.PARK_LENS)
    assert sorted(smoke.PARK_LENS).count(3072) == 2
    assert [it["arrival_block"] for it in trace] == list(range(8))
    assert all(it["max_new_tokens"] == 96 and it["eos_token_id"] is None for it in trace)
    again = smoke.park_trace(128256)
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(trace, again))


def test_park_fault_pass_meets_the_prediction_on_the_cpu(smoke, tmp_path):
    """Pass (x) is a function of the sessions and the plan alone (greedy, no
    EOS): served by a one-layer model at the phase's scheduling shape (the
    trace phase's ``CausalLM``; the prompts' ids folded into a 512-token
    vocabulary) it gives exactly the counts the card's run is held to
    (``PARK_PREDICTED``; ``scripts/park_rehearsal.py`` reads every pass's),
    fires every rung, and in fp32 its degraded sessions re-prefill to the
    reference pass's tokens. One intra-op thread."""
    from neuronx_distributed_tpu_torch.models import llama as tl

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tl.LlamaConfig(vocab_size=512, hidden_size=16, intermediate_size=32, num_layers=1,
                             num_heads=2, num_kv_heads=1, max_seq_len=4096, dtype=torch.float32)
        lm = smoke.trace_lm(cfg, "cpu", tl.init_params(cfg, torch.Generator().manual_seed(0)))
        trace = smoke.park_trace(128256)
        for it in trace:
            it["prompt"] = it["prompt"] % (cfg.vocab_size - 1) + 1
        passes = smoke.park_passes(lm, "cpu", (), tmp_path, trace=trace, labels=("u", "x"))
    finally:
        torch.set_num_threads(threads)
    x = passes["x"]
    assert {k: x["counts"][k] for k in smoke.PARK_PREDICTED["x"]} == smoke.PARK_PREDICTED["x"]
    assert x["streams"] == passes["u"]["streams"] and len(x["streams"]) == 8
    assert x["attribution"] == [] and x["incidents"] and x["slo"] is not None
    assert all(r["freed"] for r in x["records"] if r["op"] == "park")


# --- phase 4g: captured programs and speculation ------------------------------------


def _trace_pass(streams, chunk=512, ops_ok=True):
    return dict(streams=streams, requests=32, prefill_chunk_tokens=chunk, steady_ok=ops_ok,
                blocks_ok=True, host_ops=[2, 3])


def test_program_route_gates_hold_and_catch(smoke):
    captured = {"a": {0: [1, 2]}, "b": {0: [1, 2], 1: [3]}}
    good = {"a": _trace_pass({0: [1, 2]}, chunk=0), "b": _trace_pass({0: [1, 2], 1: [3]})}
    assert smoke.program_route_gates(captured, good) == []
    bad = {"a": _trace_pass({0: [1, 2]}, chunk=0, ops_ok=False),
           "b": _trace_pass({0: [1, 2], 1: [4]}, ops_ok=False)}
    problems = smoke.program_route_gates(captured, bad)
    assert len(problems) == 2 and "differ" in problems[0] and "host ops" in problems[1]


def _spec_result(tokens, acceptance=1.0, dispatches=2):
    from neuronx_distributed_tpu_torch.inference.causal_lm import GenerationResult

    return GenerationResult(tokens=np.asarray([tokens]), lengths=np.asarray([len(tokens)]),
                            stats=dict(acceptance_rate=acceptance,
                                       host_dispatches_per_block=dispatches))


def test_spec_gates_hold_and_catch(smoke):
    gen = _spec_result([5, 6, 7])
    ok = {"self": {"greedy": dict(host=_spec_result([5, 6, 7]), fused=_spec_result([5, 6, 7])),
                   "sampled": dict(host=_spec_result([9, 9, 1]), fused=_spec_result([9, 9, 1]))}}
    assert smoke.spec_gates(ok, gen, exact=True) == []
    bad = {"self": {"greedy": dict(host=_spec_result([5, 6, 8], 0.5),
                                   fused=_spec_result([5, 6, 7], dispatches=3))},
           "2-layer": {"greedy": dict(host=_spec_result([5, 6, 7], 0.1),
                                      fused=_spec_result([5, 6, 7]))}}
    problems = smoke.spec_gates(bad, gen, exact=True)
    assert len(problems) == 4, problems
    # in bf16 only the fused block and the dispatches are gated
    assert len(smoke.spec_gates(bad, gen, exact=False)) == 2


def test_kernel_wrappers_carry_b1_and_a_replay_adds_its_launches():
    """A replay runs no Python: the program adds the warm-up's launches of
    each wrapper, B1's included, to its counter."""
    from types import SimpleNamespace

    from neuronx_distributed_tpu_torch.inference import model_builder as mb
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward

    assert flash_block_forward in mb.KERNEL_WRAPPERS
    assert paged_decode_attention in mb.KERNEL_WRAPPERS
    prog = mb.CapturedProgram(lambda: None, "cpu", name="p")
    prog.graph = SimpleNamespace(replay=lambda: None)
    prog.launches_per_replay = {"flash_block_forward": 3, "paged_decode_attention": 1}
    before = flash_block_forward.launches, paged_decode_attention.launches
    try:
        prog.replay()
        prog.replay()
        assert flash_block_forward.launches - before[0] == 6
        assert paged_decode_attention.launches - before[1] == 2
    finally:
        flash_block_forward.launches, paged_decode_attention.launches = before


def _small_serve_config():
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=3,
                       num_heads=4, num_kv_heads=2, max_seq_len=256, dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, remat_policy=None)


@pytest.fixture
def short_spec(smoke, monkeypatch):
    """Phase 4g's speculation and Medusa at a 128-token prompt, 16 tokens."""
    monkeypatch.setattr(smoke, "SPEC_PROMPT", 128)
    monkeypatch.setattr(smoke, "SPEC_NEW", 16)
    from neuronx_distributed_tpu_torch.models.llama import init_params

    cfg = _small_serve_config()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def test_speculation_phase_rehearses_on_the_cpu(smoke, short_spec):
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward

    cfg, params = short_spec
    out = smoke.run_speculation(cfg, "cpu", params, (flash_block_forward,))
    assert out["drafts"]["self"]["host_stats"]["acceptance_rate"] == 1.0
    assert out["fp32_acceptance"]["self"] == {"greedy": 1.0, "sampled": 1.0}
    assert out["launches"] == {"flash_block_forward": 0}   # the twins launch nothing


def test_medusa_and_bundle_phases_rehearse_on_the_cpu(smoke, short_spec, tmp_path):
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward

    cfg, params = short_spec
    out = smoke.run_medusa(cfg, "cpu", params, (flash_block_forward,))
    assert out["stats"]["rounds"] >= 1 and out["fp32_stats"]["tokens_per_round"] >= 1.0
    # the bundle's gates pass up to the launch gate, which the CPU's twins fail
    with pytest.raises(smoke.SmokeFailure, match="launched no flash kernel"):
        smoke.run_bundle(cfg, "cpu", params, (flash_block_forward,), tmp_path)


def test_w8a16_exact_and_cases_against_jax_dequantize(smoke):
    """Phase 4h's B5 operands and its fp64 evaluation: the port's weights
    dequantized with the JAX package's ``dequantize_leaf`` give the same
    product (fp32 operands, atol 1e-5 on outputs of about 1), for the
    routed, shared and per-tensor cases at small widths."""
    from neuronx_distributed_tpu.quantization.core import dequantize_leaf

    for B, M, E, shared, routed, per_tensor in ((1, 8, 1, False, False, False),
                                                (4, 3, 4, True, False, False),
                                                (6, 1, 4, False, True, False),
                                                (1, 5, 1, False, False, True)):
        x, q, s, idx = smoke.w8a16_case("cpu", "fp32", B, M, 64, 48, E, shared, routed, per_tensor)
        got = smoke.w8a16_exact(x, q, s, idx)
        w = np.asarray(dequantize_leaf({"qweight": jnp.asarray(q.numpy()),
                                        "scale": jnp.asarray(s.numpy())}, jnp.float32))
        want = np.stack([x[b].numpy() @ w[int(i)] for b, i in enumerate(idx.tolist())])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        assert got.shape == (B, M, 48)


def test_compile_report_names_the_gemm_kernels(smoke, monkeypatch):
    """``compile_report`` reads B5's entries from a ``-Xptxas -v`` log
    (the mangled names nvcc gives them, static shared memory included),
    and ``compile_gates`` holds them: a ``tc::`` kernel that spills, or has
    neither HMMA nor HGMMA, fails, and so does a prefill (``wgmma``) kernel
    without HGMMA."""
    from neuronx_distributed_tpu_torch.kernels import _build

    ns = "_ZN46_GLOBAL__N__52bd4a8a_13_w8a16_gemm_cu_137ee84a"
    log = "\n".join(f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
                    f"ptxas info    : 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                    f"ptxas info    : Used {r} registers, used 1 barriers{smem}"
                    for m, r, smem in (
                        (f"{ns}2tc12wgmma_kernelILi1EEEv14CUtensorMap_stS1_NS_4ArgsE", 128, ""),
                        (f"{ns}2tc12wgmma_kernelILi2EEEv14CUtensorMap_stS1_NS_4ArgsE", 128, ""),
                        (f"{ns}2tc13decode_kernelENS_4ArgsE", 56, ""),
                        (f"{ns}2tc19dense_decode_kernelENS_4ArgsE", 80, ", 19712 bytes smem"),
                        (f"{ns}15gemm_f32_kernelENS_4ArgsE", 80, ", 8448 bytes smem"),
                        (f"{ns}13reduce_kernelI13__nv_bfloat16EEvPKfPT_xi", 32, ""),
                        (f"{ns}13reduce_kernelIfEEvPKfPT_xi", 32, "")))
    monkeypatch.setitem(_build.build_log, "w8a16_gemm", log)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr("shutil.which", lambda name: None)   # no cuobjdump: no HMMA count
    report = smoke.compile_report("w8a16_gemm")
    none = dict(spill_bytes=0, static_smem_bytes=0, hmma=None, hgmma=None)
    assert report == {"tc::wgmma_kernel<1>": {**none, "registers": 128},
                      "tc::wgmma_kernel<2>": {**none, "registers": 128},
                      "tc::decode_kernel": {**none, "registers": 56},
                      "tc::dense_decode_kernel": {**none, "registers": 80,
                                                  "static_smem_bytes": 19712},
                      "gemm_f32_kernel": {**none, "registers": 80, "static_smem_bytes": 8448},
                      "reduce_kernel<bf16>": {**none, "registers": 32},
                      "reduce_kernel<float>": {**none, "registers": 32}}
    sass = {"tc::wgmma_kernel<1>": (0, 4), "tc::wgmma_kernel<2>": (0, 4),
            "tc::decode_kernel": (16, 0), "tc::dense_decode_kernel": (16, 0)}
    for k, (hmma, hgmma) in sass.items():
        report[k].update(hmma=hmma, hgmma=hgmma)
    smoke.compile_gates(report)
    for k, change, match in (("tc::decode_kernel", dict(hmma=0), "no HMMA or HGMMA"),
                             ("tc::wgmma_kernel<2>", dict(hgmma=0), "no HMMA or HGMMA"),
                             ("tc::wgmma_kernel<1>", dict(hmma=8, hgmma=0), "no HGMMA"),
                             ("tc::decode_kernel", dict(spill_bytes=4), "spills")):
        bad = {n: dict(v) for n, v in report.items()}
        bad[k].update(change)
        with pytest.raises(smoke.SmokeFailure, match=match):
            smoke.compile_gates(bad)


def test_quant_phase_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 4h's (q1) and (q2) at tiny widths on the CPU (the kernels'
    twins; no timing, no memory reading): every request completes, the
    captured and stepwise routes agree, the Mixtral serve runs all_experts
    and its generate selective, and the int8 weights are about a quarter
    of fp32's. (q3) fails there by design: it demands B5 launches."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig

    small = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                 num_heads=4, num_kv_heads=2, max_seq_len=256, dtype=torch.float32,
                 param_dtype=torch.float32)
    monkeypatch.setattr(smoke, "serve_config", lambda: LlamaConfig(**small))
    monkeypatch.setattr(smoke, "mixtral_config",
                        lambda: MixtralConfig(**small, num_experts=8, top_k=2))
    # the serve workload's shape at a quarter of its prompt lengths
    monkeypatch.setattr(smoke, "SERVE_PROMPT_LENS", tuple(n // 4 for n in smoke.SERVE_PROMPT_LENS))
    monkeypatch.setattr(smoke, "SHARED_PREFIX", smoke.SHARED_PREFIX // 4)
    monkeypatch.setattr(smoke, "MIXTRAL_PROMPT", 128)
    monkeypatch.setattr(smoke, "MIXTRAL_GEN_NEW", 16)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {"total_memory": 1})())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.run_quant_phase("cpu", parts=("q1", "q2"))
    finally:
        torch.set_num_threads(threads)
    q1, q2 = out["q1"], out["q2"]
    assert q1["int8"]["requests"] == q2["serve"]["requests"] == len(smoke.SERVE_PROMPT_LENS)
    wb = q1["int8"]["weight_bytes"]   # fp32 weights here: a byte for every four
    assert wb["int8"] * 4 == q1["int8"]["bf16_weight_bytes"]["float"] - wb["float"]
    assert 0.0 <= q1["int8"]["token_match_share"] <= 1.0
    assert q2["generate"]["stepwise_equal"] and q2["weight_bytes"]["int8"] > 0
    with pytest.raises(smoke.SmokeFailure, match="launched no w8a16_gemm"):
        smoke.quant_small_check("cpu")
    # the route gates read the counts (zero here: the twins launch nothing)
    assert q1["int8"]["launches_by_route"] == {
        "w8a16_gemm": {"wgmma": 0, "decode": 0, "f32": 0}}
    with pytest.raises(smoke.SmokeFailure, match="launched no w8a16_gemm on its wgmma route"):
        smoke.quant_route_gates(out)


def test_device_profile_summary_and_b5_trace_by_route(smoke, tmp_path):
    """``device_profile_summary`` ranks a trace's device kernels, writes the
    table and adds a group's share; ``b5_traced_by_route`` counts B5's
    kernels by route (both decode kernels on ``decode``, the split-K
    reduction left out), which ``profile_generate`` holds against the
    launch counts."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(key=k, count=n, self_device_time_total=us, device_type=d)
              for k, n, us, d in (
                  ("void (anonymous namespace)::tc::wgmma_kernel<2>(CUtensorMap_st)", 32, 600.0,
                   cuda),
                  ("void (anonymous namespace)::tc::decode_kernel(Args)", 96, 300.0, cuda),
                  ("void (anonymous namespace)::tc::dense_decode_kernel(Args)", 64, 100.0, cuda),
                  ("void (anonymous namespace)::reduce_kernel<__nv_bfloat16>(float const*)", 64,
                   50.0, cuda),
                  ("void flash_fwd_kernel", 8, 950.0, cuda),
                  ("aten::mm", 5, 0.0, cpu))]
    prof = SimpleNamespace(key_averages=lambda: _Averages(events))
    out = smoke.device_profile_summary(prof, 0.004, str(tmp_path / "p" / "table.txt"),
                                       shares=(("b5", smoke.B5_DEVICE_KERNELS),), top=2)
    assert (tmp_path / "p" / "table.txt").read_text() == "table"
    assert out["device_busy_s"] == pytest.approx(2e-3)
    assert out["device_busy_share"] == pytest.approx(0.5)
    assert [t["calls"] for t in out["top"]] == [8, 32]
    assert out["b5_ms"] == pytest.approx(1.05) and out["b5_share"] == pytest.approx(0.525)
    assert smoke.b5_traced_by_route(prof) == {"wgmma": 32, "decode": 160, "f32": 0}
    prof_idle = SimpleNamespace(key_averages=lambda: _Averages(events[-1:]))
    with pytest.raises(smoke.SmokeFailure, match="no device activity"):
        smoke.device_profile_summary(prof_idle, 1.0, str(tmp_path / "idle.txt"))


class _Averages(list):
    """A stand-in for ``torch.profiler``'s ``key_averages()``: the events
    and a table."""

    def table(self, **kw):
        return "table"


# --- phase 4i: the replica fleet ------------------------------------------------------


def _fleet_pass(smoke, label, n):
    want = dict(smoke.FLEET_PREDICTED.get(label, {}))
    stats = {k: want.get(k, 0) for k in smoke.FLEET_STAT_KEYS}
    return dict(stats=stats, submitted=n, completed=want.get("completed", n),
                rejected=want.get("rejected", 0), blocks=want.get("blocks", 10),
                host_ops=dict(steady_ok=True, blocks_ok=True, host_ops=[2, 3]),
                survivor_pages_in_use={1: 0}, dropped=0, attribution_problems=[],
                attributed=n, nonfinite_logits=0,
                launches={"flash_block_forward": 4, "paged_decode_attention": 9},
                router_lanes=["clock", "drain", "faults", "place"])


def _fleet_passes(smoke, changes=()):
    """Fabricated phase-4i passes that every gate accepts, with ``changes``
    ((path, key) -> value) applied."""
    z3 = {k: _fleet_pass(smoke, f"z3_{k}", 32) for k in ("disagg", "colocated", "disagg_faults")}
    z3["disagg"].update(adopted_bytes_equal=True, adopt_checks=32, decode_inserts=0)
    z3["disagg_faults"].update(corrupt_adopted=0, adopted_bytes_equal=True, adopt_checks=26,
                               decode_inserts=6)
    z4 = dict(_fleet_pass(smoke, "z4", 42), device_states=True,
              scale_events=list(smoke.FLEET_PREDICTED["z4_events"]),
              time_to_ready_blocks=list(smoke.FLEET_PREDICTED["z4_time_to_ready"]),
              spawns=[dict(replica=3, warm=False, new_state=True, others_busy=True,
                           captured={"decode": 240.0}, spawn_ms=900.0, capture_s=0.2)])
    passes = {"z1": {k: dict(_fleet_pass(smoke, f"z1_{k}", 8), identical=True)
                     for k in ("sync", "async")},
              "z2": _fleet_pass(smoke, "z2", 32), "z3": z3, "z4": z4,
              "z5": dict(identical={"card_router": True, "card_disagg": True, "cpu_router": True,
                                    "cpu_disagg": True}, greedy_card_equals_cpu=True,
                         launches={"flash_block_forward": 2, "paged_decode_attention": 5}),
              "memory": dict(peak_bytes=40 * 2**30, card_bytes=80 * 2**30)}
    for (path, key), value in dict(changes).items():
        node = passes
        for part in path.split("/"):
            node = node[part]
        node[key] = value
    return passes


def test_fleet_gates_hold_on_a_good_run(smoke):
    assert smoke.fleet_gates(_fleet_passes(smoke), smoke.FLEET_PREDICTED) == []


@pytest.mark.parametrize("path,key,value,says", [
    ("z1/sync", "identical", False, "(z1 sync) the router's streams differ"),
    ("z2", "completed", 31, "(z2) completed 31 + rejected 0 != submitted 32"),
    ("z2", "stats", "failovers=0", "(z2) failovers 0, the CPU predicted 1"),
    ("z2", "stats", "affinity_placements=3", "(z2) affinity_placements 3"),
    ("z2", "stats", "drain_migrated_requests=0", "(z2) drain_migrated_requests 0"),
    ("z2", "survivor_pages_in_use", {1: 4}, "(z2) survivors hold pages"),
    ("z2", "router_lanes", ["clock", "place"], "(z2) router lanes"),
    ("z2", "dropped", 3, "(z2) the tracer dropped 3"),
    ("z2", "attribution_problems", ["request 4: phases"], "(z2) attribution: request 4"),
    ("z2", "attributed", 30, "(z2) 30 of 32 requests attributed"),
    ("z2", "host_ops", dict(steady_ok=False, blocks_ok=True, host_ops=[3]), "host-op contract"),
    ("z2", "launches", {"paged_decode_attention": 0}, "(z2) never launched"),
    ("z3/disagg", "stats", "handoffs_degraded=1", "(z3) handoffs sent"),
    ("z3/disagg", "adopted_bytes_equal", False, "adopted page bytes differ"),
    ("z3/disagg", "decode_inserts", 2, "a decode worker re-prefilled"),
    ("z3/disagg_faults", "corrupt_adopted", 1, "a corrupted handoff was adopted"),
    ("z3/disagg_faults", "stats", "handoffs_degraded=5", "(z3_disagg_faults) handoffs_degraded"),
    ("z3/colocated", "blocks", 47, "(z3_colocated) blocks 47, the CPU predicted 46"),
    ("z4", "scale_events", [], "(z4) scale events []"),
    ("z4", "time_to_ready_blocks", [2], "(z4) time to ready [2]"),
    ("z4", "spawns", [dict(replica=3, warm=False, new_state=False, others_busy=True,
                          captured={}, spawn_ms=1.0, capture_s=0.0)], "captured its programs"),
    ("z5", "identical", {"card_router": False, "cpu_router": True}, "(z5) fp32 fleet streams"),
    ("z5", "greedy_card_equals_cpu", False, "card vs CPU"),
    ("memory", "peak_bytes", 81 * 2**30, "above the card's"),
])
def test_fleet_gates_catch_each_fault(smoke, path, key, value, says):
    """A router over one replica that leaves the bare engine's streams, a
    lost request, a decision the CPU did not predict, pages held after a
    pass, missing router lanes, tracer drops, an attribution that does not
    sum, extra host ops, a kernel not launched, a handoff degraded or not
    adopted byte for byte, a re-prefill on a decode worker, a corrupted
    handoff adopted, other scale events, a spawn that captured nothing
    beside live sessions, an fp32 fleet off one engine's streams, or a
    peak above the card: each fails phase 4i, and the message says which."""
    passes = _fleet_passes(smoke)
    if key == "stats":
        name, n = value.split("=")
        node = passes
        for part in path.split("/"):
            node = node[part]
        value = dict(node["stats"], **{name: int(n)})
    problems = smoke.fleet_gates(_fleet_passes(smoke, {(path, key): value}),
                                 smoke.FLEET_PREDICTED)
    assert problems and any(says in p for p in problems), problems


def test_fleet_predictions_are_the_rehearsals(smoke):
    """``FLEET_PREDICTED`` is what ``scripts/fleet_rehearsal.py`` prints:
    (z2)-(z4) over the port's ``SimCausalLM`` at the trace cell's shape,
    whose gates hold on the rehearsal itself."""
    import importlib.util as iu

    spec = iu.spec_from_file_location("fleet_rehearsal", ROOT / "scripts" / "fleet_rehearsal.py")
    rehearsal = iu.module_from_spec(spec)
    spec.loader.exec_module(rehearsal)
    from neuronx_distributed_tpu_torch.inference.simlm import SimCausalLM

    sim = SimCausalLM(max_batch=8, buckets=smoke.TRACE_BUCKETS, max_seq_len=4096,
                      vocab_size=rehearsal.VOCAB, page_size=16, page_pool_pages=8 * 256 + 8)
    passes = {"z2": smoke.fleet_z2(sim, "cpu", ()), "z3": smoke.fleet_z3(sim, "cpu", ()),
              "z4": smoke.fleet_z4(sim, "cpu", ())}
    counts = rehearsal.predicted(passes)
    assert counts == smoke.FLEET_PREDICTED
    assert smoke.fleet_gates(passes, counts) == []


# --- phase 4j: tensor-parallel serving --------------------------------------------------

def _tp_readings(smoke, over=None):
    """Readings of a good phase 4j run (t1 both legs, t2 two ranks, the
    small model's TP=1 reference), with ``over`` {(path, key): value}
    replacing one reading (path "t1/nccl", "t2/0/serve", "t2/1", ...)."""
    n, new = len(smoke.SERVE_PROMPT_LENS), smoke.MAX_NEW_TOKENS
    streams = {i: [i + 1] * new for i in range(n)}
    leg = dict(streams=dict(streams), steady_blocks=4, steady_ok=True, host_ops=[2, 2, 3],
               requests=n, nonfinite=0, launches={"flash_block_forward": 8,
                                                   "paged_decode_attention": 128},
               kv_bytes={"kv_bytes": 100, "kv_bytes_global": 100, "kv_slab_bytes": 90})
    t1 = {"plain": dict(leg), "nccl": dict(leg, collective_work={"Memcpy DtoD": 528},
                                           nccl_kernels={}, block_steps=8, group_backend="nccl")}
    small_ref = {"logits": [[0.5, -1.0], [2.0, 0.25]], "streams": {0: [3, 4], 1: [5]}}

    def rank(r):
        serve = dict(requests=n, generated_tokens=n * new, nonfinite=0, digest="ab" * 8,
                     digests=["ab" * 8] * 2,
                     kv_bytes={"kv_bytes": 50, "kv_bytes_global": 100, "kv_slab_bytes": 45},
                     weight_bytes=52, launches=dict(leg["launches"]))
        return dict(rank=r, backend="gloo", local_heads=list(smoke.TP_LOCAL_HEADS),
                    weight_bytes_tp1=100, layers=32, serve=serve,
                    small={"logits": [[0.5 + 1e-6, -1.0], [2.0, 0.25]],
                           "streams": {"0": [3, 4], "1": [5]}},
                    held={"flash_fwd": {"max_abs_err": 1e-3}, "paged_decode": {"ok": True}})

    t2 = {"ranks": [rank(0), rank(1)], "layers": None}
    for (path, key), value in (over or {}).items():
        node = {"t1": t1, "t2": t2}[path.split("/")[0]]
        for part in path.split("/")[1:]:
            node = node["ranks"][int(part)] if part.isdigit() else node[part]
        node[key] = value
    return t1, t2, small_ref


def test_tp_gates_hold_on_a_good_run(smoke):
    assert smoke.tp_gates(*_tp_readings(smoke)) == []


@pytest.mark.parametrize("path,key,value,says", [
    ("t2/1/serve", "digests", ["ab" * 8, "cd" * 8], "digests differ across ranks"),
    ("t2/1/serve", "digest", "cd" * 8, "digests differ"),
    ("t2/0/small", "streams", {"0": [3, 9], "1": [5]}, "small-model greedy streams differ"),
    ("t2/1/small", "logits", [[0.5 + 1e-3, -1.0], [2.0, 0.25]], "small-model logits differ"),
    ("t1/nccl", "streams", {0: [0]}, "(t1) streams through the NCCL group differ"),
    ("t1/nccl", "collective_work", {"Memcpy DtoD": 7}, "holds no more device work"),
    ("t1/nccl", "steady_ok", False, "(t1 nccl) steady decode blocks are not 2 host ops"),
    ("t1/plain", "requests", 7, "(t1 plain) 7 requests"),
    ("t2/0/serve", "generated_tokens", 100, "(t2 rank 0) 8 requests, 100 tokens"),
    ("t2/0/serve", "kv_bytes", {"kv_bytes": 60, "kv_bytes_global": 100}, "kv_bytes 60"),
    ("t2/1/serve", "weight_bytes", 56, "weight bytes 56"),
    ("t2/0", "local_heads", [32, 8], "local heads [32, 8]"),
    ("t2/1/serve", "launches", {"flash_block_forward": 8}, "paged_decode_attention never"),
    ("t2/0/held", "flash_fwd", {"max_abs_err": 1.0}, "B1 at local heads differs"),
    ("t2/1/held", "paged_decode", {"ok": False}, "B2 at local heads is not held"),
    ("t2/0", "backend", "nccl", "(t2 rank 0) group backend nccl"),
])
def test_tp_gates_catch_each_fault(smoke, path, key, value, says):
    """A digest that differs between the ranks, a small-model stream or
    logit off TP=1's, NCCL streams off the plain ones, a replay through the
    NCCL group with less than one collective copy a step beyond the plain
    block's, extra host ops, a lost request or token, a rank holding
    more than 0.55 of TP=1's KV or weight bytes, the wrong heads, a kernel
    not launched or not held at the rank's heads: each fails phase 4j, and
    the message says which."""
    problems = smoke.tp_gates(*_tp_readings(smoke, {(path, key): value}))
    assert problems and any(says in p for p in problems), problems


def test_tp_passes_rehearse_on_the_cpu(smoke):
    """Phase 4j's passes on a small model on the CPU, TP=2 as two thread
    ranks over gloo: the serve workload's digest equal on both ranks and to
    TP=1's (fp32), half the KV bytes a rank, the small-model streams equal
    TP=1's and logits within ``TP_SMALL_TOL``."""
    import dataclasses

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        init_params,
    )
    from neuronx_distributed_tpu_torch.parallel import mesh

    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=1024, dtype=torch.float32)
    small = dataclasses.replace(cfg, max_seq_len=256)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(r, tp):
        sd = init_params(cfg, torch.Generator().manual_seed(0), tp_rank=r, tp_size=tp)
        lm = CausalLM(cfg, sd, LlamaForCausalLM, device="cpu", **smoke.TP_SERVE_LM)
        st = smoke.tp_serve_pass(lm, "cpu", (), fused=False)
        sd = init_params(small, torch.Generator().manual_seed(0), tp_rank=r, tp_size=tp)
        return st, smoke.tp_small_pass(CausalLM(small, sd, LlamaForCausalLM, device="cpu",
                                                **smoke.TP_SMALL_LM))

    try:
        one = run(0, 1)
        two = mesh.run_in_threads(2, lambda r: run(r, 2))
    finally:
        torch.set_num_threads(threads)
    assert one[0]["requests"] == len(smoke.SERVE_PROMPT_LENS)
    for st, sm in two:
        assert st["digest"] == one[0]["digest"]
        assert st["kv_bytes"]["kv_bytes"] <= smoke.TP_SHARE_MAX * one[0]["kv_bytes"]["kv_bytes"]
        assert st["weight_bytes"] <= smoke.TP_SHARE_MAX * one[0]["weight_bytes"]
        assert sm["streams"] == one[1]["streams"]
        assert np.abs(np.asarray(sm["logits"]) - np.asarray(one[1]["logits"])).max() \
            <= smoke.TP_SMALL_TOL


@pytest.fixture(scope="module")
def train_loop_run(smoke, tmp_path_factory):
    """Phase 4k at a tiny width on the CPU: the same loop, crash and resume
    as on the card."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=128, dtype=torch.float32,
                      param_dtype=torch.float32, remat_policy="full")
    return smoke.run_train_loop(cfg, "cpu", (), tmp_path_factory.mktemp("loop"),
                                lora=dict(r=8, lora_alpha=16.0, lora_dropout=0.05))


def test_train_loop_phase_rehearses_on_the_cpu(smoke, train_loop_run):
    """The loop resumes from step 3 of 6 with bit-identical losses, grad
    norms and adapters, the base untouched and the loss falling; every gate
    but the card's (launches, memory) holds."""
    st = train_loop_run
    assert smoke.train_loop_gates(st, kernels=False) == []
    assert (st["resume_tag"], st["resumed_at"], st["steps_resumed"]) == ("step_3", 3, [4, 5, 6])
    assert st["adapter_tensors"] == 2 * 7 * 2 and st["saves"] == 2 and st["flip_caught"]
    assert st["losses_resumed"] == st["losses"][3:]


@pytest.mark.parametrize("key,value,says", [
    ("losses_resumed", [0.0, 0.0, 0.0], "resumed losses"),
    ("adapters_equal", False, "resumed adapters"),
    ("base_unchanged", False, "frozen base"),
    ("flip_caught", False, "flipped payload byte"),
    ("using_native", False, "native token-shard reader"),
    ("resume_tag", "step_6", "resumed from step_6"),
    ("epoch_loss_last", 1e9, "did not fall"),
    ("launches", {"flash_block_forward": 64, "flash_bwd_dkdv": 0, "flash_bwd_dq": 32,
                  "fused_adamw_leaf": 448}, "never launched flash_bwd_dkdv"),
])
def test_train_loop_gates_catch_each_fault(smoke, train_loop_run, key, value, says):
    st = {**train_loop_run, key: value, "peak_bytes_phase": 1, "device_bytes": 2,
          "b4_leaf_max_abs_err": 0.0}
    if key != "launches":
        st["launches"] = dict.fromkeys(smoke.TRAIN_LOOP_COUNTERS, 1)
    bad = smoke.train_loop_gates(st)
    assert len(bad) == 1 and says in bad[0], bad


def test_train_check_cases_rehearse_on_the_cpu(smoke):
    """Phase 3's five training cases run end to end (CPU against CPU here,
    so every difference reads 0 and no kernel is counted)."""
    out = smoke.train_check("cpu", ())
    assert list(out) == [name for name, _ in smoke.TRAIN_CHECK_CASES]
    for name, r in out.items():
        assert r["loss_max_abs_err"] == 0.0 and r["param_max_abs_err"] == 0.0, name
        assert r["losses_gpu"][1] < r["losses_gpu"][0], name
    assert out["lora"]["trained_tensors"] == 2 * 7 * 2


def _dist_run():
    """A fabricated phase-4l reading that passes every gate: (d0) and four
    ranks at TP 2 x DP 2."""
    d0 = {"steps": [{"loss": 10.0 - i, "grad_norm": 1.0} for i in range(3)],
          "state_bytes_by_leaf": {"a": 4000, "norm": 40}}
    ranks = []
    for r in range(4):
        tp = r % 2
        ranks.append({"rank": r, "coords": {"tp": tp, "dp": r // 2},
                      "tp_sharded_leaves": ["a"], "state_bytes_tp_sharded": 1000,
                      "d1": {"steps": [{"loss": (10.0 - i) * 1.001, "digest": f"p{tp}{i}",
                                        "replicated_digest": f"r{i}"} for i in range(3)],
                             "launches": {"flash_block_forward": 12, "flash_bwd_dkdv": 6,
                                          "flash_bwd_dq": 6, "fused_adamw_leaf": 48}}})
    return d0, {"ranks": ranks}


def test_dist_gates_hold_on_a_good_run(smoke):
    d0, d1 = _dist_run()
    assert smoke.dist_gates(d0, d1) == []
    assert abs(d1["loss_max_rel_diff"] - 1e-3) < 1e-9
    assert all(rk["state_share_of_quarter"] == 1.0 for rk in d1["ranks"])


@pytest.mark.parametrize("fault,says", [
    ("loss", "losses differ"), ("dp_digest", "data-parallel replicas"),
    ("replicated", "TP-replicated leaves"), ("state", "ZeRO state bytes"),
    ("b1", "never launched flash_block_forward"), ("b4", "B4 launched 60 times")])
def test_dist_gates_catch_each_fault(smoke, fault, says):
    d0, d1 = _dist_run()
    rk = d1["ranks"][2]
    if fault == "loss":
        rk["d1"]["steps"][1]["loss"] *= 1.02
    elif fault == "dp_digest":
        rk["d1"]["steps"][2]["digest"] = "other"
    elif fault == "replicated":
        rk["d1"]["steps"][0]["replicated_digest"] = "other"
    elif fault == "state":
        rk["state_bytes_tp_sharded"] = 1020
    elif fault == "b1":
        rk["d1"]["launches"]["flash_block_forward"] = 0
    else:
        rk["d1"]["launches"]["fused_adamw_leaf"] = 60
    problems = smoke.dist_gates(d0, d1)
    assert any(says in p for p in problems), problems


def _cppp_run():
    """A fabricated phase-4m reading that passes every gate: (c0), (p0) and
    four ranks at CP 2 x TP 2, then TP 2 x PP 2."""
    c0 = {"steps": [{"loss": 10.0 - i, "grad_norm": 1.0} for i in range(3)]}
    p0 = {"loss": 10.5}
    launches = {"flash_block_forward": 8, "flash_bwd_dkdv": 4, "flash_bwd_dq": 4,
                "fused_adamw_leaf": 90}
    ranks = []
    for r in range(4):
        stage = r // 2
        ranks.append({
            "rank": r, "p1_stage": stage, "p2_stage": stage,
            "c1": {"steps": [{"loss": (10.0 - i) * 1.002} for i in range(3)],
                   "launches": dict(launches), "collectives": {"send": [40, 10], "recv": [40, 10]}},
            "p1": {"steps": [{"loss": 10.5 * 1.003 - i, "stash_peak": 2 - stage,
                              "sends_peak": 2 - stage} for i in range(3)],
                   "launches": dict(launches)},
            "p2": {"steps": [{"loss": (10.5 * 1.003 - i) * 1.001, "stash_peak": 4,
                              "sends_peak": 3} for i in range(3)],
                   "launches": dict(launches)}})
    return c0, p0, ranks


def test_cppp_gates_hold_on_a_good_run(smoke):
    c0, p0, ranks = _cppp_run()
    assert smoke.cppp_gates(c0, p0, ranks) == []
    assert abs(c0["c1_loss_max_rel_diff"] - 2e-3) < 1e-9
    assert abs(p0["p1_loss_rel_diff"] - 3e-3) < 1e-9


@pytest.mark.parametrize("fault,says", [
    ("c1_loss", "(c1) losses differ from (c0)'s"), ("p1_loss", "(p1)'s step-1 loss"),
    ("p2_loss", "(p2) losses differ from (p1)'s"), ("b3", "never launched flash_bwd_dq in (p2)"),
    ("b4", "never launched fused_adamw_leaf in (c1)"), ("ring", "sent nothing round the ring"),
    ("stash", "stashed more than pp - stage"), ("sends", "held more than pp - stage sends"),
    ("steps", "ran 2 p1 steps"),
    ("ranks", "c1 losses differ from rank 0's")])
def test_cppp_gates_catch_each_fault(smoke, fault, says):
    c0, p0, ranks = _cppp_run()
    rk = ranks[3]
    if fault == "c1_loss":
        for r in ranks:
            r["c1"]["steps"][2]["loss"] *= 1.02
    elif fault == "p1_loss":
        p0["loss"] *= 0.97
    elif fault == "p2_loss":
        for r in ranks:
            r["p2"]["steps"][1]["loss"] *= 1.03
    elif fault == "b3":
        rk["p2"]["launches"]["flash_bwd_dq"] = 0
    elif fault == "b4":
        rk["c1"]["launches"]["fused_adamw_leaf"] = 0
    elif fault == "ring":
        rk["c1"]["collectives"] = {}
    elif fault == "stash":
        rk["p1"]["steps"][0]["stash_peak"] = 2
    elif fault == "sends":
        rk["p1"]["steps"][1]["sends_peak"] = 2
    elif fault == "steps":
        rk["p1"]["steps"].pop()
    else:
        rk["c1"]["steps"][0]["loss"] += 1e-4
    problems = smoke.cppp_gates(c0, p0, ranks)
    assert any(says in p for p in problems), problems


def _moe_run():
    """A fabricated phase-4n reading that passes every gate: (m0), four
    (m1) ranks at TP 2 x EP 2, and (m2)'s CPU side."""
    m0 = {"steps": [{"loss": 10.0 - i, "grad_norm": 1.0} for i in range(3)]}
    launches = {"flash_block_forward": 4, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2,
                "fused_adamw_leaf": 40}
    ranks = [{"rank": r,
              "m1": {"steps": [{"loss": (10.0 - i) * 1.004} for i in range(3)],
                     "launches": dict(launches), "collectives": {"all_to_all": [24, 10]}},
              "m2": {"tp2_ep2": {"bit_identical": True}}} for r in range(4)]
    small = {"max_abs_err": {"tp2_ep2": 4e-7, "ep2_edp2": 5e-7},
             "dropped_equal": {"tp2_ep2": True, "ep2_edp2": True},
             "dbrx_max_abs_err": 3e-7, "dbrx_dropped_equal": True,
             "tp1_ep1_equals_gathered": True, "flipped_byte_caught": True}
    return m0, ranks, small


def test_moe_gates_hold_on_a_good_run(smoke):
    m0, ranks, small = _moe_run()
    assert smoke.moe_gates(m0, ranks) == []
    assert smoke.moe_small_problems(small, ranks) == []
    assert abs(m0["m1_loss_max_rel_diff"] - 4e-3) < 1e-9


@pytest.mark.parametrize("fault,says", [
    ("loss", "(m1) losses differ from (m0)'s"), ("b1", "never launched flash_block_forward"),
    ("b3", "never launched flash_bwd_dkdv"), ("b4", "never launched fused_adamw_leaf"),
    ("a2a", "sent no token through the expert all-to-all"), ("steps", "ran 2 (m1) steps"),
    ("ranks", "(m1) losses differ from rank 0's"),
    ("small", "(m2) ep2_edp2: losses or grad norms differ"),
    ("dropped", "(m2) tp2_ep2: dropped assignments differ"),
    ("dbrx", "(m2) DBRX: the step differs"), ("resume", "the resumed step 3 is not bit"),
    ("load", "tp1_ep1_equals_gathered failed"), ("flip", "flipped_byte_caught failed")])
def test_moe_gates_catch_each_fault(smoke, fault, says):
    m0, ranks, small = _moe_run()
    rk = ranks[2]
    if fault == "loss":
        for r in ranks:
            r["m1"]["steps"][1]["loss"] *= 1.02
    elif fault in ("b1", "b3", "b4"):
        name = {"b1": "flash_block_forward", "b3": "flash_bwd_dkdv", "b4": "fused_adamw_leaf"}
        rk["m1"]["launches"][name[fault]] = 0
    elif fault == "a2a":
        rk["m1"]["collectives"] = {"all_reduce": [10, 10]}
    elif fault == "steps":
        rk["m1"]["steps"].pop()
    elif fault == "ranks":
        rk["m1"]["steps"][0]["loss"] += 1e-4
    elif fault == "small":
        small["max_abs_err"]["ep2_edp2"] = 3e-5
    elif fault == "dropped":
        small["dropped_equal"]["tp2_ep2"] = False
    elif fault == "dbrx":
        small["dbrx_max_abs_err"] = 2e-5
    elif fault == "resume":
        rk["m2"]["tp2_ep2"]["bit_identical"] = False
    elif fault == "load":
        small["tp1_ep1_equals_gathered"] = False
    else:
        small["flipped_byte_caught"] = False
    problems = smoke.moe_gates(m0, ranks) + smoke.moe_small_problems(small, ranks)
    assert any(says in p for p in problems), problems


def _families_run():
    """A fabricated phase-4o reading that passes every gate: (b0), (n0),
    four (n1) ranks at TP 2 x DP 2 and (n2)'s CPU side."""
    launches = {"flash_block_forward": 4, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2,
                "fused_adamw_leaf": 40}
    b0 = {"steps": [{"loss": 90.0 - i, "grad_norm": 50.0} for i in range(4)],
          "launches": dict(launches, flash_block_forward=96), "peak_bytes": 2e10,
          "card_bytes": 8e10, "descent_losses": [90.0, 80.0, 70.0, 60.0, 50.0]}
    n0 = {"layers": 2, "steps": [{"loss": 11.0 - i, "grad_norm": 3.0} for i in range(3)],
          "launches": dict(launches, flash_block_forward=12), "b1_head_dims": {"96": 12},
          "kernel_head_dim": 128, "peak_bytes": 4e10, "card_bytes": 8e10}
    ranks = [{"rank": r, "coords": {"tp": r % 2, "dp": r // 2},
              "n1": {"steps": [{"loss": (11.0 - i) * 1.004, "digest": f"p{r % 2}{i}",
                                "replicated_digest": f"r{i}"} for i in range(3)],
                     "launches": dict(launches)}} for r in range(4)]
    small = {"max_rel_err": {"neox": 4e-7, "bert": 6e-7}}
    return b0, n0, ranks, small


def _families_problems(smoke, b0, n0, ranks, small):
    return (smoke.fam_b0_problems(b0) + smoke.fam_n0_problems(n0) + smoke.fam_gates(n0, ranks)
            + smoke.fam_small_problems(small))


def test_families_gates_hold_on_a_good_run(smoke):
    b0, n0, ranks, small = _families_run()
    assert _families_problems(smoke, b0, n0, ranks, small) == []
    assert abs(n0["n1_loss_max_rel_diff"] - 4e-3) < 1e-9


@pytest.mark.parametrize("fault,says", [
    ("b0_loss", "(b0): a non-finite loss"), ("b0_b3", "(b0) never launched flash_bwd_dq"),
    ("b0_peak", "(b0): peak"), ("b0_descent", "the loss did not fall"),
    ("n0_b4", "(n0) never launched fused_adamw_leaf"), ("n0_width", "not every layer's at 96"),
    ("n0_build", "runs at the 256-wide build"), ("n0_peak", "(n0): peak"),
    ("n1_loss", "(n1) losses differ from (n0)'s"), ("n1_b1", "never launched flash_block_forward"),
    ("n1_steps", "ran 2 (n1) steps"), ("n1_dp", "data-parallel replicas' params differ"),
    ("n1_tp", "TP-replicated leaves differ"), ("n2", "(n2) bert: losses or grad norms differ")])
def test_families_gates_catch_each_fault(smoke, fault, says):
    b0, n0, ranks, small = _families_run()
    rk = ranks[3]
    if fault == "b0_loss":
        b0["steps"][2]["loss"] = float("nan")
    elif fault == "b0_b3":
        b0["launches"]["flash_bwd_dq"] = 0
    elif fault == "b0_peak":
        b0["peak_bytes"] = b0["card_bytes"]
    elif fault == "b0_descent":
        b0["descent_losses"][-1] = 95.0
    elif fault == "n0_b4":
        n0["launches"]["fused_adamw_leaf"] = 0
    elif fault == "n0_width":
        n0["b1_head_dims"] = {"96": 10, "128": 2}
    elif fault == "n0_build":
        n0["kernel_head_dim"] = 256
    elif fault == "n0_peak":
        n0["peak_bytes"] = 9e10
    elif fault == "n1_loss":
        for r in ranks:
            r["n1"]["steps"][2]["loss"] *= 1.02
    elif fault == "n1_b1":
        rk["n1"]["launches"]["flash_block_forward"] = 0
    elif fault == "n1_steps":
        rk["n1"]["steps"].pop()
    elif fault == "n1_dp":
        rk["n1"]["steps"][1]["digest"] = "other"
    elif fault == "n1_tp":
        rk["n1"]["steps"][0]["replicated_digest"] = "other"
    else:
        small["max_rel_err"]["bert"] = 2e-5
    assert any(says in p for p in _families_problems(smoke, b0, n0, ranks, small))


def test_families_small_runs_rehearse_on_the_cpu(smoke):
    """(n2) on the CPU: the small NeoX (SP) and BERT at TP 2 x DP 2 in thread
    ranks against one rank, within the phase's tolerance."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = {name: smoke.fam_small_run("cpu", name, 1) for name in ("neox", "bert")}
        ranks = mesh.run_in_threads(4, lambda r: {name: smoke.fam_small_run("cpu", name, 2)
                                                  for name in ("neox", "bert")},
                                    tensor_model_parallel_size=2)
    finally:
        torch.set_num_threads(threads)
    small = {"max_rel_err": {name: smoke.fam_small_errors([rk[name] for rk in ranks], cpu[name])
                             for name in cpu}}
    assert smoke.fam_small_problems(small) == [], small
    assert all(len(v) == smoke.FAM_SMALL_STEPS for v in cpu.values())


def test_family_kernels_rehearse_on_the_cpu(smoke, monkeypatch):
    """The family-shape kernel check at tiny shapes on the twins: every
    element held (errors 0: the twins run on both sides), the pad keys'
    dK/dV 0, every timing key present."""
    monkeypatch.setattr(smoke, "FAM_KERNEL_BERT", dict(b=2, h=2, s=128, d=64))
    monkeypatch.setattr(smoke, "FAM_KERNEL_NEOX", dict(b=1, h=2, s=128, d=96))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps, flush: (fn(), 1.0)[1])
    got, problems = smoke.run_family_kernels("cpu", None)
    assert problems == [] and set(got) == {"bert", "neox"}
    for case, r in got.items():
        assert all(x["max_abs_err"] == 0.0 for x in r["held"].values()), (case, r["held"])
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            t = r["timed"][name]
            assert t["bound_ms"] > 0 and t["library_ms"] == 1.0 and t["bound_by"], t
