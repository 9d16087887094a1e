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
