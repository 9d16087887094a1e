"""Paged decode attention (B2) of the PyTorch port against the JAX package.

Seeded numpy pools with stale bytes in every unused page and ragged
lengths go through JAX ``paged_decode_attention`` (the Pallas kernel, in
interpret mode on the CPU) and ``reference_paged_attention`` (the gather
oracle), and through the port's twin and gather oracle. fp32 math on both
sides; the page loop's summation order may differ: atol 1e-5. int8 pages
are quantized bit-exactly alike (checked separately), so int8 pools get the
same bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import paged_kernel as jpk
from neuronx_distributed_tpu_torch.inference import paged_kernel as tpk

ATOL = 1e-5


def _case(seed, b=3, n_q=4, n_kv=2, hd=16, ps=4, pages=24, ppseq=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, n_q, hd), dtype=np.float32)
    # stale bytes everywhere: unused pages and tails hold finite garbage
    kp = rng.standard_normal((pages, ps, n_kv, hd), dtype=np.float32) * 3
    vp = rng.standard_normal((pages, ps, n_kv, hd), dtype=np.float32) * 3
    table = rng.permutation(pages)[: b * ppseq].reshape(b, ppseq).astype(np.int32)
    cache_len = np.array([0, 9, ps * ppseq - 1][:b], np.int32)   # ragged
    return q, kp, vp, table, cache_len


@pytest.mark.parametrize("pool", ["fp32", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_matches_jax(pool, seed):
    q, kp, vp, table, cache_len = _case(seed)
    jkw, tkw = {}, {}
    if pool == "int8":
        kq, ks = jpk.quantize_kv_pages(jnp.asarray(kp))
        vq, vs = jpk.quantize_kv_pages(jnp.asarray(vp))
        kp, vp = np.array(kq), np.array(vq)
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = dict(k_scale=torch.from_numpy(np.array(ks)),
                   v_scale=torch.from_numpy(np.array(vs)))
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, cache_len)))
    targs = tuple(map(torch.from_numpy, (q, kp, vp, table, cache_len)))
    want = np.asarray(jpk.paged_decode_attention(*jargs, **jkw))
    got = tpk.paged_decode_attention(*targs, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    jref = np.asarray(jpk.reference_paged_attention(*jargs, **jkw))
    tref = tpk.reference_paged_attention(*targs, **tkw).numpy()
    np.testing.assert_allclose(tref, jref, atol=ATOL)
    np.testing.assert_allclose(got, tref, atol=ATOL)


def test_quantize_kv_pages_bit_exact_including_zero_page():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 4, 2, 16), dtype=np.float32) * 7
    w[1] = 0.0                                # an all-zero page stays exact
    w[2, :, 1] *= 1e-3                        # a small-scale head
    jq, js = jpk.quantize_kv_pages(jnp.asarray(w))
    tq, ts = tpk.quantize_kv_pages(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.shape == (3, 1, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(tq.numpy()[1] == 0)
    np.testing.assert_array_equal(
        tpk.dequantize_kv_pages(tq, ts).numpy(),
        np.asarray(jpk.dequantize_kv_pages(jq, js)))


def test_paged_kernel_supported_matches_jax():
    for args in ((1, 16, 32, 8), (2, 16, 32, 8), (1, 4, 6, 4), (1, 1, 4, 4)):
        assert tpk.paged_kernel_supported(*args) == jpk.paged_kernel_supported(*args)


def test_paged_checker_rejects_bad_inputs():
    q, kp, vp, table, cache_len = map(torch.from_numpy, _case(0))
    with pytest.raises(ValueError, match="single-token"):
        tpk.paged_decode_attention(q.repeat(1, 2, 1, 1), kp, vp, table, cache_len)
    with pytest.raises(ValueError, match="int32"):
        tpk.paged_decode_attention(q, kp, vp, table.long(), cache_len)
    with pytest.raises(ValueError, match="BOTH"):
        tpk.paged_decode_attention(q, kp, vp, table, cache_len, k_scale=torch.ones(1))
    with pytest.raises(ValueError, match="need k_scale"):
        tpk.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8), table, cache_len)
