"""Head dims the CUDA flash kernels are not built for (80, 96, 160), and
the widest built one (256), on the CPU.

The kernels exist at head_dim 64, 128 and 256; the wrappers run any other
head_dim up to 256 zero-padded to the next of those widths
(``at_kernel_width``) with the softmax scale of the unpadded d, and raise
above 256. Here the padded route runs the twins — the same function the
kernel computes — and must equal the unpadded twin: zero columns change no
q·kᵀ, no LSE, no delta, and none of an output's first d columns. fp32: atol
1e-6 (the padded sums add zero terms, which can regroup a sum by an fp32
place); bf16: each element within 2**-7 of its value plus 1e-6 (p rounds to
bf16 against sums that may differ by that place). The forward is also held
against the JAX package's Pallas kernel (interpret mode) at the same d, and
the paged decode wrapper's CPU route (its twin) against the JAX paged
kernel at the rows the card reads otherwise: an fp32 pool at head_dim 256
(64 lanes of 16 bytes) and bf16 at 36 (72-byte rows, read 4 bytes a lane).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import paged_kernel as jpk
from neuronx_distributed_tpu.kernels import flash_attn as jfa
from neuronx_distributed_tpu_torch.inference import paged_kernel as tpk
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, H, HK, S = 2, 4, 2, 128


def _case(d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B * H, S, d), generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((B * HK, S, d), generator=g).to(dtype) for _ in range(2))
    qpos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    kpos = qpos.clone()
    qpos[0, -5:] = -1                        # pad query rows
    kpos[1, 40:43] = tfa.INVALID_POS         # pad keys
    return q, k, v, do, qpos.reshape(B, 1, S), kpos.reshape(B, 1, S)


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    rel = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert float((err - rel * want.float().abs()).max()) <= 1e-6, float(err.max())


def test_kernel_head_dim_picks_the_next_built_width():
    assert ([tfa.kernel_head_dim(d) for d in (16, 64, 80, 96, 128, 160, 256)]
            == [64, 64, 128, 128, 128, 256, 256])
    with pytest.raises(ValueError, match="up to 256"):
        tfa.kernel_head_dim(288)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 96, 160])
def test_padded_route_equals_the_twin(d, dtype):
    """B1's out and LSE, B3a's dK/dV and B3b's dQ through the padded route
    (the twins at the next built width, sm_scale from the unpadded d)
    against the twins at width d."""
    q, k, v, do, qpos, kpos = _case(d, dtype)
    sm = d ** -0.5
    blocks = (64, 64, H // HK, H)
    widths = []

    def spy(fn):
        def run(*a):
            widths.append(a[0].shape[-1])
            return fn(*a)
        return run

    out, lse = tfa.at_kernel_width(spy(tfa.flash_block_forward_plain), d, (q, k, v), qpos,
                                   kpos, sm, *blocks, keep=(1,))
    ref, ref_lse = tfa.flash_block_forward_plain(q, k, v, qpos, kpos, sm, *blocks)
    _close(out, ref, dtype)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5, rtol=1e-6)
    delta = (do.float() * ref.float()).sum(-1)
    args = (lse, delta, qpos, kpos, sm, *blocks)
    dq = tfa.at_kernel_width(spy(tfa.flash_bwd_dq_plain), d, (q, k, v, do), *args)
    dk, dv = tfa.at_kernel_width(spy(tfa.flash_bwd_dkdv_plain), d, (q, k, v, do), *args)
    want = tfa.flash_block_grads_plain(q, k, v, do, *args)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, dtype)
    assert widths == [tfa.kernel_head_dim(d)] * 3
    assert float(dk.reshape(B, HK, S, d)[1, :, 40:43].abs().max()) == 0.0


@pytest.mark.parametrize("d", [80, 96, 160, 256])
def test_head_dim_forward_matches_jax(d):
    """``flash_attention`` at head_dim d (its default scale 1/sqrt(d))
    against the JAX package's flash forward, fp32, causal with pads."""
    q, k, v, _, qpos, kpos = _case(d, torch.float32, seed=1)
    pos = dict(q_positions=qpos.reshape(B, S), kv_positions=kpos.reshape(B, S))
    got = tfa.flash_attention(q.reshape(B, H, S, d), k.reshape(B, HK, S, d),
                              v.reshape(B, HK, S, d), block_q=64, block_k=64, **pos)
    want = jfa.flash_attention(*(jnp.asarray(t.reshape(B, -1, S, d).numpy()) for t in (q, k, v)),
                               block_q=64, block_k=64,
                               **{n: jnp.asarray(t.numpy()) for n, t in pos.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("pool, hd", [("fp32", 256), ("bf16", 36), ("int8", 40)])
def test_paged_decode_rows_past_32_lanes_and_ragged_rows_match_jax(pool, hd):
    """The paged decode wrapper on CPU tensors (its twin) against the JAX
    paged kernel (interpret mode) and gather oracle at head dims whose pool
    rows the card reads past 32 lanes (fp32, 256) or 4 bytes a lane (bf16
    36, int8 40). bf16 pools hold bf16-exact values on both sides; fp32
    math, atol 1e-5 as in ``test_torch_paged_kernel.py``."""
    rng = np.random.default_rng(hd)
    b, n_q, n_kv, ps, pages, ppseq = 3, 4, 2, 4, 24, 6
    q = rng.standard_normal((b, 1, n_q, hd), dtype=np.float32)
    kp, vp = (rng.standard_normal((pages, ps, n_kv, hd), dtype=np.float32) * 3
              for _ in range(2))
    if pool == "bf16":
        kp, vp = (torch.from_numpy(t).to(torch.bfloat16).float().numpy() for t in (kp, vp))
    table = rng.permutation(pages)[: b * ppseq].reshape(b, ppseq).astype(np.int32)
    cache_len = np.array([0, 9, ps * ppseq - 1], np.int32)
    jkw, tkw = {}, {}
    if pool == "int8":
        kq, ks = jpk.quantize_kv_pages(jnp.asarray(kp))
        vq, vs = jpk.quantize_kv_pages(jnp.asarray(vp))
        kp, vp = np.array(kq), np.array(vq)
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = dict(k_scale=torch.from_numpy(np.array(ks)), v_scale=torch.from_numpy(np.array(vs)))
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, cache_len)))
    targs = [torch.from_numpy(t) for t in (q, kp, vp, table, cache_len)]
    if pool == "bf16":
        targs[1], targs[2] = targs[1].to(torch.bfloat16), targs[2].to(torch.bfloat16)
    got = tpk.paged_decode_attention(*targs, **tkw).float().numpy()
    np.testing.assert_allclose(got, np.asarray(jpk.paged_decode_attention(*jargs, **jkw)),
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jpk.reference_paged_attention(*jargs, **jkw)),
                               atol=1e-5)
