"""Head dims the CUDA flash kernels are not built for (80, 96), on the CPU.

The kernels exist at head_dim 64 and 128; the wrappers run any other
head_dim up to 128 zero-padded to the next of those widths
(``at_kernel_width``) with the softmax scale of the unpadded d. Here the
padded route runs the twins — the same function the kernel computes — and
must equal the unpadded twin: zero columns change no q·kᵀ, no LSE, no
delta, and none of an output's first d columns. fp32: atol 1e-6 (the
padded sums add zero terms, which can regroup a sum by an fp32 place);
bf16: each element within 2**-7 of its value plus 1e-6 (p rounds to bf16
against sums that may differ by that place). The forward is also held
against the JAX package's Pallas kernel (interpret mode) at the same d.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kernels import flash_attn as jfa
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa

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
    assert [tfa.kernel_head_dim(d) for d in (16, 64, 80, 96, 128)] == [64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="up to 128"):
        tfa.kernel_head_dim(160)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 96])
def test_padded_route_equals_the_twin(d, dtype):
    """B1's out and LSE, B3a's dK/dV and B3b's dQ through the padded route
    (the twins at width 128, sm_scale from the unpadded d) against the
    twins at width d."""
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
    assert widths == [128, 128, 128]
    assert float(dk.reshape(B, HK, S, d)[1, :, 40:43].abs().max()) == 0.0


@pytest.mark.parametrize("d", [80, 96])
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
