"""Flash-attention backward (B3a, B3b) of the PyTorch port against the JAX
package.

The same seeded numpy inputs go through ``jax.grad`` of JAX
``flash_attention`` (its custom VJP: the Pallas backward kernels in
interpret mode on the CPU) and through autograd of the port's
``flash_attention``, whose backward runs the plain twins of the two CUDA
kernels on CPU tensors. fp32 on both sides with the same block sizes, so
only the summation order differs: atol 2e-5 on gradients whose largest
entries are about 10 (relative 1e-5 where the JAX package holds its kernel
to 5e-3 against the dense golden). Pad keys get gradients of exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kernels import flash_attn as jfa
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 2e-5

CASES = {
    # name: (b, h, hk, sq, sk, d, block_q, block_k, causal, pad_len)
    "causal_mha": (1, 2, 2, 128, 128, 32, 64, 64, True, 0),
    "gqa_compact_kv": (2, 8, 2, 64, 64, 32, 32, 32, True, 0),
    "sq_lt_sk_bottom_aligned": (1, 4, 2, 64, 128, 32, 32, 64, True, 0),
    "asymmetric_32_64": (1, 2, 2, 128, 128, 32, 32, 64, True, 0),
    "asymmetric_64_32": (1, 2, 2, 128, 128, 32, 64, 32, True, 0),
    "pad_rows_keys": (1, 2, 2, 128, 128, 32, 64, 64, True, 80),
}


def _inputs(b, h, hk, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, hk, sk, d), dtype=np.float32),
            rng.standard_normal((b, hk, sk, d), dtype=np.float32),
            rng.standard_normal((b, h, sq, d), dtype=np.float32))


def _pad_positions(b, s, length):
    iota = np.arange(s)[None].repeat(b, 0)
    qpos = np.where(iota < length, iota, -1).astype(np.int32)
    kpos = np.where(iota < length, iota, tfa.INVALID_POS).astype(np.int32)
    return {"q_positions": qpos, "kv_positions": kpos}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_gradients_match_jax(name, monkeypatch):
    b, h, hk, sq, sk, d, bq, bk, causal, pad_len = CASES[name]
    q, k, v, ct = _inputs(b, h, hk, sq, sk, d, seed=len(name))
    pos = _pad_positions(b, sq, pad_len) if pad_len else {}
    kw = dict(causal=causal, block_q=bq, block_k=bk)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, **kw,
                                  **{n: jnp.asarray(a) for n, a in pos.items()})
        return jnp.sum(out * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    calls = []
    real = tfa.flash_bwd_dkdv_plain
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_plain",
                        lambda *a, **kw_: calls.append(1) or real(*a, **kw_))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **kw,
                              **{n: torch.from_numpy(a) for n, a in pos.items()})
    (out * torch.from_numpy(ct)).sum().backward()
    assert calls == [1]        # the backward twin ran, not autograd through the forward
    for gname, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=f"{name}: d{gname}")
    if pad_len:
        assert np.all(tk.grad.numpy()[:, :, pad_len:] == 0.0)
        assert np.all(tv.grad.numpy()[:, :, pad_len:] == 0.0)
        assert np.all(tq.grad.numpy()[:, :, pad_len:] == 0.0)


def test_flash_block_grads_with_external_statistics():
    """The ring-attention contract: ``flash_block_grads`` under a given LSE
    and delta (here seeded values larger than the block's own, as a softmax
    over more keys gives) equals JAX's ``flash_block_grads``, whose
    statistics are lane-broadcast to 128; CPU tensors launch nothing."""
    b, h, hk, sq, sk, d, blk = 1, 4, 2, 128, 128, 32, 64
    q, k, v, do = _inputs(b, h, hk, sq, sk, d, seed=11)
    flat = lambda a: a.reshape(-1, a.shape[2], d)  # noqa: E731
    rng = np.random.default_rng(12)
    lse = (rng.standard_normal((b * h, sq)) + 6.0).astype(np.float32)
    delta = rng.standard_normal((b * h, sq)).astype(np.float32)
    qpos = (np.arange(sq, dtype=np.int32) + 128).reshape(b, 1, sq)
    kpos = np.arange(sk, dtype=np.int32).reshape(b, 1, sk)
    args = (flat(q), flat(k), flat(v), flat(do))
    lanes = lambda a: np.broadcast_to(a[..., None], (*a.shape, 128))  # noqa: E731
    want = jfa.flash_block_grads(*map(jnp.asarray, args), jnp.asarray(lanes(lse)),
                                 jnp.asarray(lanes(delta)), jnp.asarray(qpos),
                                 jnp.asarray(kpos), d ** -0.5, blk, blk, h // hk, h)
    before = (tfa.flash_bwd_dkdv.launches, tfa.flash_bwd_dq.launches)
    got = tfa.flash_block_grads(*map(torch.from_numpy, args), torch.from_numpy(lse),
                                torch.from_numpy(delta), torch.from_numpy(qpos),
                                torch.from_numpy(kpos), d ** -0.5, blk, blk, h // hk, h)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5, err_msg=name)
    assert (tfa.flash_bwd_dkdv.launches, tfa.flash_bwd_dq.launches) == before


def test_backward_rejects_mismatched_statistics():
    q = torch.zeros((2, 64, 16))
    pos = torch.arange(64, dtype=torch.int32).reshape(1, 1, 64)
    with pytest.raises(ValueError, match="lse must be fp32"):
        tfa.flash_block_grads(q, q, q, q, torch.zeros((2, 64, 128)), torch.zeros((2, 64)),
                              pos, pos, 0.25, 64, 64, 1, 2)
    with pytest.raises(ValueError, match="do"):
        tfa.flash_block_grads(q, q, q, q[:1], torch.zeros((2, 64)), torch.zeros((2, 64)),
                              pos, pos, 0.25, 64, 64, 1, 2)
