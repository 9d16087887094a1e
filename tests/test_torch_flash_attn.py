"""Flash-attention forward (B1) of the PyTorch port against the JAX package.

The same seeded numpy inputs go through JAX ``flash_attention`` (the
Pallas kernel, in interpret mode on the CPU) and the port's plain twin
(what a CPU tensor routes to). fp32 on both sides with the same block
sizes, so only the summation order differs: atol 1e-5 on the output and on
the log-sum-exp.
"""

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


ATOL = 1e-5


def _inputs(b, h, hk, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hk, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hk, sk, d), dtype=np.float32)
    return q, k, v


def _positions(b, sq, sk, pad_rows=0, pad_keys=0):
    qpos = np.tile(np.arange(sq, dtype=np.int32) + (sk - sq), (b, 1))
    kpos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    if pad_rows:
        qpos[0, -pad_rows:] = -1                       # pad query rows
    if pad_keys:
        kpos[-1, sk - pad_keys:] = tfa.INVALID_POS     # pad keys
    return qpos, kpos


CASES = {
    # name: (b, h, hk, sq, sk, d, block, causal, pad_rows, pad_keys)
    "gqa_causal": (2, 4, 2, 256, 256, 32, 128, True, 0, 0),
    "mha_causal": (1, 2, 2, 128, 128, 16, 64, True, 0, 0),
    "bottom_aligned": (1, 4, 1, 128, 384, 32, 128, True, 0, 0),
    "pad_rows_keys": (2, 4, 2, 128, 256, 32, 128, False, 5, 17),
    "non_causal": (1, 2, 1, 128, 256, 16, 128, False, 0, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_matches_jax_kernel(name):
    b, h, hk, sq, sk, d, blk, causal, pad_rows, pad_keys = CASES[name]
    q, k, v = _inputs(b, h, hk, sq, sk, d, seed=len(name))
    kw = {}
    if pad_rows or pad_keys or not causal:
        qpos, kpos = _positions(b, sq, sk, pad_rows, pad_keys)
        kw = dict(q_positions=qpos, kv_positions=kpos)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=blk,
        block_k=blk, **{n: jnp.asarray(a) for n, a in kw.items()}))
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        block_q=blk, block_k=blk, **{n: torch.from_numpy(a) for n, a in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    ref = tfa.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        **{n: torch.from_numpy(a) for n, a in kw.items()}).numpy()
    jref = np.asarray(jfa.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        **{n: jnp.asarray(a) for n, a in kw.items()}))
    np.testing.assert_allclose(ref, jref, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("fully_masked", [False, True])
def test_flash_block_forward_lse_matches_jax(fully_masked):
    """Output and LSE of the flattened entry; a fully masked query row gives
    output 0 and LSE -1e30 on both sides."""
    b, h, hk, sq, sk, d, blk = 2, 4, 2, 128, 256, 32, 64
    q, k, v = _inputs(b, h, hk, sq, sk, d, seed=7)
    qpos, kpos = _positions(b, sq, sk, pad_rows=3 if fully_masked else 0, pad_keys=9)
    flat = lambda a, heads: a.reshape(b * heads, a.shape[2], d)  # noqa: E731
    args = (flat(q, h), flat(k, hk), flat(v, hk), qpos.reshape(b, 1, sq),
            kpos.reshape(b, 1, sk))
    jout, jlse = jfa.flash_block_forward(*map(jnp.asarray, args), d ** -0.5, blk, blk,
                                         h // hk, h)
    tout, tlse = tfa.flash_block_forward(*map(torch.from_numpy, args), d ** -0.5, blk, blk,
                                         h // hk, h)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0], atol=ATOL, rtol=1e-6)
    if fully_masked:
        assert np.all(tout.numpy()[0, -3:] == 0.0)
        assert np.all(tlse.numpy()[0, -3:] == tfa.NEG_INF)


def test_flash_supported_and_blocks_match_jax():
    for sq in (16, 128, 384, 1280, 4096):
        assert tfa.default_attention_blocks(sq) == jfa.default_attention_blocks(sq)
        for bq, bk in ((128, 128), (256, 512), (1024, 1024)):
            assert tfa.flash_supported(sq, 4096, bq, bk) == jfa.flash_supported(sq, 4096, bq, bk)
    with pytest.raises(ValueError, match="multiples of the block"):
        q = torch.zeros((1, 2, 96, 16))
        tfa.flash_attention(q, q, q, block_q=64, block_k=64)


def test_cpu_tensor_takes_the_twin_not_the_kernel():
    b, h, hk, sq, sk, d = 1, 2, 1, 64, 64, 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, h, hk, sq, sk, d, seed=3))
    before = tfa.flash_block_forward.launches
    tfa.flash_attention(q, k, v, block_q=64, block_k=64)
    assert tfa.flash_block_forward.launches == before
