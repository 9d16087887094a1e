"""Ring attention and the point-to-point mappings on the port against the
JAX package (the counterpart of ``tests/test_ring_attention.py``).

The JAX ring runs as its own tests run it: ``ring_flash_attention`` under
a ``cp`` mesh of CPU devices, its Pallas kernels in interpret mode. The
port's ring runs on ``cp`` thread ranks over gloo, each on its block of
the sequence (the twins of B1 and B3a/B3b: CPU tensors). Same inputs
(seeded jax.random arrays, passed as numpy):

* the forward at cp 2 contiguous, cp 2 zigzag, cp 4 zigzag and cp 2
  zigzag with a chunk of 40 positions (not a multiple of 64: the kernels'
  block skip reads per-tile bounds): ``rtol=2e-5, atol=2e-5``;
* the gradients of q, k and v through each ring's backward:
  ``rtol=2e-4, atol=2e-4``; compact GQA K/V;
* the dispatcher's choice (flash for causal block-aligned shapes, the
  plain blocks otherwise, non-causal included; on the card flash for
  every causal shape, whole-sequence blocks where none divides) and both
  impls agreeing with each other and with JAX's ``impl="xla"``;
* ``zigzag_indices`` and ``_rank_positions`` equal to JAX's; bad shapes
  raise JAX's errors;
* ``ppermute_next``/``ppermute_prev`` with and without ``wrap`` and their
  backward, the sends and receives counted with their bytes;
* a Llama under ``context_parallel`` zigzag at cp 2 against the same model
  on one rank: loss and (cp-summed) gradients; ``measure_cp_ratio`` on
  the CPU at a tiny shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.ops.ring_attention import (
    _rank_positions as j_rank_positions,
    ring_attention as j_ring_attention,
    ring_flash_attention as j_ring_flash_attention,
    zigzag_indices as j_zigzag_indices,
)
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.ops import ring_attention as R
from neuronx_distributed_tpu_torch.parallel import mappings, mesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(b, h, s, d, hk=None, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    hk = hk or h
    return tuple(np.asarray(jax.random.normal(k, shape, jnp.float32))
                 for k, shape in zip(ks, ((b, h, s, d), (b, hk, s, d), (b, hk, s, d))))


def _jax_ring(cp, fn):
    st = jps.initialize_model_parallel(context_parallel_size=cp)
    try:
        with jax.set_mesh(st.mesh):
            return fn()
    finally:
        jps.destroy_model_parallel()


def _port_ring(cp, q, k, v, w=None, **kw):
    """Each rank's block of the (already laid out) sequence through the
    port's ring; the outputs (and with ``w`` the grads of sum(out * w))
    concatenated back along the sequence."""
    def rank(r):
        sl = mesh.context_seq_slice(q.shape[2])
        qi, ki, vi = (torch.tensor(t[:, :, sl], requires_grad=True) for t in (q, k, v))
        out = R.ring_attention(qi, ki, vi, group=mesh.get_context_parallel_group(), **kw)
        if w is None:
            return out.detach(), None
        grads = torch.autograd.grad(out, (qi, ki, vi), torch.tensor(w[:, :, sl]))
        return out.detach(), grads

    ranks = mesh.run_in_threads(cp, rank, tensor_model_parallel_size=1,
                                context_parallel_size=cp)
    out = torch.cat([o for o, _ in ranks], dim=2).numpy()
    if w is None:
        return out, None
    return out, [torch.cat([g[i] for _, g in ranks], dim=2).numpy() for i in range(3)]


@pytest.mark.parametrize("cp,layout,s", [(2, "contiguous", 64), (2, "zigzag", 64),
                                         (4, "zigzag", 64), (2, "zigzag", 160)])
def test_ring_forward_matches_jax(cp, layout, s):
    q, k, v = _qkv(4, 2, s, 8)
    want = _jax_ring(cp, lambda: np.asarray(jax.jit(lambda *a: j_ring_flash_attention(
        *a, layout=layout, block_q=16, block_k=16))(q, k, v)))
    got, _ = _port_ring(cp, q, k, v, layout=layout, block_q=16, block_k=16, impl="flash")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_grads_match_jax(layout):
    cp = 2
    q, k, v = _qkv(4, 2, 64, 8, seed=3)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(9), q.shape, jnp.float32))

    def jax_side():
        loss, grads = jax.jit(jax.value_and_grad(lambda q, k, v: jnp.sum(j_ring_flash_attention(
            q, k, v, layout=layout, block_q=16, block_k=16) * w), argnums=(0, 1, 2)))(q, k, v)
        return float(loss), [np.asarray(g) for g in grads]

    loss, want = _jax_ring(cp, jax_side)
    out, got = _port_ring(cp, q, k, v, w, layout=layout, block_q=16, block_k=16, impl="flash")
    np.testing.assert_allclose(float((out * w).sum()), loss, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_ring_gqa_compact_kv():
    """Compact K/V travel the ring (4 query heads over 2 KV heads), in the
    forward and, with their gradients, in the backward."""
    cp = 2
    q, k, v = _qkv(4, 4, 64, 8, hk=2, seed=5)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(4), q.shape, jnp.float32))

    def jax_side():
        out = jax.jit(lambda *a: j_ring_flash_attention(
            *a, layout="zigzag", block_q=16, block_k=16))(q, k, v)
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(j_ring_flash_attention(
            q, k, v, layout="zigzag", block_q=16, block_k=16) * w), argnums=(0, 1, 2)))(q, k, v)
        return np.asarray(out), [np.asarray(g) for g in grads]

    want, want_g = _jax_ring(cp, jax_side)
    got, got_g = _port_ring(cp, q, k, v, w, layout="zigzag", block_q=16, block_k=16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_dispatcher_impl_choice_and_both_impls_agree(monkeypatch):
    cp = 2
    q, k, v = _qkv(4, 2, 64, 8, seed=7)
    want = _jax_ring(cp, lambda: np.asarray(jax.jit(lambda *a: j_ring_attention(
        *a, impl="xla", layout="zigzag"))(q, k, v)))
    calls = []
    real = R.ring_flash_attention
    monkeypatch.setattr(R, "ring_flash_attention", lambda *a, **kw: calls.append(1) or real(
        *a, **kw))
    auto, _ = _port_ring(cp, q, k, v, layout="zigzag", block_q=16, block_k=16)
    assert len(calls) == cp   # impl=None took the flash ring on every rank
    xla, _ = _port_ring(cp, q, k, v, layout="zigzag", impl="xla")
    assert len(calls) == cp
    np.testing.assert_allclose(auto, xla, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xla, want, rtol=2e-5, atol=2e-5)
    # non-causal: the plain blocks (JAX's xla path), against JAX's
    want_nc = _jax_ring(cp, lambda: np.asarray(jax.jit(lambda *a: j_ring_attention(
        *a, causal=False))(q, k, v)))
    got_nc, _ = _port_ring(cp, q, k, v, causal=False)
    assert len(calls) == cp
    np.testing.assert_allclose(got_nc, want_nc, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="causal-only"):
        R.ring_attention(*(torch.as_tensor(t) for t in (q, k, v)), causal=False, impl="flash")


def test_dispatcher_takes_the_kernels_for_any_causal_shape_on_the_card():
    """On CUDA tensors ``impl=None`` runs the kernels for every causal shape
    the layout takes: where no default block divides the rank's sequence
    (above 1024 and not a multiple of 128), the block is the whole of it.
    On the CPU the choice stays JAX's. A ring over whole-sequence blocks at
    a per-rank length of 34 (chunks of 17) agrees with the plain blocks and
    with JAX's ``impl="xla"``."""
    choose = R.choose_impl
    assert choose(True, 1100, "zigzag", on_card=True) == ("flash", 1100, 1100)
    assert choose(True, 1100, "zigzag", on_card=False) == ("xla", None, None)
    assert choose(True, 1984, "contiguous", True, 64, 64) == ("flash", 64, 64)
    assert choose(True, 1984, "contiguous", True, 128, 128) == ("flash", 1984, 1984)
    assert choose(True, 16384, "zigzag", on_card=True) == ("flash", None, None)
    assert choose(False, 16384, "zigzag", on_card=True)[0] == "xla"
    assert choose(True, 1101, "zigzag", on_card=True)[0] == "xla"   # which then raises
    cp, s = 2, 68
    q, k, v = _qkv(1, 4, s, 8, hk=2, seed=9)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(10), q.shape, jnp.float32))
    idx = R.zigzag_indices(s, cp).numpy()
    q, k, v, w = (t[:, :, idx] for t in (q, k, v, w))
    want = _jax_ring(cp, lambda: np.asarray(jax.jit(lambda *a: j_ring_attention(
        *a, impl="xla", layout="zigzag"))(q, k, v)))
    got, got_g = _port_ring(cp, q, k, v, w, impl="flash", layout="zigzag", block_q=s // cp,
                            block_k=s // cp)
    xla, xla_g = _port_ring(cp, q, k, v, w, impl="xla", layout="zigzag")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)
    for a, b in zip(got_g, xla_g):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_zigzag_indices_and_positions_equal_jax():
    s, cp = 32, 4
    idx = R.zigzag_indices(s, cp)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_zigzag_indices(s, cp)))
    assert sorted(idx.tolist()) == list(range(s))
    assert torch.equal(idx[torch.argsort(idx)], torch.arange(s))   # the round trip
    for layout in ("contiguous", "zigzag"):
        for r in range(cp):
            np.testing.assert_array_equal(
                R._rank_positions(r, cp, s // cp, layout).numpy(),
                np.asarray(j_rank_positions(r, cp, s // cp, layout)))


def test_ring_rejects_bad_shapes():
    q, k, v = (torch.as_tensor(t) for t in _qkv(4, 2, 31, 8))
    with pytest.raises(ValueError, match="zigzag needs even per-rank seq"):
        R.ring_flash_attention(q, k, v, layout="zigzag")
    with pytest.raises(ValueError, match="not divisible by 2"):
        R.zigzag_indices(30, 4)
    with pytest.raises(ValueError, match="unknown cp layout"):
        R.ring_attention(q, k, v, layout="striped", impl="xla")
    with pytest.raises(ValueError, match="not a multiple of blocks"):
        R.ring_flash_attention(q, k, v, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="not divisible by cp"):
        mesh.run_in_threads(2, lambda r: mesh.context_seq_slice(31),
                            tensor_model_parallel_size=1, context_parallel_size=2)


def test_ppermute_regions_and_their_counts():
    def rank(r):
        g = mesh.get_context_parallel_group()
        mappings.reset_collective_stats()
        x = torch.full((2, 3), float(r), requires_grad=True)
        nxt, prv = mappings.ppermute_next(x, g), mappings.ppermute_prev(x, g)
        open_next = mappings.ppermute_next(x, g, wrap=False)
        (gx,) = torch.autograd.grad((nxt * 1.0 + prv * 10.0 + open_next * 100.0).sum(), x)
        return nxt[0, 0].item(), prv[0, 0].item(), open_next[0, 0].item(), gx[0, 0].item(), \
            dict(mappings.collective_stats())

    n = 4
    for r, (nxt, prv, open_next, gx, stats) in enumerate(mesh.run_in_threads(
            n, rank, tensor_model_parallel_size=1, context_parallel_size=n)):
        assert nxt == (r - 1) % n and prv == (r + 1) % n
        assert open_next == (0.0 if r == 0 else r - 1)
        # each rank's x reached three places; the backward permutes back
        assert gx == 1.0 + 10.0 + (100.0 if r < n - 1 else 0.0)
        # two wrapped permutes and their backward, the open one's ends
        assert stats["send"][0] == stats["recv"][0] == 4 + (r < n - 1) + (r > 0)
        assert stats["send"][1] == 24 * stats["send"][0]
        assert stats["recv"][1] == 24 * stats["recv"][0]
        assert "p2p_staging" not in stats   # CPU tensors go as they are


def test_llama_zigzag_cp_matches_one_rank():
    """Llama's loss and gradients under context_parallel (zigzag, cp 2: each
    rank feeds its block of the permuted ids and labels) equal the one-rank
    model's; the ranks' gradients are their tokens' shares and sum to it."""
    cfg = tl.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=64, dtype=torch.float32,
                         use_flash_attention=False, remat_policy=None)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    ids, labels = (torch.as_tensor(rs.randint(0, 127, (2, 64))) for _ in range(2))
    ref = tl.LlamaForCausalLM(cfg)
    ref.load_state_dict(params)
    ref.requires_grad_(True)
    loss = ref.loss(ids, labels)
    want = dict(zip([n for n, _ in ref.named_parameters()],
                    torch.autograd.grad(loss, list(ref.parameters()))))
    idx = R.zigzag_indices(64, 2)

    def rank(r):
        import dataclasses

        model = tl.LlamaForCausalLM(dataclasses.replace(cfg, context_parallel=True,
                                                        cp_layout="zigzag"),
                                    cp_group=mesh.get_context_parallel_group())
        model.load_state_dict(params)
        model.requires_grad_(True)
        sl = mesh.context_seq_slice(64)
        out = model.loss(ids[:, idx][:, sl], labels[:, idx][:, sl])
        grads = torch.autograd.grad(out, list(model.parameters()))
        return out.item(), dict(zip([n for n, _ in model.named_parameters()], grads))

    ranks = mesh.run_in_threads(2, rank, tensor_model_parallel_size=1, context_parallel_size=2)
    for got, _ in ranks:
        assert abs(got - float(loss)) < 1e-5
    for n, g in want.items():
        total = ranks[0][1][n] + ranks[1][1][n]
        np.testing.assert_allclose(total.numpy(), g.numpy(), rtol=1e-4, atol=1e-6, err_msg=n)


def test_measure_cp_ratio_runs_on_the_cpu():
    from neuronx_distributed_tpu_torch.utils.cp_microbench import measure_cp_ratio

    row = measure_cp_ratio(256, cp=2, heads=4, head_dim=64, tp=2, trials=2, device="cpu",
                           dtype=torch.float32)
    assert row["device"] == "cpu (host clock)" and len(row["cp_trials_ms"]) == 2
    assert row["cp_vs_sp_throughput"] == row["sp_rank_ms"] / row["cp_rank_ms"] > 0
    assert row["ring_bytes_per_step"] == 2 * 4 * 128 * 64 * 4
    with pytest.raises(ValueError, match="divisible by 2\\*cp"):
        measure_cp_ratio(250, cp=2, device="cpu")
