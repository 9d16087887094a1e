"""The vocab-parallel cross entropy (fault C10) held against the JAX
package's ``parallel_cross_entropy_mean`` over the global logits.

C10: under a tensor-parallel group the head is ``gather_output=False``, so
each rank holds its slice of the vocabulary's logits; a cross entropy over
that slice alone gives every rank a different, wrong loss. The port's
``parallel_cross_entropy(..., group=)`` reduces over the whole vocabulary
(a MAX all-reduce of the row max, a SUM all-reduce of the sum of
exponentials, the label's logit and the logit sum) and its backward is
softmax minus the smoothed one-hot on the rank's slice. Ranks are threads
over gloo at TP 2 and 4; ``LlamaForCausalLM.loss`` passes its group in the
whole-sequence and the chunked branch.

Tolerances, fp32 on both sides: the loss and the hidden state's gradient to
``rtol=1e-6, atol=1e-6``; the model's loss and gradients (two layers of
float sums between) to ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel.loss import parallel_cross_entropy_mean as j_ce_mean
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import layers as TL
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.loss import parallel_cross_entropy_mean

B, S, HID, V = 2, 12, 16, 64
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(ignore):
    rs = np.random.default_rng(0)
    h = rs.standard_normal((B, S, HID)).astype(np.float32)
    w = rs.standard_normal((HID, V)).astype(np.float32)
    labels = rs.integers(0, V, (B, S)).astype(np.int32)
    if ignore:
        labels[0, :3] = -100
        labels[1, -2:] = -100
    return h, w, labels


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("smoothing,ignore", [(0.0, False), (0.1, True)])
def test_vocab_parallel_loss_and_hidden_grad_match_jax(tp, smoothing, ignore):
    """Each rank's loss and the hidden state's gradient (through the head's
    input region) equal JAX's over the global logits."""
    h, w, labels = _inputs(ignore)
    ignore_index = -100 if ignore else None
    loss_j, gh_j = jax.value_and_grad(
        lambda hh: j_ce_mean(hh @ w, labels, smoothing, ignore_index))(h)

    def rank(r):
        head = TL.ColumnParallelLinear(HID, V, use_bias=False, dtype=torch.float32,
                                       group=mesh.get_tensor_model_parallel_group())
        c = V // tp
        head.load_state_dict({"kernel": torch.tensor(w[:, r * c:(r + 1) * c])})
        ht = torch.tensor(h, requires_grad=True)
        loss = parallel_cross_entropy_mean(head(ht), torch.tensor(labels), smoothing,
                                           ignore_index, group=head.group)
        loss.backward()
        return loss.item(), ht.grad.numpy()

    for loss, gh in mesh.run_in_threads(tp, rank):
        np.testing.assert_allclose(loss, float(loss_j), **TOL)
        np.testing.assert_allclose(gh, np.asarray(gh_j), **TOL)


def test_single_device_loss_unchanged():
    """Without a group the function is the single-device cross entropy:
    JAX's value and gradient of the logits."""
    h, w, labels = _inputs(True)
    logits = h @ w
    loss_j, g_j = jax.value_and_grad(lambda x: j_ce_mean(x, labels, 0.1, -100))(logits)
    lt = torch.tensor(logits, requires_grad=True)
    loss = parallel_cross_entropy_mean(lt, torch.tensor(labels), 0.1, -100)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_j), **TOL)


@pytest.mark.parametrize("chunk", [None, 5])
def test_model_loss_under_a_group_matches_jax(chunk):
    """``LlamaForCausalLM.loss`` built with a TP=2 group, whole-sequence and
    chunked (a chunk of 5 over 12 positions: a short last chunk), equals
    JAX's model loss; the embedding's gradient is JAX's, cut."""
    tiny = dict(vocab_size=V, hidden_size=HID, intermediate_size=32, num_layers=1, num_heads=4,
                num_kv_heads=2, max_seq_len=S, loss_chunk_size=chunk)
    jcfg = jl.LlamaConfig(**tiny, dtype=jnp.float32, remat_policy=None)
    ids = np.random.default_rng(1).integers(0, V, (B, S)).astype(np.int32)
    labels = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    labels[0, :2] = -100
    jm = jl.LlamaForCausalLM(jcfg)
    tree = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"]
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, ids, labels, method=jl.LlamaForCausalLM.loss)))(tree)
    emb_grad = np.asarray(g_j["model"]["embed"]["embedding"])
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def rank(r):
        cfg = tl.LlamaConfig(**tiny, dtype=torch.float32, remat_policy=None)
        m = tl.LlamaForCausalLM(cfg, group=mesh.get_tensor_model_parallel_group())
        m.load_state_dict(llama_params_from_jax(tree, tp_rank=r, tp_size=2))
        m.requires_grad_(True)
        loss = m.loss(torch.tensor(ids), torch.tensor(labels))
        loss.backward()
        return loss.item(), m.model.embed.embedding.grad.numpy()

    for r, (loss, ge) in enumerate(mesh.run_in_threads(2, rank)):
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ge, emb_grad[r * V // 2:(r + 1) * V // 2], rtol=1e-5,
                                   atol=1e-6)
