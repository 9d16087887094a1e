"""Channel-parallel convs (``parallel/conv.py``) and head padding for every
family (``parallel/pad.py``) on the port, against the JAX package.

Convs: JAX's NHWC activations and HWIO kernels transposed to PyTorch's NCHW
and ``(out, in, kh, kw)``; the output-channel -> input-channel pair at TP 2
(thread ranks over gloo, each holding its slices) equals the dense pair and
JAX's pair (``atol=2e-5``: the input-channel conv sums its partial products
over the group); ``gather_output`` gathers every channel; SAME padding at
stride 2 and VALID padding match JAX's shapes and values. Head padding:
padded BERT and GPT-NeoX models (5 heads to 8 for TP 4) give the unpadded
model's logits bit for bit at fp32, the padded state dict equals JAX's
padded tree carried over, and a grouped-query config is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from neuronx_distributed_tpu.models import bert as jb
from neuronx_distributed_tpu.models import gpt_neox as jn
from neuronx_distributed_tpu.parallel import conv as jconv
from neuronx_distributed_tpu.parallel import pad as jpad
from neuronx_distributed_tpu_torch.converters.jax_params import (
    bert_params_from_jax,
    gpt_neox_params_from_jax,
)
from neuronx_distributed_tpu_torch.models import bert as tb
from neuronx_distributed_tpu_torch.models import gpt_neox as tn
from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig
from neuronx_distributed_tpu_torch.parallel import conv as tconv
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.pad import get_number_of_extra_heads, pad_model

ATOL = 2e-5


def _nchw(x):
    return torch.as_tensor(np.array(x)).permute(0, 3, 1, 2).contiguous()


def _oihw(k):
    return torch.as_tensor(np.array(k)).permute(3, 2, 0, 1).contiguous()


class _JaxPair(nn.Module):
    @nn.compact
    def __call__(self, x):
        h = jconv.OutputChannelParallelConv2d(16, kernel_size=3, name="c1")(x)
        return jconv.InputChannelParallelConv2d(8, kernel_size=3, name="c2")(nn.relu(h))


def _jax_pair():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 8, 4))
    m = _JaxPair()
    params = meta.unbox(m.init(jax.random.PRNGKey(1), x))["params"]
    params = jax.tree.map(lambda p: p + 0.1, params)   # nonzero biases
    return x, params, np.asarray(m.apply({"params": params}, x))


def _port_pair(params, x, group=None, rank=0, tp=1):
    c1 = tconv.OutputChannelParallelConv2d(4, 16, 3, group=group)
    c2 = tconv.InputChannelParallelConv2d(16, 8, 3, group=group)
    k1, b1 = _oihw(params["c1"]["kernel"]), torch.as_tensor(np.array(params["c1"]["bias"]))
    k2, b2 = _oihw(params["c2"]["kernel"]), torch.as_tensor(np.array(params["c2"]["bias"]))
    n1 = 16 // tp
    c1.load_state_dict({"kernel": k1[rank * n1:(rank + 1) * n1],
                        "bias": b1[rank * n1:(rank + 1) * n1]})
    c2.load_state_dict({"kernel": k2[:, rank * n1:(rank + 1) * n1].contiguous(), "bias": b2})
    return c2(torch.relu(c1(_nchw(x))))


def test_conv_pair_tp2_matches_dense_and_jax():
    x, params, want = _jax_pair()
    dense = _port_pair(params, x)
    np.testing.assert_allclose(dense.permute(0, 2, 3, 1).detach().numpy(), want, atol=ATOL)

    def rank(r):
        group = mesh.get_tensor_model_parallel_group()
        return _port_pair(params, x, group, mesh.tensor_model_parallel_rank(), 2)

    for out in mesh.run_in_threads(2, rank, tensor_model_parallel_size=2):
        np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(), atol=ATOL)

    def whole_input(r):   # the input-channel conv takes its slice of a whole input
        tp_rank = mesh.tensor_model_parallel_rank()
        c2 = tconv.InputChannelParallelConv2d(16, 8, 3, input_is_parallel=False,
                                              group=mesh.get_tensor_model_parallel_group())
        k2 = _oihw(params["c2"]["kernel"])
        c2.load_state_dict({"kernel": k2[:, 8 * tp_rank:8 * tp_rank + 8].contiguous(),
                            "bias": torch.as_tensor(np.array(params["c2"]["bias"]))})
        h = torch.relu(_nchw(jax.nn.relu(_jax_c1(params, x))))
        return c2(h)

    for out in mesh.run_in_threads(2, whole_input, tensor_model_parallel_size=2):
        np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(), atol=ATOL)


def _jax_c1(params, x):
    return jconv.OutputChannelParallelConv2d(16, kernel_size=3).apply(
        {"params": params["c1"]}, x)


@pytest.mark.parametrize("strides,padding", [(2, "VALID"), (2, "SAME"), (1, "SAME")])
def test_gather_output_and_strides(strides, padding):
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 9, 8, 3))
    m = jconv.OutputChannelParallelConv2d(6, kernel_size=2, strides=strides, padding=padding,
                                          gather_output=True)
    params = meta.unbox(m.init(jax.random.PRNGKey(1), x))["params"]
    want = np.asarray(m.apply({"params": params}, x))
    k, b = _oihw(params["kernel"]), torch.as_tensor(np.array(params["bias"]))

    def rank(r):
        tp_rank = mesh.tensor_model_parallel_rank()
        c = tconv.OutputChannelParallelConv2d(3, 6, 2, strides=strides, padding=padding,
                                              gather_output=True,
                                              group=mesh.get_tensor_model_parallel_group())
        c.load_state_dict({"kernel": k[3 * tp_rank:3 * tp_rank + 3],
                           "bias": b[3 * tp_rank:3 * tp_rank + 3]})
        return c(_nchw(x))

    for y in mesh.run_in_threads(2, rank, tensor_model_parallel_size=2):
        assert y.shape == (1, 6) + want.shape[1:3]
        np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), want, atol=ATOL)


def test_extra_heads_math():
    assert [get_number_of_extra_heads(n, t) for n, t in ((12, 8), (16, 8), (5, 4))] == [4, 0, 3]


def _fill(abstract, seed):
    rs = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        scale = 0.1 if name.endswith("bias']") else 1.0 if "embed" in name else 0.3
        return (rs.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, meta.unbox(abstract)["params"])


@pytest.mark.parametrize("fam", ["bert", "gpt_neox"])
def test_pad_model_exact_and_equal_to_jax(fam):
    ids = np.random.RandomState(2).randint(0, 63, (2, 8)).astype(np.int32)
    if fam == "bert":
        kw = dict(vocab_size=64, hidden_size=30, intermediate_size=32, num_layers=2,
                  num_heads=5, max_position_embeddings=32, use_flash_attention=False,
                  hidden_dropout=0.0)
        jcfg, cfg = jb.BertConfig(**kw, dtype=jnp.float32), tb.BertConfig(**kw,
                                                                         dtype=torch.float32)
        jmodel, carry, port_cls = jb.BertForPreTraining(jcfg), bert_params_from_jax, \
            tb.BertForPreTraining
    else:
        kw = dict(vocab_size=64, hidden_size=30, intermediate_size=32, num_layers=2,
                  num_heads=5, num_kv_heads=5, head_dim=6, max_seq_len=32, rotary_pct=0.67,
                  use_flash_attention=False, remat_policy=None)
        jcfg, cfg = jn.GPTNeoXConfig(**kw, dtype=jnp.float32), tn.GPTNeoXConfig(
            **kw, dtype=torch.float32)
        jmodel, carry, port_cls = jn.GPTNeoXForCausalLM(jcfg), gpt_neox_params_from_jax, \
            tn.GPTNeoXForCausalLM
    tree = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.key(0), ids)), 3)
    params = carry(tree)
    padded, pcfg = pad_model(params, cfg, tp_degree=4)
    assert pcfg.num_heads == 8 and pcfg.head_dim_ == 6
    if fam == "gpt_neox":
        assert pcfg.num_kv_heads == 8 and pcfg.rope_dims == cfg.rope_dims == 4
    jpadded, jpcfg = jpad.pad_model(tree, jcfg, tp_degree=4)
    want = carry(jax.tree_util.tree_map(np.asarray, jpadded))
    assert set(want) == set(padded)
    for k, v in padded.items():
        assert torch.equal(v, want[k]), k

    def run(c, p):
        m = port_cls(c)
        m.load_state_dict(p, strict=True)
        out = m(torch.as_tensor(ids))
        return out if isinstance(out, tuple) else (out,)

    for a, b in zip(run(cfg, params), run(pcfg, padded)):
        assert torch.equal(a, b)


def test_pad_refuses_gqa():
    for cfg in (MixtralConfig(num_heads=10, num_kv_heads=2, head_dim=4),
                tn.GPTNeoXConfig(num_heads=6, num_kv_heads=2, head_dim=4)):
        with pytest.raises(ValueError, match="kv_size_multiplier"):
            pad_model({}, cfg, tp_degree=4)
    bert = tb.BertConfig(num_heads=8, hidden_size=64)   # 8 heads divide 4: nothing to pad
    assert pad_model({}, bert, tp_degree=4)[1] is bert
