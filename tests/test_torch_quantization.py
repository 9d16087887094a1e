"""The port's int8 weight-only quantization against the JAX package's.

One seeded flax Llama init (2 layers, hidden 32, GQA group 2) is carried
over with ``llama_params_from_jax``. The port's ``quantize_params`` on the
port's flat state dict must give JAX's int8 weights and scales bit for bit
on every leaf (JAX quantizes the scan-stacked tree: its per-layer slices
are the port's leaves), per output channel and per tensor; ``dequantize_
params`` the same floats. A model serves straight from the int8 dict: its
logits equal the ``param_transform`` route's bit for bit, and its greedy
streams through ``CausalLM.generate`` and ``ServeEngine`` equal JAX's
``CausalLM`` serving the JAX int8 tree, in fp32 on both sides. B5's twin
(the CPU route of every int8 product) is held against the plain
dequantize-then-matmul. The MoE and Mixtral cases are in
``test_torch_moe.py``; B5 itself runs on the card
(``test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.quantization import core as jq
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    quantized_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.kernels.w8a16 import (
    dequantize,
    int8_linear,
    w8a16_gemm,
    w8a16_gemm_plain,
)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel.layers import QuantizedKernel
from neuronx_distributed_tpu_torch.quantization import core as tq

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
PAGED = dict(buckets=(8, 16), max_batch=4, page_size=4, paged_attn_kernel=True)
K = 4
PER_TENSOR = dict(quantization_type="per_tensor_symmetric")



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny CPU models run thousands of small ops,
    which several threads a worker only slow down beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, llama_params_from_jax(params)


def _jax_layer_leaves(tree):
    """JAX tree -> {port name: leaf} over the stacked layer leaves, one
    entry a layer (a QuantizedLeaf keeps its qweight and scale slices)."""
    out = {}
    block = tree["model"]["layers"]["block"]
    for path, name in (
            (("attention", "qkv", "q_kernel"), "attention.qkv.q_kernel"),
            (("attention", "qkv", "k_kernel"), "attention.qkv.k_kernel"),
            (("attention", "qkv", "v_kernel"), "attention.qkv.v_kernel"),
            (("attention", "o_proj", "kernel"), "attention.o_proj.kernel"),
            (("mlp", "gate_proj", "kernel"), "mlp.gate_proj.kernel"),
            (("mlp", "up_proj", "kernel"), "mlp.up_proj.kernel"),
            (("mlp", "down_proj", "kernel"), "mlp.down_proj.kernel")):
        node = block
        for key in path:
            node = node[key]
        for i in range(TINY["num_layers"]):
            out[f"model.layers.{i}.{name}"] = (
                {k: np.asarray(v)[i] if np.ndim(v) else np.asarray(v) for k, v in node.items()}
                if isinstance(node, dict) else np.asarray(node)[i])
    return out


def test_per_channel_int8_and_scales_equal_jax_bit_for_bit(weights):
    _, _, params, sd = weights
    got = tq.quantize_params(sd)
    want = _jax_layer_leaves(jq.quantize_params(params))
    assert want
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name + ".qweight"].numpy(), leaf["qweight"])
        np.testing.assert_array_equal(got[name + ".scale"].numpy(), leaf["scale"])
        assert got[name + ".qweight"].dtype == torch.int8
        assert got[name + ".scale"].dtype == torch.float32
    # dense (in, out) -> (1, out); GQA (H, N, D) -> (1, N, D): fan-in only
    assert got["model.layers.0.mlp.gate_proj.kernel.scale"].shape == (1, 64)
    assert got["model.layers.0.attention.qkv.k_kernel.scale"].shape == (1, 2, 8)
    # embedding, head and norms stay float, untouched
    for name in ("model.embed.embedding", "lm_head.kernel", "model.final_norm.scale",
                 "model.layers.1.input_norm.scale"):
        assert got[name] is sd[name]


def test_per_tensor_int8_and_scales_equal_jax_per_layer(weights):
    """Per tensor, one scale a weight of one layer: JAX's per-tensor rule on
    each layer's weight (on the stacked tree JAX takes one abs-max over all
    layers at once)."""
    _, _, params, sd = weights
    got = tq.quantize_params(sd, tq.QuantizationConfig(**PER_TENSOR))
    for name, w in _jax_layer_leaves(params).items():
        # a one-layer tree under the stacked path's keys
        leaf = jq.quantize_params({"model": {"layers": {"block": {"x": {"kernel": w}}}}},
                                  jq.QuantizationConfig(**PER_TENSOR))
        leaf = leaf["model"]["layers"]["block"]["x"]["kernel"]
        np.testing.assert_array_equal(got[name + ".qweight"].numpy(), np.asarray(leaf["qweight"]))
        np.testing.assert_array_equal(got[name + ".scale"].numpy(), np.asarray(leaf["scale"]))
        assert got[name + ".scale"].shape == ()


@pytest.mark.parametrize("config", [{}, PER_TENSOR], ids=["per_channel", "per_tensor"])
def test_dequantize_params_equals_jax(weights, config):
    _, _, params, sd = weights
    qp = tq.quantize_params(sd, tq.QuantizationConfig(**config))
    got = tq.dequantize_params(qp, torch.float32)
    assert set(got) == set(sd)
    for name in _jax_layer_leaves(params):
        pair = {"qweight": jnp.asarray(qp[name + ".qweight"].numpy()),
                "scale": jnp.asarray(qp[name + ".scale"].numpy())}
        want = np.asarray(jq.dequantize_params({"w": jq.QuantizedLeaf(pair)}, jnp.float32)["w"])
        np.testing.assert_array_equal(got[name].numpy(), want)


def test_roundtrip_within_half_a_step():
    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(64, 32) * np.geomspace(0.01, 10.0, 32)).astype(np.float32))
    qp = tq.quantize_params({"proj.kernel": w})
    deq = tq.dequantize_params(qp, torch.float32)["proj.kernel"]
    step = w.abs().amax(dim=0) / 127.0
    assert bool(((deq - w).abs() <= step[None, :] * 0.5 + 1e-9).all())
    assert torch.equal(tq.dequantize_leaf({"qweight": qp["proj.kernel.qweight"],
                                           "scale": qp["proj.kernel.scale"]}, torch.float32), deq)


def test_targets_exclusions_and_expert_axis():
    """The JAX patterns on flax-style names: the router, embeddings, head,
    norms and biases stay float; an expert weight (E, H, I) keeps one scale
    set per expert (E, 1, I); pairs already quantized pass through."""
    g = torch.Generator().manual_seed(0)
    sd = {n: torch.randn(s, generator=g) for n, s in (
        ("model.embed.embedding", (16, 8)), ("lm_head.kernel", (8, 16)),
        ("model.layers.0.moe.router.kernel", (8, 4)),
        ("model.layers.0.moe.experts.gate", (4, 8, 12)),
        ("model.layers.0.moe.experts.down", (4, 12, 8)),
        ("model.layers.0.attention.o_proj.kernel", (8, 8)),
        ("model.layers.0.input_norm.scale", (8,)))}
    qp = tq.quantize_params(sd)
    assert sorted(k for k in qp if k.endswith(".qweight")) == [
        "model.layers.0.attention.o_proj.kernel.qweight",
        "model.layers.0.moe.experts.down.qweight", "model.layers.0.moe.experts.gate.qweight"]
    assert qp["model.layers.0.moe.experts.gate.scale"].shape == (4, 1, 12)
    assert qp["model.layers.0.moe.experts.down.scale"].shape == (4, 1, 8)
    assert tq.flax_path("model.layers.3.moe.experts.up") == \
        "['model']['layers']['block']['moe']['experts']['up']"
    assert tq.quantize_params(qp).keys() == qp.keys()
    for k in qp:
        assert qp[k] is tq.quantize_params(qp)[k]


def test_quantized_params_from_jax_equals_port_quantization(weights):
    _, _, params, sd = weights
    for config in ({}, PER_TENSOR):
        carried = quantized_params_from_jax(
            jq.quantize_params(params, jq.QuantizationConfig(**config)))
        if config:   # JAX's stacked per-tensor scale is shared by the layers
            scale = carried["model.layers.0.mlp.up_proj.kernel.scale"]
            assert scale.shape == () and torch.equal(
                scale, carried["model.layers.1.mlp.up_proj.kernel.scale"])
            continue
        ours = tq.quantize_params(sd)
        assert carried.keys() == ours.keys()
        for k in ours:
            assert torch.equal(carried[k], ours[k]), k


def test_w8a16_twin_is_the_dequantized_product():
    """B5's CPU route: routed experts, a shared (stride-0) x, per-tensor
    scales and the dense layers' 2-D product."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn((4, 32, 48), generator=g)
    qp = tq.quantize_params({"moe.experts.gate": w})
    q, s = qp["moe.experts.gate.qweight"], qp["moe.experts.gate.scale"]
    x = torch.randn((6, 3, 32), generator=g)
    idx = torch.tensor([2, 0, 3, 3, 1, 2], dtype=torch.int32)
    want = torch.stack([x[b] @ dequantize(q[i], s[i], torch.float32)
                        for b, i in enumerate(idx.tolist())])
    torch.testing.assert_close(w8a16_gemm(x, q, s, idx), want, rtol=1e-6, atol=1e-6)
    xs = x[:1].expand(4, 3, 32)
    want = torch.stack([xs[e] @ dequantize(q[e], s[e], torch.float32) for e in range(4)])
    torch.testing.assert_close(w8a16_gemm(xs, q, s, torch.arange(4, dtype=torch.int32)), want,
                               rtol=1e-6, atol=1e-6)
    qt, st = tq.quantize_tensor(w[0], None)
    x2 = torch.randn((5, 7, 32), generator=g)
    assert torch.equal(int8_linear(x2, qt, st), x2 @ dequantize(qt, st, torch.float32))
    assert torch.equal(w8a16_gemm_plain(x2.reshape(1, 35, 32), qt[None], st,
                                        torch.zeros(1, dtype=torch.int32)),
                       (x2.reshape(35, 32) @ dequantize(qt, st, torch.float32))[None])
    with pytest.raises(ValueError, match="idx"):
        w8a16_gemm(x, q, s, idx.long())
    with pytest.raises(ValueError, match="scale"):
        w8a16_gemm(x, q, s[:, :, :10], idx)


def test_int8_model_holds_quantized_kernels(weights):
    """``CausalLM`` swaps each pair in as a QuantizedKernel: int8 and fp32
    as given, no float copy of the weight."""
    _, tcfg, _, sd = weights
    qp = tq.quantize_params(sd)
    lm = CausalLM(tcfg, qp, tl.LlamaForCausalLM, buckets=(8,), max_batch=1, device="cpu")
    layer = lm.model.model.layers[1]
    for mod in (layer.attention.qkv.q_kernel, layer.mlp.down_proj.kernel):
        assert isinstance(mod, QuantizedKernel) and mod.qweight.dtype == torch.int8
    assert layer.attention.qkv.k_kernel.qweight is qp["model.layers.1.attention.qkv.k_kernel.qweight"]
    assert not any(p.dtype == torch.int8 for p in lm.model.parameters())


def test_int8_in_layer_equals_param_transform_route(weights):
    """Serving straight from the int8 dict needs no knob and gives the
    ``param_transform`` route's logits and streams bit for bit (JAX
    ``test_int8_direct_in_layer_dequant``)."""
    _, tcfg, _, sd = weights
    qp = tq.quantize_params(sd)
    ids = np.random.default_rng(0).integers(1, 127, (2, 8)).astype(np.int32)
    direct = CausalLM(tcfg, qp, tl.LlamaForCausalLM, buckets=(8,), max_batch=2, device="cpu")
    routed = CausalLM(tcfg, qp, tl.LlamaForCausalLM, buckets=(8,), max_batch=2, device="cpu",
                      param_transform=lambda p: tq.dequantize_params(p, torch.float32))
    assert next(routed.model.parameters()).device.type == "meta"
    sessions = [lm.start_session() for lm in (direct, routed)]
    a, b = (lm.insert(s, [0, 1], ids) for lm, s in zip((direct, routed), sessions))
    assert torch.equal(a, b)
    tok = a.argmax(-1).numpy().astype(np.int32)
    assert torch.equal(direct.step(sessions[0], tok), routed.step(sessions[1], tok))
    gen = [lm.generate(ids, max_new_tokens=8).tokens for lm in (direct, routed)]
    np.testing.assert_array_equal(*gen)
    with pytest.raises(KeyError, match="param_transform"):
        CausalLM(tcfg, qp, tl.LlamaForCausalLM, buckets=(8,), device="cpu",
                 param_transform=lambda p: p)


@pytest.fixture(scope="module")
def int8_pair(weights):
    jcfg, tcfg, params, sd = weights
    jq_params = jq.quantize_params(params)
    return (JaxLM(jcfg, jq_params, jl.LlamaForCausalLM, **PAGED).compile(),
            CausalLM(tcfg, quantized_params_from_jax(jq_params), tl.LlamaForCausalLM,
                     device="cpu", **PAGED))


def test_int8_generate_streams_equal_jax(weights):
    jcfg, tcfg, params, sd = weights
    ids = np.random.default_rng(2).integers(1, 127, (2, 8)).astype(np.int32)
    want = JaxLM(jcfg, jq.quantize_params(params), jl.LlamaForCausalLM, buckets=(8,),
                 max_batch=2).generate(ids, max_new_tokens=10)
    lm = CausalLM(tcfg, tq.quantize_params(sd), tl.LlamaForCausalLM, buckets=(8,), max_batch=2,
                  device="cpu")
    for chunk in (0, 4):
        got = lm.generate(ids, max_new_tokens=10, fused_chunk=chunk)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


def _submits():
    rng = np.random.default_rng(11)
    lens = (12, 7, 14, 10, 5, 9)
    prompts = [rng.integers(1, 127, n).astype(np.int32) for n in lens]
    prompts[3][:8] = prompts[0][:8]
    return [dict(prompt=p, max_new_tokens=m, arrival_block=a)
            for p, m, a in zip(prompts, (6, 9, 5, 7, 8, 4), (0, 0, 0, 1, 1, 2))]


def _serve(engine):
    ids = [engine.submit(**sub) for sub in _submits()]
    done = engine.run()
    return ({c.request_id: c.tokens.tolist() for c in done}, [c.request_id for c in done], ids)


def test_int8_serve_engine_streams_equal_jax(int8_pair):
    """Paged pools, the paged kernel's twin and int8 weights: the JAX
    engine's streams and completion order; the stepwise engine agrees."""
    jlm, tlm = int8_pair
    want, want_order, _ = _serve(JaxEngine(jlm, block_steps=K))
    got, got_order, ids = _serve(ServeEngine(tlm, block_steps=K))
    assert sorted(got) == sorted(ids)
    assert got == want and got_order == want_order
    assert _serve(ServeEngine(tlm, block_steps=K, fused=False))[0] == got


def test_int8_model_through_chunk_extends_and_speculation(weights):
    """The other programs take the int8 model too: chunked admission (slab
    ``chunk_extend`` and paged extends) gives the one-shot streams, and a
    speculative decode with an int8 self-draft accepts every proposal and
    gives ``generate``'s tokens (fp32)."""
    from neuronx_distributed_tpu_torch.inference.speculative import speculative_generate

    _, tcfg, _, sd = weights
    qp = tq.quantize_params(sd)
    for kw in (dict(buckets=(8, 16), max_batch=4),
               dict(buckets=(8, 16), max_batch=4, page_size=4, paged_attn_kernel=True)):
        lm = CausalLM(tcfg, qp, tl.LlamaForCausalLM, device="cpu", **kw)
        one_shot = _serve(ServeEngine(lm, block_steps=K))[0]
        chunked = ServeEngine(lm, block_steps=K, prefill_chunk_tokens=4)
        assert _serve(chunked)[0] == one_shot
        assert chunked.chunk_program_calls > 0
    target, draft = (CausalLM(tcfg, qp, tl.LlamaForCausalLM, buckets=(16,), max_batch=1,
                              device="cpu") for _ in range(2))
    ids = np.random.default_rng(3).integers(1, 127, (1, 9)).astype(np.int32)
    spec = speculative_generate(target, draft, ids, 12, num_draft=3)
    np.testing.assert_array_equal(spec.tokens, target.generate(ids, 12).tokens)
    assert spec.stats["acceptance_rate"] == 1.0
