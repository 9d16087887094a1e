"""The port's MoE block and Mixtral family against the JAX package's.

The same seeded weights and inputs (numpy) go through the JAX modules and
the port's, fp32 on both sides, at tiny widths (hidden 32, 4 experts, 2
layers): each router, each expert mode and the MoE block within 1e-5; a
tiny ``MixtralForCausalLM``'s logits within 1e-5; greedy streams through
``CausalLM.generate`` (selective and all_experts decode) and through
``ServeEngine`` over a small paged trace identical to JAX's. With int8
weights the port quantizes one scale set per expert; JAX serves a tree that
``quantize_params`` built layer by layer and restacked (scale ``(L, E, 1,
I)``): logits within 1e-5, streams identical in both modes.

ROADMAP C7 is pinned here: JAX's ``quantize_params`` on the scan-stacked
tree reduces the expert axis (scale ``(L, 1, H, I)``), and its selective
decode then takes NaN scales and emits token 0, while the port's selective
stream on the same dequantized weights equals JAX's all_experts stream,
and ``quantized_params_from_jax`` refuses the layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.inference import ServeEngine as JaxEngine
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.moe import expert_mlps as jx
from neuronx_distributed_tpu.moe import layer as jlayer
from neuronx_distributed_tpu.moe import routing as jr
from neuronx_distributed_tpu.quantization import core as jq
from neuronx_distributed_tpu_torch.converters.jax_params import (
    mixtral_params_from_jax,
    quantized_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.moe import (
    ExpertMLPs,
    MoE,
    RouterSinkhorn,
    RouterTopK,
    load_balancing_loss,
    router_z_loss,
    top_k,
)
from neuronx_distributed_tpu_torch.parallel.layers import adopt_quantized
from neuronx_distributed_tpu_torch.quantization import core as tq

E, H, I, T = 4, 32, 64, 6
TOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=H, intermediate_size=I, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=48, use_flash_attention=False, num_experts=E, top_k=2)
# T * k / E for one decode token: 1 * 2 / 4 = 0.5; threshold 1.5 -> selective, 0 -> all_experts
MODES = {"selective": 1.5, "all_experts": 0.0}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny CPU models run thousands of small ops,
    which several threads a worker only slow down beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def expert_weights():
    return {"gate": _rand(1, E, H, I, scale=H ** -0.5), "up": _rand(2, E, H, I, scale=H ** -0.5),
            "down": _rand(3, E, I, H, scale=I ** -0.5)}


def test_top_k_breaks_ties_as_jax():
    """Equal values come out lower index first, as ``jax.lax.top_k`` gives
    them (``torch.topk`` promises no order)."""
    x = np.array([[0.1, 0.3, 0.3, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2, 0.2],
                  [0.5, 0.1, 0.5, 0.4, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_routers_match_jax():
    w = _rand(4, H, E, scale=H ** -0.5)
    x = _rand(5, T, H)
    x[3] = 0.0            # a row of equal logits: a tie over every expert
    for jcls, tcls in ((jr.RouterTopK(E, top_k=2), RouterTopK(H, E, top_k=2)),
                       (jr.RouterSinkhorn(E), RouterSinkhorn(H, E))):
        want = jcls.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
        tcls.load_state_dict({"kernel": _t(w)})
        got = tcls(_t(x))
        for g, wv in zip(got, want):
            _close(g.numpy(), wv)
    r = RouterTopK(H, E, top_k=2)
    r.load_state_dict({"kernel": _t(w)})
    c, logits = r(_t(x))
    # the tied row routes to the two lowest-numbered experts, as JAX does
    np.testing.assert_array_equal((c[3] > 0).numpy(), [True, True, False, False])
    _close(load_balancing_loss(logits, c, E).numpy(),
           jr.load_balancing_loss(jnp.asarray(logits.numpy()), jnp.asarray(c.numpy()), E))
    _close(router_z_loss(logits).numpy(), jr.router_z_loss(jnp.asarray(logits.numpy())))


def _combine(seed):
    r = RouterTopK(H, E, top_k=2)
    r.load_state_dict({"kernel": _t(_rand(seed, H, E, scale=H ** -0.5))})
    return r(_t(_rand(seed + 1, T, H)))[0].numpy()


@pytest.mark.parametrize("mode", ["all_experts", "selective", "capacity_factor"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_expert_mlps_match_jax(expert_weights, mode, quantized):
    x, combine = _rand(7, T, H), _combine(8)
    jparams = {k: jnp.asarray(v) for k, v in expert_weights.items()}
    sd = {k: _t(v) for k, v in expert_weights.items()}
    mod = ExpertMLPs(E, H, I, mode=mode, dtype=torch.float32)
    if quantized:   # the port's per-expert scales, given to JAX as they are
        sd = tq.quantize_params({f"moe.experts.{k}": v for k, v in sd.items()})
        jparams = {k: jq.QuantizedLeaf(qweight=jnp.asarray(sd[f"moe.experts.{k}.qweight"].numpy()),
                                       scale=jnp.asarray(sd[f"moe.experts.{k}.scale"].numpy()))
                   for k in expert_weights}
        sd = {k[len("moe.experts."):]: v for k, v in sd.items()}
        adopt_quantized(mod, sd)
    mod.load_state_dict(sd, strict=True)
    jmod = jx.ExpertMLPs(num_experts=E, hidden_size=H, intermediate_size=I, mode=mode,
                         capacity_factor=1.0, dtype=jnp.float32)
    mod.capacity_factor = 1.0   # 1 * 6 / 4 -> one slot an expert: drops tokens
    want = jmod.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(combine), top_k=2)
    with torch.no_grad():
        got = mod(_t(x), _t(combine), top_k=2)
    _close(got.numpy(), want)


def test_selective_equals_all_experts(expert_weights):
    x, combine = _t(_rand(9, T, H)), _t(_combine(10))
    mod = ExpertMLPs(E, H, I, dtype=torch.float32)
    mod.load_state_dict({k: _t(v) for k, v in expert_weights.items()})
    with torch.no_grad():
        _close(mod(x, combine, top_k=2, mode="selective").numpy(),
               mod(x, combine, top_k=2, mode="all_experts").numpy())


@pytest.mark.parametrize("seq,inference", [(5, False), (5, True), (1, True)])
def test_moe_block_matches_jax(expert_weights, seq, inference):
    """Training-style forward (capacity_factor), context encoding
    (all_experts) and a decode step (T * k / E = 0.5 < 1.5: selective)."""
    b = 2 if seq > 1 else 1
    x = _rand(11, b, seq, H)
    w = _rand(12, H, E, scale=H ** -0.5)
    kw = dict(inference=inference, selective_loading_threshold=1.5)
    jmoe = jlayer.MoE(num_experts=E, hidden_size=H, intermediate_size=I, top_k=2,
                      dtype=jnp.float32, **kw)
    jparams = {"router": {"kernel": jnp.asarray(w)},
               "experts": {k: jnp.asarray(v) for k, v in expert_weights.items()}}
    want, _ = jmoe.apply({"params": jparams}, jnp.asarray(x), mutable=["losses"])
    moe = MoE(E, H, I, top_k=2, dtype=torch.float32, **kw)
    moe.load_state_dict({"router.kernel": _t(w),
                         **{f"experts.{k}": _t(v) for k, v in expert_weights.items()}})
    assert moe.mode_for(b, seq) == ("capacity_factor" if not inference else
                                    "selective" if seq == 1 else "all_experts")
    with torch.no_grad():
        _close(moe(_t(x)).numpy(), want)


@pytest.fixture(scope="module")
def mixtral():
    jcfg = jm.MixtralConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tcfg = tm.MixtralConfig(**TINY, dtype=torch.float32)
    params = meta.unbox(jm.MixtralForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, mixtral_params_from_jax(params)


def _prompt(seed, b=1, n=8):
    return np.random.default_rng(seed).integers(1, 127, (b, n)).astype(np.int32)


def test_mixtral_logits_match_jax(mixtral):
    jcfg, tcfg, params, sd = mixtral
    ids = _prompt(0, 2)
    want = jm.MixtralForCausalLM(jcfg).apply({"params": params}, jnp.asarray(ids))
    model = tm.MixtralForCausalLM(tcfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    _close(got.numpy(), want)
    assert isinstance(model.model.layers[0], tm.MixtralDecoderLayer)
    assert tm.MixtralModel.layer_cls is tm.MixtralDecoderLayer


def _generate_pair(jcfg, tcfg, jparams, tparams, mode, ids, new=10):
    jc = dataclasses.replace(jcfg, selective_loading_threshold=MODES[mode])
    tc = dataclasses.replace(tcfg, selective_loading_threshold=MODES[mode])
    want = JaxLM(jc, jparams, jm.MixtralForCausalLM, buckets=(8,), max_batch=1).generate(
        ids, max_new_tokens=new)
    lm = CausalLM(tc, tparams, tm.MixtralForCausalLM, buckets=(8,), max_batch=1, device="cpu")
    return np.asarray(want.tokens), lm


@pytest.mark.parametrize("mode", list(MODES))
def test_mixtral_generate_streams_match_jax(mixtral, mode):
    jcfg, tcfg, params, sd = mixtral
    ids = _prompt(3)
    want, lm = _generate_pair(jcfg, tcfg, params, sd, mode, ids)
    assert lm.model.model.layers[0].moe.mode_for(1, 1) == mode
    for chunk in (0, 4):
        np.testing.assert_array_equal(lm.generate(ids, max_new_tokens=10,
                                                  fused_chunk=chunk).tokens, want)


def _jax_per_expert_quantize(params):
    """JAX ``quantize_params`` with the expert tensors quantized one layer at
    a time and restacked: scale ``(L, E, 1, I)`` (its docstring's rule)."""
    q = jq.quantize_params(params)
    experts = params["model"]["layers"]["block"]["moe"]["experts"]
    qe = q["model"]["layers"]["block"]["moe"]["experts"]
    for name, w in experts.items():
        layers = [jq.quantize_params({"moe": {"experts": {name: w[i]}}})["moe"]["experts"][name]
                  for i in range(w.shape[0])]
        qe[name] = jq.QuantizedLeaf(qweight=jnp.stack([x["qweight"] for x in layers]),
                                    scale=jnp.stack([x["scale"] for x in layers]))
    return q


@pytest.fixture(scope="module")
def int8_mixtral(mixtral):
    jcfg, tcfg, params, sd = mixtral
    return _jax_per_expert_quantize(params), tq.quantize_params(sd)


def test_int8_mixtral_quantization_is_jax_rule_per_layer(mixtral, int8_mixtral):
    _, _, params, _ = mixtral
    jqp, tqp = int8_mixtral
    assert tqp["model.layers.0.moe.experts.gate.scale"].shape == (E, 1, I)
    assert np.asarray(jqp["model"]["layers"]["block"]["moe"]["experts"]["gate"]["scale"]).shape \
        == (2, E, 1, I)
    carried = quantized_params_from_jax(jqp)
    assert carried.keys() == tqp.keys()
    for k in tqp:
        assert torch.equal(carried[k], tqp[k]), k
    assert "model.layers.1.moe.router.kernel" in tqp   # the router stays float


def test_int8_mixtral_logits_match_jax(mixtral, int8_mixtral):
    jcfg, tcfg, _, _ = mixtral
    jqp, tqp = int8_mixtral
    ids = _prompt(4, 2)
    want = jm.MixtralForCausalLM(jcfg).apply({"params": jqp}, jnp.asarray(ids))
    # serving: context encoding in all_experts, the head at each row's last
    # token, then a decode step (2 rows: all_experts)
    kw = dict(buckets=(8,), max_batch=2)
    jlm = JaxLM(jcfg, jqp, jm.MixtralForCausalLM, **kw)
    lm = CausalLM(tcfg, tqp, tm.MixtralForCausalLM, device="cpu", **kw)
    js, ts = jlm.start_session(), lm.start_session()
    jl, tl = np.asarray(jlm.insert(js, [0, 1], ids)), lm.insert(ts, [0, 1], ids).numpy()
    _close(tl, jl)
    tok = jl.argmax(-1).astype(np.int32)
    _close(lm.step(ts, tok).numpy(), np.asarray(jlm.step(js, tok)))
    model = tm.MixtralForCausalLM(tcfg)   # training-style forward: capacity_factor
    adopt_quantized(model, tqp)
    model.load_state_dict(tqp, strict=True)
    with torch.no_grad():
        _close(model(torch.from_numpy(ids).long()).numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_mixtral_streams_match_jax(mixtral, int8_mixtral, mode):
    jcfg, tcfg, _, _ = mixtral
    jqp, tqp = int8_mixtral
    ids = _prompt(5)
    want, lm = _generate_pair(jcfg, tcfg, jqp, tqp, mode, ids)
    np.testing.assert_array_equal(lm.generate(ids, max_new_tokens=10, fused_chunk=4).tokens,
                                  want)


def test_c7_jax_stacked_expert_scales_degenerate_port_serves_them(mixtral):
    """ROADMAP C7: JAX's stacked quantization shares each scale across the
    experts and its int8 selective decode emits token 0 from the first
    decode step on. On the same weights (dequantized) the port's selective
    stream is JAX's all_experts int8 stream; the converter refuses the
    layout."""
    jcfg, tcfg, params, _ = mixtral
    c7 = jq.quantize_params(params)
    gate = c7["model"]["layers"]["block"]["moe"]["experts"]["gate"]
    assert np.asarray(gate["qweight"]).shape == (2, E, H, I)
    assert np.asarray(gate["scale"]).shape == (2, 1, H, I)
    ids = _prompt(6)
    streams = {}
    for mode in MODES:
        jc = dataclasses.replace(jcfg, selective_loading_threshold=MODES[mode])
        streams[mode] = np.asarray(JaxLM(jc, c7, jm.MixtralForCausalLM, buckets=(8,),
                                         max_batch=1).generate(ids, max_new_tokens=6).tokens[0])
    assert (streams["selective"][1:] == 0).all()
    assert not (streams["all_experts"][1:] == 0).all()
    deq = mixtral_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jq.dequantize_params(c7, jnp.float32)))
    tc = dataclasses.replace(tcfg, selective_loading_threshold=MODES["selective"])
    lm = CausalLM(tc, deq, tm.MixtralForCausalLM, buckets=(8,), max_batch=1, device="cpu")
    np.testing.assert_array_equal(lm.generate(ids, max_new_tokens=6).tokens[0],
                                  streams["all_experts"])
    with pytest.raises(ValueError, match="C7"):
        quantized_params_from_jax(c7)


def _submits():
    rng = np.random.default_rng(12)
    lens = (12, 7, 14, 10, 5)
    prompts = [rng.integers(1, 127, n).astype(np.int32) for n in lens]
    prompts[3][:8] = prompts[0][:8]
    return [dict(prompt=p, max_new_tokens=m, arrival_block=a)
            for p, m, a in zip(prompts, (6, 9, 5, 7, 8), (0, 0, 0, 1, 1))]


def _serve(engine):
    ids = [engine.submit(**sub) for sub in _submits()]
    done = engine.run()
    return ({c.request_id: c.tokens.tolist() for c in done}, [c.request_id for c in done],
            {c.request_id: (c.queue_blocks, c.ttft_blocks, c.decode_blocks) for c in done}, ids)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_mixtral_serve_engine_matches_jax(mixtral, int8_mixtral, quantized):
    """Paged pools at max_batch 2 (decode: 2 * 2 / 4 = 1 > 0.5, all_experts)
    through the paged kernel's twin: JAX's tokens, completion order and
    schedule; the stepwise engine agrees."""
    jcfg, tcfg, params, sd = mixtral
    jp, tp = (int8_mixtral if quantized else (params, sd))
    kw = dict(buckets=(8, 16), max_batch=2, page_size=4, paged_attn_kernel=True)
    jlm = JaxLM(jcfg, jp, jm.MixtralForCausalLM, **kw).compile()
    tlm = CausalLM(tcfg, tp, tm.MixtralForCausalLM, device="cpu", **kw)
    want = _serve(JaxEngine(jlm, block_steps=4))
    got = _serve(ServeEngine(tlm, block_steps=4))
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert _serve(ServeEngine(tlm, block_steps=4, fused=False))[0] == got[0]
