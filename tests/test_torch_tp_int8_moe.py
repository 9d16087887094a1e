"""int8 weights and Mixtral served under a tensor-parallel group, held
against the JAX package at TP=2 on its CPU mesh and against the port at
TP=1.

The JAX oracle runs once per module inside its own TP=2 world: it draws
the weights with its trainer's init (value-identical at every degree),
quantizes the (sharded) tree with ``quantize_params`` as its runner does
(the Mixtral experts one layer at a time: one scale set per expert, see
ROADMAP C7), and serves greedy streams with its ``CausalLM``. The port's
two ranks are threads over one gloo group; each carries the JAX trees
across with ``quantized_params_from_jax`` / ``mixtral_params_from_jax``
at ``tp_rank``/``tp_size`` and serves its shard.

- int8 Llama: greedy streams equal JAX's and the port's at TP=1; logits
  within 1e-5 of both; every rank's ``X.scale`` is the slice of JAX's
  global scale (a planted per-shard quantization fails that check); a
  rank's weight bytes are at most 0.55 of TP=1's; ``init_params(quantize=,
  tp_rank=, tp_size=)`` gives the cut of the whole-model quantization;
- Mixtral, fp32 and int8: all_experts at 8 rows and selective at 1 row,
  each equal to JAX's streams at TP=2; selective equals all_experts at
  TP=2; both ranks route alike;
- EP in decode stays refused.

Tiny models, fp32, one intra-op thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import CausalLM as JaxLM
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as psm
from neuronx_distributed_tpu.quantization import core as jq
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model,
    neuronx_distributed_config,
)
from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    mixtral_params_from_jax,
    quantized_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.partition import (
    param_partition_specs,
    scale_spec,
    shard_slice,
    state_partition_specs,
)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.moe.expert_mlps import ExpertMLPs
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.layers import QuantizedKernel, adopt_quantized
from neuronx_distributed_tpu_torch.quantization import core as tq

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, use_flash_attention=False)
MOE = dict(num_experts=4, top_k=2)
# selective at 1 row (2/4 = 0.5 < 1.5), all_experts at 8 rows (4 >= 1.5)
THRESHOLD = 1.5
NEW = 8
ATOL = 1e-5   # fp32 logits: the row-parallel all-reduce sums in another order
SHARE_MAX = 0.55


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(b, seed):
    return np.random.default_rng(seed).integers(1, 127, (b, 8)).astype(np.int32)


P8 = _prompts(8, 3)
P1 = _prompts(1, 4)


def _per_expert_quantize(params):
    """JAX ``quantize_params`` with the expert tensors quantized one layer
    at a time and restacked (one scale set per expert: the port's rule)."""
    q = jq.quantize_params(params)
    experts = params["model"]["layers"]["block"]["moe"]["experts"]
    qe = q["model"]["layers"]["block"]["moe"]["experts"]
    for name, w in experts.items():
        layers = [jq.quantize_params({"moe": {"experts": {name: w[i]}}})["moe"]["experts"][name]
                  for i in range(w.shape[0])]
        qe[name] = jq.QuantizedLeaf(qweight=jnp.stack([x["qweight"] for x in layers]),
                                    scale=jnp.stack([x["scale"] for x in layers]))
    return q


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def oracle():
    """The JAX package at TP=2: float and int8 trees of a Llama and a
    Mixtral, their greedy streams and one insert's logits."""
    psm.destroy_model_parallel()
    psm.initialize_model_parallel(tensor_model_parallel_size=2)
    try:
        nxd = neuronx_distributed_config(tensor_parallel_size=2)
        ids = jnp.zeros((1, 8), jnp.int32)
        jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
        model = initialize_parallel_model(nxd, lambda: jl.LlamaForCausalLM(jcfg), ids)
        qtree = jq.quantize_params(model.params)
        jlm = JaxLM(jcfg, qtree, jl.LlamaForCausalLM, buckets=(8,), max_batch=8)
        llama = dict(params=_np(model.params), qtree=_np(qtree),
                     stream=np.asarray(jlm.generate(P8, max_new_tokens=NEW).tokens),
                     insert=np.asarray(jlm.insert(jlm.start_session(), np.arange(8), P8)))
        mcfg = jm.MixtralConfig(**TINY, **MOE, dtype=jnp.float32, remat_policy=None,
                                selective_loading_threshold=THRESHOLD)
        mmodel = initialize_parallel_model(nxd, lambda: jm.MixtralForCausalLM(mcfg), ids)
        mq = _per_expert_quantize(mmodel.params)
        mixtral = dict(params=_np(mmodel.params), qtree=_np(mq))
        for kind, tree in (("fp32", mmodel.params), ("int8", mq)):
            for rows, prompts in ((8, P8), (1, P1)):
                jm_lm = JaxLM(mcfg, tree, jm.MixtralForCausalLM, buckets=(8,), max_batch=rows)
                mixtral[(kind, rows)] = np.asarray(
                    jm_lm.generate(prompts, max_new_tokens=NEW).tokens)
        return {"llama": llama, "mixtral": mixtral}
    finally:
        psm.destroy_model_parallel()


def _tp2(fn):
    return mesh.run_in_threads(2, fn)


def _llama_lm(sd, max_batch=8):
    return CausalLM(tl.LlamaConfig(**TINY, dtype=torch.float32), sd, tl.LlamaForCausalLM,
                    buckets=(8,), max_batch=max_batch, device="cpu")


def _mixtral_cfg(threshold=THRESHOLD):
    return tm.MixtralConfig(**TINY, **MOE, dtype=torch.float32,
                            selective_loading_threshold=threshold)


def _scale_problems(rank_sd, global_sd, rank, tp=2):
    """Each ``X.scale`` of a rank's state dict against the slice of the
    global one under its spec (empty: every scale is the global cut)."""
    with torch.device("meta"):
        specs = param_partition_specs(tl.LlamaForCausalLM(tl.LlamaConfig(**TINY)))
    bad = []
    for name in tq.quantized_names(global_sd):
        g = global_sd[f"{name}.scale"]
        want = shard_slice(g, scale_spec(specs[name], tuple(g.shape)), rank, tp)
        if not torch.equal(rank_sd[f"{name}.scale"], want):
            bad.append(name)
    return bad


def _nbytes(sd):
    return sum(t.numel() * t.element_size() for t in sd.values())


# ------------------------------------------------------------- int8 Llama

def test_int8_llama_tp2_equals_jax_and_tp1(oracle):
    o = oracle["llama"]
    tp1 = _llama_lm(quantized_params_from_jax(o["qtree"]))
    want1 = tp1.generate(P8, max_new_tokens=NEW).tokens
    logits1 = tp1.insert(tp1.start_session(), np.arange(8), P8).numpy()

    def rank(r):
        lm = _llama_lm(quantized_params_from_jax(o["qtree"], tp_rank=r, tp_size=2))
        assert isinstance(lm.model.model.layers[0].attention.o_proj.kernel, QuantizedKernel)
        out = lm.generate(P8, max_new_tokens=NEW).tokens
        return out, lm.insert(lm.start_session(), np.arange(8), P8).numpy()

    for toks, logits in _tp2(rank):
        np.testing.assert_array_equal(toks, o["stream"])
        np.testing.assert_array_equal(toks, want1)
        np.testing.assert_allclose(logits, o["insert"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(logits, logits1, atol=ATOL, rtol=0)


def test_int8_scales_are_the_global_slices(oracle):
    """Every rank's scale is its cut of JAX's global scale (a row-parallel
    weight's whole on both ranks); quantizing each rank's float shard alone
    (the planted fault) gives other scales, which the check catches."""
    o = oracle["llama"]
    whole = quantized_params_from_jax(o["qtree"])
    fp = llama_params_from_jax(o["params"])
    for r in range(2):
        mine = quantized_params_from_jax(o["qtree"], tp_rank=r, tp_size=2)
        assert _scale_problems(mine, whole, r) == []
        assert torch.equal(mine["model.layers.0.attention.o_proj.kernel.scale"],
                           whole["model.layers.0.attention.o_proj.kernel.scale"])
        planted = tq.quantize_params(llama_params_from_jax(o["params"], tp_rank=r, tp_size=2))
        assert "model.layers.0.attention.o_proj.kernel" in _scale_problems(planted, whole, r)
        # the port's own quantization of the global tree cuts to the same pairs
        cut = {k: v for name, v0 in fp.items() for k, v in tq.quantize_shard(
            name, v0, _specs()[name], r, 2).items()}
        assert cut.keys() == mine.keys()
        for k in cut:
            assert torch.equal(cut[k], mine[k]), k


def _specs():
    with torch.device("meta"):
        return param_partition_specs(tl.LlamaForCausalLM(tl.LlamaConfig(**TINY)))


def test_int8_rank_bytes_and_init_params_order():
    """A rank's int8 bytes are at most 0.55 x TP=1's; ``init_params``
    quantizes each weight whole and cuts the pair (its scales are those of
    the TP=1 init's)."""
    cfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    qcfg = tq.QuantizationConfig()
    whole = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", quantize=qcfg)
    specs = state_partition_specs(_specs(), whole)
    for r in range(2):
        mine = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                              quantize=qcfg, tp_rank=r, tp_size=2)
        assert mine.keys() == whole.keys()
        for k in whole:
            assert torch.equal(mine[k], shard_slice(whole[k], specs[k], r, 2)), k
        assert _nbytes(mine) <= SHARE_MAX * _nbytes(whole)


# ----------------------------------------------------------------- Mixtral

def _mixtral_sd(o, kind, rank=0, tp=1):
    if kind == "int8":
        return quantized_params_from_jax(o["qtree"], tp_rank=rank, tp_size=tp)
    return mixtral_params_from_jax(o["params"], tp_rank=rank, tp_size=tp)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_mixtral_tp2_both_modes_equal_jax(oracle, kind):
    """all_experts at 8 rows and selective at 1 row, each JAX's stream at
    TP=2; selective equals all_experts (threshold 0 forces it) at TP=2;
    both ranks route alike."""
    o = oracle["mixtral"]

    def rank(r):
        sd = _mixtral_sd(o, kind, r, 2)
        out = {}
        for rows, prompts in ((8, P8), (1, P1)):
            lm = CausalLM(_mixtral_cfg(), sd, tm.MixtralForCausalLM, buckets=(8,),
                          max_batch=rows, device="cpu")
            moe = lm.model.model.layers[0].moe
            assert moe.mode_for(rows, 1) == ("all_experts" if rows == 8 else "selective")
            gate = moe.experts.gate
            gate = gate.qweight if isinstance(gate, QuantizedKernel) else gate
            assert gate.shape == (4, 32, 32)   # (E, H, I / tp)
            routes = []
            hook = moe.router.register_forward_hook(lambda m, i, out: routes.append(out[0]))
            out[rows] = lm.generate(prompts, max_new_tokens=NEW).tokens
            hook.remove()
            out[f"routes{rows}"] = torch.cat([c.reshape(-1, c.shape[-1]) for c in routes])
        forced = CausalLM(_mixtral_cfg(0.0), sd, tm.MixtralForCausalLM, buckets=(8,),
                          max_batch=1, device="cpu")
        assert forced.model.model.layers[0].moe.mode_for(1, 1) == "all_experts"
        out["forced"] = forced.generate(P1, max_new_tokens=NEW).tokens
        return out

    ranks = _tp2(rank)
    for got in ranks:
        np.testing.assert_array_equal(got[8], o[(kind, 8)])
        np.testing.assert_array_equal(got[1], o[(kind, 1)])
        np.testing.assert_array_equal(got["forced"], got[1])
    for rows in (8, 1):
        assert torch.equal(ranks[0][f"routes{rows}"], ranks[1][f"routes{rows}"])


def test_mixtral_int8_expert_shards():
    """An expert's int8 gate/up keep their rank's I columns with their
    scales, down its I rows with the whole scale."""
    cfg = _mixtral_cfg()
    whole = tl.init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                           model_cls=tm.MixtralForCausalLM, quantize=tq.QuantizationConfig())
    for r in range(2):
        mine = tl.init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                              model_cls=tm.MixtralForCausalLM, quantize=tq.QuantizationConfig(),
                              tp_rank=r, tp_size=2)
        g, d = "model.layers.0.moe.experts.gate", "model.layers.0.moe.experts.down"
        assert mine[f"{g}.qweight"].shape == (4, 32, 32) and mine[f"{g}.scale"].shape == (4, 1, 32)
        assert torch.equal(mine[f"{g}.scale"], whole[f"{g}.scale"][..., r * 32:(r + 1) * 32])
        assert mine[f"{d}.qweight"].shape == (4, 32, 32)
        assert torch.equal(mine[f"{d}.scale"], whole[f"{d}.scale"])


def test_expert_parallel_decode_refused():
    """EP in token generation stays refused (the JAX package excludes it):
    the selective path and an int8 expert weight over an EP group."""
    def rank(r):
        ep = mesh.get_expert_model_parallel_group()
        experts = ExpertMLPs(4, 8, 16, mode="selective", dtype=torch.float32, ep_group=ep)
        with pytest.raises(NotImplementedError, match="excludes EP from token generation"):
            experts(torch.zeros(1, 8), torch.ones(1, 4) / 4, top_k=2)
        q = {"experts.gate.qweight": torch.zeros((2, 8, 16), dtype=torch.int8),
             "experts.gate.scale": torch.ones((2, 1, 16))}
        holder = torch.nn.Module()
        holder.experts = experts
        with pytest.raises(NotImplementedError, match="excludes EP from token generation"):
            adopt_quantized(holder, q)
        return True

    assert all(mesh.run_in_threads(2, rank, tensor_model_parallel_size=1,
                                   expert_model_parallel_size=2))

