"""Distributed training on the port against the JAX package on the same
mesh: the counterpart of ``tests/test_combinatorial.py`` (COMBOS :66-80) at
a world of 4.

The port's ranks are threads over gloo (``mesh.run_in_threads``); the JAX
package runs on the first 4 CPU devices. Both start from the same weights
(a seeded JAX tree converted by ``converters/jax_params.py``; each port rank
slices its shards of the global tree in ``initialize_parallel_model``) and
train 3 steps on the same seeded global batch, each data-parallel rank on
its rows. The losses and grad norms must match JAX's at ``rtol=5e-4`` (the
JAX test's own tolerance, :93). Within the port: every rank reports the
same loss and norm, data-parallel replicas hold bit-identical params, and
a tensor-parallel-replicated leaf is bit-identical across the TP ranks.
``grad_accum_steps=2`` equals the full batch (JAX ``tests/test_trainer.py:228``:
the loss to ``rtol=1e-6``, the params after one update to 1e-5). Without
donation the ZeRO route gives the same bits and keeps the old state; LoRA
trains under DP as on one rank (``rtol=1e-5``, adapters 1e-4) and raises
under TP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from neuronx_distributed_tpu.models.llama import LlamaConfig as JConfig
from neuronx_distributed_tpu.models.llama import LlamaForCausalLM as JLlama
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu.trainer.model import ParallelModel as JParallelModel
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD, STEPS, RTOL = 4, 3, 5e-4
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=32, use_flash_attention=False, remat_policy=None)
# name: (mesh degrees, sequence_parallel, zero-1)
MESHES = {
    "TP2_DP2": (dict(tensor_model_parallel_size=2), False, True),
    "TP4": (dict(tensor_model_parallel_size=4), False, True),
    "DP4": (dict(tensor_model_parallel_size=1), False, True),
    "TP2_SP_DP2": (dict(tensor_model_parallel_size=2), True, True),
    "TP2_DP2_Zero1Off": (dict(tensor_model_parallel_size=2), False, False),
    "TP2_EPmesh2": (dict(tensor_model_parallel_size=2, expert_model_parallel_size=2), False,
                    True),
    # context parallelism (JAX COMBOS :75-77): each rank feeds its block of
    # the sequence, ring attention over the cp group
    "CP2": (dict(tensor_model_parallel_size=1, context_parallel_size=2), False, True),
    "TP2_CP2": (dict(tensor_model_parallel_size=2, context_parallel_size=2), False, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 127, (4, 32)), rs.randint(0, 127, (4, 32))


@pytest.fixture(scope="module")
def weights():
    """The JAX model's tree, filled from a numpy seed (kernels at the
    lecun-normal scale, norm scales 1): no init program to compile."""
    ids, _ = _batch()
    abstract = jax.eval_shape(lambda: JLlama(JConfig(**TINY, dtype=jnp.float32)).init(
        jax.random.key(0), jnp.asarray(ids)))
    rs = np.random.default_rng(0)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else 1
        scale = 1.0 if "embed" in jax.tree_util.keystr(path) else fan_in ** -0.5
        return (rs.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, meta.unbox(abstract)["params"])


def _jax_run(weights, degrees, sp, zero1):
    """JAX's 3-step losses and grad norms on the same mesh of 4 devices."""
    jps.initialize_model_parallel(**degrees, devices=jax.devices()[:WORLD])
    try:
        cfg = j_config(optimizer_config={"zero_one_enabled": zero1})
        lcfg = JConfig(**TINY, dtype=jnp.float32, sequence_parallel=sp)
        ids, labels = _batch()
        # the JAX ParallelModel on the given weights (no init program)
        module = JLlama(lcfg)
        specs = nn.get_partition_spec(jax.eval_shape(
            lambda: module.init(jax.random.key(0), jnp.asarray(ids))))["params"]
        model = JParallelModel(module=module, params=None, param_specs=specs,
                               mesh=jps.get_mesh())
        model.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights),
                                      model.param_shardings())
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, b, r: model.module.apply(
            {"params": p}, b["ids"], b["labels"], method=JLlama.loss))
        out = []
        for i in range(STEPS):
            state, m = step(state, {"ids": ids, "labels": labels}, jax.random.key(i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out
    finally:
        jps.destroy_model_parallel()


def _port_rank(weights, sp, zero1, steps=STEPS, grad_accum=1, lr=1e-3):
    cfg = neuronx_distributed_config(
        tensor_parallel_size=mesh.get_tensor_model_parallel_size(), sequence_parallel=sp,
        optimizer_config={"zero_one_enabled": zero1})
    lcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
    model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                      params=llama_params_from_jax(weights))
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=lr, weight_decay=0.0)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"), grad_accum_steps=grad_accum)
    ids, labels = _batch()
    rows, cols = mesh.data_batch_slice(len(ids)), mesh.context_seq_slice(ids.shape[1])
    batch = {"ids": torch.as_tensor(ids[rows, cols]),
             "labels": torch.as_tensor(labels[rows, cols])}
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(traj=out, params={n: t.clone() for n, t in state.params.items()},
                coords=mesh.local_mesh_coords(), specs=opt.zero1_plan.param_specs)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_matches_jax_trajectory(name, weights):
    degrees, sp, zero1 = MESHES[name]
    want = _jax_run(weights, degrees, sp, zero1)
    ranks = mesh.run_in_threads(WORLD, lambda r: _port_rank(weights, sp, zero1), **degrees)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
    np.testing.assert_allclose(np.array(ranks[0]["traj"]), np.array(want), rtol=RTOL)
    # DP replicas: the same bits; TP-replicated leaves: the same bits on every rank
    by_tp = {}
    for rk in ranks:
        by_tp.setdefault(rk["coords"]["tp"], []).append(rk)
    for group in by_tp.values():
        for rk in group[1:]:
            for n, t in rk["params"].items():
                assert torch.equal(t, group[0]["params"][n]), (name, n)
    for n, spec in ranks[0]["specs"].items():
        if not spec:
            for rk in ranks[1:]:
                assert torch.equal(rk["params"][n], ranks[0]["params"][n]), (name, n)


def test_grad_accum_matches_full_batch(weights):
    """TP2 x DP2 with ZeRO-1: two microbatches of each rank's rows make the
    full batch's step."""
    def rank(r):
        full = _port_rank(weights, False, True, steps=1, lr=1e-2)
        acc = _port_rank(weights, False, True, steps=1, grad_accum=2, lr=1e-2)
        return full, acc

    for full, acc in mesh.run_in_threads(WORLD, rank, tensor_model_parallel_size=2):
        np.testing.assert_allclose(acc["traj"][0][0], full["traj"][0][0], rtol=1e-6)
        worst = max(float((acc["params"][n] - full["params"][n]).abs().max())
                    for n in full["params"])
        assert worst < 1e-5, worst


def test_donation_lora_and_the_dp_reduction(weights):
    """At TP2 x DP2 with ZeRO-1, ``donate=False`` gives the donated run's
    bits and leaves the old state as it was; LoRA trains under DP 4 as on
    one rank (the DP reduction and ZeRO-1 act on the adapter tree) and
    raises by name under TP 2; ``psum_gradients_over_dp`` is the DP mean
    and the inf norm the largest magnitude over every rank's piece."""
    from neuronx_distributed_tpu_torch.parallel.grads import get_grad_norm, psum_gradients_over_dp

    def donation(r):
        cfg = neuronx_distributed_config(tensor_parallel_size=2)
        lcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
        model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                          params=llama_params_from_jax(weights))
        opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
        state = create_train_state(model, opt)
        kept = {n: t.clone() for n, t in state.params.items()}
        step = make_train_step(model, opt, lambda p, b, rng: model.apply(
            p, b["ids"], b["labels"], method="loss"), donate=False)
        ids, labels = _batch()
        rows = mesh.data_batch_slice(4)
        new, _ = step(state, {"ids": torch.as_tensor(ids[rows]),
                              "labels": torch.as_tensor(labels[rows])})
        unchanged = all(torch.equal(state.params[n], kept[n]) for n in kept)
        g = {"w": torch.full((2, 2), float(mesh.data_parallel_rank() + 1))}
        mean = psum_gradients_over_dp(g)["w"]
        peak = get_grad_norm({"w": g["w"] * (r + 1)}, float("inf"),
                             tp_group=mesh.get_tensor_model_parallel_group(),
                             dp_group=mesh.get_data_parallel_group())
        return new.params, unchanged, mean, float(peak)

    donated = mesh.run_in_threads(WORLD, lambda r: _port_rank(weights, False, True, steps=1),
                                  tensor_model_parallel_size=2)
    for rk, (params, unchanged, mean, peak) in zip(
            donated, mesh.run_in_threads(WORLD, donation, tensor_model_parallel_size=2)):
        assert unchanged
        for n, t in params.items():
            assert torch.equal(t, rk["params"][n]), n
        assert torch.equal(mean, torch.full((2, 2), 1.5)) and peak == 8.0

    lora = {"r": 4, "lora_alpha": 8.0}

    def lora_run(r=None):
        cfg = neuronx_distributed_config(lora_config=lora)
        lcfg = tl.LlamaConfig(**TINY, dtype=torch.float32)
        model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                          params=llama_params_from_jax(weights))
        opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-2)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, lambda p, b, rng: model.apply(
            p, b["ids"], b["labels"], method="loss"))
        ids, labels = _batch()
        rows = mesh.data_batch_slice(4) if mesh.model_parallel_is_initialized() else slice(0, 4)
        for _ in range(2):
            state, m = step(state, {"ids": torch.as_tensor(ids[rows]),
                                    "labels": torch.as_tensor(labels[rows])})
        return float(m["loss"]), state.params

    one_loss, one = lora_run()
    for loss, adapters in mesh.run_in_threads(WORLD, lora_run, tensor_model_parallel_size=1):
        np.testing.assert_allclose(loss, one_loss, rtol=1e-5)
        for n, t in adapters.items():
            np.testing.assert_allclose(t.numpy(), one[n].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=n)

    def lora_tp(r):
        with pytest.raises(NotImplementedError, match="LoRA under a tensor-parallel"):
            initialize_parallel_model(
                neuronx_distributed_config(tensor_parallel_size=2, lora_config=lora),
                lambda: tl.LlamaForCausalLM(tl.LlamaConfig(**TINY)), device="cpu")
        return True

    assert all(mesh.run_in_threads(2, lora_tp))
