"""Mixtral training with expert parallelism on the port against the JAX
package's trainer on the same mesh (a world of 4).

The port's ranks are threads over gloo (``mesh.run_in_threads``); the JAX
package runs on the first 4 CPU devices. Both start from the same weights
(a seeded JAX tree converted by ``mixtral_params_from_jax``; each port rank
cuts its (ep, tp) slices in ``initialize_parallel_model``) and train 3
steps of ``mixtral_loss`` (the cross entropy plus the MoE blocks'
auxiliary losses) on the same seeded global batch, at a capacity factor
that drops tokens (1.25). Losses and grad norms match JAX's at ``rtol=5e-4``
(``tests/test_combinatorial.py``'s tolerance) at TP 2 x EP 2, EP 2 x edp 2
and TP 2 x EP 2 with sequence parallelism (ZeRO-1 on), ZeRO-1 off once and
remat ``"full"`` once; every rank reports the same numbers, data-parallel
replicas of a dense leaf and the edp replicas of an expert slice hold the
same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu.trainer.model import ParallelModel as JParallelModel
from neuronx_distributed_tpu_torch.converters.jax_params import mixtral_params_from_jax
from neuronx_distributed_tpu_torch.models import mixtral as tm
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
            num_kv_heads=2, max_seq_len=32, use_flash_attention=False, num_experts=4, top_k=2,
            capacity_factor=1.25)
# name: (mesh degrees, sequence_parallel, zero-1, remat policy)
MESHES = {
    "TP2_EP2": (dict(tensor_model_parallel_size=2, expert_model_parallel_size=2), False, True,
                None),
    "EP2_EDP2": (dict(tensor_model_parallel_size=1, expert_model_parallel_size=2), False, True,
                 None),
    "TP2_EP2_SP": (dict(tensor_model_parallel_size=2, expert_model_parallel_size=2), True, True,
                   None),
    "TP2_EP2_Zero1Off": (dict(tensor_model_parallel_size=2, expert_model_parallel_size=2), False,
                         False, None),
    "EP2_EDP2_RematFull": (dict(tensor_model_parallel_size=1, expert_model_parallel_size=2),
                           False, True, "full"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 127, (4, 16)), rs.randint(0, 127, (4, 16))


def _fill(abstract, seed=0):
    """A flax tree filled from a numpy seed: kernels at the lecun-normal
    scale, norm scales 1, biases 0."""
    rs = np.random.default_rng(seed)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        if key.endswith("['bias']"):
            return np.zeros(leaf.shape, np.float32)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else 1
        scale = 1.0 if "embed" in key else fan_in ** -0.5
        return (rs.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, meta.unbox(abstract)["params"])


@pytest.fixture(scope="module")
def weights():
    ids, _ = _batch()
    return _fill(jax.eval_shape(lambda: jm.MixtralForCausalLM(jm.MixtralConfig(
        **TINY, dtype=jnp.float32)).init(jax.random.key(0), jnp.asarray(ids))))


def _jax_run(weights, degrees, sp, zero1, remat, cfg_over=None, steps=STEPS, lr=1e-3):
    """JAX's losses and grad norms of ``mixtral_loss`` on the same mesh of
    4 devices."""
    jps.initialize_model_parallel(**degrees, devices=jax.devices()[:WORLD])
    try:
        cfg = j_config(optimizer_config={"zero_one_enabled": zero1})
        mcfg = jm.MixtralConfig(**{**TINY, **(cfg_over or {})}, dtype=jnp.float32,
                                sequence_parallel=sp, remat_policy=remat)
        ids, labels = _batch()
        module = jm.MixtralForCausalLM(mcfg)
        specs = nn.get_partition_spec(jax.eval_shape(
            lambda: module.init(jax.random.key(0), jnp.asarray(ids))))["params"]
        model = JParallelModel(module=module, params=None, param_specs=specs,
                               mesh=jps.get_mesh())
        model.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights),
                                      model.param_shardings())
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=lr, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, b, r: jm.mixtral_loss(
            model.module, p, b["ids"], b["labels"]))
        out = []
        for i in range(steps):
            state, m = step(state, {"ids": ids, "labels": labels}, jax.random.key(i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out
    finally:
        jps.destroy_model_parallel()


def _port_rank(weights, sp, zero1, remat, cfg_over=None, steps=STEPS, lr=1e-3):
    cfg = neuronx_distributed_config(
        tensor_parallel_size=mesh.get_tensor_model_parallel_size(),
        expert_parallel_size=mesh.get_expert_model_parallel_size(), sequence_parallel=sp,
        optimizer_config={"zero_one_enabled": zero1})
    mcfg = tm.MixtralConfig(**{**TINY, **(cfg_over or {})}, dtype=torch.float32,
                            remat_policy=remat)
    model = initialize_parallel_model(cfg, lambda: tm.MixtralForCausalLM(mcfg), device="cpu",
                                      params=mixtral_params_from_jax(weights))
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=lr, weight_decay=0.0)
    state = create_train_state(model, opt)

    def loss_fn(p, b, rng):
        model.bind(p)
        return tm.mixtral_loss(model.module, b["ids"], b["labels"])

    step = make_train_step(model, opt, loss_fn)
    ids, labels = _batch()
    rows = mesh.data_batch_slice(len(ids))
    batch = {"ids": torch.as_tensor(ids[rows]), "labels": torch.as_tensor(labels[rows])}
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(traj=out, params={n: t.clone() for n, t in state.params.items()},
                coords=mesh.local_mesh_coords(), plan=opt.zero1_plan, model=model)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mixtral_mesh_matches_jax_trajectory(name, weights):
    degrees, sp, zero1, remat = MESHES[name]
    want = _jax_run(weights, degrees, sp, zero1, remat)
    ranks = mesh.run_in_threads(WORLD, lambda r: _port_rank(weights, sp, zero1, remat),
                                **degrees)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
    np.testing.assert_allclose(np.array(ranks[0]["traj"]), np.array(want), rtol=RTOL)
    # replicas hold the same bits: a dense leaf over DP and TP's replicated
    # ones, an expert slice over its edp ranks
    plan = ranks[0]["plan"]
    for rk in ranks[1:]:
        for n, t in rk["params"].items():
            same = {"tp": rk["coords"]["tp"] == ranks[0]["coords"]["tp"]
                    or plan.tp_dim(n) is None,
                    "ep": rk["coords"]["ep"] == ranks[0]["coords"]["ep"] or n not in plan.expert}
            if all(same.values()):
                assert torch.equal(t, ranks[0]["params"][n]), (name, n)
    if name == "EP2_EDP2_RematFull":   # the aux loss reaches the router under full remat
        for rk in ranks:
            assert rk["model"].module.config.remat_policy == "full"
    assert any(n in plan.expert for n in ranks[0]["params"])
