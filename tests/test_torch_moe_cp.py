"""The MoE block under context parallelism on the port against the JAX
package on the same mesh (a world of 4).

The port's ranks are threads over gloo (``mesh.run_in_threads``); the JAX
package runs on the first 4 CPU devices. Both start from the same seeded
Mixtral tree (4 experts, top 2) and train 3 steps of ``mixtral_loss`` on the
same seeded global batch, each data-parallel rank on its rows and each
context-parallel rank on its block of their positions, at CP 2 (contiguous
and zigzag, the ids and labels permuted by ``zigzag_indices`` on both
sides) and at CP 2 x EP 2 (zigzag), at capacity factors 1.25 and 1.0, where
tokens drop.

Held against JAX, fp32 on both sides: the losses of the 3 steps at
``rtol=1e-5`` and their grad norms at ``rtol=1e-4`` (a gradient), and at
the first forward each layer's auxiliary
loss (the mean over the data-parallel ranks of what every cp rank holds)
at ``rtol=1e-5``, and each layer's dropped assignments an expert exactly
(JAX's drop rule, an int32 cumsum over the global tokens in the order fed,
applied to JAX's own routing, each router's output kept through
``nn.intercept_methods``). JAX runs once a token order and capacity
factor, at CP 2 for the contiguous order and CP 2 x EP 2 for zigzag: its
numbers do not depend on the mesh. Within the port, every rank reports the
same numbers.

Trap 5: the drop order under CP is row-major over the global batch. A
planted rank-major order (a rank's tokens counted after every lower
rank's, whole: the rule before CP) keeps other tokens at 2 rows a rank and
capacity factor 1.0, and its losses leave JAX's (the dropped counts an
expert and the first forward's aux losses are totals, which the order
barely moves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.moe.routing import RouterTopK as JRouterTopK
from neuronx_distributed_tpu.ops.ring_attention import zigzag_indices as j_zigzag_indices
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
from neuronx_distributed_tpu_torch.moe import expert_mlps
from neuronx_distributed_tpu_torch.moe import record_aux_losses
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD, STEPS, LR = 4, 3, 1e-3
RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S = 4, 32
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=S, use_flash_attention=False, num_experts=4, top_k=2)
# name: (mesh degrees, cp layout)
LAYOUTS = {
    "CP2": (dict(context_parallel_size=2), "contiguous"),
    "CP2_zigzag": (dict(context_parallel_size=2), "zigzag"),
    "CP2_EP2_zigzag": (dict(context_parallel_size=2, expert_model_parallel_size=2), "zigzag"),
}
# JAX's mesh for each token order: its numbers do not depend on the mesh
# (GSPMD computes the global program), so one run serves every port layout
# of that order
JAX_MESH = {"contiguous": LAYOUTS["CP2"][0], "zigzag": LAYOUTS["CP2_EP2_zigzag"][0]}
_JAX_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(layout):
    """The global batch in the order both sides feed it: under zigzag the
    positions permuted by ``zigzag_indices(S, 2)``."""
    rs = np.random.RandomState(0)
    ids, labels = rs.randint(0, 127, (B, S)), rs.randint(0, 127, (B, S))
    if layout == "zigzag":
        perm = np.asarray(j_zigzag_indices(S, 2))
        ids, labels = ids[:, perm], labels[:, perm]
    return ids, labels


@pytest.fixture(scope="module")
def weights():
    ids, _ = _batch("contiguous")
    abstract = jax.eval_shape(lambda: jm.MixtralForCausalLM(jm.MixtralConfig(
        **TINY, dtype=jnp.float32)).init(jax.random.key(0), jnp.asarray(ids)))
    rs = np.random.default_rng(0)

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


def _jax_drops(combine, cf):
    """JAX's drop rule (``moe/expert_mlps.py:99-105``) on JAX's routing:
    positions from an int32 cumsum over the global tokens in the order
    fed, dropped at the capacity."""
    mask = combine > 0
    t, e = mask.shape
    cap = max(1, min(int(cf * t / e), t))
    pos = np.cumsum(mask, axis=0) - 1
    return (mask & (pos >= cap)).sum(axis=0)


def _jax_run(weights, layout, cf):
    """JAX's losses and grad norms on the mesh of 4 devices, and each
    layer's aux loss at the first forward (computed once a token order and
    capacity factor)."""
    if (layout, cf) not in _JAX_RUNS:
        _JAX_RUNS[layout, cf] = _jax_steps(weights, JAX_MESH[layout], layout, cf)
    return _JAX_RUNS[layout, cf]


def _jax_steps(weights, degrees, layout, cf):
    jps.initialize_model_parallel(**degrees, devices=jax.devices()[:WORLD])
    try:
        cfg = j_config(optimizer_config={"zero_one_enabled": True})
        mcfg = jm.MixtralConfig(**TINY, dtype=jnp.float32, capacity_factor=cf,
                                context_parallel=True, cp_layout=layout)
        ids, labels = (jnp.asarray(a) for a in _batch(layout))
        module = jm.MixtralForCausalLM(mcfg)
        specs = nn.get_partition_spec(jax.eval_shape(
            lambda: module.init(jax.random.key(0), ids)))["params"]
        model = JParallelModel(module=module, params=None, param_specs=specs,
                               mesh=jps.get_mesh())
        model.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights),
                                      model.param_shardings())

        def keep_routing(next_fun, args, kwargs, context):
            # each router's combine weights, sown where the scan carries
            # the layers' aux losses
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JRouterTopK) and context.method_name == "__call__":
                context.module.sow("losses", "combine", out[0])
            return out

        def first_forward(p):
            with nn.intercept_methods(keep_routing):
                return module.apply({"params": p}, ids, mutable=["losses"])[1]["losses"]

        sown = jax.jit(first_forward)(model.params)["model"]["layers"]["block"]["moe"]
        aux = np.asarray(sown["moe_aux_loss"][0])
        drops = np.stack([_jax_drops(c, cf) for c in np.asarray(sown["router"]["combine"][0])])
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=LR, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, b, r: jm.mixtral_loss(
            model.module, p, b["ids"], b["labels"]))
        traj = []
        for i in range(STEPS):
            state, m = step(state, {"ids": ids, "labels": labels}, jax.random.key(i))
            traj.append((float(m["loss"]), float(m["grad_norm"])))
        return dict(traj=traj, aux=aux.reshape(-1), drops=drops)
    finally:
        jps.destroy_model_parallel()


def _port_rank(weights, layout, cf):
    cfg = neuronx_distributed_config(optimizer_config={"zero_one_enabled": True})
    mcfg = tm.MixtralConfig(**TINY, dtype=torch.float32, capacity_factor=cf, cp_layout=layout)
    model = initialize_parallel_model(cfg, lambda: tm.MixtralForCausalLM(mcfg), device="cpu",
                                      params=mixtral_params_from_jax(weights))
    ids, labels = _batch(layout)
    rows, cols = mesh.data_batch_slice(B), mesh.context_seq_slice(S)
    batch = {"ids": torch.as_tensor(ids[rows, cols]), "labels": torch.as_tensor(labels[rows, cols])}
    blocks = [layer.moe for layer in model.module.model.layers]
    with torch.no_grad(), record_aux_losses(model.module):
        model.module.loss(batch["ids"], batch["labels"])
        aux = [float(m.aux_loss) for m in blocks]
    drops = np.stack([m.experts.last_dropped.numpy() for m in blocks])
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=LR, weight_decay=0.0)
    state = create_train_state(model, opt)

    def loss_fn(p, b, rng):
        model.bind(p)
        return tm.mixtral_loss(model.module, b["ids"], b["labels"])

    step = make_train_step(model, opt, loss_fn)
    traj = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        traj.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(traj=traj, aux=aux, drops=drops, coords=mesh.local_mesh_coords())


def _port_run(weights, degrees, layout, cf):
    ranks = mesh.run_in_threads(WORLD, lambda r: _port_rank(weights, layout, cf),
                                tensor_model_parallel_size=1, **degrees)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
        np.testing.assert_array_equal(rk["drops"], ranks[0]["drops"])
    by_dp = {}
    for rk in ranks:   # every cp rank of a dp rank holds the global aux loss
        by_dp.setdefault(rk["coords"]["dp"], []).append(rk["aux"])
    for auxes in by_dp.values():
        assert all(a == auxes[0] for a in auxes)
    aux = np.mean([auxes[0] for auxes in by_dp.values()], axis=0)
    return dict(traj=ranks[0]["traj"], aux=aux, drops=ranks[0]["drops"])


@pytest.mark.parametrize("cf", [1.25, 1.0])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_moe_under_cp_matches_jax(name, cf, weights):
    degrees, layout = LAYOUTS[name]
    want = _jax_run(weights, layout, cf)
    got = _port_run(weights, degrees, layout, cf)
    np.testing.assert_allclose(np.array(got["traj"])[:, 0], np.array(want["traj"])[:, 0],
                               rtol=RTOL)
    np.testing.assert_allclose(np.array(got["traj"])[:, 1], np.array(want["traj"])[:, 1],
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL)
    np.testing.assert_array_equal(got["drops"], want["drops"])
    assert want["drops"].sum() > 0   # tokens drop at both factors


def test_trap5_rank_total_offset_leaves_jax(weights, monkeypatch):
    """A planted rank-major drop order (each rank's tokens after every lower
    dp and cp rank's, whole: the rule that holds only when a rank holds
    whole rows) drops other assignments than JAX at 2 rows a rank and
    capacity factor 1.0, and its losses leave JAX's."""
    degrees, layout = LAYOUTS["CP2"]
    want = _jax_run(weights, layout, 1.0)
    real = expert_mlps.dispatch_counts

    def rank_totals(combine, rows=1, dp_group=None, cp_group=None):
        # a rank's tokens counted as one row: its tokens after every lower
        # (dp, cp) rank's, whole
        return real(combine, 1, dp_group, cp_group)

    monkeypatch.setattr(expert_mlps, "dispatch_counts", rank_totals)
    monkeypatch.setattr("neuronx_distributed_tpu_torch.moe.layer.dispatch_counts", rank_totals)
    got = _port_run(weights, degrees, layout, 1.0)
    assert not np.allclose(np.array(got["traj"])[:, 0], np.array(want["traj"])[:, 0],
                           rtol=RTOL)


def test_capacity_factor_under_cp_needs_the_rows_counts():
    """Under a cp group the experts do not count the rank's tokens
    themselves (as one row they would take the rank-major order of trap
    5): without the counts of :func:`dispatch_counts` a row at a time they
    refuse; with them they run."""
    def rank(r):
        g = mesh.get_context_parallel_group()
        experts = expert_mlps.ExpertMLPs(4, 8, 16, capacity_factor=1.0, dtype=torch.float32,
                                         cp_group=g)
        x = torch.ones(2 * 4, 8)
        combine = torch.zeros(2 * 4, 4)
        combine[:, 0] = 1.0
        with pytest.raises(ValueError, match="dispatch counts of each row"):
            experts(x, combine, top_k=1)
        counts = expert_mlps.dispatch_counts(combine, 2, None, g)
        return experts(x, combine, top_k=1, counts=counts).shape

    assert mesh.run_in_threads(2, rank, tensor_model_parallel_size=1,
                               context_parallel_size=2) == [(8, 8)] * 2


def test_c13_jax_pipelined_mixtral_drops_its_experts_port_refuses():
    """Fault C13 of the reference: JAX's ``PipelinedLlama`` builds a dense
    ``LlamaDecoderLayer`` from a ``MixtralConfig``
    (``models/llama_pipeline.py:92``), so its init holds dense MLP leaves
    and no expert or router leaf: the experts are silently dropped. The
    port's ``PipelinedLlama`` refuses the MoE block by name."""
    from neuronx_distributed_tpu.models.llama_pipeline import PipelinedLlama as JPipelined
    from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama

    jcfg = jm.MixtralConfig(**{**TINY, "num_layers": 2}, dtype=jnp.float32)
    params = JPipelined(jcfg, num_stages=2, num_microbatches=2).init(
        jax.random.key(0), jnp.zeros((2, 8), jnp.int32))
    leaves = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert not any("moe" in p or "router" in p or "experts" in p for p in leaves)
    assert any("['mlp']['gate_proj']" in p for p in leaves)
    with pytest.raises(NotImplementedError, match="MoE block .* pipeline parallelism"):
        PipelinedLlama(tm.MixtralConfig(**TINY, dtype=torch.float32), num_stages=2,
                       num_microbatches=2)
