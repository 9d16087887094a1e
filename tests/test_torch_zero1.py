"""ZeRO-1 on the port (``optimizer/zero1.py``) against the JAX package's.

* the spec rule: ``zero1_param_spec`` gives JAX's spec for every leaf of a
  tiny Llama (the JAX tree's leaves, whose layers are stacked, and the
  port's per-layer leaves) on each mesh of 4 ranks (pure logic);
* one step at TP2 x DP2: each rank's state shards (mu, nu and the fp32
  master) equal their blocks of JAX's global ``opt_state`` after the same
  step, to ``rtol=1e-5`` (fp32), mu and nu with ``atol=1e-6``, the master
  with ``atol=1e-5``. The learning rate is the Llama-2 example's 1e-4: a
  first Adam step moves a weight by ``lr * g / (|g| + eps)``, which is
  +-lr except where a gradient that nearly cancels is of the order of
  ``eps``, and there the last bits of either framework's sum decide (one
  master element of 512 moves 3e-6 apart);
* the state a rank holds is 1/DP of the unsharded state's bytes, apart from
  the leaves no dim divides, which stay whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta
from jax.sharding import PartitionSpec as P

from neuronx_distributed_tpu.models.llama import LlamaConfig as JConfig
from neuronx_distributed_tpu.models.llama import LlamaForCausalLM as JLlama
from neuronx_distributed_tpu.optimizer.zero1 import zero1_param_spec as j_zero1_param_spec
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu.trainer.model import ParallelModel as JParallelModel
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.inference.partition import param_partition_specs
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.optimizer import zero1 as tz
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD = 4
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=32, use_flash_attention=False, remat_policy=None)
MESHES = (dict(tensor_model_parallel_size=2), dict(tensor_model_parallel_size=4),
          dict(tensor_model_parallel_size=1),
          dict(tensor_model_parallel_size=2, expert_model_parallel_size=2),
          dict(tensor_model_parallel_size=1, expert_model_parallel_size=2))
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 127, (4, 32)), rs.randint(0, 127, (4, 32))


def _jax_abstract(lcfg):
    ids, _ = _batch()
    return jax.eval_shape(lambda: JLlama(lcfg).init(jax.random.key(0), jnp.asarray(ids)))


def _as_tuple(spec):
    return tuple(spec) if isinstance(spec, P) else ()


@pytest.mark.parametrize("degrees", MESHES, ids=lambda d: "_".join(f"{k[:2]}{v}" for k, v in
                                                                   d.items()))
def test_zero1_param_spec_matches_jax(degrees):
    st = jps.initialize_model_parallel(**degrees, devices=jax.devices()[:WORLD])
    sizes = dict(zip(st.mesh.axis_names, st.mesh.devices.shape))
    assert sizes == dict(zip(mesh.MESH_AXES, mesh.rank_layout(WORLD, **degrees)["shape"]))
    abstract = _jax_abstract(JConfig(**TINY, dtype=jnp.float32))
    jspecs = nn.get_partition_spec(abstract)["params"]
    leaves = jax.tree_util.tree_leaves_with_path(meta.unbox(abstract)["params"])
    flat_specs = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
    for (path, leaf), spec in zip(leaves, flat_specs):
        want = _as_tuple(j_zero1_param_spec(spec, leaf.shape, st.mesh))
        got = tz.zero1_param_spec(_as_tuple(spec), leaf.shape, sizes)
        assert got == want, (jax.tree_util.keystr(path), got, want)
    # the port's per-layer leaves, at their global shapes
    with torch.device("meta"):
        m = tl.LlamaForCausalLM(tl.LlamaConfig(**TINY))
    for name, spec in param_partition_specs(m).items():
        shape = tuple(m.state_dict()[name].shape)
        want = _as_tuple(j_zero1_param_spec(P(*spec), shape, st.mesh))
        assert tz.zero1_param_spec(spec, shape, sizes) == want, (name, spec)


@pytest.fixture(scope="module")
def weights():
    rs = np.random.default_rng(0)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        scale = 1.0 if "embed" in key else leaf.shape[-2] ** -0.5
        return (rs.standard_normal(leaf.shape) * scale).astype(np.float32)

    abstract = _jax_abstract(JConfig(**TINY, dtype=jnp.float32))
    return jax.tree_util.tree_map_with_path(fill, meta.unbox(abstract)["params"])


def test_state_shards_match_jax_after_one_step(weights):
    """TP2 x DP2, ZeRO-1 on: after one step each rank's mu, nu and master
    shard are their blocks of JAX's global state (the layout the state
    carries says where each block lies), and the state's bytes a rank are
    1/DP of the unsharded state's, bar the leaves no dim divides."""
    ids, labels = _batch()
    lcfg = JConfig(**TINY, dtype=jnp.float32)
    jps.initialize_model_parallel(tensor_model_parallel_size=2, devices=jax.devices()[:WORLD])
    try:
        module = JLlama(lcfg)
        specs = nn.get_partition_spec(_jax_abstract(lcfg))["params"]
        model = JParallelModel(module=module, params=None, param_specs=specs,
                               mesh=jps.get_mesh())
        model.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights),
                                      model.param_shardings())
        cfg = j_config(optimizer_config={"zero_one_enabled": True})
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=LR, weight_decay=0.0)
        step = j_make_train_step(model, opt, lambda p, b, r: module.apply(
            {"params": p}, b["ids"], b["labels"], method=JLlama.loss))
        state, _ = step(j_create_train_state(model, opt), {"ids": ids, "labels": labels},
                        jax.random.key(0))
        want = {f: llama_params_from_jax(jax.tree_util.tree_map(
            np.asarray, getattr(state.opt_state, f))) for f in ("mu", "nu", "master")}
    finally:
        jps.destroy_model_parallel()

    def rank(r):
        cfg = neuronx_distributed_config(tensor_parallel_size=2,
                                         optimizer_config={"zero_one_enabled": True})
        model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(
            tl.LlamaConfig(**TINY, dtype=torch.float32)), device="cpu",
            params=llama_params_from_jax(weights))
        opt = initialize_parallel_optimizer(cfg, model, learning_rate=LR, weight_decay=0.0)
        st = create_train_state(model, opt)
        step = make_train_step(model, opt, lambda p, b, rng: model.apply(
            p, b["ids"], b["labels"], method="loss"))
        rows = mesh.data_batch_slice(4)
        st, _ = step(st, {"ids": torch.as_tensor(ids[rows]),
                          "labels": torch.as_tensor(labels[rows])})
        plan = opt.zero1_plan
        state_bytes = sum(t.numel() * 4 for f in ("mu", "nu", "master")
                          for t in getattr(st.opt_state, f).values())
        whole = sum(3 * 4 * p.numel() for n, p in st.params.items())
        undivided = sum(3 * 4 * p.numel() for n, p in st.params.items() if plan.dims[n] is None)
        return st, plan, state_bytes, whole, undivided

    for st, plan, state_bytes, whole, undivided in mesh.run_in_threads(
            WORLD, rank, tensor_model_parallel_size=2):
        assert plan.sharded and plan.dp == 2
        assert state_bytes == (whole - undivided) // 2 + undivided
        for f in ("mu", "nu", "master"):
            for n, shard in getattr(st.opt_state, f).items():
                piece = st.layout[f".opt_state.{f}['{n}']"]
                block = want[f][n].numpy()[tuple(slice(o, o + s) for o, s in
                                                 zip(piece.offset, shard.shape))]
                assert tuple(piece.global_shape) == tuple(want[f][n].shape)
                np.testing.assert_allclose(shard.numpy(), block, err_msg=f"{f} {n}", rtol=1e-5,
                                           atol=1e-5 if f == "master" else 1e-6)
