"""Sequence parallelism in the port's TP layers, held against the JAX layers
built with ``sequence_parallel=True`` under GSPMD on the 8-device CPU mesh
at TP=2.

Each port rank is a thread over gloo (``mesh.run_in_threads``) holding the
sequence shard of the activations between the layers: a column layer (and
the fused QKV) takes its input's shard and all-gathers it, a row layer and
the embedding reduce-scatter their output to the rank's positions, the
norms (RMSNorm and ``SPLayerNorm``) normalise the rank's positions. Every rank's loss is the sum over its own
outputs of ``y * ct`` (``ct`` a seeded cotangent), so the ranks' losses add
up to JAX's ``sum(y * ct)`` over the global output and the gradients are
JAX's: the input's (the rank's shard), each sharded weight's (the rank's
slice) and each replicated weight's (whole, all-reduced over the group; the
norm's and the row bias's are bit-identical across the ranks). fp32 on both
sides; values and gradients to ``rtol=1e-5, atol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.parallel import layers as JL
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.parallel.partitioning import named_sharding_tree
from neuronx_distributed_tpu_torch.inference.partition import param_partition_specs, shard_slice
from neuronx_distributed_tpu_torch.parallel import layers as TL
from neuronx_distributed_tpu_torch.parallel import mesh

TP = 2
B, S, H = 4, 8, 32      # the batch divides the JAX mesh's edp axis (4 at TP=2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cut(a, dim, r):
    n = a.shape[dim] // TP
    return np.take(a, range(r * n, (r + 1) * n), axis=dim)


# each case: the JAX layer, its input, the port layer's constructor, and
# which dims are cut on a rank: the input's, the output's (None: whole)
CASES = {
    "column": dict(jax=lambda: JL.ColumnParallelLinear(48, sequence_parallel=True,
                                                       dtype=jnp.float32),
                   x=lambda: _rng(1, B, S, H), x_dim=1, y_dims=(-1,),
                   port=lambda g: TL.ColumnParallelLinear(H, 48, dtype=torch.float32, group=g,
                                                          sequence_parallel=True)),
    "row": dict(jax=lambda: JL.RowParallelLinear(H, sequence_parallel=True, dtype=jnp.float32),
                x=lambda: _rng(2, B, S, 48), x_dim=-1, y_dims=(1,),
                port=lambda g: TL.RowParallelLinear(48, H, dtype=torch.float32, group=g,
                                                    sequence_parallel=True)),
    "qkv": dict(jax=lambda: JL.GQAQKVColumnParallelLinear(num_heads=4, num_kv_heads=2,
                                                          head_dim=8, use_bias=True,
                                                          sequence_parallel=True,
                                                          dtype=jnp.float32),
                x=lambda: _rng(3, B, S, H), x_dim=1, y_dims=(2, 2, 2),
                port=lambda g: TL.GQAQKVColumnParallelLinear(H, 4, 2, 8, use_bias=True,
                                                             dtype=torch.float32, group=g,
                                                             sequence_parallel=True)),
    "embedding": dict(jax=lambda: JL.ParallelEmbedding(64, H, dtype=jnp.float32),
                      x=lambda: np.random.default_rng(4).integers(0, 64, (B, S)),
                      x_dim=None, y_dims=(1,),
                      port=lambda g: TL.ParallelEmbedding(64, H, dtype=torch.float32, group=g,
                                                          sequence_parallel=True)),
    "layernorm": dict(jax=lambda: JL.SPLayerNorm(sequence_parallel=True, dtype=jnp.float32),
                      x=lambda: _rng(9, B, S, H), x_dim=1, y_dims=(1,),
                      port=lambda g: TL.SPLayerNorm(H, dtype=torch.float32, group=g,
                                                    sequence_parallel=True)),
    "norm": dict(jax=lambda: JL.RMSNorm(sequence_parallel=True, dtype=jnp.float32),
                 x=lambda: _rng(5, B, S, H), x_dim=1, y_dims=(1,),
                 port=lambda g: TL.RMSNorm(H, dtype=torch.float32, group=g,
                                           sequence_parallel=True)),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_sp_layer_matches_jax(name):
    """The rank's outputs and every gradient against the JAX layer's."""
    case = CASES[name]
    st = jps.initialize_model_parallel(tensor_model_parallel_size=TP)
    layer, x = case["jax"](), case["x"]()
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # random values for every weight (the norm's ones, the zero biases)
    rs = np.random.default_rng(6)
    unboxed = jax.tree_util.tree_map(
        lambda v: rs.standard_normal(v.shape).astype(np.float32), meta.unbox(variables))
    params = jax.device_put(unboxed, named_sharding_tree(variables, st.mesh))
    ys = layer.apply(params, jnp.asarray(x))
    ys = ys if isinstance(ys, tuple) else (ys,)
    cts = [_rng(10 + i, *y.shape) for i, y in enumerate(ys)]
    integer = x.dtype.kind == "i"

    def loss(p, xx):
        out = layer.apply(p, xx)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(out, cts))

    with jax.set_mesh(st.mesh):
        if integer:
            gp = jax.jit(jax.grad(loss))(params, jnp.asarray(x))
            gx = None
        else:
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    full = _flat(unboxed["params"])
    grads = _flat(jax.tree_util.tree_map(np.asarray, gp)["params"])
    ys = [np.asarray(y) for y in ys]

    def rank(r):
        m = case["port"](mesh.get_tensor_model_parallel_group())
        with torch.device("meta"):
            specs = param_partition_specs(case["port"](None))
        m.load_state_dict({k: shard_slice(torch.tensor(v), specs[k], r, TP)
                           for k, v in full.items()})
        for p in m.parameters():
            p.requires_grad_(True)
        xt = torch.tensor(x if integer else _cut(x, case["x_dim"], r))
        if not integer:
            xt.requires_grad_(True)
        out = m(xt)
        out = out if isinstance(out, tuple) else (out,)
        loss_r = sum((o * torch.tensor(_cut(c, d, r))).sum()
                     for o, c, d in zip(out, cts, case["y_dims"]))
        loss_r.backward()
        return ([o.detach().numpy() for o in out], None if integer else xt.grad.numpy(),
                {k: p.grad.numpy() for k, p in m.named_parameters()}, specs)

    results = mesh.run_in_threads(TP, rank)
    for r, (out, gxr, gw, specs) in enumerate(results):
        for o, y, d in zip(out, ys, case["y_dims"]):
            np.testing.assert_allclose(o, _cut(y, d, r), **TOL)
        if gx is not None:
            np.testing.assert_allclose(gxr, _cut(np.asarray(gx), case["x_dim"], r), **TOL)
        for k, g in gw.items():
            want = shard_slice(torch.tensor(grads[k]), specs[k], r, TP).numpy()
            np.testing.assert_allclose(g, want, err_msg=k, **TOL)
            if not specs[k]:   # replicated: the same bits on every rank
                assert np.array_equal(g, results[0][2][k]), k


def test_sp_norm_block_grads_equal_across_ranks():
    """A residual block norm -> column -> gelu -> row with SP, three steps
    of SGD on every rank: the replicated norm scale stays bit-identical
    across the ranks, and equals the single-device block's."""
    rs = np.random.default_rng(7)
    w1, w2 = rs.standard_normal((H, 64)).astype(np.float32), rs.standard_normal(
        (64, H)).astype(np.float32) / 8
    x = _rng(8, B, S, H)

    def block(g, sp):
        norm = TL.RMSNorm(H, dtype=torch.float32, group=g, sequence_parallel=sp)
        up = TL.ColumnParallelLinear(H, 64, use_bias=False, dtype=torch.float32, group=g,
                                     sequence_parallel=sp)
        down = TL.RowParallelLinear(64, H, use_bias=False, dtype=torch.float32, group=g,
                                    sequence_parallel=sp)
        r = TL.group_rank(g)
        tp = TL.group_size(g)
        norm.load_state_dict({"scale": torch.ones(H)})
        up.load_state_dict({"kernel": shard_slice(torch.tensor(w1), (None, "tp"), r, tp)})
        down.load_state_dict({"kernel": shard_slice(torch.tensor(w2), ("tp", None), r, tp)})
        mods = (norm, up, down)
        for m in mods:
            m.requires_grad_(True)
        xs = torch.tensor(_cut(x, 1, r) if g is not None else x)
        for _ in range(3):
            h = xs + down(torch.nn.functional.gelu(up(norm(xs))))
            # each rank's share of the global mean
            ((h ** 2).sum() / (B * S * H)).backward()
            with torch.no_grad():
                for m in mods:
                    for p in m.parameters():
                        p -= 0.1 * p.grad
                        p.grad = None
        return norm.scale.detach().clone()

    ref = block(None, False)
    scales = mesh.run_in_threads(TP, lambda r: block(mesh.get_tensor_model_parallel_group(),
                                                      True))
    assert torch.equal(scales[0], scales[1])
    np.testing.assert_allclose(scales[0].numpy(), ref.numpy(), **TOL)
    assert not torch.equal(ref, torch.ones(H))
