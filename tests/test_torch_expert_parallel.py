"""Expert parallelism in the port, held against the JAX package.

- The all-to-all (``parallel/mappings.py``) against JAX's under
  ``shard_map`` (JAX ``tests/test_mappings.py:103``): one hop's values on
  every rank, the round trip, and the gradient (the reverse all-to-all);
  ``nonzero_partition_dim_swap`` over TP likewise.
- The MoE block at EP 2 x TP 2 with edp 2 (8 thread ranks over gloo, each
  data-parallel rank feeding its rows of the global batch) against JAX's
  one-device block on the global batch (JAX ``tests/test_moe.py:69``):
  outputs, the input's gradient, the router's (summed over the DP ranks)
  and each expert slice's (summed over the edp ranks), at
  ``capacity_factor`` 8.0 (nothing drops) and at 1.25 and 1.0, where
  tokens drop, with JAX's own tolerance (2e-4); the dropped assignments an
  expert equal the count JAX's drop rule gives on JAX's routing; and the
  ``all_experts`` mode at the same layout.
- The auxiliary loss under DP 2 for both routers: the DP mean of the
  ranks' losses and its router gradient equal JAX's on the global batch,
  while the mean of the ranks' one-rank losses does not.

Each rank's loss is ``sum(out * ct) + aux / dp`` over its rows, so the
ranks' losses add up to JAX's ``sum(out * ct) + aux``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neuronx_distributed_tpu.moe import layer as jlayer
from neuronx_distributed_tpu.moe import routing as jr
from neuronx_distributed_tpu.moe.expert_mlps import ExpertMLPs as JExperts
from neuronx_distributed_tpu.parallel import mappings as jmp
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu_torch.inference.partition import shard_slice
from neuronx_distributed_tpu_torch.moe import MoE, collect_aux_losses, record_aux_losses
from neuronx_distributed_tpu_torch.parallel import mappings, mesh

E, H, I = 4, 32, 64
B, S = 4, 16
TOL = dict(rtol=2e-4, atol=2e-4)
Z_COEF = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --- the all-to-all ---------------------------------------------------------------

def _jax_a2a(x, ct, axis, split, concat, n):
    """JAX's all-to-all over ``axis`` on shards of ``x`` along dim 0, its
    round trip, and the gradient of ``sum(a2a(x) * ct)``."""
    st = jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                       expert_model_parallel_size=2)
    try:
        def hop(x):
            return jax.shard_map(lambda v: jmp.all_to_all_in_expert_parallel_region(
                v, split, concat, axis), mesh=st.mesh, in_specs=(P(axis),),
                out_specs=P(axis))(x)

        def trip(x):
            return jax.shard_map(lambda v: jmp.all_to_all_in_expert_parallel_region(
                jmp.all_to_all_in_expert_parallel_region(v, split, concat, axis), concat,
                split, axis), mesh=st.mesh, in_specs=(P(axis),), out_specs=P(axis))(x)

        y = np.asarray(hop(jnp.asarray(x)))
        back = np.asarray(trip(jnp.asarray(x)))
        g = np.asarray(jax.grad(lambda v: jnp.sum(hop(v) * ct))(jnp.asarray(x)))
        return y, back, g
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("axis", ["ep", "tp"])
def test_all_to_all_matches_jax(axis):
    x = _rng(0, 8, 4)
    ct = _rng(1, 4, 8)
    want, back, grad = _jax_a2a(x, ct, axis, 0, 1, 2)
    np.testing.assert_array_equal(back, x)

    def rank(r):
        c = mesh.local_mesh_coords()[axis]
        group = mesh.get_state().groups[axis]
        xr = torch.tensor(x[c * 4:(c + 1) * 4], requires_grad=True)
        if axis == "ep":
            y = mappings.all_to_all_in_expert_parallel_region(xr, 0, 1, group)
            trip = mappings.all_to_all_in_expert_parallel_region(y, 1, 0, group)
        else:   # the TP swap: split dim 0, concatenate dim 1
            y = mappings.nonzero_partition_dim_swap(xr, 1, 0, group)
            trip = mappings.nonzero_partition_dim_swap(y, 0, 1, group)
        (y * torch.tensor(ct[c * 2:(c + 1) * 2])).sum().backward()
        return c, y.detach().numpy(), trip.detach().numpy(), xr.grad.numpy(), \
            mappings.collective_stats()["all_to_all"]

    for c, y, trip, g, stats in mesh.run_in_threads(4, rank, tensor_model_parallel_size=2,
                                                    expert_model_parallel_size=2):
        np.testing.assert_array_equal(y, want[c * 2:(c + 1) * 2])
        np.testing.assert_array_equal(trip, x[c * 4:(c + 1) * 4])
        np.testing.assert_array_equal(g, grad[c * 4:(c + 1) * 4])
        assert stats == [3, 3 * 16 * 4]   # hop, trip's return, the backward


# --- the MoE block at EP 2 x TP 2 x edp 2 -----------------------------------------------

def _weights():
    return {"router": _rng(10, H, E, scale=H ** -0.5),
            "gate": _rng(11, E, H, I, scale=H ** -0.5), "up": _rng(12, E, H, I, scale=H ** -0.5),
            "down": _rng(13, E, I, H, scale=I ** -0.5)}


def _jax_block(w, x, ct, router, mode, cf):
    """JAX's one-device block on the global batch: output, the gradients of
    ``sum(out * ct) + aux`` and the aux loss."""
    m = jlayer.MoE(num_experts=E, hidden_size=H, intermediate_size=I, top_k=2, router=router,
                   mode=mode, capacity_factor=cf, dtype=jnp.float32, z_loss_coef=Z_COEF)
    params = {"router": {"kernel": w["router"]},
              "experts": {k: w[k] for k in ("gate", "up", "down")}}

    def loss(p, xv):
        out, mut = m.apply({"params": p}, xv, mutable=["losses"])
        aux = jlayer.collect_aux_losses(mut)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    flat = jnp.asarray(x).reshape(-1, H)
    if router == "top_k":
        combine, _ = jr.RouterTopK(E, top_k=2).apply({"params": params["router"]}, flat)
    else:
        combine, _ = jr.RouterSinkhorn(E).apply({"params": params["router"]}, flat)
    mask = np.asarray(combine) > 0
    pos = np.cumsum(mask, axis=0) * mask - mask
    cap = JExperts(num_experts=E, hidden_size=H, intermediate_size=I,
                   capacity_factor=cf).capacity(flat.shape[0])
    dropped = (mask & (pos >= cap)).sum(axis=0)
    return dict(out=np.asarray(out), aux=float(aux), gx=np.asarray(gx),
                router=np.asarray(gp["router"]["kernel"]),
                experts={k: np.asarray(gp["experts"][k]) for k in ("gate", "up", "down")},
                dropped=dropped)


def _port_rank(w, x, ct, router, mode, cf):
    st = mesh.get_state()
    c = mesh.local_mesh_coords()
    tp_g = st.groups["tp"] if st.tensor_model_parallel_size > 1 else None
    ep_g = st.groups["ep"] if st.expert_model_parallel_size > 1 else None
    dp_g, dp = st.groups["dp"], st.data_parallel_size
    m = MoE(E, H, I, top_k=2, router=router, mode=mode, capacity_factor=cf,
            dtype=torch.float32, z_loss_coef=Z_COEF, tp_group=tp_g, ep_group=ep_g,
            dp_group=dp_g)
    tp, ep = st.tensor_model_parallel_size, st.expert_model_parallel_size
    state = {"router.kernel": torch.tensor(w["router"])}
    for k in ("gate", "up", "down"):
        state[f"experts.{k}"] = shard_slice(torch.tensor(w[k]), m.experts.partition_specs[k],
                                            c["tp"], tp, c["ep"], ep).contiguous()
    m.load_state_dict(state)
    m.requires_grad_(True)
    rows = mesh.data_batch_slice(B)
    xr = torch.tensor(x[rows], requires_grad=True)
    with record_aux_losses(m):
        out = m(xr)
        aux = collect_aux_losses(m)
    ((out * torch.tensor(ct[rows])).sum() + aux / dp).backward()
    return dict(coords=c, rows=rows, out=out.detach().numpy(), gx=xr.grad.numpy(),
                aux=float(aux.detach()), router=m.router.kernel.grad.numpy(),
                experts={k: getattr(m.experts, k).grad.numpy() for k in ("gate", "up", "down")},
                dropped=None if mode == "all_experts" else m.experts.last_dropped.numpy(),
                a2a=mappings.collective_stats().get("all_to_all", [0, 0])[0])


def _cut(a, spec, c, tp=2, ep=2):
    return shard_slice(torch.tensor(a), spec, c["tp"], tp, c["ep"], ep).numpy()


@pytest.mark.parametrize("mode,cf", [("capacity_factor", 8.0), ("capacity_factor", 1.25),
                                     ("capacity_factor", 1.0), ("all_experts", 1.0)])
def test_moe_block_ep2_tp2_edp2_matches_jax(mode, cf):
    w = _weights()
    x, ct = _rng(20, B, S, H), _rng(21, B, S, H)
    want = _jax_block(w, x, ct, "top_k", mode, cf)
    ranks = mesh.run_in_threads(8, lambda r: _port_rank(w, x, ct, "top_k", mode, cf),
                                tensor_model_parallel_size=2, expert_model_parallel_size=2)
    assert {rk["coords"]["edp"] for rk in ranks} == {0, 1}
    for rk in ranks:
        np.testing.assert_allclose(rk["out"], want["out"][rk["rows"]], **TOL)
        np.testing.assert_allclose(rk["gx"], want["gx"][rk["rows"]], **TOL)
        if mode == "capacity_factor":
            np.testing.assert_array_equal(rk["dropped"], want["dropped"])
            assert rk["a2a"] == 4   # dispatch and return, forward and backward
    # the router's gradient: each DP rank's share; the TP ranks hold it whole
    for t in (0, 1):
        got = sum(rk["router"] for rk in ranks if rk["coords"]["tp"] == t)
        np.testing.assert_allclose(got, want["router"], **TOL)
    # an expert slice's gradient: summed over the ranks that hold it (edp)
    for rk in ranks:
        c = rk["coords"]
        for k, spec in (("gate", ("ep", None, "tp")), ("up", ("ep", None, "tp")),
                        ("down", ("ep", "tp", None))):
            got = sum(o["experts"][k] for o in ranks
                      if (o["coords"]["ep"], o["coords"]["tp"]) == (c["ep"], c["tp"]))
            np.testing.assert_allclose(got, _cut(want["experts"][k], spec, c), **TOL)
    np.testing.assert_allclose(np.mean([rk["aux"] for rk in ranks]), want["aux"], rtol=1e-5)
    if cf == 1.0 and mode == "capacity_factor":
        assert want["dropped"].sum() > 0   # the case drops tokens


@pytest.mark.parametrize("router", ["top_k", "sinkhorn"])
def test_aux_loss_under_dp2_matches_jax_on_the_global_batch(router):
    """Two DP ranks with unequal routing: the DP mean of the ranks' aux
    losses (each with the global dispatch share, its own mean probability)
    and its router gradient are JAX's global ones; the mean of the ranks'
    one-rank losses is not (the loss is bilinear)."""
    w = _weights()
    x, ct = _rng(30, B, S, H), np.zeros((B, S, H), np.float32)
    want = _jax_block(w, x, ct, router, "capacity_factor", 2.0)
    ranks = mesh.run_in_threads(2, lambda r: _port_rank(w, x, ct, router, "capacity_factor",
                                                        2.0), tensor_model_parallel_size=1)
    np.testing.assert_allclose(np.mean([rk["aux"] for rk in ranks]), want["aux"], rtol=1e-5)
    np.testing.assert_allclose(sum(rk["router"] for rk in ranks), want["router"],
                               rtol=1e-5, atol=1e-7)
    alone = [_jax_block(w, x[rk["rows"]], ct[rk["rows"]], router, "capacity_factor", 2.0)["aux"]
             for rk in ranks]
    assert abs(np.mean(alone) - want["aux"]) > 1e-4 * want["aux"]
    # a rank's loss takes the global dispatch share, not its own rows'
    assert abs(ranks[0]["aux"] - alone[0]) > 1e-4 * alone[0]
