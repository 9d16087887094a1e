"""The port's parallel core (``parallel/mesh.py``, ``parallel/mappings.py``
and the TP split of ``parallel/layers.py``), held against the JAX package
at TP=2 on its CPU mesh: the counterparts of ``tests/test_mesh.py``,
``tests/test_mappings.py`` and ``tests/test_layers.py``.

The port's ranks are threads of this process over gloo groups
(``mesh.run_in_threads``); the JAX functions run inside ``shard_map`` or
under GSPMD on the 8-device CPU mesh. Inputs come from numpy seeds. Every
comparison is fp32 at ``rtol=1e-5, atol=1e-6`` for values (1e-4/1e-5 for
gradients, as the JAX tests).
"""

import datetime
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from jax.sharding import PartitionSpec as P

from neuronx_distributed_tpu.parallel import layers as JL
from neuronx_distributed_tpu.parallel import mappings as jmp
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.parallel.partitioning import named_sharding_tree
from neuronx_distributed_tpu_torch.inference.partition import param_partition_specs, shard_slice
from neuronx_distributed_tpu_torch.parallel import layers as TL
from neuronx_distributed_tpu_torch.parallel import mappings as tmp
from neuronx_distributed_tpu_torch.parallel import mesh

ALL_AXES = ("pp", "edp", "ep", "tp")
TP = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # two thread ranks share the process: one intra-op thread each
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tp2(fn, **kw):
    return mesh.run_in_threads(TP, fn, **kw)


def _slice(a, dim, rank):
    n = a.shape[dim] // TP
    return np.take(a, range(rank * n, (rank + 1) * n), axis=dim)


# --- mesh (tests/test_mesh.py) ---------------------------------------------------------

def _jax_groups(devs, axis):
    i = jps.MESH_AXES.index(axis)
    return np.moveaxis(np.vectorize(lambda d: d.id)(devs), i, -1).reshape(
        -1, devs.shape[i]).tolist()


@pytest.mark.parametrize("degrees", [dict(tensor_model_parallel_size=2,
                                          pipeline_model_parallel_size=2),
                                     dict(tensor_model_parallel_size=4),
                                     dict(tensor_model_parallel_size=2,
                                          expert_model_parallel_size=2)])
def test_rank_layout_matches_jax_mesh(degrees):
    """The port's rank layout at world 8 is the JAX mesh's device layout:
    the same shape and, per axis, the same groups (TP innermost and
    contiguous)."""
    st = jps.initialize_model_parallel(**degrees)
    lay = mesh.rank_layout(8, **degrees)
    assert lay["shape"] == st.mesh.devices.shape
    for axis in jps.MESH_AXES:
        assert lay["groups"][axis] == _jax_groups(st.mesh.devices, axis), axis
    for row in lay["groups"]["tp"]:
        assert row == list(range(row[0], row[0] + len(row)))
    sizes = (jps.get_data_parallel_size(), jps.get_expert_data_parallel_size())
    assert (len(lay["groups"]["dp"][0]), lay["shape"][1]) == sizes


def test_divisibility_errors():
    """JAX's errors: a world the degrees do not divide, a dp the ep does
    not divide, a second initialization in one rank."""
    for kw in (dict(tensor_model_parallel_size=3), dict(expert_model_parallel_size=3)):
        with pytest.raises(ValueError):
            jps.initialize_model_parallel(**kw)
        with pytest.raises(ValueError):
            mesh.rank_layout(8, **kw)

    def twice(r):
        with pytest.raises(RuntimeError):
            mesh.initialize_model_parallel(2, store=torch.distributed.HashStore(), rank=r,
                                           world_size=2)
        return mesh.get_tensor_model_parallel_size()

    assert _tp2(twice) == [2, 2]
    assert not mesh.model_parallel_is_initialized()


def test_initialize_sizes_and_ranks():
    """Eight thread ranks at tp 2, pp 2: every rank's sizes, its TP rank
    and group, and its coordinates match the JAX mesh's device at that
    position."""
    st = jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                       pipeline_model_parallel_size=2)
    want = {int(d.id): idx for idx, d in np.ndenumerate(st.mesh.devices)}

    def rank(r):
        return (mesh.get_tensor_model_parallel_size(), mesh.get_pipeline_model_parallel_size(),
                mesh.get_data_parallel_size(), mesh.get_expert_model_parallel_size(),
                mesh.get_world_size(), mesh.get_tensor_model_parallel_rank(),
                mesh.get_tensor_model_parallel_group().size(), mesh.get_state().coords(),
                mesh.rmsg("x"))

    out = mesh.run_in_threads(8, rank, tensor_model_parallel_size=2,
                              pipeline_model_parallel_size=2)
    for r, (tp, pp, dp, ep, world, tp_rank, gsize, coords, msg) in enumerate(out):
        assert (tp, pp, dp, ep, world, gsize) == (2, 2, 2, 1, 8, 2)
        pp_i, edp_i, ep_i, cp_i, tp_i = want[r]
        assert tp_rank == tp_i and coords["pp"] == pp_i and coords["edp"] == edp_i
        assert msg.startswith(f"[rank_{r}_pp{pp_i}_tp{tp_i}_")


def test_dead_rank_fails_its_peer():
    """A rank that never joins the collective fails its peer at the group's
    timeout instead of hanging it."""
    def rank(r):
        if r == 1:
            raise KeyError("rank 1 died")
        tmp.all_reduce(torch.ones(2), mesh.get_tensor_model_parallel_group())

    with pytest.raises((KeyError, RuntimeError)):
        _tp2(rank, timeout=datetime.timedelta(seconds=3))


_RANK_PROCESS = """
import json, torch
from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import mesh
torch.set_num_threads(1)
local = mesh.init_distributed("gloo")          # torchrun's environment
st = mesh.initialize_model_parallel(2)
cfg = tl.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_seq_len=32, dtype=torch.float32)
sd = tl.init_params(cfg, torch.Generator().manual_seed(0), tp_rank=st.rank, tp_size=2)
lm = CausalLM(cfg, sd, tl.LlamaForCausalLM, buckets=(8,), max_batch=2, page_size=4,
              device="cpu")
eng = ServeEngine(lm, block_steps=4, seed=1)
for i in range(3):
    eng.submit([5 + i, 9, 2 * i + 1], 6)
eng.run()
print(json.dumps({"local": local, "tp": lm.tp, "backend": mesh.group_backend(lm.tp_group),
                  "streams": {c.request_id: c.tokens.tolist() for c in eng.completed}}))
"""


def test_process_per_rank_launch_from_torchrun_environment():
    """Two processes launched as ``torchrun`` launches them (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) join
    through ``init_distributed``, build their groups with ``new_group`` and
    serve a TP=2 model: both ranks stream what one process at TP=1 does."""
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.models import llama as tl

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROCESS], cwd=root, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(root), "RANK": str(r), "WORLD_SIZE": "2",
             "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0
        outs.append(json.loads(out.strip().splitlines()[-1]))
    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=32, dtype=torch.float32)
    lm = CausalLM(cfg, tl.init_params(cfg, torch.Generator().manual_seed(0)),
                  tl.LlamaForCausalLM, buckets=(8,), max_batch=2, page_size=4, device="cpu")
    eng = ServeEngine(lm, block_steps=4, seed=1)
    for i in range(3):
        eng.submit([5 + i, 9, 2 * i + 1], 6)
    eng.run()
    want = {str(c.request_id): c.tokens.tolist() for c in eng.completed}
    for r, out in enumerate(outs):
        assert (out["local"], out["tp"], out["backend"]) == (r, 2, "gloo")
        assert out["streams"] == want


# --- mappings (tests/test_mappings.py) -----------------------------------------------

def _jax_column(x, w):
    mesh_ = jps.initialize_model_parallel(tensor_model_parallel_size=TP).mesh

    def sharded(x, w):
        def f(x, w_local):
            y_local = jmp.copy_to_tensor_parallel_region(x) @ w_local
            y = jmp.gather_from_tensor_parallel_region(y_local, dim=-1)
            return jnp.sum(jnp.tanh(y))[None]

        return jax.shard_map(f, mesh=mesh_, in_specs=(P(), P(None, "tp")),
                             out_specs=P(ALL_AXES))(x, w).mean()

    return jax.value_and_grad(sharded, argnums=(0, 1))(x, w)


def _jax_row(x, w):
    mesh_ = jps.initialize_model_parallel(tensor_model_parallel_size=TP).mesh

    def sharded(x, w):
        def f(x, w_local):
            x_local = jmp.scatter_to_tensor_parallel_region(x, dim=-1)
            y = jmp.reduce_from_tensor_parallel_region(x_local @ w_local)
            return jnp.sum(jnp.tanh(y))[None]

        return jax.shard_map(f, mesh=mesh_, in_specs=(P(), P("tp", None)),
                             out_specs=P(ALL_AXES))(x, w).mean()

    return jax.value_and_grad(sharded, argnums=(0, 1))(x, w)


@pytest.mark.parametrize("kind", ["column", "row"])
def test_parallel_matmul_fwd_bwd_matches_jax(kind):
    """Column (copy + gather) and row (scatter + reduce) regions: the loss
    and the gradients of x (whole on every rank) and of the rank's weight
    shard equal JAX's at TP=2."""
    x = _rng(0, 2, 6, 16 if kind == "column" else 32)
    w = _rng(1, 16, 32) if kind == "column" else _rng(1, 32, 16)
    loss_j, (gx_j, gw_j) = (_jax_column if kind == "column" else _jax_row)(x, w)
    wdim = 1 if kind == "column" else 0

    def rank(r):
        g = mesh.get_tensor_model_parallel_group()
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(_slice(w, wdim, r), requires_grad=True)
        if kind == "column":
            y = tmp.gather_from_tensor_parallel_region(
                tmp.copy_to_tensor_parallel_region(xt, g) @ wt, g, -1)
        else:
            y = tmp.reduce_from_tensor_parallel_region(
                tmp.scatter_to_tensor_parallel_region(xt, g, -1) @ wt, g)
        loss = torch.tanh(y).sum()
        loss.backward()
        return loss.item(), xt.grad.numpy(), wt.grad.numpy()

    for r, (loss, gx, gw) in enumerate(_tp2(rank)):
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(gx, np.asarray(gx_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gw, _slice(np.asarray(gw_j), wdim, r), rtol=1e-4, atol=1e-5)


def test_sequence_parallel_roundtrip_and_backward():
    """Scatter then gather over the sequence is the identity, as in JAX;
    the gather's backward is the reduce-scatter of the ranks' gradients."""
    x = _rng(2, 2, 8, 4)
    mesh_ = jps.initialize_model_parallel(tensor_model_parallel_size=TP).mesh

    def f(x):
        xs = jmp.scatter_to_sequence_parallel_region(x, seq_dim=1)
        return jmp.gather_from_sequence_parallel_region(xs, seq_dim=1)

    want = np.asarray(jax.shard_map(f, mesh=mesh_, in_specs=(P(),), out_specs=P(),
                                    check_vma=False)(x))

    def rank(r):
        g = mesh.get_tensor_model_parallel_group()
        xt = torch.tensor(x)
        local = tmp.scatter_to_sequence_parallel_region(xt, g, 1).requires_grad_(True)
        y = tmp.gather_from_sequence_parallel_region(local, g, 1)
        (y * (r + 1)).sum().backward()
        return y.detach().numpy(), local.grad.numpy()

    for y, grad in _tp2(rank):
        np.testing.assert_allclose(y, want)
        np.testing.assert_allclose(grad, np.full((2, 4, 4), 3.0, np.float32))


def test_reduce_scatter_matches_jax():
    """``reduce_scatter_to_sequence_parallel_region`` (and the plain
    ``reduce_scatter``) on rank-scaled inputs equals JAX's psum_scatter."""
    x = _rng(3, 8, 4)
    mesh_ = jps.initialize_model_parallel(tensor_model_parallel_size=TP).mesh

    def f(x):
        xr = x * (1.0 + jax.lax.axis_index("tp"))
        return jmp.reduce_scatter_to_sequence_parallel_region(xr, seq_dim=0)

    want = np.asarray(jax.shard_map(f, mesh=mesh_, in_specs=(P(),), out_specs=P("tp"))(x))

    def rank(r):
        g = mesh.get_tensor_model_parallel_group()
        xr = torch.tensor(x) * (1.0 + r)
        return (tmp.reduce_scatter_to_sequence_parallel_region(xr, g, 0).numpy(),
                tmp.reduce_scatter(xr, 0, g).numpy(),
                tmp.all_gather(torch.tensor(_slice(x, 0, r)), 0, g).numpy(),
                tmp.all_reduce(xr, g).numpy())

    for r, (rs, rs2, ag, ar) in enumerate(_tp2(rank)):
        np.testing.assert_allclose(rs, _slice(want, 0, r), rtol=1e-6)
        np.testing.assert_allclose(rs2, rs)
        np.testing.assert_allclose(ag, x)
        np.testing.assert_allclose(ar, x * 3.0, rtol=1e-6)


# --- layers (tests/test_layers.py) ---------------------------------------------------

def _jax_sharded(variables, mesh_):
    return jax.device_put(meta.unbox(variables), named_sharding_tree(variables, mesh_))


def test_column_row_mlp_matches_jax():
    """A column -> gelu -> row MLP at TP=2: the loss and every weight's
    gradient (the rank's shard) equal the JAX layers' under GSPMD, and x's
    gradient; the port's specs cut JAX's kernels."""
    st = jps.initialize_model_parallel(tensor_model_parallel_size=TP)

    class MLP(JL.nn.Module):
        @JL.nn.compact
        def __call__(self, x):
            h = JL.ColumnParallelLinear(64, dtype=jnp.float32, name="up")(x)
            return JL.RowParallelLinear(32, dtype=jnp.float32, name="down")(jax.nn.gelu(h))

    x = _rng(4, 4, 8, 32)
    model = MLP()
    params = _jax_sharded(model.init(jax.random.PRNGKey(1), x), st.mesh)

    def loss_fn(params, x):
        return jnp.mean(model.apply(params, x) ** 2)

    with jax.set_mesh(st.mesh):
        loss_j, (gp, gx_j) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(params, x)
    full = {f"{m}.{k}": np.asarray(v) for m in ("up", "down")
            for k, v in params["params"][m].items()}
    grads = {f"{m}.{k}": np.asarray(v) for m in ("up", "down")
             for k, v in gp["params"][m].items()}

    class TMLP(torch.nn.Module):
        def __init__(self, group=None):
            super().__init__()
            self.up = TL.ColumnParallelLinear(32, 64, dtype=torch.float32, group=group)
            self.down = TL.RowParallelLinear(64, 32, dtype=torch.float32, group=group)

        def forward(self, x):
            return self.down(torch.nn.functional.gelu(self.up(x), approximate="tanh"))

    specs = param_partition_specs(TMLP())
    assert specs == {"up.kernel": (None, "tp"), "up.bias": ("tp",),
                     "down.kernel": ("tp", None), "down.bias": ()}

    def rank(r):
        m = TMLP(mesh.get_tensor_model_parallel_group())
        m.load_state_dict({k: shard_slice(torch.tensor(v), specs[k], r, TP)
                           for k, v in full.items()})
        for p in m.parameters():
            p.requires_grad_(True)
        xt = torch.tensor(x, requires_grad=True)
        loss = (m(xt) ** 2).mean()
        loss.backward()
        return loss.item(), xt.grad.numpy(), {k: p.grad.numpy() for k, p in m.named_parameters()}

    for r, (loss, gx, gw) in enumerate(_tp2(rank)):
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(gx, np.asarray(gx_j), rtol=1e-4, atol=1e-6)
        for k, g in gw.items():
            want = shard_slice(torch.tensor(grads[k]), specs[k], r, TP).numpy()
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_vocab_parallel_embedding_matches_jax():
    """The vocab-parallel embedding at TP=2 (a masked lookup of the rank's
    rows, then an all-reduce) equals JAX's lookup; ``attend`` gives the
    rank's vocabulary shard of ``x @ E.T``."""
    st = jps.initialize_model_parallel(tensor_model_parallel_size=TP)
    ids = np.random.default_rng(5).integers(0, 100, (4, 8))   # batch over edp (4 at TP=2)
    emb = JL.ParallelEmbedding(100, 32, shard_over="vocab", dtype=jnp.float32)
    params = _jax_sharded(emb.init(jax.random.PRNGKey(1), jnp.asarray(ids)), st.mesh)
    with jax.set_mesh(st.mesh):
        want = np.asarray(jax.jit(emb.apply)(params, jnp.asarray(ids)))
    table = np.asarray(params["params"]["embedding"])
    x = _rng(6, 2, 3, 32)
    logits = x @ table.T

    def rank(r):
        m = TL.ParallelEmbedding(100, 32, dtype=torch.float32,
                                 group=mesh.get_tensor_model_parallel_group())
        m.load_state_dict({"embedding": torch.tensor(_slice(table, 0, r))})
        return m(torch.tensor(ids)).numpy(), m.attend(torch.tensor(x)).numpy()

    for r, (y, att) in enumerate(_tp2(rank)):
        np.testing.assert_allclose(y, want, rtol=1e-6)
        np.testing.assert_allclose(att, _slice(logits, -1, r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mult", [1, 2])
def test_gqa_qkv_matches_jax(mult):
    """GQA QKV at TP=2 with ``kv_size_multiplier`` 1 (K/V kernels sharded)
    and 2 (compact K/V kernels replicated, heads repeated then sliced):
    each rank's Q/K/V heads equal its slice of JAX's outputs."""
    st = jps.initialize_model_parallel(tensor_model_parallel_size=TP)
    kv = 2 if mult == 1 else 1
    x = _rng(7, 4, 8, 64)
    qkv = JL.GQAQKVColumnParallelLinear(num_heads=8, num_kv_heads=kv, head_dim=16,
                                        kv_size_multiplier=mult, use_bias=True,
                                        dtype=jnp.float32)
    params = _jax_sharded(qkv.init(jax.random.PRNGKey(1), jnp.asarray(x)), st.mesh)
    with jax.set_mesh(st.mesh):
        want = [np.asarray(t) for t in jax.jit(qkv.apply)(params, jnp.asarray(x))]
    full = {k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()}
    biases = {k: v + 0.25 * torch.arange(v.numel(), dtype=torch.float32).reshape(v.shape)
              for k, v in full.items() if k.endswith("bias")}
    full.update(biases)
    bias_add = {k[0]: np.asarray(biases[k] - torch.tensor(np.asarray(params["params"][k])))
                for k in biases}

    def rank(r):
        m = TL.GQAQKVColumnParallelLinear(64, 8, kv, 16, use_bias=True, dtype=torch.float32,
                                          group=mesh.get_tensor_model_parallel_group(),
                                          kv_size_multiplier=mult)
        specs = {k: (() if d is None else tuple("tp" if i == d else None
                                                 for i in range(full[k].dim())))
                 for k, d in m.tp_shard_dims.items()}
        m.load_state_dict({k: shard_slice(v, specs[k], r, TP) for k, v in full.items()})
        return [t.detach().numpy() for t in m(torch.tensor(x))]

    for r, got in enumerate(_tp2(rank)):
        for name, g, w in zip("qkv", got, want):
            b = bias_add[name]
            if name != "q" and mult > 1:
                b = np.repeat(b, mult, axis=0)
            assert g.shape == (4, 8, (8 if name == "q" else kv * mult) // TP, 16)
            np.testing.assert_allclose(g, _slice(w + b, 2, r), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="kv_size_multiplier"):
        mesh.run_in_threads(4, lambda r: TL.GQAQKVColumnParallelLinear(
            64, 8, 2, 16, group=mesh.get_tensor_model_parallel_group()))


def test_sequence_parallel_and_int8_refused_under_tp():
    """Sequence parallelism is ported (``tests/test_torch_sequence_parallel.py``
    holds it against JAX): without a group the flag is a no-op. Context
    parallelism is ported too (``tests/test_torch_ring_attention.py``); what
    JAX refuses the port refuses with JAX's error: SP with CP. Not ported:
    int8 weights in a layer of more than one rank."""
    assert not TL.ColumnParallelLinear(8, 8, sequence_parallel=True).sequence_parallel
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
               num_kv_heads=2, context_parallel=True)
    with torch.device("meta"):
        assert LlamaForCausalLM(LlamaConfig(**cfg)).model.layers[0].attention.cp_group is None
    with torch.device("meta"), pytest.raises(
            ValueError, match="sequence_parallel and context_parallel are exclusive"):
        LlamaForCausalLM(LlamaConfig(**cfg, sequence_parallel=True))

    def rank(r):
        m = TL.ColumnParallelLinear(8, 8, group=mesh.get_tensor_model_parallel_group())
        with pytest.raises(NotImplementedError, match="int8"):
            TL.adopt_quantized(m, {"kernel.qweight": torch.zeros((8, 4), dtype=torch.int8),
                                   "kernel.scale": torch.ones((1, 4))})
        return True

    assert _tp2(rank) == [True, True]
