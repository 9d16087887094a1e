"""GPT-NeoX on the port against the JAX package (``models/gpt_neox.py``).

Logits of the same seeded flax tree (``gpt_neox_params_from_jax``) at fp32,
parallel and serial residual, ``rotary_pct`` 0.25 and 1.0: ``atol=2e-5``
(the two frameworks sum the GEMMs in other orders). The partial rotary:
the port's tables for ``rope_dims`` and ``apply_partial_rotary`` equal
JAX's (``atol=1e-6``), and the passthrough dims are the input's bits. Head
dim 96 (NeoX-20B's) through B1's twin at the padded 128 width (what the card
runs) equals the unpadded twin and JAX's Pallas kernel (interpret mode) in a
whole model with flash attention on (``atol=2e-5``). Trajectories: 3 steps
of losses and grad norms at TP 2 x DP 2 with SP and ZeRO-1, and at CP 2,
against JAX's trainer on the same 4-device mesh (``rtol=5e-4``, as
``tests/test_torch_dist_training.py``); every rank reports the same numbers
and the DP replicas hold the same bits. ``decode=True`` raises, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from neuronx_distributed_tpu.kernels import flash_attn as jfa
from neuronx_distributed_tpu.models import gpt_neox as jn
from neuronx_distributed_tpu.models.llama import rotary_embedding as j_rotary
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu.trainer.model import ParallelModel as JParallelModel
from neuronx_distributed_tpu_torch.converters.jax_params import gpt_neox_params_from_jax
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa
from neuronx_distributed_tpu_torch.models import gpt_neox as tn
from neuronx_distributed_tpu_torch.models.llama import rotary_embedding
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD, STEPS, RTOL = 4, 3, 5e-4
ATOL = 2e-5
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=32, use_flash_attention=False, remat_policy=None)
MESHES = {
    "TP2_SP_DP2": (dict(tensor_model_parallel_size=2), True),
    "CP2": (dict(tensor_model_parallel_size=1, context_parallel_size=2), False),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill(abstract, seed=0):
    """A flax tree filled from a numpy seed: kernels at the lecun-normal
    scale, norm scales near 1, biases small and nonzero (so a bias that
    lands in the wrong place shows)."""
    rs = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith("bias']"):
            return (0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-3] if "qkv" in name else leaf.shape[-2]
        scale = 1.0 if "embed" in name else fan_in ** -0.5
        return (rs.standard_normal(leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, meta.unbox(abstract)["params"])


def _ids(b=2, s=16, vocab=128, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def _jax_tree(cfg, ids):
    module = jn.GPTNeoXForCausalLM(cfg)
    return module, _fill(jax.eval_shape(lambda: module.init(jax.random.key(0), ids)))


@pytest.mark.parametrize("parallel,pct", [(True, 0.25), (False, 0.25), (True, 1.0)])
def test_logits_match_jax(parallel, pct):
    over = dict(use_parallel_residual=parallel, rotary_pct=pct)
    jcfg = jn.GPTNeoXConfig(**TINY, **over, dtype=jnp.float32)
    ids = _ids()
    module, tree = _jax_tree(jcfg, ids)
    want = np.asarray(module.apply({"params": tree}, ids))
    cfg = tn.GPTNeoXConfig(**TINY, **over, dtype=torch.float32)
    model = tn.GPTNeoXForCausalLM(cfg)
    model.load_state_dict(gpt_neox_params_from_jax(tree), strict=True)
    got = model(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert cfg.rope_dims == jcfg.rope_dims == int(cfg.head_dim_ * pct)


def test_partial_rotary_tables_and_passthrough():
    """Tables for rope_dims (its own denominator base), the rotation of the
    first rope_dims, and the rest passed through bit for bit."""
    rd, d = 6, 24
    pos = np.arange(10, dtype=np.int32)
    jc, js = j_rotary(jnp.asarray(pos), rd, 10000.0)
    tc, ts = rotary_embedding(torch.as_tensor(pos), rd, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 10, 3, d)).astype(np.float32)
    want = np.asarray(jn.apply_partial_rotary(jnp.asarray(x), jc, js, rd))
    got = tn.apply_partial_rotary(torch.as_tensor(x), tc, ts, rd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(got[..., rd:], torch.as_tensor(x)[..., rd:])
    # the tables of the whole head, sliced, are other frequencies
    full_c, _ = rotary_embedding(torch.as_tensor(pos), d, 10000.0)
    assert not torch.allclose(full_c[:, : rd // 2], tc)


def test_head_dim_96_through_the_padded_twin():
    """NeoX-20B's head_dim: B1's twin at the kernel's 128 width equals the
    twin at 96, and a whole model with flash on (the port's twin, JAX's
    Pallas kernel in interpret mode) matches JAX."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((4, 128, 96), generator=g) for _ in range(3))
    pos = torch.arange(128, dtype=torch.int32).reshape(1, 1, 128).expand(2, 1, 128).contiguous()
    args = (pos, pos, 96 ** -0.5, 64, 64, 1, 2)
    out, lse = tfa.at_kernel_width(tfa.flash_block_forward_plain, 96, (q, k, v), *args, keep=(1,))
    ref, ref_lse = tfa.flash_block_forward_plain(q, k, v, *args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)
    jout = jfa.flash_attention(jnp.asarray(q.numpy()).reshape(2, 2, 128, 96),
                               jnp.asarray(k.numpy()).reshape(2, 2, 128, 96),
                               jnp.asarray(v.numpy()).reshape(2, 2, 128, 96), causal=True,
                               block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(4, 128, 96), atol=2e-5)

    over = dict(TINY, hidden_size=192, num_heads=2, num_kv_heads=2, max_seq_len=128,
                use_flash_attention=True, attention_block_q=64, attention_block_k=64)
    jcfg = jn.GPTNeoXConfig(**over, dtype=jnp.float32)
    ids = _ids(1, 128)
    module, tree = _jax_tree(jcfg, ids)
    want = np.asarray(module.apply({"params": tree}, ids))
    model = tn.GPTNeoXForCausalLM(tn.GPTNeoXConfig(**over, dtype=torch.float32))
    assert model.config.head_dim_ == 96 and model.config.rope_dims == 24
    model.load_state_dict(gpt_neox_params_from_jax(tree), strict=True)
    launches = tfa.flash_block_forward.launches
    got = model(torch.as_tensor(ids)).detach().numpy()
    assert tfa.flash_block_forward.launches == launches   # the CPU runs the twin, uncounted
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decode_raises():
    with pytest.raises(NotImplementedError, match="GPT-NeoX decode"):
        tn.GPTNeoXForCausalLM(tn.GPTNeoXConfig(**TINY, decode=True))


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 127, (4, 32)), rs.randint(0, 127, (4, 32))


@pytest.fixture(scope="module")
def weights():
    ids, _ = _batch()
    return _jax_tree(jn.GPTNeoXConfig(**TINY, dtype=jnp.float32), ids)[1]


def _jax_run(weights, degrees, sp):
    jps.initialize_model_parallel(**degrees, devices=jax.devices()[:WORLD])
    try:
        cfg = j_config(optimizer_config={"zero_one_enabled": True})
        ids, labels = _batch()
        module = jn.GPTNeoXForCausalLM(jn.GPTNeoXConfig(**TINY, dtype=jnp.float32,
                                                        sequence_parallel=sp))
        specs = nn.get_partition_spec(jax.eval_shape(
            lambda: module.init(jax.random.key(0), jnp.asarray(ids))))["params"]
        model = JParallelModel(module=module, params=None, param_specs=specs,
                               mesh=jps.get_mesh())
        model.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights),
                                      model.param_shardings())
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, b, r: model.module.apply(
            {"params": p}, b["ids"], b["labels"], method=jn.GPTNeoXForCausalLM.loss))
        out = []
        for i in range(STEPS):
            state, m = step(state, {"ids": ids, "labels": labels}, jax.random.key(i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out
    finally:
        jps.destroy_model_parallel()


def _port_rank(weights, sp):
    cfg = neuronx_distributed_config(
        tensor_parallel_size=mesh.get_tensor_model_parallel_size(), sequence_parallel=sp,
        optimizer_config={"zero_one_enabled": True})
    ncfg = tn.GPTNeoXConfig(**TINY, dtype=torch.float32)
    model = initialize_parallel_model(cfg, lambda: tn.GPTNeoXForCausalLM(ncfg), device="cpu",
                                      params=gpt_neox_params_from_jax(weights))
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    ids, labels = _batch()
    rows, cols = mesh.data_batch_slice(len(ids)), mesh.context_seq_slice(ids.shape[1])
    batch = {"ids": torch.as_tensor(ids[rows, cols]),
             "labels": torch.as_tensor(labels[rows, cols])}
    out = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(traj=out, params={n: t.clone() for n, t in state.params.items()},
                coords=mesh.local_mesh_coords())


@pytest.mark.parametrize("name", sorted(MESHES))
def test_trajectory_matches_jax(name, weights):
    degrees, sp = MESHES[name]
    want = _jax_run(weights, degrees, sp)
    ranks = mesh.run_in_threads(WORLD, lambda r: _port_rank(weights, sp), **degrees)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
    np.testing.assert_allclose(np.array(ranks[0]["traj"]), np.array(want), rtol=RTOL)
    by_tp = {}
    for rk in ranks:
        by_tp.setdefault(rk["coords"]["tp"], []).append(rk)
    for group in by_tp.values():
        for rk in group[1:]:
            for n, t in rk["params"].items():
                assert torch.equal(t, group[0]["params"][n]), (name, n)
