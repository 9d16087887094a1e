"""The Mixtral training line's entry points on the port against the JAX
package: the ``mixtral_moe`` example, a DBRX-shaped model, the auxiliary
loss under activation checkpointing, and what stays refused.

- ``examples/mixtral_moe.py``'s ``main`` at ``--tiny`` (TP 2 x EP 2 x edp 2,
  eight thread ranks) on the JAX example's init trains the JAX example's
  losses (``tests/test_examples.py:746``) at ``rtol=5e-4``.
- A DBRX-shaped tiny model (bias-free LayerNorms, ``qkv_clip`` 8, top-4 of
  8 experts): logits within the MoE block's tolerance of JAX's (2e-4, JAX
  ``tests/test_moe.py:82``), and one training step at EP 2 x edp 2 within
  ``rtol=5e-4``.
- The auxiliary loss's router gradient is the same under remat ``"full"``,
  ``"attention"`` and none (the recompute reaches it), and not zero.
- The MoE block under context parallelism builds (the model and the
  trainer on a cp mesh, each MoE block over the cp group; its numbers are
  held against JAX in ``tests/test_torch_moe_cp.py``); refused by name
  under pipeline parallelism (fault C13 of the reference); Mixtral serving
  under a tensor-parallel group (``CausalLM``) gives TP=1's tokens.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.models import mixtral as jm
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu_torch.converters.jax_params import mixtral_params_from_jax
from neuronx_distributed_tpu_torch.examples import mixtral_moe as port_example
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.llama import init_params
from neuronx_distributed_tpu_torch.moe import collect_aux_losses, record_aux_losses
from neuronx_distributed_tpu_torch.parallel import mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_moe_training import _fill, _jax_run, _port_rank  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "training"
RTOL = 5e-4
DBRX = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=32, use_flash_attention=False, num_experts=8, top_k=4,
            capacity_factor=1.25, remat_policy=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()]


def test_mixtral_moe_example_matches_jax(tmp_path):
    for p in (EXAMPLES, EXAMPLES.parent):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import mixtral_moe as jax_example

    jm_file, pm_file = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    try:
        jax_example.main(["--tiny", "--log_every", "1", "--metrics_file", jm_file])
    finally:
        jps.destroy_model_parallel()
    want = _losses(jm_file)
    assert len(want) == 3
    # the JAX example's weights: its seeded init (key 0)
    cfg = jm.MixtralConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=2, kv_size_multiplier=2, max_seq_len=32,
                           dtype=jnp.float32, use_flash_attention=False, remat_policy=None,
                           num_experts=4, top_k=2, capacity_factor=2.0)
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jm.MixtralForCausalLM(cfg).init(
        jax.random.key(0), jnp.zeros((4, 32), jnp.int32))))
    params = mixtral_params_from_jax(tree)
    finals = mesh.run_in_threads(8, lambda r: port_example.main(
        ["--tiny", "--log_every", "1", "--device", "cpu", "--metrics_file", pm_file],
        params=params), tensor_model_parallel_size=2, expert_model_parallel_size=2)
    assert len(set(finals)) == 1
    np.testing.assert_allclose(_losses(pm_file), want, rtol=RTOL)


@pytest.fixture(scope="module")
def dbrx_weights():
    ids = jnp.zeros((4, 16), jnp.int32)
    return _fill(jax.eval_shape(lambda: jm.MixtralForCausalLM(jm.dbrx(
        **DBRX, dtype=jnp.float32)).init(jax.random.key(0), ids)), seed=3)


def test_dbrx_shaped_logits_and_step_match_jax(dbrx_weights):
    cfg = tm.dbrx(**DBRX, dtype=torch.float32)
    assert (cfg.norm_type, cfg.norm_bias, cfg.qkv_clip) == ("layernorm", False, 8.0)
    model = tm.MixtralForCausalLM(cfg)
    state = mixtral_params_from_jax(dbrx_weights)
    assert "model.final_norm.ln.scale" in state and not any(k.endswith("ln.bias") for k in state)
    model.load_state_dict(state)
    ids = np.random.RandomState(1).randint(0, 127, (2, 16))
    want = jm.MixtralForCausalLM(jm.dbrx(**DBRX, dtype=jnp.float32)).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, dbrx_weights)}, jnp.asarray(ids))
    got = model(torch.as_tensor(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    degrees = dict(tensor_model_parallel_size=1, expert_model_parallel_size=2)
    over = {k: v for k, v in DBRX.items() if k in ("num_experts", "top_k")}
    over.update(norm_type="layernorm", norm_bias=False, qkv_clip=8.0)
    jtraj = _jax_run(dbrx_weights, degrees, False, True, None, cfg_over=over, steps=1)
    ranks = mesh.run_in_threads(4, lambda r: _port_rank(dbrx_weights, False, True, None,
                                                        cfg_over=over, steps=1), **degrees)
    for rk in ranks:
        np.testing.assert_allclose(np.array(rk["traj"]), np.array(jtraj), rtol=RTOL)


def test_aux_loss_gradient_under_every_remat_policy():
    base = tm.MixtralConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=32, dtype=torch.float32,
                            use_flash_attention=False, num_experts=4, top_k=2)
    params = init_params(base, torch.Generator().manual_seed(0), model_cls=tm.MixtralForCausalLM)
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 63, (2, 16)))
    grads = {}
    for remat in (None, "full", "attention"):
        m = tm.MixtralForCausalLM(dataclasses.replace(base, remat_policy=remat))
        m.load_state_dict(params)
        m.requires_grad_(True)
        with record_aux_losses(m):
            m.loss(ids, ids)
            aux = collect_aux_losses(m)
        assert aux.requires_grad
        aux.backward()
        grads[remat] = torch.stack([layer.moe.router.kernel.grad for layer in m.model.layers])
    assert grads[None].abs().sum() > 0
    for remat in ("full", "attention"):
        torch.testing.assert_close(grads[remat], grads[None], rtol=1e-6, atol=1e-9)


def test_moe_under_cp_pp_and_tp_serving_raises_by_name():
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        neuronx_distributed_config,
    )

    cfg = tm.MixtralConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                           num_heads=4, num_kv_heads=2, max_seq_len=32, dtype=torch.float32,
                           use_flash_attention=False, num_experts=4, top_k=2)
    with torch.device("meta"):   # no group: one rank's whole sequence
        built = tm.MixtralForCausalLM(dataclasses.replace(cfg, context_parallel=True))
    assert all(layer.moe.cp_group is None for layer in built.model.layers)
    with pytest.raises(NotImplementedError, match="pipeline parallelism"):
        PipelinedLlama(cfg, num_stages=2, num_microbatches=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), model_cls=tm.MixtralForCausalLM)
    ids = np.arange(1, 9, dtype=np.int32)[None]
    want = CausalLM(cfg, params, tm.MixtralForCausalLM, buckets=(8,), max_batch=1,
                    device="cpu").generate(ids, max_new_tokens=4).tokens

    def rank(r):
        if mesh.get_context_parallel_size() > 1:
            model = initialize_parallel_model(neuronx_distributed_config(), lambda: (
                tm.MixtralForCausalLM(cfg)), device="cpu")
            cp_group = mesh.get_context_parallel_group()
            for layer in model.module.model.layers:
                assert layer.moe.cp_group is cp_group and layer.moe.experts.cp_group is cp_group
                assert layer.attention.cp_group is cp_group
        else:   # serving under a TP group: the rank's shard, TP=1's tokens
            sd = init_params(cfg, torch.Generator().manual_seed(0),
                             model_cls=tm.MixtralForCausalLM, tp_rank=r, tp_size=2)
            lm = CausalLM(cfg, sd, tm.MixtralForCausalLM, buckets=(8,), max_batch=1,
                          device="cpu")
            np.testing.assert_array_equal(lm.generate(ids, max_new_tokens=4).tokens, want)
        return True

    assert mesh.run_in_threads(2, rank, tensor_model_parallel_size=1,
                               context_parallel_size=2) == [True, True]
    assert mesh.run_in_threads(2, rank) == [True, True]
