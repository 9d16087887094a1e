"""LoRA fine-tuning in the port against the JAX package's, on the CPU.

A tiny fp32 Llama (2 layers, 128 tokens: the flash gate is taken, the
Pallas kernels in interpret mode on the JAX side, the twins here) with
rank-4 adapters on the five default targets. Both sides start from the same
base and the same adapters (B drawn nonzero, so A has a gradient from the
first step). JAX trains through ``make_train_step`` with ``lora_config``
(dropout 0: the adapters merged into the weights; dropout > 0: the attached
in-activation form); the port always adds the in-activation correction,
and at dropout > 0 is fed the keep-masks ``jax.random.bernoulli`` drew for
each JAX layer's key.

Tolerances, fp32 on both sides: the loss to 1e-5 (summation order); each
adapter gradient to 2e-6 absolute plus 1e-4 of its value (the merged and
the in-activation forms sum the same products in another order; gradients
reach about 0.05); the adapters after one and three Adam steps to 2e-5 (a
step moves an element by about the learning rate, 1e-3: a gradient of the
other sign would put it 2e-3 off); the merged HF export to 1e-6 (one fp32
matmul of a rank-4 product).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from neuronx_distributed_tpu.lora.core import (
    LoraConfig as JLoraConfig,
    attach_adapters as j_attach_adapters,
    export_merged_hf as j_export_merged_hf,
    merge_lora as j_merge_lora,
)
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_model as j_initialize_parallel_model,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu_torch.converters.jax_params import (
    _FLAX_KEY,
    _LAYER_LEAVES,
    llama_params_from_jax,
    lora_params_from_jax,
)
from neuronx_distributed_tpu_torch.lora.core import (
    LoraConfig,
    export_merged_hf,
    flat_lora,
    nest_lora,
)
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128)
LORA = dict(r=4, lora_alpha=8.0)
LR = 1e-3
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-4
ADAPTER_TOL = 2e-5
EXPORT_TOL = 1e-6
OPT = {"zero_one_enabled": False, "grad_clipping": True, "max_grad_norm": 1.0}


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (8, 129)).astype(np.int32)
    return {"ids": ids[:, :-1], "labels": ids[:, 1:].copy()}


def _jax_model(dropout, batch):
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    cfg = j_config(optimizer_config=OPT, mixed_precision_config={"use_master_weights": True},
                   lora_config=JLoraConfig(**LORA, lora_dropout=dropout))
    model = j_initialize_parallel_model(cfg, lambda: jl.LlamaForCausalLM(jcfg),
                                        jnp.asarray(batch["ids"]))
    return cfg, jcfg, model


@pytest.fixture(scope="module")
def start():
    """The shared base and adapters (numpy), from JAX's own inits; each B
    redrawn nonzero from a seeded numpy stream."""
    batch = _batch(0)
    _, _, model = _jax_model(0.0, batch)
    base = jax.tree_util.tree_map(np.asarray, model.params)
    rng = np.random.default_rng(1)
    lora = {p: {"lora_a": np.asarray(ad["lora_a"]),
                "lora_b": (rng.normal(size=ad["lora_b"].shape) * 0.1).astype(np.float32)}
            for p, ad in model.lora_params.items()}
    ps.destroy_model_parallel()
    return base, lora


def _jax_masks(lora, drop_rng, keep, batch):
    """The keep-masks JAX's attached layers draw under ``drop_rng``, by the
    port's weight name (JAX ``lora/core.py:163-186``, ``layers.py:75``)."""
    b, s = batch["ids"].shape
    width = {"down_proj": TINY["intermediate_size"]}   # o_proj's heads x head_dim = hidden
    out = {}
    for i, path in enumerate(sorted(lora)):
        parts = tuple(_FLAX_KEY.findall(path))
        name = _LAYER_LEAVES[parts[3:]]
        fan_in = width.get(parts[-2], TINY["hidden_size"])
        keys = jax.random.split(jax.random.fold_in(drop_rng, i), TINY["num_layers"])
        for layer in range(TINY["num_layers"]):
            m = jax.random.bernoulli(keys[layer], jnp.float32(keep), (b, s, fan_in))
            out[f"model.layers.{layer}.{name}"] = torch.from_numpy(np.array(m))
    return out


def _port_model(base, lora, dropout, remat_policy=None):
    lcfg = tl.LlamaConfig(**TINY, dtype=torch.float32, remat_policy=remat_policy)
    cfg = neuronx_distributed_config(optimizer_config=OPT,
                                     mixed_precision_config={"use_master_weights": True},
                                     lora_config=LoraConfig(**LORA, lora_dropout=dropout))
    model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                      params=llama_params_from_jax(base))
    model.bind_trainable(flat_lora(lora_params_from_jax(lora, model.lora_config)))
    return cfg, model


def _loss_fn(model):
    return lambda p, b, rng: model.apply(p, torch.as_tensor(b["ids"]),
                                         torch.as_tensor(b["labels"]), method="loss")


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_lora_steps_match_jax(start, dropout):
    """Loss and every adapter gradient of the first step, then the losses,
    grad norms and adapters after one and three steps, equal JAX's; the
    base stays bit for bit what it was; only adapters carry optimizer
    state."""
    base, lora = start
    batch = _batch(2)
    keep = 1.0 - dropout

    # JAX: gradients of the first step, then three steps
    cfg, jcfg, jmodel = _jax_model(dropout, batch)
    jmodel = dataclasses.replace(
        jmodel, params=jax.device_put(jax.tree_util.tree_map(jnp.array, base),
                                      jmodel.param_shardings()),
        lora_params=jax.device_put(jax.tree_util.tree_map(jnp.array, lora),
                                   jmodel.trainable_shardings()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lcfg = jmodel.lora_config

    def jloss(lt, rng):
        drop_rng, _ = jax.random.split(rng)
        p = (j_attach_adapters(jmodel.params, lt, lcfg, drop_rng) if dropout
             else j_merge_lora(jmodel.params, lt, lcfg))
        return jmodel.module.apply({"params": p}, jb["ids"], jb["labels"],
                                   method=jl.LlamaForCausalLM.loss)

    want_loss, want_grads = jax.value_and_grad(jloss)(jmodel.lora_params, jax.random.key(0))
    want_grads = flat_lora(lora_params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads),
                                                LoraConfig(**LORA)))
    opt = j_initialize_parallel_optimizer(cfg, jmodel, learning_rate=LR, weight_decay=0.01)

    def loss_fn(p, b, rng):
        return jmodel.module.apply({"params": p}, b["ids"], b["labels"],
                                   method=jl.LlamaForCausalLM.loss)

    state = j_create_train_state(jmodel, opt)
    step = j_make_train_step(jmodel, opt, loss_fn)
    want, want_adapters = [], []
    for i in range(3):
        state, m = step(state, jb, jax.random.key(i))
        want.append((float(m["loss"]), float(m["grad_norm"])))
        want_adapters.append(flat_lora(lora_params_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params), LoraConfig(**LORA))))
    ps.destroy_model_parallel()

    masks = [_jax_masks(lora, jax.random.split(jax.random.key(i))[0], keep, batch)
             if dropout else None for i in range(3)]

    # the port: the same first-step gradients, then the same three steps
    cfg_t, model = _port_model(base, lora, dropout)
    frozen = {n: p.clone() for n, p in model.params.items()}
    if dropout:
        model.lora_dropout.use_masks(masks[0])
    leaves = model.trainable_leaves()
    loss = _loss_fn(model)(model.params, batch, None)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=LOSS_TOL)
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=n)
        assert float(g.abs().max()) > 0, n

    opt_t = initialize_parallel_optimizer(cfg_t, model, learning_rate=LR, weight_decay=0.01)
    st = create_train_state(model, opt_t)
    assert set(st.opt_state.master) == set(leaves)
    step_t = make_train_step(model, opt_t, _loss_fn(model))
    got = []
    for i in range(3):
        st, m = step_t(st, batch, lora_masks=masks[i])
        got.append((float(m["loss"]), float(m["grad_norm"])))
        if i in (0, 2):
            for n, a in st.params.items():
                np.testing.assert_allclose(a.numpy(), want_adapters[i][n].numpy(),
                                           atol=ADAPTER_TOL, err_msg=f"step {i + 1} {n}")
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got[-1][0] < got[0][0]
    for n, p in model.params.items():
        assert torch.equal(p, frozen[n]), n
        assert p.grad is None and not p.requires_grad, n


def test_dropout_masks_drawn_from_the_state_generator_repeat_under_remat(start):
    """Without given masks each step draws one seed per adapter from
    ``state.rng``: two runs from equal states give the same bits, the
    checkpointed layer recomputes the same masks (its gradients equal the
    unchecked model's), and the next step's masks differ."""
    base, lora = start
    batch = _batch(3)
    runs = {}
    for policy in (None, "full", "attention"):
        _, model = _port_model(base, lora, 0.25, remat_policy=policy)
        cfg = neuronx_distributed_config(optimizer_config=OPT)
        opt = initialize_parallel_optimizer(cfg, model, learning_rate=LR)
        st = create_train_state(model, opt)
        step = make_train_step(model, opt, _loss_fn(model))
        losses = []
        for _ in range(2):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
        runs[policy] = (losses, st.params)
    for policy in ("full", "attention"):
        assert runs[policy][0] == runs[None][0], policy
        for n, a in runs[None][1].items():
            np.testing.assert_allclose(runs[policy][1][n].numpy(), a.numpy(), atol=1e-7,
                                       err_msg=f"{policy} {n}")
    seeds = []
    _, model = _port_model(base, lora, 0.25)
    g = torch.Generator().manual_seed(5)
    for _ in range(2):
        model.lora_dropout.draw(g, sorted(model.lora_specs))
        seeds.append(dict(model.lora_dropout.seeds))
    assert seeds[0] != seeds[1] and len(set(seeds[0].values())) == len(seeds[0])


def test_export_merged_hf_and_specs_equal_jax(start, tmp_path):
    """``export_merged_hf`` writes JAX's tensors, name for name, and
    ``lora_param_specs`` gives each adapter JAX's spec without the stacked
    layer axis; ``merged_params`` equals the weight-space merge."""
    base, lora = start
    batch = _batch(0)
    _, jcfg, jmodel = _jax_model(0.0, batch)
    jlora = jax.tree_util.tree_map(jnp.asarray, lora)
    jpath = j_export_merged_hf(jax.tree_util.tree_map(jnp.asarray, base), jlora,
                               jmodel.lora_config, jcfg, str(tmp_path / "jax"))
    jspecs = jmodel.lora_specs
    ps.destroy_model_parallel()
    _, model = _port_model(base, lora, 0.0)
    tcfg = model.module.config
    tpath = export_merged_hf(model.params, nest_lora(model.trainable_params), model.lora_config,
                             tcfg, str(tmp_path / "port"))
    want, got = load_file(jpath), load_file(tpath)
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=EXPORT_TOL, err_msg=n)
    # the merged state dict is what the export wrote, before the HF renaming
    merged = model.merged_params()
    changed = [n for n, p in merged.items() if not torch.equal(p, model.params[n])]
    assert len(changed) == 7 * TINY["num_layers"]
    for path, spec in jspecs.items():
        name = _LAYER_LEAVES[tuple(_FLAX_KEY.findall(path))[3:]]
        for layer in range(TINY["num_layers"]):
            ours = model.lora_specs[f"model.layers.{layer}.{name}"]
            for k in ("lora_a", "lora_b"):
                assert ours[k] == tuple(spec[k])[1:], (path, k)
    assert model.trainable_specs["model.layers.0.attention.qkv.q_kernel.lora_b"] == (None, "tp")
