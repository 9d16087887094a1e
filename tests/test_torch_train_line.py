"""The port's training line against the JAX package, on the CPU: plain AdamW
(``use_master_weights=False``) against ``optax.adamw``, the ``"attention"``
remat policy against ``"full"`` and none, the single optimizer route of
``make_train_step`` against the reference route, and the examples'
warmup-cosine schedule against optax's.

Tolerances, fp32 on both sides: one optimizer update on the same grads to
2e-7 absolute (a few last places of weights of about 1: optax and the port
compute the same expressions, XLA may fuse them otherwise); the three-step
trajectory of the whole train step as ``test_torch_training.py`` holds it
(losses and grad norms to 1e-5, since Adam divides each gradient by its own
magnitude), the weights after them to 1e-4 (a weight moves by about the
learning rate, 1e-2, a step: a sign error shows); gradients under the remat
policies to 1e-7 within the port (the same operations recomputed) and to
2e-6 against JAX; the schedule to 1e-6 relative (fp32 cosines).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_model as j_initialize_parallel_model,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.examples.common import warmup_cosine_decay
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.optimizer.adamw import adamw
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128)
UPDATE_ATOL = 2e-7
TRAJ_TOL = 1e-5
REMAT_ATOL = 1e-7
GRAD_ATOL = 2e-6


def _batch(b, s, seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s + 1)).astype(np.int32)
    return {"ids": ids[:, :-1], "labels": ids[:, 1:].copy()}


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    tree = meta.unbox(jl.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 8), jnp.int32)))["params"]
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(state, cfg=None, **over):
    lcfg = tl.LlamaConfig(**{**TINY, **over}, dtype=torch.float32)
    return initialize_parallel_model(cfg or neuronx_distributed_config(),
                                     lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                     params=state)


def _loss_fn(model):
    return lambda p, b, rng: model.apply(p, torch.as_tensor(b["ids"]),
                                         torch.as_tensor(b["labels"]), method="loss")


@pytest.mark.parametrize("schedule", [False, True])
def test_plain_adamw_update_matches_optax(schedule):
    """Three updates of ``adamw`` on the same fp32 grads as optax.adamw
    (constant and scheduled learning rate): the params agree leaf for leaf."""
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "e": (4, 3, 5)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) * 0.1 for n, s in shapes.items()}
             for _ in range(3)]
    lr_j = optax.linear_schedule(1e-2, 1e-3, 3) if schedule else 1e-2
    lr_t = (lambda c: 1e-2 + (1e-3 - 1e-2) * torch.clamp(c.float(), 0, 3) / 3
            ) if schedule else 1e-2
    tx_j = optax.adamw(lr_j, weight_decay=0.05)
    tx_t = adamw(lr_t, weight_decay=0.05)
    pj = {n: jnp.asarray(p) for n, p in params.items()}
    pt = {n: torch.tensor(p) for n, p in params.items()}
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for g in grads:
        uj, sj = tx_j.update({n: jnp.asarray(x) for n, x in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, uj)
        pt, st = tx_t.update_and_params({n: torch.tensor(x) for n, x in g.items()}, st, pt)
    assert int(st.count) == 3
    for n in shapes:
        np.testing.assert_allclose(pt[n].numpy(), np.asarray(pj[n]), atol=UPDATE_ATOL, rtol=0,
                                   err_msg=n)


def _jax_run(params, batch, steps, lr, master):
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    cfg = j_config(optimizer_config={"zero_one_enabled": False, "grad_clipping": True,
                                     "max_grad_norm": 1.0},
                   mixed_precision_config={"use_master_weights": master})
    model = j_initialize_parallel_model(cfg, lambda: jl.LlamaForCausalLM(jcfg),
                                        jnp.asarray(batch["ids"]))
    model = dataclasses.replace(model, params=jax.device_put(
        jax.tree_util.tree_map(jnp.array, params), model.param_shardings()))
    opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=lr, weight_decay=0.01)

    def loss_fn(p, b, rng):
        return model.module.apply({"params": p}, b["ids"], b["labels"],
                                  method=jl.LlamaForCausalLM.loss)

    state = j_create_train_state(model, opt)
    step = j_make_train_step(model, opt, loss_fn)
    out = []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(steps):
        state, m = step(state, jb, jax.random.key(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    final = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    ps.destroy_model_parallel()
    return out, final


def test_plain_adamw_train_steps_match_jax(jax_params):
    """``use_master_weights=False`` on both sides (optax.adamw in JAX, the
    port's plain AdamW): three clipped steps give the same losses, grad
    norms and weights; the state holds mu and nu only."""
    batch = _batch(8, 128, seed=1)   # the JAX mesh's 8 data ranks divide it
    want, want_params = _jax_run(jax_params, batch, steps=3, lr=1e-2, master=False)
    cfg = neuronx_distributed_config(
        optimizer_config={"zero_one_enabled": False, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": False})
    model = _port_model(llama_params_from_jax(jax_params), cfg)
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-2, weight_decay=0.01)
    state = create_train_state(model, opt)
    assert type(state.opt_state).__name__ == "AdamState"
    step = make_train_step(model, opt, _loss_fn(model))
    got = []
    for _ in range(3):
        state, m = step(state, batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert got[-1][0] < got[0][0]
    worst = max(float((state.params[n] - want_params[n]).abs().max()) for n in want_params)
    assert worst < 1e-4, worst


def _grads(model, batch):
    loss = _loss_fn(model)(model.params, batch, None)
    names = [n for n, _ in model.module.named_parameters()]
    g = torch.autograd.grad(loss, [p for _, p in model.module.named_parameters()])
    return float(loss.detach()), dict(zip(names, g))


def test_attention_remat_gives_the_gradients_and_recomputes_b1(jax_params, monkeypatch):
    """``"attention"`` saves the projection GEMMs' outputs and recomputes the
    rest, the flash forward included: the gradients equal ``"full"``'s and
    no remat's, the flash twin runs twice a layer under both policies (once
    without), and the port under ``"attention"`` matches JAX's
    ``dots_with_no_batch_dims_saveable``."""
    state = llama_params_from_jax(jax_params)
    batch = _batch(2, 128, seed=5)
    calls = []
    real = tfa.flash_block_forward_plain
    monkeypatch.setattr(tfa, "flash_block_forward_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs, per_layer = {}, {}
    for policy in (None, "full", "attention"):
        calls.clear()
        runs[policy] = _grads(_port_model(state, remat_policy=policy), batch)
        per_layer[policy] = len(calls) / TINY["num_layers"]
    assert per_layer == {None: 1.0, "full": 2.0, "attention": 2.0}
    for policy in ("full", "attention"):
        assert runs[policy][0] == runs[None][0]
        for n, g in runs[None][1].items():
            np.testing.assert_allclose(runs[policy][1][n].numpy(), g.numpy(), atol=REMAT_ATOL,
                                       err_msg=f"{policy} {n}")

    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy="attention")

    def jloss(p):
        return jl.LlamaForCausalLM(jcfg).apply({"params": p}, jnp.asarray(batch["ids"]),
                                               jnp.asarray(batch["labels"]),
                                               method=jl.LlamaForCausalLM.loss)

    want_loss, want_grads = jax.value_and_grad(jloss)(jax_params)
    want = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    np.testing.assert_allclose(runs["attention"][0], float(want_loss), atol=1e-5)
    for n, g in runs["attention"][1].items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=GRAD_ATOL, err_msg=n)


def test_single_route_equals_the_reference_route_in_bf16():
    """``make_train_step`` updates through ``update_and_params_local`` (the
    kernel's twin on leaves of 8192 elements and more, the plain formula on
    the rest); with bf16 params it writes the same bits as the reference
    route ``update_and_params``."""
    lcfg = tl.LlamaConfig(**{**TINY, "vocab_size": 256}, dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16)
    init = tl.init_params(lcfg, torch.Generator().manual_seed(4))
    batch = _batch(2, 128, seed=6)
    batch["ids"] = batch["ids"] * 2
    out = []
    for reference in (False, True):
        cfg = neuronx_distributed_config()
        model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                          params=init)
        opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-2)
        if reference:
            opt = dataclasses.replace(opt, tx=opt.tx._replace(
                update_and_params_local=opt.tx.update_and_params))
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, _loss_fn(model))
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out.append((losses, state.params))
    assert out[0][0] == out[1][0]
    for n, p in out[0][1].items():
        assert torch.equal(p, out[1][1][n]), n


def test_warmup_cosine_schedule_matches_optax():
    """The examples' ``--warmup_steps`` schedule is optax's
    ``warmup_cosine_decay_schedule``, on host ints and device tensors."""
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 40, end_value=3e-5)
    got = warmup_cosine_decay(0.0, 3e-4, 5, 40, end_value=3e-5)
    for c in list(range(0, 45, 3)) + [5, 40]:
        np.testing.assert_allclose(float(got(c)), float(want(c)), rtol=1e-6, atol=1e-12)
        assert float(got(torch.tensor(c, dtype=torch.int32))) == float(got(c))
