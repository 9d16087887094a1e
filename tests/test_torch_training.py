"""The port's training path against the JAX package, on the CPU.

A seeded flax init of a tiny fp32 Llama (2 layers, 128 tokens, so the flash
gate is taken: the Pallas kernels in interpret mode on the JAX side, the
forward and backward twins here) is carried over with
``llama_params_from_jax``. The loss and every parameter gradient are held
against ``jax.value_and_grad`` of ``LlamaForCausalLM.loss`` (JAX's gradient
tree mapped by name through the same converter), and three steps of the
port's ``make_train_step`` against JAX's at TP = 1, ZeRO off, clipping on.
Then the port against itself: the optimizer kernel route, gradient
accumulation, the chunked loss and activation checkpointing.

Tolerances, fp32 on both sides: the loss to 1e-5; gradients (largest about
0.3) to 2e-6 absolute, the summation order of two frameworks; the
trajectory to 1e-5 (Adam divides each gradient by its own magnitude, so a
sub-ulp difference in a near-zero gradient can move a weight by up to the
learning rate, and the loss by far less).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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
from neuronx_distributed_tpu_torch.kernels import flash_attn as tfa
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128)
LOSS_TOL = 1e-5
GRAD_ATOL = 2e-6
TRAJ_TOL = 1e-5


def _batch(b, s, seed, ignore=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, s + 1)).astype(np.int32)
    labels = ids[:, 1:].copy()
    if ignore:
        labels[0, -ignore:] = -100
    return {"ids": ids[:, :-1], "labels": labels}


def _jax_params(jcfg):
    return meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]


def _port_model(params, convert=True, **over):
    """The port's model on ``params``: a flax tree of numpy arrays
    (``convert``) or a state dict."""
    cfg = tl.LlamaConfig(**{**TINY, **over}, dtype=torch.float32)
    return initialize_parallel_model(
        neuronx_distributed_config(), lambda: tl.LlamaForCausalLM(cfg), device="cpu",
        params=llama_params_from_jax(params) if convert else params)


def _port_loss_fn(model):
    def loss_fn(params, batch, rng):
        return model.apply(params, torch.as_tensor(batch["ids"]),
                           torch.as_tensor(batch["labels"]), method="loss")
    return loss_fn


def _grads(model, batch):
    loss = _port_loss_fn(model)(model.params, batch, None)
    names = [n for n, _ in model.module.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.module.named_parameters()])
    return float(loss.detach()), dict(zip(names, grads))


def test_loss_and_every_gradient_match_jax(monkeypatch):
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    params = _jax_params(jcfg)
    batch = _batch(2, 128, seed=0, ignore=9)

    def jloss(p):
        return jl.LlamaForCausalLM(jcfg).apply({"params": p}, jnp.asarray(batch["ids"]),
                                               jnp.asarray(batch["labels"]),
                                               method=jl.LlamaForCausalLM.loss)

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    want = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))

    calls = []
    real = tfa.flash_bwd_dq_plain
    monkeypatch.setattr(tfa, "flash_bwd_dq_plain",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    model = _port_model(jax.tree_util.tree_map(np.asarray, params))
    loss, got = _grads(model, batch)
    assert calls == [(2 * 4, 128, 8)] * TINY["num_layers"]   # the backward twin ran
    np.testing.assert_allclose(loss, float(want_loss), atol=LOSS_TOL)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL, err_msg=name)
        assert float(g.abs().max()) > 0.0, name


def _jax_trajectory(jcfg, params, batch, steps, lr):
    cfg = j_config(optimizer_config={"zero_one_enabled": False, "grad_clipping": True,
                                     "max_grad_norm": 1.0},
                   mixed_precision_config={"use_master_weights": True})
    ids = jnp.asarray(batch["ids"])
    model = j_initialize_parallel_model(cfg, lambda: jl.LlamaForCausalLM(jcfg), ids)
    model = dataclasses.replace(model, params=jax.device_put(params, model.param_shardings()))
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
    ps.destroy_model_parallel()
    return out


def _port_run(params, batch, steps, lr, optimizer_kernel=False, grad_accum_steps=1,
              convert=True, **over):
    cfg = neuronx_distributed_config(
        optimizer_config={"zero_one_enabled": False, "grad_clipping": True,
                          "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = _port_model(params, convert, **over)
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=lr, weight_decay=0.01)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, _port_loss_fn(model), grad_accum_steps=grad_accum_steps,
                           optimizer_kernel=optimizer_kernel)
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state, model


def test_train_step_trajectory_matches_jax():
    """Three steps at TP = 1 with ZeRO off and clipping on: losses and grad
    norms track JAX's, the loss falls, and the module's own weights are the
    state's params."""
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    params_np = jax.tree_util.tree_map(np.asarray, _jax_params(jcfg))
    batch = _batch(8, 128, seed=1)
    # the JAX step donates its state: it gets its own copy of the weights
    want = _jax_trajectory(jcfg, jax.tree_util.tree_map(jnp.array, params_np), batch, steps=3,
                           lr=1e-2)
    got, state, model = _port_run(params_np, batch, steps=3, lr=1e-2)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert got[-1][0] < got[0][0]
    assert int(state.step) == 3
    for name, p in model.module.named_parameters():
        assert p.data_ptr() == state.params[name].data_ptr(), name


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, remat_policy=None)
    return jax.tree_util.tree_map(np.asarray, _jax_params(jcfg))


def test_optimizer_kernel_route_equals_plain_route(monkeypatch):
    """``optimizer_kernel=True`` sends the leaves of 8192 elements or more
    (here the embedding and the head, at vocab 256) through
    ``fused_adamw_leaf`` (its twin here) and the rest through the plain
    formula; the two routes round the same way, so the params agree bit for
    bit."""
    from neuronx_distributed_tpu_torch.optimizer import adamw

    params = tl.init_params(tl.LlamaConfig(**{**TINY, "vocab_size": 256}, dtype=torch.float32),
                            torch.Generator().manual_seed(1))
    batch = _batch(2, 128, seed=2)
    calls = []
    real = adamw.fused_adamw_leaf
    monkeypatch.setattr(adamw, "fused_adamw_leaf",
                        lambda g, *a, **k: calls.append(g.numel()) or real(g, *a, **k))
    runs = [_port_run(params, batch, steps=2, lr=1e-2, optimizer_kernel=k, vocab_size=256,
                      convert=False) for k in (False, True)]
    assert calls == [256 * 32] * 4      # embedding and head, two steps, kernel route only
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].params.items():
        np.testing.assert_array_equal(p.numpy(), runs[1][1].params[n].numpy(), err_msg=n)


def test_grad_accum_matches_full_batch(tiny_params):
    """Two microbatches with every label valid give the full batch's mean
    loss and gradients, so one update lands on the same params."""
    batch = _batch(8, 128, seed=3)
    full = _port_run(tiny_params, batch, steps=1, lr=1e-2)
    acc = _port_run(tiny_params, batch, steps=1, lr=1e-2, grad_accum_steps=2)
    np.testing.assert_allclose(acc[0][0][0], full[0][0][0], rtol=1e-6)
    worst = max(float((acc[1].params[n] - p).abs().max()) for n, p in full[1].params.items())
    assert worst < 1e-5, worst


def test_chunked_loss_equals_unchunked(tiny_params):
    """Past ``loss_chunk_size`` the head and CE run per chunk (a short last
    chunk here: 48 + 48 + 32) under checkpointing; loss and gradients equal
    the whole-sequence path's."""
    batch = _batch(2, 128, seed=4, ignore=20)
    whole = _grads(_port_model(tiny_params), batch)
    chunked = _grads(_port_model(tiny_params, loss_chunk_size=48), batch)
    np.testing.assert_allclose(chunked[0], whole[0], rtol=1e-6)
    for n, g in whole[1].items():
        np.testing.assert_allclose(chunked[1][n].numpy(), g.numpy(), atol=1e-7, err_msg=n)


def test_full_remat_gives_the_same_gradients():
    """``remat_policy="full"`` recomputes each layer in the backward: the
    gradients equal those of ``None``; ``"attention"`` is not ported and
    says so; serving (no grad) never checkpoints."""
    params = tl.init_params(tl.LlamaConfig(**TINY, dtype=torch.float32),
                            torch.Generator().manual_seed(0))
    batch = _batch(2, 128, seed=5)
    grads = {}
    for policy in ("full", None):
        grads[policy] = _grads(_port_model(params, False, remat_policy=policy), batch)[1]
    for n, g in grads[None].items():
        np.testing.assert_allclose(grads["full"][n].numpy(), g.numpy(), atol=1e-7, err_msg=n)
    m = _port_model(params, False, remat_policy="attention")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.module.loss(torch.as_tensor(batch["ids"]), torch.as_tensor(batch["labels"]))
    with torch.no_grad():
        assert m.module(torch.as_tensor(batch["ids"])).shape == (2, 128, TINY["vocab_size"])


def test_initialize_parallel_model_config_and_refusals():
    """Explicit mixed-precision keys and the activation-checkpoint config
    reach the model config; the seeded init is reproducible; parallel
    degrees above 1 and the plain-AdamW optimizer raise."""
    cfg = neuronx_distributed_config(
        mixed_precision_config={"param_dtype": "bfloat16"},
        activation_checkpoint_config=None, model_init_config={"seed": 7})
    make = lambda: tl.LlamaForCausalLM(tl.LlamaConfig(**TINY, dtype=torch.float32))  # noqa: E731
    a = initialize_parallel_model(cfg, make, device="cpu")
    b = initialize_parallel_model(cfg, make, device="cpu")
    assert a.module.config.param_dtype == torch.bfloat16
    assert a.module.config.dtype == torch.float32          # not set explicitly: kept
    assert all(p.dtype == torch.bfloat16 and p.requires_grad for p in a.module.parameters())
    assert all(torch.equal(a.params[n], b.params[n]) for n in a.params)
    remat = initialize_parallel_model(
        neuronx_distributed_config(activation_checkpoint_config="full"),
        lambda: tl.LlamaForCausalLM(tl.LlamaConfig(**TINY, remat_policy=None)), device="cpu")
    assert remat.module.config.remat_policy == "full"
    with pytest.raises(NotImplementedError, match="later slice"):
        initialize_parallel_model(neuronx_distributed_config(tensor_parallel_size=2), make,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="use_master_weights=False"):
        initialize_parallel_optimizer(
            neuronx_distributed_config(mixed_precision_config={"use_master_weights": False}), a)
