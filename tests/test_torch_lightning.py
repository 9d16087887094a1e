"""The port's managed fit loop (``neuronx_distributed_tpu_torch/lightning``)
against the JAX package's, on the CPU.

The same tiny fp32 Llama (the JAX weights carried across with
``llama_params_from_jax``) and the same seeded numpy batches go through
JAX's ``NxDTrainer.fit`` (TP 2 x DP 4 with ZeRO-1 on the 8-device mesh) and
the port's (one rank): the logged steps are ``[1, 2, 3, 4]`` and every loss
lies within ``RTOL`` of JAX's, straight and with ``grad_accum_steps=2``
(``optax.MultiSteps`` there, ``optimizer/multi_steps.py`` here). The
wrapper alone is held against ``optax.MultiSteps`` over the JAX package's
fp32-master AdamW at k = 2 and 3, params after every microstep, also across
a checkpoint taken at an odd microstep. Within the port: a checkpoint
resume, a ``TokenShardDataset`` seek and a SIGTERM preemption each land on
the straight run's params bit for bit, and the accumulator shards as the
moments under ZeRO-1 over two data-parallel thread ranks.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.lightning import (
    Callback,
    JsonLogger,
    ModelCheckpoint,
    NxDLightningModule,
    NxDTrainer,
    ProgressLogger,
    TensorBoardLogger,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.optimizer.adamw import adamw_fp32_master
from neuronx_distributed_tpu_torch.optimizer.multi_steps import MultiStepsState, multi_steps
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import neuronx_distributed_config

RTOL = 1e-4   # fp32 losses after Adam steps: reduction order differs (TP 2 x DP 4 vs one rank)
TOL = 1e-6    # the MultiSteps wrapper against optax's, fp32 params
DIMS = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=32, use_flash_attention=False, remat_policy=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TinyLlamaModule(NxDLightningModule):
    def __init__(self, **kw):
        super().__init__(neuronx_distributed_config(
            tensor_parallel_size=1, optimizer_config={"zero_one_enabled": True}),
            learning_rate=3e-3, weight_decay=0.0, **kw)

    def configure_model(self):
        return LlamaForCausalLM(LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                                            **DIMS))

    def model_inputs(self, batch):
        return (batch["ids"],)

    def training_loss(self, model, params, batch, rng):
        return model.apply(params, batch["ids"], batch["labels"], method="loss")


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    while True:
        yield {"ids": rs.randint(0, 127, (4, 16)).astype(np.int32),
               "labels": rs.randint(0, 127, (4, 16)).astype(np.int32)}


def _jax_module(**kw):
    from neuronx_distributed_tpu.lightning import NxDLightningModule as JaxModule
    from neuronx_distributed_tpu.models.llama import LlamaConfig as JCfg
    from neuronx_distributed_tpu.models.llama import LlamaForCausalLM as JLlama
    from neuronx_distributed_tpu.trainer import neuronx_distributed_config as jconfig

    class Tiny(JaxModule):
        def configure_model(self):
            return JLlama(JCfg(dtype=jnp.float32, **DIMS))

        def model_inputs(self, batch):
            return (batch["ids"],)

        def training_loss(self, model, params, batch, rng):
            return model.module.apply({"params": params}, batch["ids"], batch["labels"],
                                      method=JLlama.loss)

    return Tiny(jconfig(tensor_parallel_size=2, optimizer_config={"zero_one_enabled": True}),
                learning_rate=3e-3, weight_decay=0.0, **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's fit, straight (with logger and validation) and with
    ``grad_accum_steps=2``: the logged records, and the initial weights in
    the port's names."""
    from neuronx_distributed_tpu.lightning import JsonLogger as JLogger
    from neuronx_distributed_tpu.lightning import NxDTrainer as JTrainer
    from neuronx_distributed_tpu.parallel import mesh as jmesh
    from neuronx_distributed_tpu.trainer import initialize_parallel_model

    out = {}
    module = _jax_module()
    sample = next(_batches())
    model = initialize_parallel_model(module.nxd_config, module.configure_model, sample["ids"])
    out["params"] = llama_params_from_jax(jax.tree.map(lambda a: np.array(a), model.params))
    for name, kw in (("straight", {}), ("accum", {"grad_accum_steps": 2})):
        jmesh.destroy_model_parallel()
        log_dir = tmp_path_factory.mktemp(f"jax_{name}")
        logger = JLogger(str(log_dir))
        trainer = JTrainer(max_steps=4, logger_=logger, val_every_n_steps=2, val_steps=1)
        trainer.fit(_jax_module(**kw), _batches(), _batches(99))
        out[name] = [json.loads(line) for line in open(logger.path)]
    jmesh.destroy_model_parallel()
    return out


def _params(state):
    return {n: t.clone() for n, t in state.params.items()}


def _assert_equal(a, b):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("name", ["straight", "accum"])
def test_fit_losses_equal_jax(name, jax_runs, tmp_path):
    accum = name == "accum"
    logger = JsonLogger(str(tmp_path))
    seen = []

    class Watch(Callback):
        def on_step_end(self, trainer, module, step, metrics):
            seen.append(_params(trainer.state))

    trainer = NxDTrainer(max_steps=4, logger_=logger, val_every_n_steps=2, val_steps=1,
                         callbacks=[ProgressLogger(every_n_steps=2), Watch()], device="cpu")
    state, metrics = trainer.fit(TinyLlamaModule(grad_accum_steps=2 if accum else 1),
                                 _batches(), _batches(99), params=jax_runs["params"])
    assert int(state.step) == 4 and np.isfinite(float(metrics["loss"]))
    ours = [json.loads(line) for line in open(logger.path)]
    theirs = jax_runs[name]
    assert [r["step"] for r in ours if "loss" in r] == [1, 2, 3, 4]
    for key in ("loss", "val_loss"):
        got = [r[key] for r in ours if key in r]
        want = [r[key] for r in theirs if key in r]
        assert len(got) == len(want) > 0, key
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=key)
    init = {n: torch.as_tensor(v) for n, v in jax_runs["params"].items()}
    moved = [not all(torch.equal(a[n], b[n]) for n in a) for a, b in zip([init] + seen, seen)]
    assert moved == ([False, True, False, True] if accum else [True] * 4)
    if accum:
        assert isinstance(state.opt_state, MultiStepsState)
        assert (state.opt_state.mini_step, state.opt_state.gradient_step) == (0, 2)
        assert int(state.opt_state.inner_opt_state.count) == 2


def _optax_params(k, params, grads_seq):
    from neuronx_distributed_tpu.optimizer.adamw import adamw_fp32_master as jadamw

    tx = optax.MultiSteps(jadamw(1e-2, weight_decay=0.1), every_k_schedule=k)
    p = {n: jnp.asarray(v) for n, v in params.items()}
    st = tx.init(p)
    out = []
    for g in grads_seq:
        upd, st = tx.update({n: jnp.asarray(v) for n, v in g.items()}, st, p)
        p = optax.apply_updates(p, upd)
        out.append({n: np.asarray(v) for n, v in p.items()})
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_multi_steps_equals_optax(k, tmp_path):
    from neuronx_distributed_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    rs = np.random.RandomState(k)
    params = {"w": rs.randn(64, 128).astype(np.float32), "b": rs.randn(96).astype(np.float32)}
    grads_seq = [{n: rs.randn(*v.shape).astype(np.float32) for n, v in params.items()}
                 for _ in range(2 * k + 1)]
    want = _optax_params(k, params, grads_seq)
    tx = multi_steps(adamw_fp32_master(1e-2, weight_decay=0.1), k)
    p = {n: torch.tensor(v) for n, v in params.items()}
    st = tx.init(p)
    cut = 3   # an odd microstep: inside the window at k = 2 and 3 alike
    for i, g in enumerate(grads_seq):
        if i == cut:   # a checkpoint mid-window, restored into a fresh state
            save_checkpoint(str(tmp_path), "mid", {"p": p, "opt": st})
            fresh = multi_steps(adamw_fp32_master(1e-2, weight_decay=0.1), k)
            restored, _ = load_checkpoint(str(tmp_path), "mid", target={
                "p": {n: torch.zeros_like(v) for n, v in p.items()},
                "opt": fresh.init({n: torch.zeros_like(v) for n, v in p.items()})})
            p, st, tx = restored["p"], restored["opt"], fresh
            assert st.mini_step == cut % k
        p, st = tx.update_and_params_local({n: torch.tensor(v) for n, v in g.items()}, st, p,
                                           out=p)
        for n in p:
            np.testing.assert_allclose(p[n].numpy(), want[i][n], rtol=TOL, atol=TOL,
                                       err_msg=f"microstep {i} {n}")
    assert st.gradient_step == len(grads_seq) // k


def test_multi_steps_accumulator_shards_like_the_moments():
    def rank(r):
        module = TinyLlamaModule(grad_accum_steps=2)
        trainer = NxDTrainer(max_steps=2, device="cpu")
        rows = mesh.data_batch_slice(4)
        batches = ({k: v[rows] for k, v in b.items()} for b in _batches())
        state, _ = trainer.fit(module, batches)
        inner = state.opt_state.inner_opt_state
        assert trainer.optimizer.zero1_plan.dp == 2
        shapes = {n: (tuple(a.shape), tuple(inner.mu[n].shape))
                  for n, a in state.opt_state.acc_grads.items()}
        full = {n: tuple(p.shape) for n, p in state.params.items()}
        assert state.layout is not None and all(
            f".opt_state.acc_grads['{n}']" in state.layout for n in full)
        return shapes, full

    for shapes, full in mesh.run_in_threads(2, rank, tensor_model_parallel_size=1):
        assert all(a == m for a, m in shapes.values())
        assert any(a != full[n] for n, (a, _) in shapes.items())   # sharded over DP


@pytest.mark.parametrize("broken", [False, True])
def test_tensorboard_logger_fallback(broken, tmp_path, monkeypatch):
    import builtins
    import glob

    if broken:
        real = builtins.__import__

        def fail(name, *a, **kw):
            if name.startswith("torch.utils.tensorboard"):
                raise ImportError(name)
            return real(name, *a, **kw)

        monkeypatch.setattr(builtins, "__import__", fail)
    tb = TensorBoardLogger(str(tmp_path))
    tb.log_metrics({"loss": 1.5}, 1)
    tb.finalize()
    files = glob.glob(str(tmp_path / "**" / "*"), recursive=True)
    jsonl = [f for f in files if f.endswith(".jsonl")]
    assert any("events" in f for f in files) or jsonl, files
    if broken:
        assert [json.loads(line)["loss"] for line in open(jsonl[0])] == [1.5]


def _fit(max_steps, ckpt=None, stream=None, every=2, kill_at=None):
    cbs = [ModelCheckpoint(ckpt, every_n_steps=every, async_save=False)] if ckpt and every else []

    class KillAtStep(Callback):
        def on_step_end(self, trainer, module, step, metrics):
            if step == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)

    if kill_at:
        cbs.append(KillAtStep())
    trainer = NxDTrainer(max_steps=max_steps, checkpoint_dir=ckpt, callbacks=cbs, device="cpu")
    state, metrics = trainer.fit(TinyLlamaModule(), stream if stream is not None else _batches())
    return trainer, _params(state), float(metrics["loss"])


@pytest.mark.parametrize("how", ["checkpoint", "sigterm"])
def test_resume_bit_for_bit(how, tmp_path):
    ck = str(tmp_path / "ck")
    _, straight, loss_s = _fit(4)
    if how == "checkpoint":
        first, _, _ = _fit(2, ck)
        assert int(first.state.step) == 2
    else:
        before = signal.getsignal(signal.SIGTERM)
        pre, _, _ = _fit(4, ck, every=0, kill_at=2)
        assert pre.preempted and int(pre.state.step) == 2
        from neuronx_distributed_tpu_torch.checkpoint import latest_tag

        assert latest_tag(ck) == "step_2"
        assert signal.getsignal(signal.SIGTERM) == before   # the disposition restored
    resumed, params, loss_r = _fit(4, ck, every=0 if how == "sigterm" else 2)
    assert int(resumed.state.step) == 4 and not resumed.preempted
    assert loss_r == loss_s
    _assert_equal(straight, params)


def test_resume_seeks_token_shard_dataset(tmp_path):
    from neuronx_distributed_tpu_torch.data.loader import TokenShardDataset, write_token_shard

    rs = np.random.RandomState(0)
    shard = str(tmp_path / "s0.bin")
    write_token_shard(shard, rs.randint(0, 127, (10, 17)).astype(np.int32))
    ck = str(tmp_path / "ck")

    def make_ds():
        return TokenShardDataset([shard], batch_size=4, shuffle_seed=7)

    ds_s = make_ds()
    _, straight, loss_s = _fit(4, stream=ds_s)
    assert ds_s.batches_served == 4
    _fit(2, ck, stream=make_ds())
    ds_r = make_ds()
    _, resumed, loss_r = _fit(4, ck, stream=ds_r)
    assert ds_r.batches_served == 3   # the first batch, then batches 2 and 3: a seek
    assert loss_r == loss_s
    _assert_equal(straight, resumed)
