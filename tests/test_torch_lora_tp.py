"""LoRA fine-tuning under tensor parallelism on the port against the JAX
package on the same mesh (JAX ``tests/test_lora.py::_build`` at ``tp=2``).

The port's ranks are threads over gloo (``mesh.run_in_threads``, a world
of 4: TP 2 x DP 2); the JAX package runs on the first 4 CPU devices. Both
start from the same seeded base (a JAX tree converted by
``converters/jax_params.py``) and the same adapters (JAX's ``init_lora``
draw, each ``B`` redrawn nonzero from numpy so ``A`` has a gradient from the
first step), each port rank cutting its slices of the global adapters by
``lora_param_specs``. Both train 3 steps through ``make_train_step`` with
clipping on the same seeded global batch, each data-parallel rank on its
rows, with rank-4 adapters on the five default targets plus the embedding:

* TP 2 x DP 2 with ZeRO-1 and dropout 0.25: the port is fed the global
  keep-masks ``jax.random.bernoulli`` drew for each JAX layer's key, and
  each rank cuts its block (its rows; a row-parallel input's fan-in);
* TP 2 with sequence parallelism x DP 2, ZeRO-1 off, ``kv_size_multiplier``
  2 (the compact K/V kernels and their adapters whole on every rank).

Held against JAX, fp32 on both sides: the losses at ``rtol=1e-5``, the grad
norms at ``rtol=1e-4`` (a gradient), and the adapters after 3 steps,
gathered, at ``rtol=1e-4, atol=1e-5``. Within the port: every rank reports
the same numbers, the base is bit for bit what it was, the optimizer
state holds the adapters only, and the TP-replicated adapter leaves and the
DP replicas stay bit-identical. The checkpoint saved at TP 2 x DP 2 loads
at TP 1 and back; the merged HF export at TP 2 writes JAX's tensors; the
fit loop (``lightning/``) takes ``lora_config`` at TP 2 unchanged.

The parity traps, each planted and caught:

1. the TP-replicated adapter leaves' gradients are the ranks' partial
   sums, summed once over TP (planted: no sum);
2. the adapters are drawn at their global shapes, then cut (planted: drawn
   at the shard's shape);
3. the clip norm counts a TP-replicated leaf once (planted: on every TP
   rank);
4. the dropout masks are the global activation's, cut to the rank's block
   (planted: drawn at the rank's shape, so both DP replicas and both TP
   ranks of a row-parallel input draw the same mask).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from neuronx_distributed_tpu.lora.core import (
    LoraConfig as JLoraConfig,
    export_merged_hf as j_export_merged_hf,
)
from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_model as j_initialize_parallel_model,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu_torch.checkpoint import core as tcore
from neuronx_distributed_tpu_torch.converters.jax_params import (
    _FLAX_KEY,
    _LAYER_LEAVES,
    llama_params_from_jax,
    lora_params_from_jax,
)
from neuronx_distributed_tpu_torch.inference.partition import (
    param_partition_specs,
    shard_slice,
)
from neuronx_distributed_tpu_torch.lora import core as tlora
from neuronx_distributed_tpu_torch.lora.core import LoraConfig, flat_lora, nest_lora
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)
from neuronx_distributed_tpu_torch.trainer import step as tstep

WORLD, STEPS, LR = 4, 3, 1e-2
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ADAPTER_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 4, 32
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=S, use_flash_attention=False, remat_policy=None)
TARGETS = ("qkv", "o_proj", "gate_proj", "up_proj", "down_proj", "embed")
LORA = dict(r=4, lora_alpha=8.0, target_modules=TARGETS)
# name: (sequence_parallel, zero-1, dropout, kv_size_multiplier)
CASES = {
    "TP2_DP2_dropout": (False, True, 0.25, 1),
    "TP2_SP_DP2_kv2": (True, False, 0.0, 2),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rs = np.random.RandomState(0)
    return {"ids": rs.randint(0, 127, (B, S)), "labels": rs.randint(0, 127, (B, S))}


def _opt(zero1):
    return {"zero_one_enabled": zero1, "grad_clipping": True, "max_grad_norm": 0.5}


def _jax_model(zero1, dropout, kvm, sp=False):
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32, kv_size_multiplier=kvm,
                          sequence_parallel=sp)
    cfg = j_config(tensor_parallel_size=2, optimizer_config=_opt(zero1),
                   lora_config=JLoraConfig(**LORA, lora_dropout=dropout))
    model = j_initialize_parallel_model(cfg, lambda: jl.LlamaForCausalLM(jcfg),
                                        jnp.asarray(_batch()["ids"]))
    return cfg, jcfg, model


@pytest.fixture(scope="module")
def start():
    """The shared base and global adapters (numpy), from JAX's own inits at
    TP 2; each B redrawn nonzero from a seeded numpy stream."""
    jps.initialize_model_parallel(tensor_model_parallel_size=2, devices=jax.devices()[:WORLD])
    try:
        _, _, model = _jax_model(True, 0.0, 1)
        base = jax.tree_util.tree_map(np.asarray, model.params)
        rng = np.random.default_rng(1)
        lora = {p: {"lora_a": np.asarray(ad["lora_a"]),
                    "lora_b": (rng.normal(size=ad["lora_b"].shape) * 0.1).astype(np.float32)}
                for p, ad in model.lora_params.items()}
    finally:
        jps.destroy_model_parallel()
    return base, lora


def _jax_masks(lora, drop_rng, keep):
    """The global keep-masks JAX's attached layers draw under ``drop_rng``,
    by the port's weight name (JAX ``lora/core.py:163-186``, every adapter
    path numbered, the embedding's included)."""
    width = {"down_proj": TINY["intermediate_size"]}
    out = {}
    for i, path in enumerate(sorted(lora)):
        parts = tuple(_FLAX_KEY.findall(path))
        if parts[:3] != ("model", "layers", "block"):
            continue   # the embedding merges in weight space: no mask
        name = _LAYER_LEAVES[parts[3:]]
        fan_in = width.get(parts[-2], TINY["hidden_size"])
        keys = jax.random.split(jax.random.fold_in(drop_rng, i), TINY["num_layers"])
        for layer in range(TINY["num_layers"]):
            m = jax.random.bernoulli(keys[layer], jnp.float32(keep), (B, S, fan_in))
            out[f"model.layers.{layer}.{name}"] = torch.from_numpy(np.array(m))
    return out


def _jax_run(start, sp, zero1, dropout, kvm):
    """JAX's 3 steps at TP 2 x DP 2: (loss, grad norm) a step and the
    adapters after the last, as the port's flat global tree."""
    base, lora = start
    jps.initialize_model_parallel(tensor_model_parallel_size=2, devices=jax.devices()[:WORLD])
    try:
        cfg, _, model = _jax_model(zero1, dropout, kvm, sp)
        model = dataclasses.replace(
            model, params=jax.device_put(jax.tree_util.tree_map(jnp.array, base),
                                         model.param_shardings()),
            lora_params=jax.device_put(jax.tree_util.tree_map(jnp.array, lora),
                                       model.trainable_shardings()))
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=LR, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, b, r: model.module.apply(
            {"params": p}, b["ids"], b["labels"], method=jl.LlamaForCausalLM.loss))
        jb = {k: jnp.asarray(v) for k, v in _batch().items()}
        traj = []
        for i in range(STEPS):
            state, m = step(state, jb, jax.random.key(i))
            traj.append((float(m["loss"]), float(m["grad_norm"])))
        adapters = flat_lora(lora_params_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params), LoraConfig(**LORA)))
        return traj, adapters
    finally:
        jps.destroy_model_parallel()


def _port_model(start, sp=False, zero1=True, dropout=0.0, kvm=1, tp=None):
    """Model, optimizer, state and step at this rank's layout on the shared
    base and adapters (each rank its slices of the global adapters)."""
    base, lora = start
    tp = mesh.get_tensor_model_parallel_size() if tp is None else tp
    cfg = neuronx_distributed_config(tensor_parallel_size=tp, sequence_parallel=sp,
                                     optimizer_config=_opt(zero1),
                                     lora_config=LoraConfig(**LORA, lora_dropout=dropout))
    lcfg = tl.LlamaConfig(**TINY, dtype=torch.float32, kv_size_multiplier=kvm)
    model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(lcfg), device="cpu",
                                      params=llama_params_from_jax(base))
    tp_rank = mesh.tensor_model_parallel_rank() if mesh.model_parallel_is_initialized() else 0
    glob = flat_lora(lora_params_from_jax(lora, model.lora_config))
    specs = model.trainable_specs
    model.bind_trainable({n: shard_slice(t, specs[n], tp_rank, tp).contiguous()
                          for n, t in glob.items()})
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=LR, weight_decay=0.0)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    return model, opt, state, step


def _rows(batch):
    rows = mesh.data_batch_slice(B) if mesh.model_parallel_is_initialized() else slice(0, B)
    return {k: torch.as_tensor(v[rows]) for k, v in batch.items()}


def _port_rank(start, sp, zero1, dropout, kvm, masks=None):
    model, opt, state, step = _port_model(start, sp, zero1, dropout, kvm)
    frozen = {n: p.clone() for n, p in model.params.items()}
    batch = _rows(_batch())
    traj = []
    for i in range(STEPS):
        state, m = step(state, batch, lora_masks=None if masks is None else masks[i])
        traj.append((float(m["loss"]), float(m["grad_norm"])))
    base_frozen = all(torch.equal(p, frozen[n]) and not p.requires_grad
                      for n, p in model.params.items())
    return dict(traj=traj, params={n: t.clone() for n, t in state.params.items()},
                specs=model.trainable_specs, coords=mesh.local_mesh_coords(),
                base_frozen=base_frozen, state_leaves=set(state.opt_state.mu),
                adapters=set(model.trainable_leaves()), model=model)


def _gathered(ranks):
    """The global adapters from the ranks' slices (rank 0's view of each
    replicated leaf)."""
    out = {}
    for n, spec in ranks[0]["specs"].items():
        if "tp" not in spec:
            out[n] = ranks[0]["params"][n]
            continue
        parts = sorted((rk["coords"]["tp"], rk["params"][n]) for rk in ranks
                       if rk["coords"]["dp"] == 0)
        out[n] = torch.cat([t for _, t in parts], dim=spec.index("tp"))
    return out


def _port_run(start, sp, zero1, dropout, kvm, masks=None):
    ranks = mesh.run_in_threads(WORLD, lambda r: _port_rank(start, sp, zero1, dropout, kvm,
                                                            masks),
                                tensor_model_parallel_size=2)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
        assert rk["base_frozen"] and rk["state_leaves"] == rk["adapters"]
        for n, spec in rk["specs"].items():
            same_tp = rk["coords"]["tp"] == ranks[0]["coords"]["tp"] or "tp" not in spec
            if same_tp:   # DP replicas and TP-replicated leaves: the same bits
                assert torch.equal(rk["params"][n], ranks[0]["params"][n]), n
    return ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_lora_tp2_matches_jax(name, start):
    sp, zero1, dropout, kvm = CASES[name]
    want, want_adapters = _jax_run(start, sp, zero1, dropout, kvm)
    masks = ([_jax_masks(start[1], jax.random.split(jax.random.key(i))[0], 1.0 - dropout)
              for i in range(STEPS)] if dropout else None)
    ranks = _port_run(start, sp, zero1, dropout, kvm, masks)
    got = np.array(ranks[0]["traj"])
    np.testing.assert_allclose(got[:, 0], np.array(want)[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[:, 1], np.array(want)[:, 1], rtol=GRAD_RTOL)
    assert got[-1, 0] < got[0, 0]
    adapters = _gathered(ranks)
    assert set(adapters) == set(want_adapters)
    for n, t in adapters.items():
        np.testing.assert_allclose(t.numpy(), want_adapters[n].numpy(), err_msg=n,
                                   **ADAPTER_TOL)


def _tp_vs_one(start, dropout=0.0, kvm=1, sp=False):
    """The port's own 3 steps on one rank and at TP 2 x DP 2 (rank 0's
    trajectory), seeded dropout masks drawn from the state's generator."""
    def run(r=None):
        model, _, state, step = _port_model(start, sp=sp, dropout=dropout, kvm=kvm,
                                            tp=1 if r is None else 2)
        batch = _rows(_batch())
        out = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    return np.array(run()), np.array(mesh.run_in_threads(
        WORLD, run, tensor_model_parallel_size=2)[0])


def test_tp_layouts_equal_one_rank(start):
    """At TP 2 x DP 2 the port trains its one-rank trajectory: dropout masks
    drawn from the state's generator (trap 4's positive), sequence
    parallelism with ``kv_size_multiplier`` 2."""
    for kw in (dict(dropout=0.25), dict(kvm=2, sp=True)):
        one, tp = _tp_vs_one(start, **kw)
        np.testing.assert_allclose(tp[:, 0], one[:, 0], rtol=LOSS_RTOL, err_msg=str(kw))
        np.testing.assert_allclose(tp[:, 1], one[:, 1], rtol=GRAD_RTOL, err_msg=str(kw))


def test_trap1_replicated_leaves_unsummed_leave_jax(start, monkeypatch):
    """Planted: the TP-replicated adapter leaves read without their copy
    region, so their gradients stay a rank's partial sums."""
    monkeypatch.setattr(tlora.Adapter, "_leaves", lambda self: (self.a, self.b))
    one, tp = _tp_vs_one(start, kvm=2)
    np.testing.assert_allclose(tp[0, 0], one[0, 0], rtol=LOSS_RTOL)   # the forward holds
    assert not np.allclose(tp[:, 1], one[:, 1], rtol=GRAD_RTOL)


def test_trap2_global_init_then_cut(start, monkeypatch):
    """The seeded adapters of a TP rank are its slices of the one-rank draw;
    planted: drawn at the shard's shape, they are not."""
    def adapters(r=None):
        cfg = neuronx_distributed_config(
            tensor_parallel_size=1 if r is None else 2, lora_config=LoraConfig(**LORA))
        model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(
            tl.LlamaConfig(**TINY, dtype=torch.float32)), device="cpu")
        tp_rank = 0 if r is None else mesh.tensor_model_parallel_rank()
        return model.trainable_params, model.trainable_specs, tp_rank

    one, _, _ = adapters()

    def cut_of_one(ranks):
        return all(torch.equal(t, shard_slice(one[n], specs[n], tp_rank, 2))
                   for params, specs, tp_rank in ranks for n, t in params.items())

    assert cut_of_one(mesh.run_in_threads(2, adapters))
    real = tlora.init_lora
    local = {}

    def per_shard(sd, config, generator, device=None):
        # planted: the rank's own shapes, not the global ones
        return real({n: local[n] for n in sd}, config, generator, device)

    monkeypatch.setattr("neuronx_distributed_tpu_torch.trainer.model.init_lora", per_shard)
    monkeypatch.setattr("neuronx_distributed_tpu_torch.trainer.model.global_shape",
                        lambda shape, spec, tp, ep=1: tuple(shape))

    def planted(r):
        return adapters(r)

    local_shapes = mesh.run_in_threads(2, lambda r: {
        n: torch.empty(p.shape, device="meta") for n, p in initialize_parallel_model(
            neuronx_distributed_config(tensor_parallel_size=2), lambda: tl.LlamaForCausalLM(
                tl.LlamaConfig(**TINY, dtype=torch.float32)), device="cpu").params.items()})
    local.update(local_shapes[0])
    assert not cut_of_one(mesh.run_in_threads(2, planted))


def test_trap3_clip_norm_counts_replicated_leaves_once(start, monkeypatch):
    """Planted: every adapter leaf counted as a TP shard in the clip norm,
    so a replicated leaf counts on both TP ranks and the norm grows."""
    real = tstep.get_grad_norm

    def every_rank(grads, **layout):
        return real(grads, **{**layout, "tp_sharded": set(grads)})

    one, _ = _tp_vs_one(start)
    monkeypatch.setattr(tstep, "get_grad_norm", every_rank)
    _, tp = _tp_vs_one(start)
    assert tp[0, 1] > one[0, 1] * (1 + 1e-3)


@pytest.mark.parametrize("rows,seq,features", [((1, 2), (0, 1), None),
                                                ((0, 2), (1, 2), None),
                                                ((1, 2), (1, 2), (1, 2))])
def test_seeded_dropout_rank_block_is_the_global_masks_block(rows, seq, features, monkeypatch):
    """A rank's seeded mask is its block of the one-rank mask (rows, the cp
    block of the sequence, a row-parallel input's features), and the rank
    draws its own rows only, one row's global shape at a time."""
    g, x = torch.Generator().manual_seed(5), torch.ones(4, 6, 8)
    one = tlora.LoraDropout(0.75)
    one.draw(g, ["w"])
    want = one.apply("w", x)
    rank = tlora.LoraDropout(0.75, rows, seq)
    rank.seeds = dict(one.seeds)
    block = x[:4 // rows[1], :6 // seq[1], :8 // (features or (0, 1))[1]]
    drawn = []
    real = torch.rand
    monkeypatch.setattr(torch, "rand", lambda shape, **k: drawn.append(list(shape))
                        or real(shape, **k))
    got = rank.apply("w", block, features)
    assert drawn == [[6, 8]] * block.shape[0]
    cut = want
    for d, (r, n) in ((0, rows), (1, seq), (2, features or (0, 1))):
        cut = cut.narrow(d, r * block.shape[d], block.shape[d])
    assert torch.equal(got, cut) and 0 < int((got == 0).sum()) < got.numel()


def test_trap4_dropout_masks_at_the_rank_shape_leave_one_rank(start, monkeypatch):
    """Planted: each rank draws its mask at its own shape, so the DP
    replicas and the TP ranks of a row-parallel input repeat one mask."""
    monkeypatch.setattr(tlora.LoraDropout, "_cuts", lambda self, x, features: [])
    one, tp = _tp_vs_one(start, dropout=0.25)
    assert not np.allclose(tp[:, 0], one[:, 0], rtol=LOSS_RTOL)


def test_checkpoint_tp2_dp2_loads_at_tp1_and_back(start, tmp_path):
    """Adapters and their ZeRO-1 state saved at TP 2 x DP 2 load at TP 1 on
    one rank (each leaf whole: the gathered adapters) and back, bit for
    bit."""
    root, back = str(tmp_path / "a"), str(tmp_path / "b")

    def save(r):
        _, _, state, step = _port_model(start)
        state, _ = step(state, _rows(_batch()))
        tcore.save_checkpoint(root, "t", state)
        return dict(params=state.params, mu=dict(state.opt_state.mu), layout=state.layout)

    sharded = mesh.run_in_threads(WORLD, save, tensor_model_parallel_size=2)
    _, _, target, _ = _port_model(start, tp=1)
    whole, _ = tcore.load_checkpoint(root, "t", target=target, verify=True)
    assert int(whole.step) == 1 and set(whole.params) == set(sharded[0]["params"])
    for st in sharded:
        for path, piece in st["layout"].items():
            field, _, name = path[1:].partition("['")
            name = name[:-2]
            local = st["params"][name] if field == "params" else (
                st["mu"][name] if field.endswith(".mu") else None)
            if local is None:
                continue
            glob = whole.params[name] if field == "params" else whole.opt_state.mu[name]
            block = glob[tuple(slice(o, o + n) for o, n in zip(piece.offset, local.shape))]
            assert torch.equal(block, local), path
    tcore.save_checkpoint(back, "t", whole)

    def load(r):
        _, _, target, _ = _port_model(start)
        got, _ = tcore.load_checkpoint(back, "t", target=target)
        return got.params

    for st, got in zip(sharded, mesh.run_in_threads(WORLD, load, tensor_model_parallel_size=2)):
        for n, t in st["params"].items():
            assert torch.equal(got[n], t), n


def test_export_merged_hf_at_tp2_equals_jax(start, tmp_path):
    """``export_merged_hf`` at TP 2 gathers the base and the adapters, then
    merges: rank 0 writes JAX's tensors, name for name."""
    base, lora = start
    jcfg = jl.LlamaConfig(**TINY, dtype=jnp.float32)
    jpath = j_export_merged_hf(jax.tree_util.tree_map(jnp.asarray, base),
                               jax.tree_util.tree_map(jnp.asarray, lora),
                               JLoraConfig(**LORA), jcfg, str(tmp_path / "jax"))

    def export(r):
        model, _, _, _ = _port_model(start, kvm=2)
        return tlora.export_merged_hf(
            model.params, nest_lora(model.trainable_params), model.lora_config,
            model.module.config, str(tmp_path / "port"),
            param_specs=param_partition_specs(model.module), group=model.group)

    paths = mesh.run_in_threads(2, export)
    assert paths[0] == paths[1]
    want, got = load_file(jpath), load_file(paths[0])
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=1e-6, err_msg=n)


def test_fit_loop_takes_lora_config_at_tp2(start):
    """``lightning``'s fit loop builds through ``initialize_parallel_model``
    with the module's ``nxd_config``: ``lora_config`` at TP 2 x DP 2 trains
    the one-rank losses with no change of interface."""
    from neuronx_distributed_tpu_torch.lightning import Callback, NxDLightningModule, NxDTrainer

    assert "lora_config" not in inspect.signature(NxDLightningModule.__init__).parameters

    class Module(NxDLightningModule):
        def configure_model(self):
            return tl.LlamaForCausalLM(tl.LlamaConfig(**TINY, dtype=torch.float32))

        def model_inputs(self, batch):
            return (batch["ids"],)

        def training_loss(self, model, params, batch, rng):
            return model.apply(params, batch["ids"], batch["labels"], method="loss")

    class Losses(Callback):
        def __init__(self):
            self.seen = []

        def on_step_end(self, trainer, module, step, metrics):
            self.seen.append(float(metrics["loss"]))

    def fit(r=None):
        cfg = neuronx_distributed_config(tensor_parallel_size=1 if r is None else 2,
                                         lora_config=LoraConfig(**LORA))
        log = Losses()
        NxDTrainer(max_steps=2, callbacks=[log], handle_preemption=False, device="cpu").fit(
            Module(cfg, learning_rate=LR), iter([_rows(_batch())] * 3))
        return log.seen

    one = fit()
    assert len(one) == 2
    for losses in mesh.run_in_threads(WORLD, fit, tensor_model_parallel_size=2):
        np.testing.assert_allclose(losses, one, rtol=LOSS_RTOL)
