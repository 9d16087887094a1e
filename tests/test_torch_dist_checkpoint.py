"""The multi-rank checkpoint (``checkpoint/core.py``) at a world of 4 thread
ranks over gloo: JAX's protocol (``checkpoint/core.py:276-330``) and its
reshard-on-load (``tests/test_checkpoint.py:73-94``), with the port's
pieces.

* rank 0 alone writes the ``checkpoint``/``done`` markers and the manifest,
  and cleans up an interrupted tag; every rank writes its own pieces;
* a TrainState saved at TP2 x DP2 with ZeRO-1 loads at TP1 on one rank
  (each leaf whole) and back into TP2 x DP2 (each rank's block), bit for
  bit;
* a resume at the same layout after an async save continues bit for bit
  as the straight run;
* a flipped byte in one rank's piece fails ``verify=True``;
* ``convert_zero_checkpoints --params-only`` writes the global params as
  one rank (JAX ``tests/test_checkpoint.py:392``);
* a Mixtral state saved at TP2 x EP2 and at EP2 x edp 2 (each expert
  leaf a piece per (ep, tp) slice; at edp 2 its ZeRO-1 state split over
  edp), optimizer state included, resumes bit for bit, loads at TP1 x
  EP1 on one rank (every rank's block equal to the whole leaf's) and
  back, and a flipped byte in a rank's piece is caught;
* a ``PipelinedLlama`` state saved at TP2 x PP2 (and with two VPP chunks
  a stage), where each leaf lives on one stage under its global name,
  resumes bit for bit, loads at TP1 x PP1 on one rank (each leaf whole,
  every rank's block equal to it) and back into TP2 x PP2.
"""

import os
import threading

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.checkpoint import core as tcore
from neuronx_distributed_tpu_torch.checkpoint import storage as tstorage
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models import mixtral as tm
from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama
from neuronx_distributed_tpu_torch.optimizer import convert_zero_checkpoints as czc
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD = 4
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=16, use_flash_attention=False, remat_policy=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"ids": rs.randint(0, 128, (4, 16)), "labels": rs.randint(0, 128, (4, 16))}


def _trainer(tp=None):
    """Model, optimizer, state and step at this rank's layout (seeded
    init: the same global weights at every layout)."""
    tp = mesh.get_tensor_model_parallel_size() if tp is None else tp
    cfg = neuronx_distributed_config(tensor_parallel_size=tp, sequence_parallel=tp > 1,
                                     optimizer_config={"zero_one_enabled": True})
    model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(
        tl.LlamaConfig(**TINY, dtype=torch.float32)), device="cpu")
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    return model, opt, create_train_state(model, opt), step


def _run(state, step, seeds):
    losses = []
    for s in seeds:
        b = _batch(s)
        rows = mesh.data_batch_slice(4) if mesh.model_parallel_is_initialized() else slice(0, 4)
        state, m = step(state, {k: torch.as_tensor(v[rows]) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


def _tp2dp2(fn):
    return mesh.run_in_threads(WORLD, fn, tensor_model_parallel_size=2)


def test_rank0_owns_the_control_plane_and_cleans_up(tmp_path, monkeypatch):
    root = str(tmp_path)
    writes = []
    real = tstorage.FilesysCheckpointStorage.save_text

    def spy(self, text, path):
        writes.append((threading.current_thread().name, os.path.basename(path)))
        return real(self, text, path)

    monkeypatch.setattr(tstorage.FilesysCheckpointStorage, "save_text", spy)
    os.makedirs(os.path.join(root, "broken"))
    open(os.path.join(root, "broken", "checkpoint"), "w").close()

    def rank(r):
        _, _, state, step = _trainer()
        state, _ = _run(state, step, [1])
        tcore.save_checkpoint(root, "step_1", state, user_content={"step": 1}, async_save=True)
        tcore.finalize_checkpoint()
        return sorted(os.listdir(os.path.join(root, "step_1", "state")))

    files = _tp2dp2(rank)
    assert not os.path.isdir(os.path.join(root, "broken"))
    assert tcore.latest_tag(root) == "step_1"
    by = {}
    for thread, name in writes:
        by.setdefault(name, set()).add(thread.split("_")[0])
    for name in ("checkpoint", "done", "manifest.json", "user_content.json", "tree.json"):
        assert by.get(name) == {"nxd-ckpt-r0"}, (name, by.get(name))
    # every rank wrote its own index; the owners of pieces their tensors
    assert by["index.rank00003.json"] == {"nxd-ckpt-r3"}
    assert files[0] == files[3]
    assert "tensors.rank00002.safetensors" in files[0]   # a ZeRO shard's owner at dp 1


def test_reshard_tp2dp2_to_tp1_and_back(tmp_path):
    root, back = str(tmp_path / "a"), str(tmp_path / "b")

    def save(r):
        _, _, state, step = _trainer()
        state, _ = _run(state, step, [1, 2])
        tcore.save_checkpoint(root, "t", state)
        return state

    sharded = _tp2dp2(save)
    # one rank at TP1, no mesh: every leaf whole
    _, _, target, _ = _trainer(tp=1)
    whole, _ = tcore.load_checkpoint(root, "t", target=target, verify=True)
    assert int(whole.step) == 2
    for st in sharded:
        for path, piece in st.layout.items():
            field, _, name = path[1:].partition("['")
            name = name[:-2]
            local = (st.params[name] if field == "params"
                     else getattr(st.opt_state, field.split(".")[1])[name])
            glob = (whole.params[name] if field == "params"
                    else getattr(whole.opt_state, field.split(".")[1])[name])
            assert tuple(glob.shape) == tuple(piece.global_shape)
            block = glob[tuple(slice(o, o + n) for o, n in zip(piece.offset, local.shape))]
            assert torch.equal(block, local), path
    tcore.save_checkpoint(back, "t", whole)

    def load(r):
        _, _, target, _ = _trainer()
        got, _ = tcore.load_checkpoint(back, "t", target=target)
        return got

    for st, got in zip(sharded, _tp2dp2(load)):
        for n in st.params:
            assert torch.equal(got.params[n], st.params[n]), n
            for f in ("mu", "nu", "master"):
                assert torch.equal(getattr(got.opt_state, f)[n], getattr(st.opt_state, f)[n])


def test_resume_is_bit_identical_and_a_flipped_piece_is_caught(tmp_path):
    root = str(tmp_path)

    def straight(r):
        _, _, state, step = _trainer()
        state, losses = _run(state, step, [1, 2, 3])
        return state, losses

    def first(r):
        _, _, state, step = _trainer()
        state, losses = _run(state, step, [1, 2])
        tcore.save_checkpoint(root, "step_2", state, async_save=True)
        tcore.finalize_checkpoint()
        return losses

    def resumed(r):
        _, _, state, step = _trainer()
        state, _ = tcore.load_checkpoint(root, target=state, verify=True)
        state, losses = _run(state, step, [3])
        return state, losses

    want = _tp2dp2(straight)
    head = _tp2dp2(first)
    got = _tp2dp2(resumed)
    for (st_w, l_w), l_h, (st_g, l_g) in zip(want, head, got):
        assert l_h + l_g == l_w
        for n in st_w.params:
            assert torch.equal(st_g.params[n], st_w.params[n]), n
            assert torch.equal(st_g.opt_state.master[n], st_w.opt_state.master[n]), n
    path = os.path.join(root, "step_2", "state", "tensors.rank00003.safetensors")
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0x10
    open(path, "wb").write(bytes(data))
    with pytest.raises(tcore.CheckpointIntegrityError, match="tensors.rank00003"):
        tcore.load_checkpoint(root, verify=True)


def test_convert_params_only(tmp_path):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")

    def rank(r):
        _, _, state, step = _trainer()
        state, _ = _run(state, step, [1])
        tcore.save_checkpoint(src, "step_1", state, user_content={"step": 1})
        return state

    sharded = _tp2dp2(rank)
    czc.main(["--input", src, "--output", dst, "--params-only", "--out_tag", "weights"])
    params, content = tcore.load_checkpoint(dst, "weights", verify=True)
    assert content == {"step": 1}
    full, _ = tcore.load_checkpoint(src, "step_1")
    assert set(params) == set(full["params"]) == set(sharded[0].params)
    for n, t in params.items():
        assert torch.equal(t, full["params"][n])
        piece = sharded[0].layout[f".params['{n}']"]
        assert tuple(t.shape) == tuple(piece.global_shape)
    with pytest.raises(ValueError, match="no 'params' entry"):
        czc.convert(dst, str(tmp_path / "x"), params_only=True)


def _pp_trainer(chunks):
    """A TP2 x PP2 stage's trainer (seeded init: the one-rank model's
    weights), 2 microbatches, ``chunks`` VPP chunks a stage."""
    cfg = neuronx_distributed_config(tensor_parallel_size=2, pipeline_parallel_size=2,
                                     optimizer_config={"zero_one_enabled": True})
    pm = PipelinedLlama(tl.LlamaConfig(**{**TINY, "num_layers": 4}, dtype=torch.float32),
                        num_stages=2, num_microbatches=2, num_chunks=chunks)
    model = pm.as_parallel_model(device="cpu")
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3)
    step = make_train_step(model, opt, lambda p, b, rng: pm.loss(p, b["ids"], b["labels"]))
    return create_train_state(model, opt), step


def _leaf(state, path):
    field, _, name = path[1:].partition("['")
    name = name[:-2]
    return (state.params[name] if field == "params"
            else getattr(state.opt_state, field.split(".")[1])[name])


@pytest.mark.parametrize("chunks", [1, 2])
def test_pp_layout_resumes_and_loads_at_one_rank_and_back(tmp_path, chunks):
    root, back = str(tmp_path / "pp"), str(tmp_path / "one")

    def pp(fn):
        return mesh.run_in_threads(WORLD, fn, tensor_model_parallel_size=2,
                                   pipeline_model_parallel_size=2)

    def straight(r):
        state, step = _pp_trainer(chunks)
        return _run(state, step, [1, 2, 3])

    def first(r):
        state, step = _pp_trainer(chunks)
        state, losses = _run(state, step, [1, 2])
        tcore.save_checkpoint(root, "step_2", state, async_save=True)
        tcore.finalize_checkpoint()
        return state, losses

    def resumed(r):
        state, step = _pp_trainer(chunks)
        state, _ = tcore.load_checkpoint(root, target=state, verify=True)
        return _run(state, step, [3])

    want, head, got = pp(straight), pp(first), pp(resumed)
    for (st_w, l_w), (_, l_h), (st_g, l_g) in zip(want, head, got):
        assert l_h + l_g == l_w
        for n in st_w.params:
            assert torch.equal(st_g.params[n], st_w.params[n]), n
            assert torch.equal(st_g.opt_state.master[n], st_w.opt_state.master[n]), n
    # one rank at TP1 x PP1: every leaf whole, each stage's block equal to it
    cfg = neuronx_distributed_config(optimizer_config={"zero_one_enabled": True})
    model = initialize_parallel_model(cfg, lambda: tl.LlamaForCausalLM(
        tl.LlamaConfig(**{**TINY, "num_layers": 4}, dtype=torch.float32)), device="cpu")
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3)
    whole, _ = tcore.load_checkpoint(root, "step_2", target=create_train_state(model, opt),
                                     verify=True)
    assert int(whole.step) == 2
    seen = set()
    for st, _ in head:
        for path, piece in st.layout.items():
            local, glob = _leaf(st, path), _leaf(whole, path)
            assert tuple(glob.shape) == tuple(piece.global_shape)
            block = glob[tuple(slice(o, o + n) for o, n in zip(piece.offset, local.shape))]
            assert torch.equal(block, local), path
            seen.add(path)
    assert {p for p in seen if p.startswith(".params")} == {
        f".params['{n}']" for n in whole.params}
    tcore.save_checkpoint(back, "t", whole)

    def load_back(r):
        state, _ = _pp_trainer(chunks)
        return tcore.load_checkpoint(back, "t", target=state)[0]

    for (st, _), got_back in zip(head, pp(load_back)):
        for n in st.params:
            assert torch.equal(got_back.params[n], st.params[n]), n
            assert torch.equal(got_back.opt_state.mu[n], st.opt_state.mu[n]), n


def _moe_trainer():
    """A tiny Mixtral's trainer at this rank's layout (one rank off-mesh),
    seeded: the same global weights at every layout."""
    on = mesh.model_parallel_is_initialized()
    tp = mesh.get_tensor_model_parallel_size() if on else 1
    ep = mesh.get_expert_model_parallel_size() if on else 1
    cfg = neuronx_distributed_config(tensor_parallel_size=tp, expert_parallel_size=ep,
                                     optimizer_config={"zero_one_enabled": True})
    model = initialize_parallel_model(cfg, lambda: tm.MixtralForCausalLM(tm.MixtralConfig(
        **TINY, dtype=torch.float32, num_experts=4, top_k=2, capacity_factor=1.25)),
        device="cpu")
    opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3)

    def loss_fn(p, b, rng):
        model.bind(p)
        return tm.mixtral_loss(model.module, b["ids"], b["labels"])

    return model, opt, create_train_state(model, opt), make_train_step(model, opt, loss_fn)


@pytest.mark.parametrize("tp", [2, 1])
def test_ep_layout_resumes_and_loads_at_one_rank(tmp_path, tp):
    root = str(tmp_path)
    degrees = dict(tensor_model_parallel_size=tp, expert_model_parallel_size=2)

    def straight(r):
        _, _, state, step = _moe_trainer()
        return _run(state, step, [1, 2, 3])

    def first(r):
        _, opt, state, step = _moe_trainer()
        state, losses = _run(state, step, [1, 2])
        tcore.save_checkpoint(root, "step_2", state, async_save=True)
        tcore.finalize_checkpoint()
        return state, losses, opt.zero1_plan

    def resumed(r):
        _, _, state, step = _moe_trainer()
        state, _ = tcore.load_checkpoint(root, target=state, verify=True)
        return _run(state, step, [3])

    want = mesh.run_in_threads(WORLD, straight, **degrees)
    head = mesh.run_in_threads(WORLD, first, **degrees)
    got = mesh.run_in_threads(WORLD, resumed, **degrees)
    plan = head[0][2]
    assert plan.expert and all(plan.zero(n) == (tp == 1) for n in plan.expert)
    for (st_w, l_w), (_, l_h, _), (st_g, l_g) in zip(want, head, got):
        assert l_h + l_g == l_w
        for n in st_w.params:
            assert torch.equal(st_g.params[n], st_w.params[n]), n
            assert torch.equal(st_g.opt_state.master[n], st_w.opt_state.master[n]), n
    # TP1 x EP1 on one rank: each leaf whole, every rank's block equal to it
    _, _, target, _ = _moe_trainer()
    whole, _ = tcore.load_checkpoint(root, "step_2", target=target, verify=True)
    assert int(whole.step) == 2
    covered = set()
    for st, _, _ in head:
        for path, piece in st.layout.items():
            field, _, name = path[1:].partition("['")
            name = name[:-2]
            local = (st.params[name] if field == "params"
                     else getattr(st.opt_state, field.split(".")[1])[name])
            glob = (whole.params[name] if field == "params"
                    else getattr(whole.opt_state, field.split(".")[1])[name])
            assert tuple(glob.shape) == tuple(piece.global_shape)
            block = glob[tuple(slice(o, o + n) for o, n in zip(piece.offset, local.shape))]
            assert torch.equal(block, local), path
            covered.add((path, piece.offset))
    experts = [p for p, _ in covered if p == ".params['model.layers.0.moe.experts.gate']"]
    assert len(experts) == 2 * tp   # one piece per (ep, tp) slice
    # and back: the one-rank tag into the EP layout, ZeRO state included
    back = str(tmp_path / "back")
    tcore.save_checkpoint(back, "t", whole)

    def load(r):
        _, _, target, _ = _moe_trainer()
        return tcore.load_checkpoint(back, "t", target=target)[0]

    for (st, _, _), again in zip(head, mesh.run_in_threads(WORLD, load, **degrees)):
        for n in st.params:
            assert torch.equal(again.params[n], st.params[n]), n
            for f in ("mu", "nu", "master"):
                assert torch.equal(getattr(again.opt_state, f)[n], getattr(st.opt_state, f)[n])
    path = os.path.join(root, "step_2", "state", "tensors.rank00001.safetensors")
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0x10
    open(path, "wb").write(bytes(data))
    with pytest.raises(tcore.CheckpointIntegrityError, match="tensors.rank00001"):
        tcore.load_checkpoint(root, verify=True)
