"""The port's checkpoint protocol against the JAX package's, on the CPU.

One script of saves, interrupted saves, interrupted deletes, re-saves and
retention runs against both packages' ``checkpoint/core.py`` in two
directories: after each action the tags on disk, the completed ones with
their ``done`` numbers, ``latest_tag`` and ``has_checkpoint`` must be the
same. The payloads differ by design (orbax there, safetensors here). Then
the port alone: a flipped payload byte fails ``verify=True``, an async save
followed by an in-place update loads the state from before it, a
``TrainState`` (dataclass, named tuple, generator) round-trips into its
target's structure, and ``user_content`` round-trips. Every comparison is
exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.checkpoint import core as jcore
from neuronx_distributed_tpu_torch.checkpoint import core as tcore
from neuronx_distributed_tpu_torch.optimizer.adamw import FP32MasterState
from neuronx_distributed_tpu_torch.trainer.step import TrainState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _view(root):
    """Tags on disk, and each completed tag's done number."""
    tags = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    done = {}
    for t in tags:
        p = os.path.join(root, t, "done")
        if os.path.exists(p):
            done[t] = open(p).read()
    return tags, done


def _crash_mid_save(root, tag):
    """What a save killed before its ``done`` leaves: the marker alone."""
    os.makedirs(os.path.join(root, tag), exist_ok=True)
    open(os.path.join(root, tag, "checkpoint"), "w").close()


def _crash_mid_delete(root, tag):
    """What a retention delete killed after removing ``done`` leaves."""
    os.remove(os.path.join(root, tag, "done"))


SCRIPT = [
    ("save", "a", None), ("save", "b", None), ("save", "c", 2), ("crash_save", "x", None),
    ("save", "d", None), ("crash_delete", "c", None), ("save", "b", 3), ("save", "e", 2),
    ("crash_save", "f", None), ("crash_save", "g", None), ("save", "h", 1),
]


def test_protocol_matches_jax_action_for_action(tmp_path):
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": np.int32(4)}
    states = {"jax": state, "port": {"w": torch.arange(6.0).reshape(2, 3),
                                     "n": torch.tensor(4, dtype=torch.int32)}}
    mods = {"jax": jcore, "port": tcore}
    for action, tag, kept in SCRIPT:
        for side, root in roots.items():
            if action == "save":
                mods[side].save_checkpoint(root, tag, states[side], num_kept=kept)
            elif action == "crash_save":
                _crash_mid_save(root, tag)
            else:
                _crash_mid_delete(root, tag)
        seen = {side: (_view(root), mods[side].latest_tag(root), mods[side].has_checkpoint(root))
                for side, root in roots.items()}
        assert seen["port"] == seen["jax"], (action, tag, seen)
    (tags, done), latest, has = seen["port"]
    assert latest == "h" and done == {"h": "7"} and tags == ["h"] and has


def test_flipped_byte_and_missing_manifest_fail_verify(tmp_path):
    root = str(tmp_path)
    tcore.save_checkpoint(root, "t", {"w": torch.randn(64, 64)})
    tcore.load_checkpoint(root, verify=True)
    path = os.path.join(root, "t", "state", "tensors.safetensors")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(path, "wb").write(bytes(data))
    tcore.load_checkpoint(root)   # unverified: the flipped value loads
    with pytest.raises(tcore.CheckpointIntegrityError, match="corrupted"):
        tcore.load_checkpoint(root, verify=True)
    os.remove(os.path.join(root, "t", "manifest.json"))
    with pytest.raises(tcore.CheckpointIntegrityError, match="no integrity manifest"):
        tcore.load_checkpoint(root, verify=True)
    with pytest.raises(FileNotFoundError, match="not complete"):
        tcore.load_checkpoint(root, tag="nope")


def test_async_save_snapshots_before_an_in_place_step(tmp_path):
    w = torch.randn(256, 256)
    before = w.clone()
    tcore.save_checkpoint(str(tmp_path), "s", {"w": w}, user_content={"step": 3, "data": {
        "epoch": 1, "cursor": 5}}, async_save=True)
    w.add_(1.0)     # the next step writes the params in place at once
    state, content = tcore.load_checkpoint(str(tmp_path))
    assert torch.equal(state["w"], before)
    assert content == {"step": 3, "data": {"epoch": 1, "cursor": 5}}


def test_train_state_round_trips_into_its_target(tmp_path):
    g = torch.Generator().manual_seed(9)
    torch.randint(0, 10, (3,), generator=g)   # a generator part way through its stream
    params = {"a.lora_a": torch.randn(8, 4), "a.lora_b": torch.randn(4, 8).to(torch.bfloat16)}
    opt = FP32MasterState(torch.tensor(3, dtype=torch.int32),
                          {n: torch.rand(p.shape) for n, p in params.items()},
                          {n: torch.rand(p.shape) for n, p in params.items()},
                          {n: p.float() for n, p in params.items()})
    state = TrainState(step=torch.tensor(3, dtype=torch.int32), params=params, opt_state=opt,
                       rng=g)
    tcore.save_checkpoint(str(tmp_path), "step_3", state)
    target = TrainState(step=torch.zeros((), dtype=torch.int32),
                        params={n: torch.zeros_like(p) for n, p in params.items()},
                        opt_state=FP32MasterState(torch.zeros((), dtype=torch.int32),
                                                  *({n: torch.zeros(p.shape) for n, p in params.items()}
                                                    for _ in range(3))),
                        rng=torch.Generator().manual_seed(0))
    got, content = tcore.load_checkpoint(str(tmp_path), target=target)
    assert content is None and isinstance(got, TrainState)
    assert isinstance(got.opt_state, FP32MasterState) and int(got.step) == 3
    for a, b in ((got.params, params), (got.opt_state.mu, opt.mu), (got.opt_state.nu, opt.nu),
                 (got.opt_state.master, opt.master)):
        for n in params:
            assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    assert torch.equal(torch.rand(4, generator=got.rng), torch.rand(4, generator=g))
    plain, _ = tcore.load_checkpoint(str(tmp_path))
    assert set(plain) == {f.name for f in dataclasses.fields(TrainState)}
    assert torch.equal(plain["opt_state"]["mu"]["a.lora_a"], opt.mu["a.lora_a"])


def test_a_group_of_more_than_one_rank_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(tcore, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="more than one rank"):
        tcore.save_checkpoint(str(tmp_path), "t", {"w": torch.zeros(2)})
