"""Pipeline-parallel training on the port against the JAX package.

* PP 2 x TP 2 x DP 2 with ZeRO-1 through the trainer: the port's 8 thread
  ranks over gloo against JAX's ``test_pp2_tp2_matches_baseline`` mesh
  (``tests/test_combinatorial.py:96``) on the first 8 CPU devices, from
  the same weights (the JAX ``PipelinedLlama``'s seeded tree, converted by
  ``pipelined_llama_params_from_jax``): 3 steps' losses and grad norms at
  ``rtol=5e-4`` (the JAX combinatorial test's own tolerance). Within the
  port every rank reports the same loss and norm, and the DP replicas of a
  stage hold the same bits.
* ``examples/llama2_tp_pp.py``'s ``main`` at ``--tiny`` (TP 2 x PP 2 x
  DP 2, 2 microbatches) on 8 thread ranks, 2 steps with a checkpoint and a
  resume to step 3, against the JAX example run as
  ``tests/test_examples.py:60-63`` runs it, from its weights: the losses of
  all three steps at ``rtol=5e-4``.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.models.llama import LlamaConfig as JConfig
from neuronx_distributed_tpu.models.llama_pipeline import PipelinedLlama as JPipelinedLlama
from neuronx_distributed_tpu.parallel import mesh as jps
from neuronx_distributed_tpu.trainer import (
    create_train_state as j_create_train_state,
    initialize_parallel_optimizer as j_initialize_parallel_optimizer,
    make_train_step as j_make_train_step,
    neuronx_distributed_config as j_config,
)
from neuronx_distributed_tpu_torch.converters.jax_params import pipelined_llama_params_from_jax
from neuronx_distributed_tpu_torch.examples import llama2_tp_pp as port_example
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    create_train_state,
    initialize_parallel_optimizer,
    make_train_step,
    neuronx_distributed_config,
)

WORLD, STEPS, RTOL = 8, 3, 5e-4
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, max_seq_len=32, use_flash_attention=False, remat_policy=None)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "training"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 127, (4, 32)), rs.randint(0, 127, (4, 32))


def _jax_trajectory():
    """JAX's PP2 x TP2 run (DP 2 on 8 devices) and its initial weights."""
    jps.initialize_model_parallel(tensor_model_parallel_size=2, pipeline_model_parallel_size=2,
                                  devices=jax.devices()[:WORLD])
    try:
        cfg = j_config(optimizer_config={"zero_one_enabled": True})
        ids, labels = _batch()
        pm = JPipelinedLlama(JConfig(**TINY, dtype=jnp.float32), num_stages=2,
                             num_microbatches=2, remat=False)
        model = pm.as_parallel_model(jnp.asarray(ids))
        tree = jax.tree_util.tree_map(np.asarray, model.params)
        opt = j_initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
        state = j_create_train_state(model, opt)
        step = j_make_train_step(model, opt, lambda p, b, r: pm.loss(p, b["ids"], b["labels"]))
        out = []
        for i in range(STEPS):
            state, m = step(state, {"ids": ids, "labels": labels}, jax.random.key(i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return tree, out
    finally:
        jps.destroy_model_parallel()


def test_pp2_tp2_dp2_matches_jax_trajectory():
    tree, want = _jax_trajectory()
    params = pipelined_llama_params_from_jax(tree, 1)

    def rank(r):
        cfg = neuronx_distributed_config(tensor_parallel_size=2, pipeline_parallel_size=2,
                                         optimizer_config={"zero_one_enabled": True})
        pm = PipelinedLlama(tl.LlamaConfig(**TINY, dtype=torch.float32), num_stages=2,
                            num_microbatches=2, remat=False)
        model = pm.as_parallel_model(device="cpu", params=params)
        opt = initialize_parallel_optimizer(cfg, model, learning_rate=1e-3, weight_decay=0.0)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, lambda p, b, rng: pm.loss(p, b["ids"], b["labels"]))
        ids, labels = _batch()
        rows = mesh.data_batch_slice(len(ids))
        batch = {"ids": torch.as_tensor(ids[rows]), "labels": torch.as_tensor(labels[rows])}
        traj = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            traj.append((float(m["loss"]), float(m["grad_norm"])))
        return dict(traj=traj, coords=mesh.local_mesh_coords(),
                    params={n: t.clone() for n, t in state.params.items()})

    ranks = mesh.run_in_threads(WORLD, rank, tensor_model_parallel_size=2,
                                pipeline_model_parallel_size=2)
    for rk in ranks:
        assert rk["traj"] == ranks[0]["traj"]
    np.testing.assert_allclose(np.array(ranks[0]["traj"]), np.array(want), rtol=RTOL)
    by_place = {}
    for rk in ranks:
        by_place.setdefault((rk["coords"]["pp"], rk["coords"]["tp"]), []).append(rk)
    assert len(by_place) == 4
    for group in by_place.values():
        assert len(group) == 2
        for n, t in group[1]["params"].items():
            assert torch.equal(t, group[0]["params"][n]), n


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()]


def test_llama2_tp_pp_example_with_resume_matches_jax(tmp_path):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    sys.path.insert(0, str(EXAMPLES.parent))
    import llama2_tp_pp as jax_example

    jdir, jm = str(tmp_path / "jax"), str(tmp_path / "jax.jsonl")
    for steps in ("2", str(STEPS)):   # a resumed run restarts the batch stream, in both
        try:
            jax_example.main(["--tiny", "--steps", steps, "--log_every", "1",
                              "--checkpoint_dir", jdir, "--metrics_file", jm])
        finally:
            jps.destroy_model_parallel()
    want = _losses(jm)
    assert len(want) == STEPS
    # the JAX example's weights: its PipelinedLlama's seeded init (key 0)
    lcfg = JConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=4,
                   num_heads=4, num_kv_heads=2, kv_size_multiplier=2, max_seq_len=32,
                   dtype=jnp.float32, use_flash_attention=False, remat_policy=None)
    tree = jax.tree_util.tree_map(np.asarray, JPipelinedLlama(lcfg, 2, 2).init(
        jax.random.key(0), jnp.zeros((4, 32), jnp.int32)))
    params = pipelined_llama_params_from_jax(tree, 1)
    pdir, pm = str(tmp_path / "port"), str(tmp_path / "port.jsonl")
    argv = ["--tiny", "--log_every", "1", "--device", "cpu", "--checkpoint_dir", pdir,
            "--metrics_file", pm]
    for steps in ("2", str(STEPS)):
        finals = mesh.run_in_threads(WORLD, lambda r: port_example.main(
            argv + ["--steps", steps], params=params), tensor_model_parallel_size=2,
            pipeline_model_parallel_size=2)
        assert len(set(finals)) == 1
    np.testing.assert_allclose(_losses(pm), want, rtol=RTOL)
    # every rank of a stage's DP rank 0 writes its pieces; stage 1 its structure
    state_dir = tmp_path / "port" / f"step_{STEPS}" / "state"
    assert len(list(state_dir.glob("tensors*"))) == WORLD
    assert (state_dir / "tree.rank00004.json").exists()
