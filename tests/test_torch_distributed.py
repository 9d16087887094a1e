"""The port's multi-process bootstrap, per-rank batches, seeds and head
padding, and the Llama-2 TP+ZeRO-1+SP example, held against the JAX
package.

* ``initialize_distributed``'s configuration rules (JAX
  ``tests/test_distributed.py``: nothing configured is a no-op, a partial
  configuration raises, a world of one is single), ``host_batch_slice``
  and ``shard_host_batch`` (each data-parallel rank's rows, the same on
  every rank of its TP group);
* ``parallel/random.py``: TP ranks draw apart, DP replicas share the seed;
* ``pad_llama_heads`` (JAX ``tests/test_conv_pad.py:64-115``): the padded
  port model's logits equal the unpadded one's (``rtol=1e-5, atol=1e-6``),
  the padded tree is JAX's padded tree converted, it runs at TP=4 where 5
  heads could not, and GQA is refused;
* ``examples/llama2_tp_zero1.py``'s ``main`` on 4 thread ranks (TP2 x DP2,
  ZeRO-1) for 2 steps with a checkpoint, then resumed to step 4, against
  the JAX example run the same way (``tests/test_examples.py:47-58``) from
  the same weights: the losses of all four steps at ``rtol=5e-4`` (the
  trajectory does not depend on the mesh).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from neuronx_distributed_tpu.models import llama as jl
from neuronx_distributed_tpu.parallel.pad import pad_llama_heads as j_pad_llama_heads
from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax
from neuronx_distributed_tpu_torch.examples import llama2_tp_zero1 as port_example
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.parallel import distributed as tdist
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel import random as trandom
from neuronx_distributed_tpu_torch.parallel.pad import get_number_of_extra_heads, pad_llama_heads

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "training"
ENV = ("NXD_COORDINATOR_ADDRESS", "NXD_NUM_PROCESSES", "NXD_PROCESS_ID", "MASTER_ADDR",
       "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clear(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def test_initialize_distributed_configuration(monkeypatch):
    _clear(monkeypatch)
    assert tdist.initialize_distributed() is False
    monkeypatch.setenv("NXD_COORDINATOR_ADDRESS", "127.0.0.1:9999")
    with pytest.raises(ValueError, match="partial distributed config"):
        tdist.initialize_distributed()
    monkeypatch.setenv("NXD_NUM_PROCESSES", "1")
    monkeypatch.setenv("NXD_PROCESS_ID", "0")
    assert tdist.initialize_distributed() is False
    _clear(monkeypatch)   # torchrun's names: the same rules
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="partial distributed config"):
        tdist.initialize_distributed()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.initialize_distributed() is False


def test_host_batch_slice_and_shard_host_batch():
    assert tdist.host_batch_slice(8) == slice(0, 8)
    batch = {"ids": np.arange(48, dtype=np.int32).reshape(8, 6)}
    assert torch.equal(tdist.shard_host_batch(batch, device="cpu")["ids"],
                       torch.as_tensor(batch["ids"]))

    def rank(r):
        c = mesh.local_mesh_coords()
        with pytest.raises(ValueError, match="not divisible"):
            tdist.host_batch_slice(3)
        return c, tdist.host_batch_slice(8), tdist.shard_host_batch(batch, device="cpu")["ids"]

    for c, sl, rows in mesh.run_in_threads(8, rank, tensor_model_parallel_size=2):
        # dp 4: two rows a data-parallel rank, the TP pair alike
        assert sl == slice(2 * c["dp"], 2 * c["dp"] + 2)
        assert torch.equal(rows, torch.as_tensor(batch["ids"][sl]))


def test_parallel_seeds():
    def rank(r):
        return (trandom.fold_in_axis_rank(5).initial_seed(),
                trandom.data_parallel_consistent_key(5), mesh.local_mesh_coords())

    for seed, key, c in mesh.run_in_threads(4, rank, tensor_model_parallel_size=2):
        assert seed == 5 + 2718 + c["tp"] and key == 5
    assert trandom.fold_in_axis_rank(5, rank=3).initial_seed() == 5 + 2718 + 3


def test_pad_llama_heads_exact_and_gqa_refused():
    assert get_number_of_extra_heads(16, 8) == 0 and get_number_of_extra_heads(5, 4) == 3
    tiny = dict(vocab_size=64, hidden_size=30, intermediate_size=32, num_layers=2, num_heads=5,
                num_kv_heads=5, head_dim=6, max_seq_len=32)
    jcfg = jl.LlamaConfig(**tiny, dtype=jnp.float32, use_flash_attention=False,
                          remat_policy=None)
    ids = np.random.default_rng(0).integers(0, 63, (2, 8))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jl.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(1), jnp.asarray(ids)))["params"])
    cfg = tl.LlamaConfig(**tiny, dtype=torch.float32, remat_policy=None)
    params = llama_params_from_jax(tree)
    model = tl.LlamaForCausalLM(cfg)
    model.load_state_dict(params)
    golden = model(torch.as_tensor(ids)).detach()
    padded, pcfg = pad_llama_heads(params, cfg, tp_degree=4)
    assert (pcfg.num_heads, pcfg.num_kv_heads, pcfg.head_dim_) == (8, 8, 6)
    jpadded, _ = j_pad_llama_heads(tree, jcfg, tp_degree=4)
    for k, v in llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jpadded)).items():
        assert torch.equal(padded[k], v), k
    pmodel = tl.LlamaForCausalLM(pcfg)
    pmodel.load_state_dict(padded)
    np.testing.assert_allclose(pmodel(torch.as_tensor(ids)).detach().numpy(), golden.numpy(),
                               rtol=1e-5, atol=1e-6)

    def rank(r):   # 8 heads split over 4 ranks (5 could not)
        m = tl.LlamaForCausalLM(pcfg, group=mesh.get_tensor_model_parallel_group())
        m.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jpadded),
                                                tp_rank=r, tp_size=4))
        return m(torch.as_tensor(ids)).detach()

    for r, out in enumerate(mesh.run_in_threads(4, rank)):
        np.testing.assert_allclose(out.numpy(), golden.numpy()[..., r * 16:(r + 1) * 16],
                                   rtol=2e-4, atol=2e-4)
    for n, kv in ((10, 3), (6, 2)):
        with pytest.raises(ValueError, match="kv_size_multiplier"):
            pad_llama_heads({}, tl.LlamaConfig(num_heads=n, num_kv_heads=kv, head_dim=4), 4)


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()]


def test_llama2_example_with_resume_matches_jax(tmp_path):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    sys.path.insert(0, str(EXAMPLES.parent))
    import llama2_tp_zero1 as jax_example

    common = ["--tiny", "--log_every", "1"]
    jdir, jm = str(tmp_path / "jax"), str(tmp_path / "jax.jsonl")
    jax_example.main(common + ["--steps", "2", "--checkpoint_dir", jdir, "--metrics_file", jm])
    jax_example.main(common + ["--steps", "4", "--checkpoint_dir", jdir, "--metrics_file", jm])
    want = _losses(jm)
    assert len(want) == 4
    # the JAX example's weights: its seeded init on its first batch
    ids = np.random.RandomState(0).randint(0, 512, (4, 33))[:, :-1].astype(np.int32)
    lcfg = jl.LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                          num_heads=4, num_kv_heads=4, max_seq_len=32, dtype=jnp.float32,
                          use_flash_attention=False, remat_policy=None)
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(jl.LlamaForCausalLM(lcfg).init(
        {"params": jax.random.key(0)}, jnp.asarray(ids)))["params"])
    params = llama_params_from_jax(tree)
    pdir, pm = str(tmp_path / "port"), str(tmp_path / "port.jsonl")
    argv = common + ["--device", "cpu", "--checkpoint_dir", pdir, "--metrics_file", pm]
    for steps in ("2", "4"):
        finals = mesh.run_in_threads(4, lambda r: port_example.main(
            argv + ["--steps", steps], params=params), tensor_model_parallel_size=2)
        assert len(set(finals)) == 1
    got = _losses(pm)
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert len(list((tmp_path / "port" / "step_4" / "state").glob("tensors*"))) == 4
