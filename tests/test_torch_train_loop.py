"""The training loop a user runs, on the CPU: the port's
``examples/codegen25.py --tiny --device cpu`` against the JAX package's
``examples/training/codegen25.py --tiny`` at TP = 1, and a run of the port
interrupted and resumed against an uninterrupted one.

Both scripts read the same token shards through their native readers, with
the same FIM draws, and start from the same weights: JAX's seeded init,
handed to the port as an HF checkpoint (``--hf_checkpoint``). Their loss and
grad-norm streams over four steps must agree within fp32 rounding (1e-5
relative: the two frameworks sum in another order). The port's resumed run
(two steps, an async save, a fresh process state resuming at step 2 and
fast-forwarding the stream) must give the uninterrupted run's losses, grad
norms and final weights bit for bit.
"""

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.converters.hf_llama import nxd_to_hf_llama, save_hf_safetensors
from neuronx_distributed_tpu.models.llama import LlamaForCausalLM
from neuronx_distributed_tpu.parallel import mesh as ps
from neuronx_distributed_tpu.trainer import initialize_parallel_model, neuronx_distributed_config
from neuronx_distributed_tpu_torch.checkpoint import latest_tag, load_checkpoint
from neuronx_distributed_tpu_torch.examples import codegen25 as tcg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain for the native reader")
ROOT = Path(__file__).resolve().parents[1]
STREAM_RTOL = 1e-5


def _jax_codegen():
    sys.path.insert(0, str(ROOT / "examples"))
    spec = importlib.util.spec_from_file_location("jax_codegen25",
                                                  ROOT / "examples" / "training" / "codegen25.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream(path):
    return [(r["loss"], r["grad_norm"]) for r in map(json.loads, open(path).read().splitlines())]


def test_port_codegen25_matches_jax(tmp_path):
    jcg = _jax_codegen()
    data = str(tmp_path / "shards")
    common = ["--tiny", "--steps", "4", "--log_every", "1", "--data_dir", data]
    jcg.main(common + ["--tp", "1", "--metrics_file", str(tmp_path / "jax.jsonl")])
    ps.destroy_model_parallel()
    # JAX's starting weights: its codegen25's seeded init at the same config
    args = jcg.add_common_args(argparse.ArgumentParser()).parse_args(["--tiny"])
    lcfg = jcg.build_config(args, 32)
    model = initialize_parallel_model(neuronx_distributed_config(tensor_parallel_size=1),
                                      lambda: LlamaForCausalLM(lcfg), jnp.zeros((4, 32), jnp.int32))
    hf = nxd_to_hf_llama(jax.tree_util.tree_map(np.asarray, model.params), lcfg)
    ps.destroy_model_parallel()
    save_hf_safetensors(hf, str(tmp_path / "hf" / "model.safetensors"))
    loss = tcg.main(common + ["--device", "cpu", "--hf_checkpoint", str(tmp_path / "hf"),
                              "--metrics_file", str(tmp_path / "port.jsonl")])
    want, got = _stream(tmp_path / "jax.jsonl"), _stream(tmp_path / "port.jsonl")
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=STREAM_RTOL)
    assert loss == got[-1][0] and got[-1][0] < got[0][0]
    rec = json.loads(open(tmp_path / "port.jsonl").read().splitlines()[-1])
    assert rec["loader_native"] == 1 and rec["loader_shards"] == 2


def test_interrupted_run_equals_the_uninterrupted_one(tmp_path):
    data = str(tmp_path / "shards")
    common = ["--tiny", "--device", "cpu", "--log_every", "1", "--data_dir", data,
              "--warmup_steps", "2"]
    straight = tmp_path / "straight"
    tcg.main(common + ["--steps", "5", "--checkpoint_dir", str(straight),
                       "--metrics_file", str(straight / "m.jsonl")])
    split = tmp_path / "split"
    tcg.main(common + ["--steps", "2", "--checkpoint_every", "2", "--checkpoint_dir", str(split),
                       "--metrics_file", str(split / "m.jsonl")])
    assert latest_tag(str(split)) == "step_2"
    tcg.main(common + ["--steps", "5", "--checkpoint_dir", str(split),
                       "--metrics_file", str(split / "m.jsonl")])
    assert _stream(split / "m.jsonl") == _stream(straight / "m.jsonl")
    a, ca = load_checkpoint(str(straight), verify=True)
    b, cb = load_checkpoint(str(split), verify=True)
    assert ca == cb == {"step": 5}
    for n, t in a["params"].items():
        assert torch.equal(b["params"][n], t), n
    for n, t in a["opt_state"]["master"].items():
        assert torch.equal(b["opt_state"]["master"][n], t), n
