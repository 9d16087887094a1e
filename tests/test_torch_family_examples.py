"""The GPT-NeoX and BERT pretraining examples of the port, through their
entry points, on the CPU.

``synthetic_mlm_batches`` draws JAX's batches field for field (the same
``RandomState`` draws). Each example runs ``--tiny`` for 3 steps on one rank
from its seeded init, and at TP 2 x DP 2 (four thread ranks over gloo, SP on
for NeoX) from the same global weights as a one-rank run: every rank's
losses within ``rtol=1e-5`` of the one rank's (BERT deterministic there;
the MLM mean is over the global batch). BERT with dropout resumes bit for
bit: 2 steps, a save, and a fresh run resuming to step 4 give the
uninterrupted run's losses and weights (the step's dropout seed is
``seed + step + 1``). The trainer's seeded init builds both families, and at
TP 2 each rank holds its slice of the one global init.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.examples import bert_pretrain, gpt_neox_pretrain
from neuronx_distributed_tpu_torch.examples.common import synthetic_mlm_batches
from neuronx_distributed_tpu_torch.inference.partition import param_partition_specs, shard_slice
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    neuronx_distributed_config,
)

TOL = 1e-5
# the JAX examples' shared module (examples/common.py, not a package)
_spec = importlib.util.spec_from_file_location(
    "jax_examples_common", Path(__file__).resolve().parents[1] / "examples" / "common.py")
jcommon = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jcommon)
EXAMPLES = {"gpt_neox": gpt_neox_pretrain, "bert": bert_pretrain}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_synthetic_mlm_batches_equal_jax():
    ours, theirs = synthetic_mlm_batches(512, 4, 32, seed=3), jcommon.synthetic_mlm_batches(
        512, 4, 32, seed=3)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _run(example, argv, params=None):
    losses = []
    loss = example.main(argv, params=params,
                        on_step=lambda i, s, m: losses.append(float(m["loss"])))
    assert losses[-1] == loss
    return losses


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_tiny_one_rank_and_tp2_dp2(name, monkeypatch):
    from neuronx_distributed_tpu_torch.models.bert import BertForPreTraining
    from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
    from neuronx_distributed_tpu_torch.models.llama import init_params

    example = EXAMPLES[name]
    argv = ["--tiny", "--device", "cpu", "--steps", "3", "--log_every", "1"]
    one = _run(example, argv)
    assert len(one) == 3 and all(np.isfinite(one))
    # the same global weights on one rank and at TP 2 x DP 2
    if name == "bert":   # parity across layouts runs deterministic
        cfg = dataclasses.replace(example.build_config(example.parse_args(argv)),
                                  hidden_dropout=0.0)
        monkeypatch.setattr(example, "build_config", lambda args: cfg)
        cls = BertForPreTraining
    else:
        cfg, cls = example.build_config(example.parse_args(argv), 32), GPTNeoXForCausalLM
    params = init_params(cfg, torch.Generator().manual_seed(5), model_cls=cls)
    want = _run(example, argv + ["--tp", "1"], params=params)
    ranks = mesh.run_in_threads(4, lambda r: _run(example, argv, params=params),
                                tensor_model_parallel_size=2)
    for got in ranks:
        np.testing.assert_allclose(got, want, rtol=TOL)


def test_bert_resume_bit_for_bit(tmp_path):
    argv = ["--tiny", "--device", "cpu", "--log_every", "0"]
    finals = {}

    def keep(tag):
        def hook(i, state, metrics):
            finals[tag] = ({n: t.clone() for n, t in state.params.items()},
                           float(metrics["loss"]))
        return hook

    straight = []
    bert_pretrain.main(argv + ["--steps", "4"],
                       on_step=lambda i, s, m: (straight.append(float(m["loss"])),
                                                keep("straight")(i, s, m)))
    ckpt = str(tmp_path / "ckpt")
    head = []
    bert_pretrain.main(argv + ["--steps", "2", "--checkpoint_dir", ckpt],
                       on_step=lambda i, s, m: head.append(float(m["loss"])))
    tail = []
    bert_pretrain.main(argv + ["--steps", "4", "--checkpoint_dir", ckpt],
                       on_step=lambda i, s, m: (tail.append(float(m["loss"])),
                                                keep("resumed")(i, s, m)))
    assert head + tail == straight
    p1, p2 = finals["straight"][0], finals["resumed"][0]
    assert all(torch.equal(p1[n], p2[n]) for n in p1)


def test_seeded_init_builds_both_families_and_shards_it():
    from neuronx_distributed_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXConfig, GPTNeoXForCausalLM

    makers = {
        "bert": lambda: BertForPreTraining(BertConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=4,
            max_position_embeddings=32, dtype=torch.float32)),
        "gpt_neox": lambda: GPTNeoXForCausalLM(GPTNeoXConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=4,
            num_kv_heads=4, max_seq_len=32, dtype=torch.float32)),
    }
    for name, fn in makers.items():
        whole = initialize_parallel_model(neuronx_distributed_config(), fn, device="cpu")
        specs = param_partition_specs(whole.module)
        for n, t in whole.params.items():
            if n.endswith("bias"):
                assert not t.any(), n     # every bias starts at 0
        if name == "bert":
            assert specs["mlm_bias"] == ("tp",)

        def rank(r, fn=fn, whole=whole, specs=specs):
            m = initialize_parallel_model(neuronx_distributed_config(tensor_parallel_size=2),
                                          fn, device="cpu")
            tp_rank = mesh.tensor_model_parallel_rank()
            for n, t in m.params.items():
                assert torch.equal(t, shard_slice(whole.params[n], specs[n], tp_rank, 2)), n
            return True

        assert all(mesh.run_in_threads(2, rank, tensor_model_parallel_size=2))
