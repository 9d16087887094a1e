"""The port's serving entry point (``examples/runner.py``): ``medusa`` and
``check-accuracy --hf_checkpoint`` against the JAX runner, and the port's
own surface, on the CPU, ``--tiny``.

Medusa: JAX's seeded ``MedusaLlamaForCausalLM`` tree (its runner's init)
carried across with ``medusa_params_from_jax``; the tokens, the invariant
and the acceptance counts equal JAX's. ``--hf_checkpoint``: a tiny
``transformers`` Llama written to local safetensors, served in bf16 and
held against its own fp32 model, as JAX holds it. Port only:
``benchmark``'s report keys, every refusal of ``build_model``,
``cmd_speculate`` and ``cmd_medusa`` (a ``SystemExit`` on JAX's
conditions) and ``--tp`` above the world (the subcommands at ``--tp 2`` are
in ``test_torch_runner_tp.py``). ``serve --snapshot_path``:
a snapshot a JAX engine wrote (the JAX version-1 format the port reads),
restored and finished by both runners alike.
"""

import argparse
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.converters.jax_params import medusa_params_from_jax
from neuronx_distributed_tpu_torch.examples import runner
from tests.test_torch_runner import _jax_runner, _same_keys, run_jax, run_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_check_accuracy_hf_checkpoint(tmp_path):
    """``--hf_checkpoint``: a tiny ``transformers`` Llama converted and
    served (bf16), against its own fp32 model, the JAX runner on the same
    files."""
    from transformers import LlamaConfig as HFC
    from transformers import LlamaForCausalLM as HFM

    from neuronx_distributed_tpu_torch.converters.hf_llama import save_hf_safetensors

    torch.manual_seed(0)
    hc = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              tie_word_embeddings=False)
    m = HFM(HFC(**hc, attention_dropout=0.0))
    state = {k: v.detach() for k, v in m.state_dict().items() if "rotary_emb" not in k}
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    save_hf_safetensors(state, str(hf_dir / "model.safetensors"))
    (hf_dir / "config.json").write_text(json.dumps({**hc, "model_type": "llama"}))
    argv = ["check-accuracy", "--tiny", "--hf_checkpoint", str(hf_dir), "--max_seq_len", "64",
            "--max_new_tokens", "4"]
    (want,), _ = run_jax(argv)
    (got,), _ = run_port(argv)
    _same_keys(want, got)
    assert got["golden"] == "transformers_fp32"
    assert got["positions_checked"] == want["positions_checked"] > 0
    assert got["logit_max_abs_diff"] < 0.25   # bf16 resolution (JAX's bound)


def test_medusa_equals_jax():
    """JAX's seeded Medusa tree (its runner's init) carried across."""
    from flax.core import meta

    from neuronx_distributed_tpu.inference.medusa import MedusaLlamaForCausalLM
    from neuronx_distributed_tpu.parallel import mesh as jmesh

    argv = ["medusa", "--tiny", "--max_new_tokens", "6"]
    (want,), code_j = run_jax(argv)
    cfg = _jax_runner().build_config(argparse.Namespace(tiny=True, model="llama",
                                                        max_seq_len=4096))
    jmesh.initialize_model_parallel(tensor_model_parallel_size=2)
    mm = MedusaLlamaForCausalLM(dataclasses.replace(cfg, decode=True), num_medusa_heads=2)
    tree = meta.unbox(jax.jit(lambda: mm.init(jax.random.key(0),
                                              jnp.zeros((1, 8), jnp.int32)))())["params"]
    jmesh.destroy_model_parallel()
    params = medusa_params_from_jax(jax.tree.map(lambda a: np.array(a), tree))
    (got,), code = run_port(argv, params=params)
    assert code is None and code_j is None
    _same_keys(want, got)
    for key in ("generated", "matches_base_greedy", "rounds", "accepted", "proposed"):
        assert got[key] == want[key], key
    assert got["matches_base_greedy"] is True


def test_benchmark_report_keys():
    (got,), code = run_port(["benchmark", "--tiny", "--trials", "2", "--decode_steps", "4",
                             "--fused_chunk", "2"])
    assert code is None
    assert set(got) == {"model", "tp", "batch", "prompt_len", "context_encoding",
                        "token_generation", "decode_tokens_per_sec", "token_generation_fused",
                        "fused_chunk", "decode_tokens_per_sec_fused"}
    for key in ("context_encoding", "token_generation", "token_generation_fused"):
        assert set(got[key]) == {"p50_ms", "p90_ms", "p95_ms", "p99_ms", "p100_ms"}
        assert got[key]["p50_ms"] > 0
    assert (got["model"], got["tp"], got["batch"], got["prompt_len"]) == ("llama_tiny", 1, 1, 16)


REFUSALS = {
    "paged_off_serve": (["generate", "--paged"], "--paged applies to the serve"),
    "paged_kernel_off_serve": (["benchmark", "--paged-kernel"], "--paged-kernel/--kv_dtype"),
    "kv_dtype_off_serve": (["generate", "--kv_dtype", "int8"], "--paged-kernel/--kv_dtype"),
    "adapters_off_serve": (["generate", "--adapters", "2"], "--adapters applies"),
    "adapters_quantize": (["serve", "--adapters", "1", "--quantize"], "--adapters with --quantize"),
    "grammar_off_serve": (["generate", "--grammar_frac", "0.5"], "--grammar_frac applies"),
    "speculate_top_k": (["speculate", "--top_k", "5"], "top_k/top_p acceptance"),
    "speculate_top_p": (["speculate", "--top_p", "0.9"], "top_k/top_p acceptance"),
    "draft_too_deep": (["speculate", "--draft_layers", "2"], "--draft_layers must be in [1, 1]"),
    "draft_zero": (["speculate", "--draft_layers", "0"], "--draft_layers must be in"),
    "medusa_mixtral": (["medusa", "--model", "mixtral"], "medusa supports --model llama"),
    "medusa_sample": (["medusa", "--sample"], "medusa supports none of"),
    "medusa_quantize": (["medusa", "--quantize"], "medusa supports none of"),
    "disagg_unpaged": (["serve", "--replicas", "2", "--disagg", "--num_requests", "2"],
                       "--disagg requires --paged"),
    "tp_above_world": (["generate", "--tp", "2"], "--tp 2 on a world of 1"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(case):
    argv, says = REFUSALS[case]
    with pytest.raises(SystemExit) as e:
        runner.main([argv[0], "--tiny", "--device", "cpu", *argv[1:]])
    assert says in str(e.value.code)


def test_serve_snapshot_recovery_equals_jax(tmp_path):
    """A snapshot left by a JAX engine stopped after one block: both
    runners restore it and finish the same streams."""
    from neuronx_distributed_tpu.inference import ServeEngine
    from neuronx_distributed_tpu.inference.engine import synthetic_trace
    from neuronx_distributed_tpu.parallel import mesh as jmesh

    snap = tmp_path / "serve.snap"
    lm, cfg = _jax_runner().build_model(argparse.Namespace(
        tiny=True, model="llama", hf_checkpoint=None, max_seq_len=4096, max_batch=2,
        tensor_parallel_size=None, quantize=False, paged=False, cmd="serve"))
    from neuronx_distributed_tpu_torch.converters.jax_params import llama_params_from_jax

    params = llama_params_from_jax(jax.tree.map(lambda a: np.array(a), lm.params))
    lm.compile()
    eng = ServeEngine(lm, block_steps=3, rng=jax.random.key(0))
    for item in synthetic_trace(3, cfg.vocab_size, prompt_lens=(8,), max_new_tokens=9, seed=0):
        eng.submit(item["prompt"], item["max_new_tokens"])
    eng.run(max_blocks=1, snapshot_path=str(snap), snapshot_every_blocks=1)
    pre = sum(len(c.tokens) for c in eng.completed)
    jmesh.destroy_model_parallel()
    copy = tmp_path / "serve_port.snap"
    shutil.copy(snap, copy)
    argv = ["serve", "--tiny", "--max_batch", "2", "--fused_steps", "3", "--snapshot_path"]
    (want,), _ = run_jax(argv + [str(snap)])
    (got,), code = run_port(argv + [str(copy)], params=params)
    assert code is None and not copy.exists() and not snap.exists()
    assert got == want
    assert got["recovered"] is True and got["restored_requests"] >= 1
    assert pre + got["total_generated_tokens"] == 3 * 9
    json.dumps(got)
