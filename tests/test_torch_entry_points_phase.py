"""Phase 4p of ``chip_smoke.py`` (the runner and the fit loop as a user
runs them) rehearsed on the CPU at small sizes: every cell through the same
functions the card runs, the kernels' plain twins in place of the kernels.

The kernel check holds B5 and B1 at small shapes through the same rule.
The runner cells (r0)-(r4) serve a small fp32 Llama (8 layers, so the
layers dominate the int8 tree as they do at 13B) with the benchmark cut to
a 256-token prompt, the serve trace to 8 requests, and (r3) and (r4 check)
to 2 layers; (r0 shell) runs the ``--tiny`` generate as a process of the
runner's module against the same generate in this process; (r5) runs the
``--tiny`` cases; (l0) fits the tiny Llama with a SIGTERM at step 2, its
resume and ``grad_accum_steps=2``. Every gate but the launch and memory
gates (the CPU runs no kernel) must hold.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    flash_block_forward,
    flash_bwd_dkdv,
    flash_bwd_dq,
)
from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, init_params
from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf

ROOT = Path(__file__).resolve().parents[1]
RUNNER_COUNTERS = (flash_block_forward, paged_decode_attention, w8a16_gemm)
TINY_GENERATE = ["generate", "--tiny", "--max_new_tokens", "8", "--fused_chunk", "4"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def threads():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and a wider pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_runner_cells_rehearse_on_the_cpu(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "EP_BENCH", ["benchmark", "--max_batch", "1", "--prompt_len",
                                            "256", "--trials", "2", "--decode_steps", "4",
                                            "--fused_chunk", "2"])
    serve = list(smoke.EP_SERVE) + ["--page_size", "16"]
    for flag, value in (("--num_requests", "8"), ("--prompt_len", "64"),
                        ("--max_new_tokens", "8"), ("--max_batch", "4")):
        serve[serve.index(flag) + 1] = value
    monkeypatch.setattr(smoke, "EP_SERVE", serve)
    cfg = LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=512, num_layers=8,
                      num_heads=4, num_kv_heads=4, max_seq_len=1024, dtype=torch.float32,
                      param_dtype=torch.float32, remat_policy=None)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    st = dict(card_bytes=0, init_s=0.0)
    st.update(smoke.ep_runner_cells("cpu", RUNNER_COUNTERS, params, cfg, config=cfg))
    st.update(smoke.ep_check_cell("cpu", RUNNER_COUNTERS,
                                  cfg=dataclasses.replace(cfg, num_layers=2)))
    # the shell process seeds its own model: its oracle is the same tiny
    # generate in this process
    monkeypatch.setattr(smoke, "EP_GENERATE", TINY_GENERATE)
    st["r0_shell"] = smoke.ep_shell("cpu")
    st["r0_generate"] = smoke.ep_run(TINY_GENERATE, "cpu", RUNNER_COUNTERS)
    assert smoke.ep_runner_problems(st, kernels=False) == []
    assert set(st["r0_shell"]["launches"]) == {c.__name__ for c in RUNNER_COUNTERS}
    assert st["r4_check"]["report"]["greedy_match"] is True
    assert st["r2"]["host"]["draft_shared"] and st["r2"]["host"]["draft_tensors"] > 0
    assert st["r1"]["report"]["paged_attn_kernel"] is True
    assert st["r1"]["report"]["async_loop"] is True


def test_kernel_check_rehearses_on_the_cpu(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "EP_B5_SHAPES", ((64, 96), (128, 64)))
    monkeypatch.setattr(smoke, "EP_B5_ROWS", (1, 8))
    monkeypatch.setattr(smoke, "EP_B1_INSERT", dict(h=2, sq=128, sk=256, d=128))
    got = smoke.ep_kernel_check("cpu")
    assert got["problems"] == []
    assert len(got["readings"]["w8a16_gemm"]) == 8
    assert got["readings"]["flash_block_forward"]["max_abs_err"] == 0.0


def test_tiny_cells_and_fit_rehearse_on_the_cpu(smoke, tmp_path):
    r5 = smoke.ep_tiny_cells("cpu", RUNNER_COUNTERS, tmp_path)
    assert smoke.ep_tiny_problems(r5) == []
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=4, max_seq_len=32, dtype=torch.float32,
                      param_dtype=torch.float32, use_flash_attention=False, remat_policy=None)
    l0 = smoke.ep_fit("cpu", (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq,
                              fused_adamw_leaf), tmp_path, cfg=cfg, batch=2)
    assert smoke.ep_fit_problems(l0, kernels=False) == []
    assert l0["resumed_equal"] and l0["accum_moved"] == [False, True, False, True]
