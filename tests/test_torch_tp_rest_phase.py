"""Phase 4q of ``chip_smoke.py`` (tensor-parallel serving, the rest)
rehearsed on the CPU at small sizes: two thread ranks over one gloo group
run every cell through the same functions the card's two processes run,
the kernels' plain twins in place of the kernels, and the parent's TP=1
references and gates follow.

(u0) holds B5 and B1 at small shapes by the same rule; (u1)/(u2) run the
runner's ``generate``/``serve --paged --paged-kernel`` at ``--tp 2`` on a
small int8 Mixtral (8 experts, top 2: selective at one row), (u3) its
``speculate``/``medusa`` on a small Llama, (u4) the small fp32 cases.
Every gate but the launch gates and the eager route's (the CPU runs the
twins, captured) must hold.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig
from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig
from neuronx_distributed_tpu_torch.parallel import mesh

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = (flash_block_forward, paged_decode_attention, w8a16_gemm)
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=1024, dtype=torch.float32,
             param_dtype=torch.float32, remat_policy=None)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_rehearses_on_thread_ranks(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "TPR_B5_SHAPES", {"dense": (64, 96, 1), "experts": (64, 32, 4)})
    monkeypatch.setattr(smoke, "TPR_B5_ROWS", (1, 8))
    monkeypatch.setattr(smoke, "TPR_B1", {"mixtral": dict(h=4, hk=2, sq=128, d=128),
                                          "13b": dict(h=2, hk=2, sq=128, d=128)})
    mixtral = MixtralConfig(**SMALL, num_experts=8, top_k=2)
    monkeypatch.setattr(smoke, "tpr_mixtral_config", lambda layers=2: mixtral)
    monkeypatch.setattr(smoke, "tpr_llama_config", lambda layers=4: LlamaConfig(
        **{**SMALL, "num_layers": 4}))
    monkeypatch.setattr(smoke, "small_config", lambda: LlamaConfig(**{
        **SMALL, "vocab_size": 256, "max_seq_len": 256}))
    ranks = mesh.run_in_threads(2, lambda r: {"rank": r, "rest": smoke.tpr_rank_cells(
        "cpu", COUNTERS, r, 2)})
    t2 = dict(ranks=ranks, card_peak_used_bytes=0, card_bytes=1)
    rest = smoke.tpr_finish(t2, "cpu", COUNTERS, on_card=False)
    assert rest["problems"] == []
    for rk in rest["ranks"]:
        assert len(rk["u0"]["w8a16_gemm"]) == 5 and len(rk["u0"]["flash_block_forward"]) == 1
        assert rk["u1"]["token_match_tp1"] == 1.0 and rk["u1"]["selective_calls"] > 0
        assert rk["u2"]["report"]["requests_completed"] == 8
        assert rk["u3"]["speculate"]["draft_shared"]
        assert rk["weight_bytes"] <= 0.55 * rk["weight_bytes_tp1"]
    assert rest["ranks"][0]["u2"]["digest"] == rest["ranks"][1]["u2"]["digest"]
    paths = smoke.tpr_launches_by_path(rest)
    assert paths == {}   # the twins launch nothing
