"""Phase 4n of ``chip_smoke.py`` rehearsed on the CPU at tiny shapes: its
pieces and its gates CPU against CPU (the gates on fabricated readings are
in ``tests/test_torch_chip_smoke_checks.py``).

* (m0) and (m1) on the ``mixtral_moe`` example's ``--tiny`` model: (m0)
  through ``moe_m0`` on one rank (remat ``"full"``), (m1) through the
  example's ``main`` on TP 2 x EP 2 thread ranks; the losses agree within
  1e-5 and every rank reads each layer's dropped assignments, the same on
  every rank; ``moe_gates`` then speaks only of the launches the CPU never
  makes;
* (m2)'s small fp32 Mixtral through ``moe_small_trainer`` at TP 2 x EP 2
  and EP 2 x edp 2 thread ranks and the DBRX model's step, against one
  rank: losses and grad norms within 1e-5, dropped assignments equal.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) < 1e-5 and abs(a["grad_norm"] - b["grad_norm"]) < 1e-5
        assert a["dropped"] == b["dropped"]


def test_m0_m1_rehearse_on_the_cpu(smoke, monkeypatch):
    from neuronx_distributed_tpu_torch.examples import mixtral_moe as example
    from neuronx_distributed_tpu_torch.parallel import mesh

    for name in ("reset_peak_memory_stats", "synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a, **k: (0, 1 << 36))
    monkeypatch.setattr(smoke, "MOE_SEQ", 32)
    monkeypatch.setattr(smoke, "MOE_BATCH", 4)
    args = smoke.moe_args
    monkeypatch.setattr(smoke, "moe_args", lambda layers, extra=(): args(
        layers, ["--tiny", *extra]))
    m0 = smoke.moe_m0("cpu", ())
    assert m0["capacity"] == 64 and len(m0["steps"]) == smoke.MOE_STEPS

    def rank(r):
        steps = []
        held = {}
        example.main(smoke.moe_args(2, ["--tp", "2", "--ep", "2", "--device", "cpu"]),
                     on_model=lambda model, state: held.update(module=model.module),
                     on_step=lambda i, state, m: steps.append(dict(
                         loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         dropped=smoke.moe_dropped(held["module"]))))
        return dict(rank=r, m1=dict(steps=steps, launches={},
                                    collectives={"all_to_all": [1, 1]}))

    ranks = mesh.run_in_threads(4, rank, tensor_model_parallel_size=2,
                                expert_model_parallel_size=2)
    for rk in ranks:
        _close(rk["m1"]["steps"], m0["steps"])
    problems = smoke.moe_gates(m0, ranks)
    assert m0["m1_loss_max_rel_diff"] < 1e-5
    assert problems and all("never launched" in p for p in problems), problems


def test_m2_small_models_rehearse_on_the_cpu(smoke, monkeypatch):
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.parallel import mesh

    narrow = dataclasses.replace(smoke.small_config(), hidden_size=64, intermediate_size=128,
                                 vocab_size=128, num_heads=4, num_kv_heads=2, max_seq_len=64,
                                 use_flash_attention=False)
    monkeypatch.setattr(smoke, "small_config", lambda: narrow)
    monkeypatch.setattr(smoke, "MOE_SMALL_SEQ", 32)
    small, dbrx = smoke.moe_small_config(), smoke.moe_dbrx_config()
    assert (small.capacity_factor, dbrx.norm_type, dbrx.top_k) == (1.0, "layernorm", 4)
    params = init_params(small, torch.Generator().manual_seed(0), model_cls=MixtralForCausalLM)
    dparams = init_params(dbrx, torch.Generator().manual_seed(1), model_cls=MixtralForCausalLM)
    batches = smoke.moe_small_batches(small.vocab_size)
    state, step, model = smoke.moe_small_trainer("cpu", small, params)
    _, want = smoke.moe_small_steps(state, step, model, batches, "cpu")
    state, step, model = smoke.moe_small_trainer("cpu", dbrx, dparams)
    _, dwant = smoke.moe_small_steps(state, step, model, batches[:1], "cpu")
    assert sum(sum(map(sum, s["dropped"])) for s in want) > 0   # tokens drop

    def rank(r):
        state, step, model = smoke.moe_small_trainer("cpu", small, params)
        got = smoke.moe_small_steps(state, step, model, batches, "cpu")[1]
        state, step, model = smoke.moe_small_trainer("cpu", dbrx, dparams)
        return got, smoke.moe_small_steps(state, step, model, batches[:1], "cpu")[1]

    for tp, ep in smoke.MOE_SMALL_LAYOUTS.values():
        for got, dgot in mesh.run_in_threads(4, rank, tensor_model_parallel_size=tp,
                                             expert_model_parallel_size=ep):
            _close(got, want)
            _close(dgot, dwant)
