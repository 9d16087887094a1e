"""The port's runner (``examples/runner.py``) at ``--tp 2`` against the JAX
runner at its tiny default TP 2, on the CPU (fp32), and the route it
takes over a gloo group on the card.

The port's two ranks are threads over one gloo group, each calling
``runner.main([... "--tp", "2"], params=...)`` with the JAX runner's
seeded global weights (its ``build_model``, carried across): the runner
cuts each rank's shard, and with ``--quantize`` quantizes the global tree
before the cut, as JAX does. Cases: ``generate --quantize``, ``generate
--model mixtral``, ``speculate``, ``medusa`` and ``serve --adapters 1`` on
a ``num_kv_heads=2, kv_size_multiplier=2`` config (the JAX runner's
``build_config`` patched to it). The deterministic report fields must
equal JAX's on both ranks, as ``tests/test_torch_runner.py`` compares
them.

A float tree already cut to a rank's shards is refused under
``--quantize`` by name.

The route: with the capture predicate patched to "on the card", a gloo group
takes the eager route (``capture_programs=False``, engines with
``fused=False``), logged, and ``--fused_chunk`` and ``--fused_rounds``
are refused by name; with no group the captured route stays.
"""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    medusa_params_from_jax,
)
from neuronx_distributed_tpu_torch.examples import runner
from neuronx_distributed_tpu_torch.parallel import mesh
from tests.test_torch_runner import _jax_runner, _same_keys, jax_params, run_jax
from tests.test_torch_runner_serve import SCHEDULE, _request_rows


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_tp2(argv, params=None, config=None):
    """The port's runner on two thread ranks at ``--tp 2``: each rank's
    report (a list of streams for ``generate``)."""
    def rank(r):
        return runner.main(argv + ["--device", "cpu", "--tp", "2"], params=params,
                           config=config)

    return mesh.run_in_threads(2, rank, tensor_model_parallel_size=2)


GENERATE = {
    "quantize": (["generate", "--tiny", "--quantize", "--max_new_tokens", "6"], "llama"),
    "mixtral": (["generate", "--tiny", "--model", "mixtral", "--max_new_tokens", "6"],
                "mixtral"),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_tp2_equals_jax(case):
    argv, model = GENERATE[case]
    want, _ = run_jax(argv)
    for got in run_tp2(argv, params=jax_params(model)):
        assert got == want and all(len(r["generated"]) == 6 for r in got)


def test_speculate_tp2_equals_jax():
    argv = ["speculate", "--tiny", "--max_new_tokens", "6", "--num_draft", "2",
            "--draft_layers", "1"]
    (want,), _ = run_jax(argv)
    for got in run_tp2(argv, params=jax_params()):
        _same_keys(want, got)
        for key in ("generated", "draft_layers", "num_draft", "rounds", "proposed", "accepted",
                    "tokens_per_round"):
            assert got[key] == want[key], key


def test_medusa_tp2_equals_jax():
    """JAX's seeded Medusa tree (its runner's init at TP 2), the heads cut
    over the vocabulary by the port's runner."""
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
                                              jax.numpy.zeros((1, 8), jax.numpy.int32)))())
    jmesh.destroy_model_parallel()
    params = medusa_params_from_jax(jax.tree.map(lambda a: np.array(a), tree["params"]))
    assert code_j is None
    for got in run_tp2(argv, params=params):
        _same_keys(want, got)
        for key in ("generated", "matches_base_greedy", "rounds", "accepted", "proposed"):
            assert got[key] == want[key], key
        assert got["matches_base_greedy"] is True


def test_serve_adapters_kv_multiplier_tp2_equals_jax(monkeypatch):
    """``serve --adapters 1`` on ``num_kv_heads=2, kv_size_multiplier=2``:
    the schedule and every request's row equal the JAX runner's at TP 2."""
    jr = _jax_runner()
    base = jr.build_config

    def kvm2(args):
        return dataclasses.replace(base(args), num_kv_heads=2, kv_size_multiplier=2)

    monkeypatch.setattr(jr, "build_config", kvm2)
    argv = ["serve", "--tiny", "--adapters", "1", "--max_batch", "2", "--num_requests", "4",
            "--max_new_tokens", "6", "--fused_steps", "3"]
    (want,), _ = run_jax(argv)
    ns = argparse.Namespace(tiny=True, model="llama", hf_checkpoint=None, max_seq_len=4096,
                            max_batch=2, tensor_parallel_size=None, quantize=False, paged=False,
                            cmd="generate")
    lm, _ = jr.build_model(ns)
    params = llama_params_from_jax(jax.tree.map(lambda a: np.array(a), lm.params))
    from neuronx_distributed_tpu.parallel import mesh as jmesh

    jmesh.destroy_model_parallel()
    config = dataclasses.replace(runner.build_config(runner.parse_args(["serve", "--tiny"])),
                                 num_kv_heads=2, kv_size_multiplier=2)
    for got in run_tp2(argv, params=params, config=config):
        assert got["tp_degree"] == 2
        for key in SCHEDULE:
            assert got.get(key) == want.get(key), key
        assert _request_rows(got) == _request_rows(want)
        assert got["requests_completed"] == 4


def test_quantize_refuses_a_rank_cut_float_tree():
    """``--quantize`` at ``--tp 2`` on a float tree already cut to the
    rank's shards exits naming a weight: quantized alone, each cut would
    take scales of its own (the global tree is quantized whole)."""
    from neuronx_distributed_tpu_torch.models.llama import init_params

    argv = ["generate", "--tiny", "--quantize", "--max_new_tokens", "2", "--device", "cpu",
            "--tp", "2"]
    cfg = runner.build_config(runner.parse_args(argv))

    def rank(r):
        mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", tp_rank=r,
                           tp_size=2)
        with pytest.raises(SystemExit) as e:
            runner.main(argv, params=mine)
        return str(e.value.code)

    for msg in mesh.run_in_threads(2, rank, tensor_model_parallel_size=2):
        assert "--quantize at --tp 2" in msg and "not its global" in msg, msg


# ----------------------------------------------------------- the route (§0)

@pytest.fixture
def on_card(monkeypatch):
    """The runner's capture predicate patched to read a gloo group as on
    the card; records each route the runner chooses and every engine's
    ``fused``."""
    from neuronx_distributed_tpu_torch.inference import engine

    routes, fused = [], []
    choose = runner.captured_route
    monkeypatch.setattr(runner, "capturable",
                        lambda dev, group: mesh.group_backend(group) != "gloo")
    monkeypatch.setattr(runner, "captured_route",
                        lambda dev, tp: routes.append((tp, choose(dev, tp))) or routes[-1][1])

    class Engine(engine.ServeEngine):
        def __init__(self, *a, **kw):
            fused.append(kw.get("fused", True))
            super().__init__(*a, **kw)

    monkeypatch.setattr(engine, "ServeEngine", Engine)
    return routes, fused


def test_gloo_on_card_takes_the_eager_route(on_card):
    routes, fused = on_card
    argv = ["serve", "--tiny", "--max_batch", "2", "--num_requests", "2", "--max_new_tokens",
            "3"]
    reports = run_tp2(argv)
    assert reports[0]["requests_completed"] == 2
    assert routes and all(r == (2, False) for r in routes)
    assert fused and not any(fused)
    lms = mesh.run_in_threads(2, lambda r: runner.build_model(runner.parse_args(
        ["generate", "--tiny", "--device", "cpu", "--tp", "2"]))[0].capture_programs)
    assert lms == [False, False]
    # one process, no group: the captured route, fused blocks
    routes.clear()
    fused.clear()
    runner.main(argv + ["--device", "cpu"])
    assert routes == [(1, True)] and all(fused)


@pytest.mark.parametrize("argv,flag", [
    (["benchmark", "--fused_chunk", "2"], "--fused_chunk"),
    (["speculate", "--fused_rounds", "2", "--draft_layers", "1"], "--fused_rounds")])
def test_captured_blocks_refused_over_gloo_on_card(on_card, argv, flag):
    def rank(r):
        with pytest.raises(SystemExit) as e:
            runner.main([argv[0], "--tiny", "--device", "cpu", "--tp", "2", *argv[1:]])
        return str(e.value.code)

    for msg in mesh.run_in_threads(2, rank, tensor_model_parallel_size=2):
        assert flag in msg and "gloo" in msg
