"""The port's serving entry point (``neuronx_distributed_tpu_torch/examples/
runner.py``) against the JAX runner (``examples/inference/runner.py``), on
the CPU, ``--tiny`` (fp32).

The JAX runner serves its seeded weights at TP 2 on the 8-device mesh; the
port's ``main(argv, params=...)`` serves the same weights, carried across
with ``llama_params_from_jax`` / ``mixtral_params_from_jax`` /
``medusa_params_from_jax``, at TP 1 (greedy streams do not depend on TP).
The reports' deterministic fields must be equal: the generated tokens,
``check-accuracy``'s match fields, speculation's and Medusa's tokens and
acceptance counts, and their key sets. Medusa, ``--hf_checkpoint`` and the
port's own surface are in ``test_torch_runner_cli.py``, the ``serve`` flag
sets in ``test_torch_runner_serve.py``.
"""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.converters.jax_params import (
    llama_params_from_jax,
    mixtral_params_from_jax,
)
from neuronx_distributed_tpu_torch.examples import runner

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
for sub in ("", "inference"):
    if str(EXAMPLES / sub) not in sys.path:
        sys.path.insert(0, str(EXAMPLES / sub))

LOGIT_TOL = 1e-3   # JAX's own bound for the tiny fp32 check-accuracy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_runner():
    import runner as jax_runner

    return jax_runner


def run_jax(argv):
    """JAX runner's stdout lines as JSON, and whether it exited."""
    from neuronx_distributed_tpu.parallel import mesh as jmesh

    buf, code = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            _jax_runner().main(argv)
        except SystemExit as e:
            code = e.code
    jmesh.destroy_model_parallel()
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()], code


def run_port(argv, params=None, config=None):
    buf, code = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            runner.main(argv + ["--device", "cpu"], params=params, config=config)
        except SystemExit as e:
            code = e.code
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()], code


def jax_params(model="llama", max_batch=1):
    """The JAX runner's seeded weights (its ``build_model``), in the port's
    names."""
    from neuronx_distributed_tpu.parallel import mesh as jmesh

    ns = argparse.Namespace(tiny=True, model=model, hf_checkpoint=None, max_seq_len=4096,
                            max_batch=max_batch, tensor_parallel_size=None, quantize=False,
                            paged=False, cmd="generate")
    lm, _ = _jax_runner().build_model(ns)
    tree = jax.tree.map(lambda a: np.array(a), lm.params)
    jmesh.destroy_model_parallel()
    return (mixtral_params_from_jax if model == "mixtral" else llama_params_from_jax)(tree)


@pytest.fixture(scope="module")
def llama():
    return jax_params()


def _same_keys(j: dict, p: dict):
    assert set(j) == set(p), (sorted(set(j) - set(p)), sorted(set(p) - set(j)))


@pytest.mark.parametrize("model,extra", [("llama", ["--max_batch", "2"]),
                                         ("llama", ["--fused_chunk", "3", "--max_new_tokens",
                                                    "7"]),
                                         ("mixtral", [])])
def test_generate_equals_jax(model, extra, llama):
    argv = ["generate", "--tiny", "--model", model, "--max_new_tokens", "6", *extra]
    params = llama if model == "llama" else jax_params("mixtral")
    want, _ = run_jax(argv)
    got, code = run_port(argv, params=params)
    assert code is None
    assert got == want and all(len(r["generated"]) == 6 or "7" in extra for r in got)


def test_check_accuracy_equals_jax(llama):
    argv = ["check-accuracy", "--tiny", "--max_new_tokens", "8"]
    (want,), _ = run_jax(argv)
    (got,), code = run_port(argv, params=llama)
    assert code is None
    _same_keys(want, got)
    for key in ("golden", "prompt_len", "generated", "greedy_match", "match_len",
                "first_divergence", "argmax_first_mismatch_pos", "positions_checked"):
        assert got[key] == want[key], key
    assert got["greedy_match"] is True and got["logit_max_abs_diff"] < LOGIT_TOL


@pytest.mark.parametrize("fused_rounds", [0, 2])
def test_speculate_equals_jax(fused_rounds, llama):
    argv = ["speculate", "--tiny", "--max_new_tokens", "6", "--num_draft", "2",
            "--draft_layers", "1", "--fused_rounds", str(fused_rounds)]
    (want,), _ = run_jax(argv)
    (got,), code = run_port(argv, params=llama)
    assert code is None
    _same_keys(want, got)
    for key in ("generated", "draft_layers", "num_draft", "rounds", "proposed", "accepted",
                "tokens_per_round"):
        assert got[key] == want[key], key
    assert len(got["generated"]) == 6
