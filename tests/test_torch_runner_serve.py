"""``runner.py serve`` of the port against the JAX runner's, on the CPU,
``--tiny`` (fp32), one flag set a case.

The JAX runner serves its seeded weights at TP 2 on the 8-device mesh, the
port the same weights (``llama_params_from_jax``) at TP 1, over the same
``synthetic_trace``. Their reports agree in the schedule: requests
completed, tokens generated, rejected (shed), expired, prefix hits,
crashes and failovers, and each request's prompt length, tokens and
first-token block; the port's report holds every key of JAX's, plus only
the counters the port adds (its host-to-device copies, recovery fetches,
page I/O and the TP degree). ``--async`` is held against JAX's synchronous
loop, whose schedule the port's pipelined loop keeps. Snapshot recovery is
in ``test_torch_runner_cli.py``.
"""

import pytest
import torch

from tests.test_torch_runner import jax_params, run_jax, run_port

BASE = ["serve", "--tiny", "--max_batch", "2", "--num_requests", "4", "--max_new_tokens", "6",
        "--fused_steps", "3"]
FLAGS = {
    "plain": [],
    "paged": ["--paged", "--page_size", "4", "--shared_prefix_len", "8",
              "--mean_interarrival", "3.0"],
    "chunked": ["--prefill_chunk_tokens", "8", "--long_prompt_frac", "0.5",
                "--long_prompt_len", "24"],
    "async": ["--async"],
    "robustness": ["--deadline_ms", "40", "--max_queue", "3", "--shed_policy", "deadline",
                   "--fault_plan", '{"seed": 2, "dispatch_fail_prob": 0.15}'],
    "replicas_crash": ["--num_requests", "6", "--replicas", "2", "--crash_replica_at", "2",
                       "--tenants", "2", "--paged", "--page_size", "4"],
}
SCHEDULE = ("requests_completed", "total_generated_tokens", "rejected", "expired",
            "prefix_hit_tokens", "prefix_queries", "crashes", "failovers",
            "restored_requests", "shed_evictions", "decode_blocks", "inserted_requests",
            "chunk_program_calls")
PORT_KEYS = {"h2d_copies", "recovery_fetches", "tp_degree", "tier_d2h_copies",
             "tier_h2d_copies", "tier_blocking_spills"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def llama():
    return jax_params(max_batch=2)


def _request_rows(report):
    return [{k: r[k] for k in ("request_id", "prompt_len", "generated", "ttft_blocks") if k in r}
            for r in report.get("per_request", [])]


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_serve_schedule_equals_jax(flags, llama):
    argv = BASE + FLAGS[flags]
    # the pipelined loop is held against JAX's synchronous one (JAX's own
    # pipelined loop retires budget-finished streams a block late)
    (want,), _ = run_jax([a for a in argv if a != "--async"])
    (got,), code = run_port(argv, params=llama)
    assert code is None
    assert set(want) <= set(got) and set(got) - set(want) <= PORT_KEYS, (
        sorted(set(want) - set(got)), sorted(set(got) - set(want)))
    for key in SCHEDULE:
        assert got.get(key) == want.get(key), key
    assert _request_rows(got) == _request_rows(want)
    submitted = int(argv[len(argv) - 1 - argv[::-1].index("--num_requests") + 1])
    assert got["requests_completed"] + got.get("rejected", 0) == submitted
    if flags == "replicas_crash":
        assert got["crashes"] == got["failovers"] == 1
        assert got["total_generated_tokens"] == 6 * 6
