"""Phase 4m of ``chip_smoke.py`` rehearsed on the CPU at tiny shapes: its
trainer pieces and its ring check, the card's gates CPU against CPU (the
gates themselves are held on fabricated readings in
``tests/test_torch_chip_smoke_checks.py``).

* (c2)'s small model through ``cp_trainer`` on CP 2 x TP 2 thread ranks
  against one rank (losses and grad norms within 1e-5);
* the ring check's blocks against the one-rank ring, the element rule with
  its per-term sizes, and the twins' ring against the fp64 ring;
* (p3)'s ``PipelinedLlama`` trainer at TP 2 x PP 2, 1F1B and interleaved,
  against one rank (within 1e-5);
* the ring check's rule fails each planted fault of the ring
  (``ring_fault_check``);
* the check of B1 and B3a/B3b at the paths' shapes (``path_kernel_check``)
  runs its ring and stage cases clean on the twins; on the CPU no wrapper
  counts a launch, so its dispatcher gate is the one that speaks.
"""

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


def test_cp_pp_pieces_rehearse_on_the_cpu(smoke, monkeypatch):
    """Phase 4m's trainer pieces at tiny shapes on the CPU: (c2)'s small
    model through ``cp_trainer`` on CP 2 x TP 2 thread ranks against one
    rank, the ring check's blocks against the one-rank ring, and (p3)'s
    ``PipelinedLlama`` trainer at TP 2 x PP 2 against one rank (the card's
    gates, CPU against CPU: every difference reads within 1e-5)."""
    import dataclasses

    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.parallel import mesh

    monkeypatch.setattr(smoke, "RING_CHECK", dict(b=1, h=4, hk=2, s=192, d=64, block=32))
    small = dataclasses.replace(smoke.small_config(), hidden_size=64, intermediate_size=128,
                                vocab_size=128, max_seq_len=64, cp_layout="zigzag")
    monkeypatch.setattr(smoke, "small_config", lambda: dataclasses.replace(
        small, cp_layout="contiguous"))
    params = init_params(small, torch.Generator().manual_seed(0))
    batches = smoke.cp_batches(small.vocab_size, small.max_seq_len, 2, 4, seed=31)
    _, state, step = smoke.cp_trainer("cpu", small, 1e-3, params=params)
    _, want = smoke.cp_steps(state, step, batches, "cpu")

    def cp_rank(r):
        _, state, step = smoke.cp_trainer("cpu", small, 1e-3, cp=2, tp=2, params=params)
        return smoke.cp_steps(state, step, batches, "cpu")[1], smoke.ring_check_rank("cpu"), \
            mesh.local_mesh_coords()["cp"]

    got = mesh.run_in_threads(4, cp_rank, tensor_model_parallel_size=2, context_parallel_size=2)
    ring = mesh.run_in_threads(2, lambda r: smoke.ring_check_rank("cpu"),
                               tensor_model_parallel_size=1, context_parallel_size=2)
    for steps, blocks, cp in got:
        for a, b in zip(steps, want):
            assert abs(a["loss"] - b["loss"]) < 1e-5 and abs(a["grad_norm"] - b["grad_norm"]) < 1e-5
        for n, t in blocks.items():   # the TP ranks of a cp rank hold its ring's bits
            assert torch.equal(t, ring[cp][n]), n
    # the ring check itself, CPU ranks against CPU ranks; each term's size
    # bounds the result's
    held = smoke.ring_check({r: ring[r] for r in range(2)})
    assert all(h["ok"] and h["max_abs_err"] == 0.0 for r in held.values() for h in r.values())
    sizes, exact = smoke.ring_references([{n: ring[r][n] for n in smoke.RING_FLOORS}
                                          for r in range(2)])
    for r in range(2):   # the twins' ring is within the rule of the fp64 ring
        for n, t in exact[r].items():
            assert smoke.held(ring[r][n], t.float(), 1e-3, size=sizes[r][n])["ok"], n
    for r in range(2):   # at least |result| and the terms' exact sum's magnitude
        for n, t in sizes[r].items():
            assert bool((t >= ring[r][n].float().abs()).all()), n
            assert bool((t >= (1 - 1e-6) * exact[r][n].abs().float()).all()), n
    # an error of a last place of every term passes with the sizes, and
    # fails where it exceeds a last place of the result alone
    bump = ring[0]["dk"].float() + smoke.REL_BF16 * sizes[0]["dk"]
    assert smoke.held(bump, ring[0]["dk"], 1e-6, size=sizes[0]["dk"])["ok"]
    assert not smoke.held(bump, ring[0]["dk"], 1e-6)["ok"]
    pp_params = init_params(smoke.pp_small_config(), torch.Generator().manual_seed(0))
    pbatches = smoke.pp_small_batches()[:2]
    state, step = smoke.pp_small_trainer("cpu", pp_params, 1, stages=1, tp=1)
    _, one = smoke.pp_small_steps(state, step, pbatches, "cpu")

    def pp_rank(r):
        out = []
        for chunks in (1, 2):
            state, step = smoke.pp_small_trainer("cpu", pp_params, chunks)
            out.append(smoke.pp_small_steps(state, step, pbatches, "cpu")[1])
        return out

    for runs in mesh.run_in_threads(4, pp_rank, tensor_model_parallel_size=2,
                                    pipeline_model_parallel_size=2):
        for steps in runs:
            for a, b in zip(steps, one):
                assert abs(a["loss"] - b["loss"]) < 1e-5
                assert abs(a["grad_norm"] - b["grad_norm"]) < 1e-5


def test_ring_check_fails_each_planted_fault(smoke, monkeypatch):
    """Every planted fault needs a floor far above ``RING_FLOORS`` under the
    ring check's rule; the sound ring needs none (CPU against CPU)."""
    monkeypatch.setattr(smoke, "RING_CHECK", dict(b=1, h=4, hk=2, s=256, d=64, block=32))
    side = smoke.ring_cpu_side()
    faults = smoke.ring_fault_check(side)
    assert set(faults) == {"dkdv_not_home", "wrong_positions", "positions_off_by_one",
                           "no_lse_weights"}
    for fault, f in faults.items():
        assert f["caught"], fault
        assert all(need > 10 * smoke.RING_FLOORS[n] for n, need in f["floor_needed"].items()), f
    sound = smoke.ring_check({r: side[0][r] for r in range(2)}, side)
    assert all(h["ok"] and h["floor_needed"] == 0.0 for r in sound.values() for h in r.values())


def test_path_kernel_check_rehearses_on_the_cpu(smoke, monkeypatch):
    """The path-shape check at tiny shapes on the twins: every element
    held, the rows outside a block's mask zero, each dropped key tile
    caught; the dispatcher takes its card choice (whole-sequence blocks).
    The CPU runs no kernel, so the dispatcher's gates are the problems."""
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.ops import ring_attention as R

    choose = R.choose_impl   # the dispatcher's choice on the card
    monkeypatch.setattr(R, "choose_impl", lambda causal, s, layout, on_card, *blocks: choose(
        causal, s, layout, True, *blocks))
    monkeypatch.setattr(smoke, "PATH_RING", dict(h=2, s=128, d=64))
    monkeypatch.setattr(smoke, "PATH_STAGE", dict(h=8, hk=1, s=128, d=64))
    monkeypatch.setattr(smoke, "PATH_ODD_S", 1088)
    got = smoke.path_kernel_check("cpu", (flash_block_forward,))
    # no launch on the CPU; and its stand-in for the kernel is the twin
    # tiled at the whole sequence, whose p rounds against other running
    # maxima than the 64-key tiles of the kernel and of the reference twin
    assert len(got["problems"]) == 2 and "launched B1 0 times" in got["problems"][0], got
    assert got["readings"]["dispatch"]["out"]["floor_needed"] < 2e-3
    cases = got["readings"]
    assert len(cases) == 6   # 2 ranks x 2 blocks, the stage, the dispatcher
    for case, r in cases.items():
        if case == "dispatch":
            continue
        for n in ("out", "dq", "dk", "dv"):
            assert r[n]["ok"] and r[n]["max_abs_err"] == 0.0 and r[n]["dead_rows_zero"], (case, n)
        assert set(r["tile_dropped"]) == {"out", "dq"}   # caught, or a problem would say so
    # zigzag at cp 2: rank 0's queries see no key of rank 1's first chunk, a
    # row of rank 0's first chunk sees nothing of rank 1's block
    assert cases["ring rank 0 block 1"]["out"]["dead_rows"] == 128 // 2
    assert cases["ring rank 0 block 0"]["out"]["dead_rows"] == 0
