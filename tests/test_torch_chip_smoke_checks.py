"""The checks ``chip_smoke.py`` holds the backward kernels to, on the CPU.

``bwd_exact`` (the fp64 evaluation of the flash backward that the card's
gradients are also held against) is compared with JAX's
``flash_block_grads`` on the same seeded fp32 inputs under external
statistics: with fp32 operands neither side rounds p or dS, so only the
summation precision differs (atol 2e-5 on gradients of about 1, as
``test_torch_flash_backward.py``). ``held`` is pinned on hand-made
tensors: an element beyond its limit against the twin passes only where
it lies within the limit of the fp64 value.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kernels import flash_attn as jfa

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_exact_matches_jax_block_grads(smoke, causal):
    b, h, hk, sq, sk, d, blk = 1, 4, 2, 128, 128, 32, 64
    rng = np.random.default_rng(21)
    q, do = (rng.standard_normal((b * h, sq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b * hk, sk, d), dtype=np.float32) for _ in range(2))
    lse = (rng.standard_normal((b * h, sq)) + 6.0).astype(np.float32)
    delta = rng.standard_normal((b * h, sq)).astype(np.float32)
    kpos = np.arange(sk, dtype=np.int32).reshape(b, 1, sk)
    qpos = (np.arange(sq, dtype=np.int32) if causal
            else np.full(sq, sk - 1, np.int32)).reshape(b, 1, sq)
    lanes = lambda a: np.broadcast_to(a[..., None], (*a.shape, 128))  # noqa: E731
    want = jfa.flash_block_grads(*map(jnp.asarray, (q, k, v, do)), jnp.asarray(lanes(lse)),
                                 jnp.asarray(lanes(delta)), jnp.asarray(qpos),
                                 jnp.asarray(kpos), d ** -0.5, blk, blk, h // hk, h)
    got = smoke.bwd_exact(*map(torch.from_numpy, (q, k, v, do, lse, delta, qpos, kpos)),
                          d ** -0.5, blk, blk, h // hk, h, chunk=48)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=name)


def test_held_excuses_only_what_the_fp64_value_backs(smoke):
    rel, floor = 2.0 ** -7, 1e-3
    exact = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64)
    twin = torch.tensor([1.0, 0.51, 0.25])       # the twin is off at element 1
    good = torch.tensor([1.0, 0.5, 0.25])        # the kernel is right there
    r = smoke.held(good, twin, floor, rel, exact=exact)
    assert r["ok"] and r["floor_needed"] == 0.0
    assert r["floor_needed_vs_twin"] == pytest.approx(0.01 - rel * 0.51, rel=1e-4)
    assert r["vs_exact"]["twin"]["max_abs_err"] == pytest.approx(0.01, rel=1e-4)
    bad = torch.tensor([1.0, 0.5, 0.26])         # off both twin and fp64 at element 2
    r = smoke.held(bad, twin, floor, rel, exact=exact)
    assert not r["ok"]
    assert r["floor_needed"] == pytest.approx(0.01 - rel * 0.25, rel=1e-4)
    assert not smoke.held(good, twin, floor, rel)["ok"]   # without fp64, the twin decides
