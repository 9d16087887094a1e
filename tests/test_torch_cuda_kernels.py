"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips (with the reason) where no NVIDIA GPU is
present. Run on a machine with one:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q``.
Imports nothing of JAX, so it runs where only the port is installed.

Tolerances: fp32 kernels differ from their twins only in summation order
(2e-5); bf16 outputs are rounded to bf16 on both sides after fp32
accumulation, and a last-place flip of bf16 at |x| ~ 1 is 2**-7 (2e-2).
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference.paged_kernel import (
    paged_decode_attention,
    paged_decode_attention_plain,
    quantize_kv_pages,
)
from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    INVALID_POS,
    flash_block_forward,
    flash_block_forward_plain,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _flash_case(dev, dtype, b, h, hk, sq, sk, d, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b * h, sq, d), generator=g).to(dev, dtype)
    k = torch.randn((b * hk, sk, d), generator=g).to(dev, dtype)
    v = torch.randn((b * hk, sk, d), generator=g).to(dev, dtype)
    qpos = (torch.arange(sq, dtype=torch.int32) + (sk - sq)).repeat(b, 1)
    kpos = torch.arange(sk, dtype=torch.int32).repeat(b, 1)
    qpos[0, -3:] = -1                      # pad query rows: fully masked
    kpos[-1, sk // 2: sk // 2 + 5] = INVALID_POS  # pad keys
    return q, k, v, qpos.reshape(b, 1, sq).to(dev), kpos.reshape(b, 1, sk).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 2, 128, 256, 128), (1, 8, 8, 192, 192, 64)])
def test_flash_kernel_matches_twin(cuda, dtype, shape):
    b, h, hk, sq, sk, d = shape
    q, k, v, qp, kp = _flash_case(cuda, dtype, b, h, hk, sq, sk, d)
    args = (q, k, v, qp, kp, d ** -0.5, 64, 64, h // hk, h)
    before = flash_block_forward.launches
    out, lse = flash_block_forward(*args)
    torch.cuda.synchronize()
    assert flash_block_forward.launches == before + 1
    ref_out, ref_lse = flash_block_forward_plain(*args)
    np.testing.assert_allclose(out.float().cpu(), ref_out.float().cpu(), atol=TOL[dtype])
    np.testing.assert_allclose(lse.cpu(), ref_lse.cpu(), atol=1e-4, rtol=1e-5)
    assert float(out[0, -1].abs().max()) == 0.0
    assert float(lse[0, -1]) == float(np.float32(-1e30))


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_twin(cuda, pool, dtype):
    g = torch.Generator(device="cpu").manual_seed(1)
    b, n_q, n_kv, hd, ps, pages, ppseq = 3, 8, 2, 128, 16, 40, 8
    q = torch.randn((b, 1, n_q, hd), generator=g).to(cuda, dtype)
    kf = torch.randn((pages, ps, n_kv, hd), generator=g)   # stale bytes everywhere
    vf = torch.randn((pages, ps, n_kv, hd), generator=g)
    table = torch.randperm(pages, generator=g)[: b * ppseq].reshape(b, ppseq).int()
    cache_len = torch.tensor([0, 37, ps * ppseq - 1], dtype=torch.int32)
    kw = {}
    if pool == "int8":
        kq, ks = quantize_kv_pages(kf)
        vq, vs = quantize_kv_pages(vf)
        kp, vp = kq.to(cuda), vq.to(cuda)
        kw = dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    else:
        kp, vp = kf.to(cuda, dtype), vf.to(cuda, dtype)
    args = (q, kp, vp, table.to(cuda), cache_len.to(cuda))
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(*args, **kw)
    np.testing.assert_allclose(out.float().cpu(), ref.float().cpu(), atol=TOL[dtype])
