"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips (with the reason) where no NVIDIA GPU is
present. Run on a machine with one:
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q``.
Imports nothing of JAX, so it runs where only the port is installed.

Tolerances: the paged kernel differs from its twin only in summation order
(fp32 2e-5; bf16 outputs rounded on both sides, a last-place flip at
|x| ~ 1 is 2**-7, 2e-2), its split merge included. The flash forward's
output and the backward's gradients span orders of magnitude, so each
element is held against its own size, ``|got - want| <= rel * |want| +
floor``: fp32 rel 1e-5 (a few fp32 places of summation order), bf16 rel
2**-7 (one bf16 last place at the value). The fp32 floor is about four
times the largest the H100 needed on these cases (1.3e-7). The bf16
kernels run their products on the tensor cores, whose sums round otherwise
than the twin's fp32 sums: where the two land on opposite sides of a bf16
rounding point of p or dS, an output moves by one term's last place. So a
bf16 forward element may instead lie within its limit of an fp64
evaluation with the twin's rounding of p (``chip_smoke.fwd_exact``, the
rule ``chip_smoke.py`` holds the kernels to), and the bf16 floors
(``FWD_FLOOR``, ``BWD_FLOOR``) are set from the H100's readings on these
cases. The AdamW kernel rounds where its twin rounds (IEEE intrinsics, no
FMA contraction): it must match bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
from neuronx_distributed_tpu_torch.inference.paged_kernel import (
    paged_decode_attention,
    paged_decode_attention_plain,
    quantize_kv_pages,
)
from neuronx_distributed_tpu_torch.inference.sampling import Sampler
from neuronx_distributed_tpu_torch.kernels.flash_attn import (
    INVALID_POS,
    flash_block_forward,
    flash_block_forward_plain,
    flash_block_grads,
    flash_block_grads_plain,
    flash_bwd_dkdv,
    flash_bwd_dq,
)
from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora
from neuronx_distributed_tpu_torch.models import llama as tl
from neuronx_distributed_tpu_torch.optimizer.fused_kernel import (
    fused_adamw_leaf,
    fused_adamw_leaf_plain,
)

pytestmark = pytest.mark.cuda

# chip_smoke.py's fp64 evaluations (it imports nothing of JAX either)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# the bf16 backward runs its products on the tensor cores, whose sums round
# otherwise than the twin's fp32 sums: where the two land on opposite sides
# of a bf16 rounding point of p or dS, a gradient moves by one term's last
# place. Both sit equally far from an fp64 evaluation of the same function
# (equal max |error| on an H100); the floor is about three times the most
# these cases needed there (3.5e-4, against medians of 0.04 to 0.17)
BWD_FLOOR = {torch.float32: 5e-7, torch.bfloat16: 1e-3}
# the bf16 forward runs on the tensor cores too: an element passes within
# its limit of the twin or of ``chip_smoke.fwd_exact``. These cases needed
# at most 1.3e-4 on an H100 by that rule (5.6e-4 against the twin alone;
# medians 0.06 to 0.11); the floor is about twice that
FWD_FLOOR = {torch.float32: 5e-7, torch.bfloat16: 2.5e-4}


def _assert_held(got, want, name, floor, exact=None):
    """Every element within ``REL * |want| + floor`` of its twin or, given
    ``exact`` (an fp64 evaluation of the same function), of that value."""
    rel = REL[want.dtype]
    err = (got.float() - want.float()).abs()
    excess = err - rel * want.float().abs()
    if exact is not None:
        excess = excess.double().minimum((got.double() - exact).abs() - rel * exact.abs())
    excess = float(excess.max())
    assert excess <= floor[want.dtype], (name, excess, float(err.max()))


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


_FWD_SHAPES = [(2, 4, 2, 128, 256, 128, "causal"), (1, 8, 8, 192, 192, 64, "causal")]
# the bf16 (tensor-core) route's edges; the fp32 route keeps its two cases
_FWD_BF16_SHAPES = [
    (2, 4, 4, 200, 384, 64, "ragged"),         # ragged lengths, group 1 (see the test)
    (1, 8, 1, 256, 256, 128, "causal"),        # group 8
    (2, 8, 2, 128, 256, 128, "causal"),        # group 4
    (1, 4, 2, 128, 256, 64, "noncausal"),      # every query after every key
    (2, 4, 2, 256, 256, 128, "masked_tile"),   # a query tile whose rows are all masked
]


@pytest.mark.parametrize("dtype,shape", [
    *((dtype, shape) for shape in _FWD_SHAPES for dtype in (torch.float32, torch.bfloat16)),
    *((torch.bfloat16, shape) for shape in _FWD_BF16_SHAPES)])
def test_flash_kernel_matches_twin(cuda, dtype, shape):
    """B1 with pad query rows and pad keys: every output element within its
    limit of the twin (bf16: or of the fp64 evaluation, whose p is rounded
    as the twin's), the LSE close, and masked rows 0 with LSE -1e30.

    The twin rounds p against the running max of each of its key blocks, so
    key lengths stay multiples of the kernel's 64-key tiles here. "ragged":
    200 queries (a partial query tile) over 384 keys of which the last 56
    are pads; the kernel run on the first 328 keys alone (a partial key
    tile, zero-filled) must give the same bits."""
    b, h, hk, sq, sk, d, mode = shape
    q, k, v, qp, kp = _flash_case(cuda, dtype, b, h, hk, sq, sk, d)
    if mode == "masked_tile":
        qp[:, :, 64:128] = -1
    if mode == "noncausal":
        qp = torch.where(qp >= 0, sk - 1, qp)
    if mode == "ragged":
        kp[:, :, 328:] = INVALID_POS
    bq = 64 if sq % 64 == 0 else sq
    args = (q, k, v, qp, kp, d ** -0.5, bq, 64, h // hk, h)
    before = flash_block_forward.launches
    out, lse = flash_block_forward(*args)
    torch.cuda.synchronize()
    assert flash_block_forward.launches == before + 1
    ref_out, ref_lse = flash_block_forward_plain(*args)
    exact = smoke.fwd_exact(*args)[0] if dtype == torch.bfloat16 else None
    _assert_held(out, ref_out, "out", FWD_FLOOR, exact=exact)
    np.testing.assert_allclose(lse.cpu(), ref_lse.cpu(), atol=1e-4, rtol=1e-5)
    assert float(out[0, -1].abs().max()) == 0.0
    assert float(lse[0, -1]) == float(np.float32(-1e30))
    if mode == "masked_tile":
        rows = out.reshape(b, h, sq, d)[:, :, 64:128]
        assert float(rows.abs().max()) == 0.0
        assert bool((lse.reshape(b, h, sq)[:, :, 64:128] == float(np.float32(-1e30))).all())
    if mode == "ragged":
        cut = [t[..., :328, :].contiguous() for t in (k, v)] + [kp[..., :328].contiguous()]
        short = flash_block_forward(q, cut[0], cut[1], qp, cut[2], d ** -0.5, sq, 328,
                                    h // hk, h)
        assert torch.equal(short[0], out) and torch.equal(short[1], lse)


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,ps", [(1, 16), (4, 16), (8, 16), (4, 48)])
def test_paged_kernel_matches_twin(cuda, pool, dtype, group, ps):
    """B2 split across CTAs, against its twin: GQA groups 1, 4 and 8, a page
    size that does not divide the 128-key split (48), empty (cache_len 0)
    and full tables."""
    _check_paged(cuda, pool, dtype, group, ps, 128)


def _check_paged(cuda, pool, dtype, group, ps, hd):
    g = torch.Generator(device="cpu").manual_seed(1)
    b, n_kv, ppseq = 3, 2, 8 if ps == 48 else 24
    n_q, pages = n_kv * group, b * ppseq + 4
    q = torch.randn((b, 1, n_q, hd), generator=g).to(cuda, dtype)
    kf = torch.randn((pages, ps, n_kv, hd), generator=g)   # stale bytes everywhere
    vf = torch.randn((pages, ps, n_kv, hd), generator=g)
    table = torch.randperm(pages, generator=g)[: b * ppseq].reshape(b, ppseq).int()
    cache_len = torch.tensor([0, 37 + ps * 9, ps * ppseq - 1], dtype=torch.int32)
    kw = {}
    if pool == "int8":
        kq, ks = quantize_kv_pages(kf)
        vq, vs = quantize_kv_pages(vf)
        kp, vp = kq.to(cuda), vq.to(cuda)
        kw = dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    else:
        pool_dtype = torch.float32 if pool == "fp32" else torch.bfloat16
        kp, vp = kf.to(cuda, pool_dtype), vf.to(cuda, pool_dtype)
    args = (q, kp, vp, table.to(cuda), cache_len.to(cuda))
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(*args, **kw)
    np.testing.assert_allclose(out.float().cpu(), ref.float().cpu(), atol=TOL[dtype])


def test_flash_and_paged_kernels_are_deterministic(cuda):
    """No atomics and a fixed order of sums: two launches of B1 (bf16,
    ragged, GQA, pads) and of B2 (int8 pool, split pages) on the same inputs
    give the same bits."""
    q, k, v, qp, kp = _flash_case(cuda, torch.bfloat16, 2, 8, 2, 200, 328, 128)
    args = (q, k, v, qp, kp, 128 ** -0.5, 200, 328, 4, 8)
    first, second = flash_block_forward(*args), flash_block_forward(*args)
    g = torch.Generator(device="cpu").manual_seed(2)
    kq, ks = quantize_kv_pages(torch.randn((80, 16, 2, 128), generator=g))
    vq, vs = quantize_kv_pages(torch.randn((80, 16, 2, 128), generator=g))
    pargs = (torch.randn((2, 1, 8, 128), generator=g).to(cuda, torch.bfloat16), kq.to(cuda),
             vq.to(cuda), torch.randperm(80, generator=g)[:64].reshape(2, 32).int().to(cuda),
             torch.tensor([300, 511], dtype=torch.int32, device=cuda))
    kw = dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    pa, pb = paged_decode_attention(*pargs, **kw), paged_decode_attention(*pargs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(pa, pb)


def test_attention_wrappers_make_no_host_sync(cuda):
    """The paged kernel sizes its split grid and workspace from shapes
    alone, and the flash forward reads no device value either: under
    ``torch.cuda.set_sync_debug_mode("error")`` neither wrapper makes a
    call that waits for the device (a decode step stays capturable in a
    CUDA graph)."""
    q, k, v, qp, kp = _flash_case(cuda, torch.bfloat16, 1, 4, 2, 128, 256, 128)
    g = torch.Generator(device="cpu").manual_seed(3)
    pargs = (torch.randn((2, 1, 8, 128), generator=g).to(cuda, torch.bfloat16),
             torch.randn((40, 16, 2, 128), generator=g).to(cuda, torch.bfloat16),
             torch.randn((40, 16, 2, 128), generator=g).to(cuda, torch.bfloat16),
             torch.randperm(40, generator=g)[:32].reshape(2, 16).int().to(cuda),
             torch.tensor([5, 200], dtype=torch.int32, device=cuda))
    flash_block_forward(q, k, v, qp, kp, 128 ** -0.5, 64, 64, 2, 4)   # builds and loads
    paged_decode_attention(*pargs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flash_block_forward(q, k, v, qp, kp, 128 ** -0.5, 64, 64, 2, 4)
        paged_decode_attention(*pargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_bf16_kernels_reject_misaligned_operands(cuda):
    """The tensor-core forward and the paged kernel stage operands 16 bytes
    at a time: an operand that starts off a 16-byte boundary raises."""
    q, k, v, qp, kp = _flash_case(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 64)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_block_forward(shifted, k, v, qp, kp, 0.125, 64, 64, 1, 2)
    pool = torch.zeros((4, 16, 1, 128), dtype=torch.bfloat16, device=cuda)
    off = torch.empty(pool.numel() + 1, dtype=pool.dtype, device=cuda)[1:].view(pool.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16, device=cuda),
                               off, pool, torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                               torch.zeros(1, dtype=torch.int32, device=cuda))


def _backward_case(cuda, dtype, b, h, hk, sq, sk, d, mode):
    """The backward's arguments for one case of the tests below: pad query
    rows and pad keys as in ``_flash_case``; ``mode`` "causal" uses the
    forward twin's own LSE and delta; "masked_tile" also masks query rows
    64..127 of every batch row (a whole 64-row tile that sees no key);
    "external" puts every query after every key (non-causal) under seeded
    statistics larger than the block's own, the ring-attention contract."""
    q, k, v, qp, kp = _flash_case(cuda, dtype, b, h, hk, sq, sk, d)
    gen = torch.Generator(device="cpu").manual_seed(9)
    do = torch.randn(q.shape, generator=gen).to(cuda, dtype)
    if mode == "masked_tile":
        qp[:, :, 64:128] = -1
    if mode == "external":
        qp = torch.where(qp >= 0, sk - 1, qp)
    # block sizes: 64 where they divide the lengths, else the whole lengths
    # (the twins' shape contract); the kernels tile by 64 either way
    bq, bk = (64, 64) if sq % 64 == 0 and sk % 64 == 0 else (sq, sk)
    if mode == "external":
        lse = (torch.randn((b * h, sq), generator=gen) + 6.0).to(cuda)
        delta = torch.randn((b * h, sq), generator=gen).to(cuda)
    else:
        out, lse = flash_block_forward_plain(q, k, v, qp, kp, d ** -0.5, bq, bk, h // hk, h)
        delta = (do.float() * out.float()).sum(-1)
    return (q, k, v, do, lse, delta, qp, kp, d ** -0.5, bq, bk, h // hk, h)


_BWD_SHAPES = [(2, 4, 2, 128, 256, 128, "causal"), (1, 8, 8, 192, 192, 64, "causal")]
# the bf16 (tensor-core) tiling's edges: the fp32 route's kernels and floor
# stay as they were
_BWD_BF16_SHAPES = [
    (2, 4, 4, 200, 328, 64, "causal"),        # ragged: no length a multiple of 64, group 1
    (1, 8, 1, 256, 256, 128, "causal"),       # group 8
    (1, 4, 2, 128, 256, 64, "external"),      # non-causal, external statistics
    (2, 4, 2, 256, 256, 128, "masked_tile"),  # a query tile whose rows are all masked
]


@pytest.mark.parametrize("dtype,shape", [
    *((dtype, shape) for shape in _BWD_SHAPES for dtype in (torch.float32, torch.bfloat16)),
    *((torch.bfloat16, shape) for shape in _BWD_BF16_SHAPES)])
def test_flash_backward_kernels_match_twins(cuda, dtype, shape):
    """dK/dV (B3a) and dQ (B3b) with pad query rows and pad keys: every
    gradient element within its limit, and the pad keys' dK and dV exactly
    zero."""
    b, h, hk, sq, sk, d, mode = shape
    args = _backward_case(cuda, dtype, b, h, hk, sq, sk, d, mode)
    before = (flash_bwd_dkdv.launches, flash_bwd_dq.launches)
    got = flash_block_grads(*args)
    torch.cuda.synchronize()
    assert (flash_bwd_dkdv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    want = flash_block_grads_plain(*args)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        _assert_held(g_, w_, name, BWD_FLOOR)
    pad = slice(sk // 2, sk // 2 + 5)      # INVALID_POS keys of the last batch row
    assert float(got[1][-hk:, pad].abs().max()) == 0.0
    assert float(got[2][-hk:, pad].abs().max()) == 0.0
    if mode == "masked_tile":              # rows that see no key get no gradient
        assert float(got[0].reshape(b, h, sq, d)[:, :, 64:128].abs().max()) == 0.0


def test_flash_backward_kernels_are_deterministic(cuda):
    """No atomics and a fixed order of sums: two launches of B3a and B3b on
    the same bf16 inputs (GQA, ragged lengths, pads) give the same bits."""
    args = _backward_case(cuda, torch.bfloat16, 2, 8, 2, 200, 328, 128, "causal")
    first = flash_block_grads(*args)
    second = flash_block_grads(*args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_kernel_matches_twin(cuda, g_dtype):
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = 3 * 8192
    g = (torch.randn(n, generator=gen) * 2).to(cuda, g_dtype)
    state = [torch.randn(n, generator=gen).mul(0.1), torch.randn(n, generator=gen).abs() * 0.01,
             torch.randn(n, generator=gen)]
    kern = [t.to(cuda) for t in state]
    twin = [t.to(cuda) for t in state]
    scalars = torch.tensor([[0.7, 1e-2, 0.5, 0.3]], device=cuda)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, p_dtype=g_dtype)
    before = fused_adamw_leaf.launches
    *_, p = fused_adamw_leaf(g, *kern, scalars, **kw)
    torch.cuda.synchronize()
    assert fused_adamw_leaf.launches == before + 1
    *_, p_ref = fused_adamw_leaf_plain(g, *twin, scalars, **kw)
    for a, b_ in zip(kern + [p], twin + [p_ref]):
        assert torch.equal(a, b_)
    assert not torch.equal(kern[2].cpu(), state[2])      # the master moved, in place
    out = torch.zeros(n, dtype=g_dtype, device=cuda)     # a donated param
    got = fused_adamw_leaf(g, *(t.to(cuda) for t in state), scalars, **kw, out=out)[3]
    torch.cuda.synchronize()
    assert got is out and torch.equal(out, p_ref)


def test_llama_loss_backward_reaches_qkv_on_cuda(cuda):
    """Regression pin: the flash path's output on the card used to carry no
    autograd graph, so a loss through the Llama forward gave the q/k/v
    kernels no gradient. Now they get one, and it matches the CPU route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=2, num_kv_heads=1, max_seq_len=128, dtype=torch.float32,
                         remat_policy=None)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 256, (2, 128), generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", cuda):
        with torch.device("meta"):
            model = tl.LlamaForCausalLM(cfg)
        model.load_state_dict({n: p.to(dev) for n, p in params.items()}, assign=True)
        model.requires_grad_(True)
        before = flash_block_forward.launches
        loss = model.loss(ids.to(dev), ids.to(dev))
        loss.backward()
        if dev != "cpu":
            assert flash_block_forward.launches == before + cfg.num_layers
        grads[str(dev)] = {n: p.grad.cpu() for n, p in model.named_parameters()
                           if ".qkv." in n}
    assert len(grads["cpu"]) == 3 * cfg.num_layers
    for n, want in grads["cpu"].items():
        got = grads[str(cuda)][n]
        assert float(got.abs().max()) > 0.0, n
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-3, err_msg=n)


@pytest.mark.parametrize("d", [80, 96, 160])
def test_kernels_at_head_dims_the_build_lacks(cuda, d):
    """Head dims other than the built 64, 128 and 256: B1 and B3 run
    zero-padded to the next built width by their wrappers (sm_scale from
    the unpadded d), B2 reads a bf16 row with 10, 12 or 20 lanes of a
    16- or 32-lane group (int8 5, 6 or 10; fp32 20, 24 or 40, the last two
    chunks a lane). Each against its twin by the rules above."""
    _check_head_dim(cuda, d)


def test_kernels_at_head_dim_256_and_ragged_pool_rows(cuda):
    """The 256-wide builds (B1 and B3 split their output columns across two
    CTAs; B2 reads an fp32 row in 64 lanes, two a lane), and pool rows whose
    byte length is no multiple of 16 (bf16 hd 36, int8 hd 40: read 4 bytes
    a lane)."""
    _check_head_dim(cuda, 256)
    for pool, hd in (("bf16", 36), ("int8", 40), ("fp32", 36)):
        for dtype in (torch.float32, torch.bfloat16):
            _check_paged(cuda, pool, dtype, 4, 16, hd)
    with pytest.raises(ValueError, match="up to 256"):
        _check_paged(cuda, "bf16", torch.bfloat16, 4, 16, 288)


def _check_head_dim(cuda, d):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qp, kp = _flash_case(cuda, dtype, 2, 4, 2, 128, 256, d)
        args = (q, k, v, qp, kp, d ** -0.5, 64, 64, 2, 4)
        out, lse = flash_block_forward(*args)
        torch.cuda.synchronize()
        assert out.shape == q.shape
        ref_out, ref_lse = flash_block_forward_plain(*args)
        exact = smoke.fwd_exact(*args)[0] if dtype == torch.bfloat16 else None
        _assert_held(out, ref_out, "out", FWD_FLOOR, exact=exact)
        np.testing.assert_allclose(lse.cpu(), ref_lse.cpu(), atol=1e-4, rtol=1e-5)
        bargs = _backward_case(cuda, dtype, 2, 4, 2, 128, 256, d, "causal")
        got = flash_block_grads(*bargs)
        torch.cuda.synchronize()
        for name, g_, w_ in zip(("dq", "dk", "dv"), got, flash_block_grads_plain(*bargs)):
            assert g_.shape == w_.shape
            _assert_held(g_, w_, name, BWD_FLOOR)
        for pool in ("fp32", "bf16", "int8"):
            _check_paged(cuda, pool, dtype, 4, 16, d)


@pytest.mark.parametrize("head_dim,page_dtype", [(128, None), (96, "int8")])
def test_captured_decode_block_equals_the_eager_steps(cuda, head_dim, page_dtype):
    """A ServeEngine captures its decode block when it is built: the
    capture raises nothing (a host sync in the body would fail it), every
    block is one replay, and the streams equal the per-token route's bit
    for bit, greedy and sampled rows mixed. A ``head_dim=96`` model with
    int8 pages serves on the card."""
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=head_dim, max_seq_len=256,
                         dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    lm = CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(128,), max_batch=4,
                  page_size=16, paged_attn_kernel=True, page_dtype=page_dtype, device=cuda)
    runs = {}
    for fused in (True, False):
        engine = ServeEngine(lm, block_steps=4, fused=fused, seed=2)
        rng = np.random.default_rng(3)
        for i, (n, budget) in enumerate(((90, 20), (40, 13), (120, 9), (64, 17), (30, 6))):
            engine.submit(rng.integers(1, 255, n), budget, arrival_block=i // 2,
                          sampler=Sampler(temperature=0.9) if i % 2 else None)
        before = paged_decode_attention.launches
        runs[fused] = {c.request_id: c.tokens.tolist() for c in engine.run()}
        assert paged_decode_attention.launches - before == (
            engine.decode_blocks * 4 * cfg.num_layers)
        assert engine.nonfinite_logits == 0
        if fused:
            assert engine.replays == engine.decode_blocks > 0
            assert set(lm.capture_ms) == {"session_fused_k4"}
    assert runs[True] == runs[False]


def test_generate_fused_chunk_on_cuda_equals_stepwise(cuda):
    """``generate(fused_chunk=4)`` on the contiguous slab (the dense decode
    attention inside the graph): 11 new tokens as 1 + 4 + 4 + a 2-token
    tail program, the same tokens as the stepwise route on the card, and
    greedy tokens equal to the CPU's."""
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=128, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(1))
    prompts = np.random.default_rng(4).integers(1, 255, (3, 16)).astype(np.int32)
    lms = {d: CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(16,), max_batch=4, device=d)
           for d in (cuda, "cpu")}
    for sampler in (None, Sampler(temperature=1.0, top_k=40)):
        fused = lms[cuda].generate(prompts, 11, sampler=sampler, seed=3, fused_chunk=4)
        step = lms[cuda].generate(prompts, 11, sampler=sampler, seed=3)
        np.testing.assert_array_equal(fused.tokens, step.tokens)
        if sampler is None:
            np.testing.assert_array_equal(
                fused.tokens, lms["cpu"].generate(prompts, 11, fused_chunk=4).tokens)
    assert set(lms[cuda].capture_ms) == {"session_fused_k4", "session_fused_k2"}


def test_chunked_and_async_engines_on_cuda_equal_the_sync_engine(cuda):
    """Chunked prefill (chunks of 48 over a 128 bucket, a 200-token prompt
    past it) and the pipelined loop on the card: the streams of the
    synchronous one-shot engine (a 200-token prompt is chunked in every
    engine here: it is past the largest bucket), greedy and sampled; the
    pipelined loop keeps the same schedule and makes one replay and one
    fetch a steady block."""
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=512, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(5))
    lm = CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(64, 128), max_batch=4,
                  page_size=16, paged_attn_kernel=True, device=cuda)
    rng = np.random.default_rng(6)
    work = [(rng.integers(1, 255, n), budget, i // 2)
            for i, (n, budget) in enumerate(((90, 20), (200, 13), (120, 9), (64, 17), (30, 6)))]
    runs = {}
    for chunk, async_loop in ((128, False), (48, False), (48, True)):
        engine = ServeEngine(lm, block_steps=4, seed=2, prefill_chunk_tokens=chunk,
                             async_loop=async_loop)
        for i, (p, budget, arrival) in enumerate(work):
            engine.submit(p, budget, arrival_block=arrival,
                          sampler=Sampler(temperature=0.9) if i % 2 else None)
        done = engine.run()
        runs[(chunk, async_loop)] = {c.request_id: (c.tokens.tolist(), c.queue_blocks,
                                                    c.ttft_blocks) for c in done}
        assert engine.nonfinite_logits == 0 and engine.chunk_program_calls > 0
    tokens = {k: {r: v[0] for r, v in run.items()} for k, run in runs.items()}
    assert tokens[(48, False)] == tokens[(128, False)]
    assert runs[(48, True)] == runs[(48, False)]
    assert engine.host_fetches == engine.replays == engine.decode_blocks


def _tier_lm(cuda, page_dtype, seed=7):
    """A small bf16 paged model on the card (pages of 16, 40 of them)."""
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=256, dtype=torch.bfloat16)
    params = tl.init_params(cfg, torch.Generator().manual_seed(seed))
    return CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(64, 128), max_batch=4,
                    page_size=16, page_pool_pages=40, paged_attn_kernel=True,
                    page_dtype=page_dtype, device=cuda)


def _tier_work():
    """Two families over a 64-token prefix (request, budget, arrival); the
    first family comes back at block 12."""
    rng = np.random.default_rng(8)
    prefixes = [rng.integers(1, 255, 64) for _ in range(2)]
    return [(np.concatenate([prefixes[fam], rng.integers(1, 255, 20 + 7 * i)]), 12 + i,
             (0, 0, 3, 3, 4, 12, 12)[i]) for i, fam in enumerate((0, 0, 1, 1, 1, 0, 0))]


@pytest.mark.parametrize("page_dtype", [None, "int8"])
def test_tier_restore_and_repair_under_the_captured_block(cuda, page_dtype):
    """Restores and repairs write the pools in place, into the tensors the
    captured decode block reads. The first five requests run, the whole
    prefix cache is spilled, and the first family comes back (a restore);
    every live page with a tier copy is then corrupted and repaired between
    blocks. The captured block's streams equal the per-token route's bit
    for bit (bf16 and int8 pages), no stream replays, and the repaired
    pages hold their bytes again."""
    lm = _tier_lm(cuda, page_dtype)
    work = _tier_work()
    runs = {}
    for fused in (True, False):
        engine = ServeEngine(lm, block_steps=4, fused=fused, seed=2, host_tier_pages=32)
        pkv, hit, repaired_ok = engine.session.paged, set(), []
        for i, (p, budget, arrival) in enumerate(work):
            if i == 5:
                engine.run()
                assert pkv.prefix.spill(10 ** 6) > 0
            engine.submit(p, budget, arrival_block=arrival,
                          sampler=Sampler(temperature=0.9) if i % 3 == 1 else None)
        while engine.step_block():
            victims = [q for q in pkv.live_pages() if q not in hit and pkv.prefix.node_for_page(q)
                       is not None and pkv.prefix.node_for_page(q).tier_id is not None]
            if victims:
                hit.update(victims)
                want = engine._read_pages_bytes(victims)
                engine.inject_page_corruption(victims)
                got = engine._read_pages_bytes(victims)
                repaired_ok.append(all(np.array_equal(w[k], g[k]) for w, g in zip(want, got)
                                       for k in w))
        runs[fused] = {c.request_id: c.tokens.tolist() for c in engine.completed}
        assert pkv.tier_restored_pages > 0 and pkv.tier_hits > 0
        assert engine.tier_page_repairs == len(hit) > 0 and engine.corrupt_page_replays == 0
        assert repaired_ok and all(repaired_ok) and engine.nonfinite_logits == 0
        assert len(runs[fused]) == len(work)
        if fused:
            assert engine.replays == engine.decode_blocks
    assert runs[True] == runs[False]


def test_from_snapshot_reuses_the_captured_graph(cuda):
    """A restored engine on the ``CausalLM`` that took the snapshot replays
    the decode block captured before (no second capture, ``capture_s``
    about 0), resumes every stream to its budget with finite logits, and
    keeps the tokens delivered before the snapshot."""
    lm = _tier_lm(cuda, None, seed=9)
    engine = ServeEngine(lm, block_steps=4, seed=2, host_tier_pages=32)
    assert engine.capture_s > 0
    work = _tier_work()
    for p, budget, arrival in work:
        engine.submit(p, budget, arrival_block=arrival)
    for _ in range(6):
        engine.step_block()
    snap = engine.snapshot()
    at_snap = {r["request_id"]: r["generated"] for r in snap["requests"]}
    before = {c.request_id: c.tokens.tolist() for c in engine.completed}
    restored = ServeEngine.from_snapshot(lm, snap)
    assert restored.capture_s < 0.05 and len(lm._fused) == 1
    assert set(lm.capture_ms) == {"session_fused_k4"}
    restored.run()
    after = {c.request_id: c.tokens.tolist() for c in restored.completed}
    assert set(before) | set(after) == set(range(len(work))) and not set(before) & set(after)
    assert all(len(after[r]) == work[r][1] for r in after)
    assert all(after[r][:len(g)] == g for r, g in at_snap.items())
    assert restored.replays == restored.decode_blocks > 0 and restored.nonfinite_logits == 0


def test_dispatch_retry_on_the_card_is_bit_identical(cuda):
    """A launch retried under injected faults re-runs nothing on the
    device: the streams equal the fault-free run's bit for bit."""
    lm = _tier_lm(cuda, None, seed=11)
    runs = {}
    for plan in (None, FaultPlan(seed=0, dispatch_fail_prob=0.3, dispatch_max_failures=2)):
        engine = ServeEngine(lm, block_steps=4, seed=2, faults=plan, dispatch_retries=8,
                             dispatch_backoff_s=0.0, async_loop=True)
        for p, budget, arrival in _tier_work():
            engine.submit(p, budget, arrival_block=arrival)
        runs[plan is None] = {c.request_id: c.tokens.tolist() for c in engine.run()}
    assert engine.dispatch_retry_count > 0
    assert runs[True] == runs[False]


def _tenant_lm(cuda):
    """A small fp32 paged model on the card with an adapter pool (rank 4,
    two usable slots) and a grammar pool (two usable slots)."""
    cfg = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=256, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(5))
    lm = CausalLM(cfg, params, tl.LlamaForCausalLM, buckets=(64, 128), max_batch=4,
                  page_size=16, paged_attn_kernel=True, lora_rank=4, lora_slots=3,
                  grammar_slots=3, grammar_states=48, device=cuda)
    adapters = {}
    for i in range(2):
        lcfg = LoraConfig(r=4, lora_alpha=8.0)
        gen = torch.Generator().manual_seed(20 + i)
        tree = init_lora(params, lcfg, gen)
        for ad in tree.values():
            ad["lora_b"] = 0.05 * torch.randn(ad["lora_b"].shape, generator=gen)
        adapters[f"a{i}"] = (tree, lcfg)
    return lm, adapters


_GRAMMARS = {"gnum": {"regex": "-?[0-9]{1,3}"}, "gab": {"regex": "a[ab]*b"}}


def _tenant_engine(lm, adapters, **kw):
    engine = ServeEngine(lm, block_steps=4, seed=2, **kw)
    for name, (tree, lcfg) in adapters.items():
        engine.register_adapter(name, tree, lcfg)
    for name, spec in _GRAMMARS.items():
        engine.register_grammar(name, **spec)
    rng = np.random.default_rng(4)
    for i, tenancy in enumerate((dict(adapter="a0"), {}, dict(adapter="a1", grammar="gab"),
                                 dict(grammar="gnum"))):
        engine.submit(rng.integers(1, 255, 40 + 9 * i), 14, arrival_block=i // 2, **tenancy)
    return engine


def test_adapter_slot_garbled_between_replays_moves_that_row_alone(cuda):
    """The captured block reads the adapter pool in place: a0's slot
    garbled for two blocks between replays, then repaired from the
    registry, changes the tokens of a0's stream and of no other row."""
    lm, adapters = _tenant_lm(cuda)
    runs = {}
    for garble in (False, True):
        engine = _tenant_engine(lm, adapters)
        pool, blocks = engine.session.adapters, 0
        while engine.step_block():
            blocks += 1
            if garble and blocks == 2:
                slot = pool.slot_of("a0")
                pool._garble_slot(slot)
                assert not pool._intact(slot, pool._registry["a0"])
            if garble and blocks == 4:
                pool._write_slot(slot, pool._registry["a0"])
                assert pool._intact(slot, pool._registry["a0"])
        runs[garble] = {c.request_id: c.tokens.tolist() for c in engine.completed}
        assert engine.replays == engine.decode_blocks and engine.nonfinite_logits == 0
    assert runs[True][0] != runs[False][0]
    assert all(runs[True][r] == runs[False][r] for r in (1, 2, 3))
    assert len(lm._fused) == 1


def test_grammar_rows_in_the_captured_block_equal_the_stepwise_route(cuda):
    """Adapter and grammar rows beside free ones: the captured block's
    streams equal the per-token route's bit for bit, and every constrained
    stream parses."""
    import re

    from neuronx_distributed_tpu_torch.inference.grammar import default_token_table, detokenize

    lm, adapters = _tenant_lm(cuda)
    runs = {}
    for fused in (True, False):
        engine = _tenant_engine(lm, adapters, fused=fused)
        runs[fused] = {c.request_id: c for c in engine.run()}
        assert engine.nonfinite_logits == 0
    assert {r: c.tokens.tolist() for r, c in runs[True].items()} == \
        {r: c.tokens.tolist() for r, c in runs[False].items()}
    table = default_token_table(256)
    for c in runs[True].values():
        if c.grammar is not None:
            assert re.fullmatch(_GRAMMARS[c.grammar]["regex"], detokenize(c.tokens, table))


def test_from_snapshot_with_tenants_reuses_the_captured_graph(cuda):
    """A snapshot taken mid-stream under adapters and grammars, restored on
    the same ``CausalLM``: no second capture, and every stream finishes as
    the uninterrupted run's."""
    lm, adapters = _tenant_lm(cuda)
    oracle = {c.request_id: c.tokens.tolist() for c in _tenant_engine(lm, adapters).run()}
    engine = _tenant_engine(lm, adapters)
    for _ in range(3):
        engine.step_block()
    snap = engine.snapshot()
    assert any(r["adapter"] and r["grammar"] and r["generated"] for r in snap["requests"])
    done = {c.request_id: c.tokens.tolist() for c in engine.completed}
    restored = ServeEngine.from_snapshot(lm, snap, adapters=adapters, grammars=_GRAMMARS)
    assert restored.capture_s < 0.05 and len(lm._fused) == 1
    done.update({c.request_id: c.tokens.tolist() for c in restored.run()})
    assert done == oracle
