"""B5's routes (``kernels/w8a16.py``): which kernel a shape takes, how K is
split, what the wrapper refuses, and the launch counts by route.

The route and the split are functions of the shapes alone, so a rerun and a
captured program take the same kernel and reduce in the same order: each is
held here at its boundaries and asked twice. The kernels themselves run
only on the card (``test_torch_cuda_kernels.py``); on the CPU the wrapper
runs its twin and counts no launch. At a shape of each route the twin is
held against the JAX package's ``dequantize_leaf`` and the product, fed the
same seeded numpy inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.quantization import core as jq
from neuronx_distributed_tpu_torch.inference import model_builder as tmb
from neuronx_distributed_tpu_torch.kernels import w8a16 as w8

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,dtype,route", [
    (1, BF16, "decode"), (8, BF16, "decode"), (16, BF16, "decode"),
    (17, BF16, "wgmma"), (512, BF16, "wgmma"), (4096, BF16, "wgmma"),
    (1, FP32, "f32"), (16, FP32, "f32"), (64, FP32, "f32"), (4096, FP32, "f32"),
])
def test_route_is_a_function_of_rows_and_dtype(M, dtype, route):
    """bf16 at most 16 rows decodes, above that the wgmma route; fp32 the
    SIMT route at any rows; batch entries, K and N never change it, and a
    second call gives the same answer."""
    for B, K, N in ((1, 4096, 14336), (16, 512, 128), (8, 14336, 4096)):
        assert w8._route(B, M, K, N, dtype) == route
        assert w8._route(B, M, K, N, dtype) == w8._route(B, M, K, N, dtype)


@pytest.mark.parametrize("M,rows,code", [(17, 128, 2), (128, 128, 2), (129, 256, 3),
                                         (4096, 256, 3)])
def test_wgmma_tile_rows(M, rows, code):
    """The wgmma route's tiles are 128 rows up to 128 rows, else 256 (C
    codes 2 and 3); the decode and fp32 tiles are fixed; the decode route
    runs the cp.async ring over several batch entries (code 1) and the
    register-staged kernel over one (code 4)."""
    assert w8._tile("wgmma", M) == (64, rows, 128)
    assert w8._code("wgmma", 1, M) == w8._code("wgmma", 8, M) == code
    assert w8._tile("decode", M) == (64, 16, 128)
    assert w8._code("decode", 1, M) == 4 and w8._code("decode", 2, M) == 1
    assert w8._tile("f32", M) == (16, 64, 64) and w8._code("f32", 1, M) == 0


# (B, M, K, N) the main path launches: decode (dense both ways, all_experts,
# selective pairs at batch 8 and 1) and prefill (the inserts' products)
MAIN_PATH = [(1, 8, 4096, 14336), (1, 8, 14336, 4096), (8, 8, 4096, 14336),
             (16, 1, 4096, 14336), (2, 1, 4096, 14336), (1, 512, 4096, 14336),
             (1, 512, 4096, 1024), (1, 512, 14336, 4096), (1, 4096, 4096, 14336),
             (8, 512, 4096, 14336), (1, 300, 4096, 14336), (1, 150, 2048, 128),
             (1, 3, 200, 48), (1, 128, 4096, 4096)]


@pytest.mark.parametrize("shape", MAIN_PATH)
def test_splits_cover_k_and_fill_one_wave(shape):
    """The splits cover every k tile and none is empty (at most
    _MAX_SPLITS). The wgmma route and the batched decode kernel split K only
    while the output tiles leave room in one wave of resident CTAs, into
    parts of at least _MIN_SPLIT_KTILES k tiles; the one-entry decode kernel
    splits as the fp32 route does (about _SPLIT_TARGET CTAs). Asked twice,
    the same."""
    B, M, K, N = shape
    route = w8._route(B, M, K, N, BF16)
    splits, per = w8._splits(route, B, M, K, N)
    assert (splits, per) == w8._splits(route, B, M, K, N)
    bk, bm, bn = w8._tile(route, M)
    tiles = B * math.ceil(M / bm) * math.ceil(N / bn)
    ktiles = math.ceil(K / bk)
    assert splits * per >= ktiles and (splits - 1) * per < ktiles
    assert 1 <= splits <= w8._MAX_SPLITS
    if w8._code(route, B, M) == 4:
        want = (1 if tiles >= w8._SPLIT_TARGET // 2
                else min(w8._MAX_SPLITS, -(-w8._SPLIT_TARGET // tiles)))
        assert per == -(-ktiles // min(want, ktiles))
    elif splits > 1:
        assert tiles * splits <= w8._WAVE[route]
        assert per >= w8._MIN_SPLIT_KTILES
    else:
        assert (tiles * 2 > w8._WAVE[route] or ktiles < 2 * w8._MIN_SPLIT_KTILES)


@pytest.mark.parametrize("shape,want", [
    ((1, 8, 4096, 14336), (5, 13)),    # dense decode (the fp32 rule): 112 tiles, 5 splits
    ((1, 8, 14336, 4096), (16, 14)),   # 32 tiles: 16 splits (the most) of 14 k tiles
    ((8, 8, 4096, 14336), (1, 64)),    # all_experts: 896 tiles fill the card
    ((2, 1, 4096, 14336), (2, 32)),    # batch-1 selective: 224 tiles, 2 a wave of 528
    ((1, 512, 4096, 14336), (1, 64)),  # prefill: 224 tiles of 256 rows
    ((1, 512, 4096, 1024), (8, 8)),    # k and v: 16 tiles, 8 splits of 8 k tiles
    ((1, 512, 14336, 4096), (2, 112)),  # down: 64 tiles, 2 a wave of 132
])
def test_splits_at_the_main_path_shapes(shape, want):
    B, M, K, N = shape
    assert w8._splits(w8._route(B, M, K, N, BF16), B, M, K, N) == want


@pytest.mark.parametrize("shape", [(1, 64, 4096, 4096), (1, 8, 4096, 14336), (4, 300, 512, 96)])
def test_f32_splits_keep_their_rule(shape):
    """The fp32 route splits as before: until about 528 CTAs, at most 16
    ways, one split once the tiles reach half of that."""
    B, M, K, N = shape
    assert w8._code("f32", B, M) == 0
    tiles = B * math.ceil(M / 64) * math.ceil(N / 64)
    ktiles = math.ceil(K / 16)
    want = 1 if tiles >= 264 else min(16, -(-528 // tiles))
    per = -(-ktiles // max(1, min(want, ktiles)))
    assert w8._splits("f32", B, M, K, N) == (-(-ktiles // per), per)


def _operands(B=1, M=24, K=64, N=32, E=1, dtype=BF16):
    g = torch.Generator().manual_seed(4)
    q = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8)
    scale = torch.rand((E, 1, N), generator=g) / 100
    x = torch.randn((B, M, K), generator=g).to(dtype)
    return x, q, scale, torch.zeros((B,), dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("n16", "N % 16"), ("k8", "K % 8"), ("misaligned", "16-byte"), ("fp16", "fp32 or bf16"),
    ("strided", "rows contiguous"), ("qweight", "contiguous qweight"),
])
def test_kernel_checks_refuse_what_no_route_reads(case, match):
    """The kernel wrapper's checks raise before anything is built or
    launched: N not a multiple of 16, K not of 8, x or the weights off a
    16-byte boundary, fp16 activations, strided rows, a strided weight."""
    x, q, scale, idx = _operands()
    if case == "n16":
        q, scale = q[:, :, :24].contiguous(), scale[:, :, :24].contiguous()
    elif case == "k8":
        x, q = x[:, :, :60].contiguous(), q[:, :60].contiguous()
    elif case == "misaligned":
        x = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape).copy_(x)
    elif case == "fp16":
        x = x.half()
    elif case == "strided":
        x = torch.randn((1, 24, 128)).to(BF16)[:, :, :64]
    elif case == "qweight":
        q = torch.randint(-127, 128, (1, 32, 64), dtype=torch.int8).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        w8._w8a16_kernel(x, q, scale, idx)


def test_cpu_tensors_count_no_launch():
    """On the CPU the wrapper runs the twin: neither the launch count nor
    any route's count moves."""
    before, routes = w8.w8a16_gemm.launches, dict(w8.w8a16_gemm.launches_by_route)
    assert set(routes) == {"wgmma", "decode", "f32"}
    for M in (8, 40):
        for dtype in (BF16, FP32):
            w8.w8a16_gemm(*_operands(M=M, dtype=dtype))
    assert w8.w8a16_gemm.launches == before
    assert w8.w8a16_gemm.launches_by_route == routes


def test_replay_adds_the_routes_its_capture_launched():
    """A captured program's replay adds, per route, what its warm-up
    launched (a replay runs no Python): the same bookkeeping as the launch
    count, here on a program whose graph is a stand-in."""

    class Graph:
        def replay(self):
            pass

    prog = tmb.CapturedProgram(lambda: None, torch.device("cpu"))
    prog.graph = Graph()
    prog.launches_per_replay = {"w8a16_gemm": 3}
    prog.routes_per_replay = {"w8a16_gemm": {"wgmma": 1, "decode": 2, "f32": 0}}
    fn = w8.w8a16_gemm
    launches, routes = fn.launches, dict(fn.launches_by_route)
    try:
        prog.replay()
        prog.replay()
        assert fn.launches == launches + 6
        assert fn.launches_by_route == {"wgmma": routes["wgmma"] + 2,
                                        "decode": routes["decode"] + 4, "f32": routes["f32"]}
    finally:
        fn.launches, fn.launches_by_route = launches, routes
    assert set(tmb._route_counts()[fn]) == {"wgmma", "decode", "f32"}


@pytest.mark.parametrize("B,M,K,N,E,routed", [
    (1, 8, 64, 48, 1, False),     # decode shape
    (6, 1, 96, 32, 4, True),      # selective pairs
    (1, 40, 72, 48, 1, False),    # wgmma shape, 128-row tile
    (3, 150, 64, 32, 3, False),   # wgmma shape, 256-row tile, one expert an entry
])
def test_twin_at_each_routes_shape_equals_jax(B, M, K, N, E, routed):
    """The twin at a shape of each route (fp32) against JAX: its
    ``quantize_params`` rule's int8 weights and scales, ``dequantize_leaf``,
    then the product per batch entry, on the same numpy inputs."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((E, K, N)).astype(np.float32) / np.sqrt(K)
    x = rng.standard_normal((B, M, K)).astype(np.float32)
    idx = (rng.integers(0, E, B) if routed else np.arange(B) % E).astype(np.int32)
    leaves = [jq.quantize_params({"kernel": w[e]}) for e in range(E)]
    ref = np.stack([np.asarray(x[b] @ jq.dequantize_leaf(leaves[idx[b]]["kernel"],
                                                         jnp.float32))
                    for b in range(B)])
    q = torch.from_numpy(np.stack([np.asarray(l["kernel"]["qweight"]) for l in leaves]))
    scale = torch.from_numpy(np.stack([np.asarray(l["kernel"]["scale"]) for l in leaves]))
    got = w8.w8a16_gemm(torch.from_numpy(x), q, scale, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert jax.devices()[0].platform == "cpu"
