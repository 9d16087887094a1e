// W8A16 GEMM for Hopper (sm_90a): activations in bf16 or fp32 against int8
// weights with fp32 scales, the weights dequantized inside the tile.
//
// Replaces: no Pallas kernel. The JAX package leaves the int8 product to
// XLA, which fuses quantization/core.py:dequantize_leaf ((q * scale) cast to
// the compute dtype) into the consuming einsum of the parallel layers and of
// moe/expert_mlps.py. Eager PyTorch would instead write and read a bf16 copy
// of every weight on every step.
//
// Computes, for each batch entry b: out[b] = x[b] @ W[idx[b]], where
// W[e][k][n] = round_T(q[e][k][n] * scale[e * s_es + n * s_ns]), the product
// taken in fp32 and rounded to the compute dtype T as the twin rounds.
//   x     (B, M, K) T, rows contiguous, batch stride x_bs (0: one x for all b)
//   q     (E, K, N) int8, contiguous
//   scale fp32: (E, 1, N) per output channel (s_es = N, s_ns = 1) or one
//         scalar (s_es = s_ns = 0)
//   idx   (B,) int32 expert of each batch entry (the identity for dense
//         layers and all_experts, the routed experts for selective decode)
//   out   (B, M, N) T
//
// What bounds it on this card: at decode (M of 1 to 16 rows) the int8
// weights, K * N bytes per distinct expert, at 3.35 TB/s (a (8, 4096) x
// (4096, 14336) product reads 58.7 MB: 17.5 us); at prefill the products,
// 2 * M * K * N operations at 989 TFLOP/s in bf16 ((4096, 4096) x
// (4096, 14336): 0.49 ms).
//
// Design. bf16 (namespace tc): one CTA of 128 threads (4 warps) per 128
// output columns, BM rows (16 for M <= 16, else 64) and one range of K
// (split-K). Each 64-deep k tile is read from device memory with 16-byte
// loads into registers (the int8 weights and the bf16 activations), and the
// next tile's loads are in flight while the tensor cores (mma.sync m16n8k16,
// fp32 accumulate) work on the current one from shared memory. A thread
// owns one 16-column strip of the weight tile for the whole run, so its 16
// scales are read once. At small M there are too few column tiles to fill
// 132 SMs, so the wrapper splits K over CTAs; the fp32 partials go to a
// workspace and a second kernel adds them in split order (deterministic: a
// rerun gives the same bits; no atomics). With one split the product kernel
// writes the output itself. fp32 (the SIMT kernel): 256 threads per 64 x 64
// tile, 16-deep k tiles through shared memory, fp32 FMAs, the same split-K.
// wgmma and TMA are later work.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  const int* idx;
  void* out;
  float* work;
  int B, M, K, N;
  long long x_bs;
  int s_es, s_ns;
  int splits, kt_per;
};

// signed bytes of a 32-bit word, lowest first
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// the fp32 sum of one output element goes to `out` (one split) or to this
// split's slice of the workspace
template <typename T>
__device__ __forceinline__ void store_pair(const Args& a, int b, int split, int m, int n,
                                           float v0, float v1) {
  if (a.splits == 1) {
    T* o = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.M + m) * a.N + n;
    o[0] = nxd::from_f<T>(v0);
    o[1] = nxd::from_f<T>(v1);
  } else {
    float* w = a.work + ((static_cast<size_t>(split) * a.B + b) * a.M + m) * a.N + n;
    *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
  }
}

namespace tc {

constexpr int NT = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDX = BK + 8;  // 144-byte rows: 9 chunks of 16 B, conflict-free ldmatrix
constexpr int LDW = BN + 8;  // 272-byte rows: 17 chunks of 16 B
constexpr int WSTRIPS = BN / 16;         // 16-column strips of a weight tile
constexpr int WROWS = NT / WSTRIPS;      // weight rows a pass of the CTA covers
constexpr int WCH = BK / WROWS;          // weight chunks per thread per tile

template <int BM, int WM>
__global__ void __launch_bounds__(NT) gemm_kernel(Args a) {
  constexpr int WN = 4 / WM;
  constexpr int WTM = BM / WM;
  constexpr int WTN = BN / WN;
  constexpr int MI = WTM / 16;
  constexpr int NJ = WTN / 16;
  constexpr int XCH = BM * BK / 8 / NT;  // 16-byte activation chunks per thread per tile
  __shared__ __align__(16) __nv_bfloat16 xs[BM * LDX];
  __shared__ __align__(16) __nv_bfloat16 ws[BK * LDW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int ktiles = (a.K + BK - 1) / BK;
  const int kt0 = split * a.kt_per;
  const int kt1 = min(ktiles, kt0 + a.kt_per);
  const int e = a.idx[b];
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x) + b * a.x_bs;
  const int8_t* qb = a.q + static_cast<size_t>(e) * a.K * a.N;

  // this thread's weight strip: columns wc .. wc + 15 of the tile, rows
  // wr + WROWS * i
  const int wc = (tid % WSTRIPS) * 16;
  const int wr = tid / WSTRIPS;
  const bool wcol = n0 + wc < a.N;  // N % 16 == 0: a strip is all in or all out
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    sc[j] = wcol ? a.scale[static_cast<size_t>(e) * a.s_es +
                           static_cast<size_t>(n0 + wc + j) * a.s_ns]
                 : 0.f;

  int4 xr[XCH];
  int4 wq[WCH];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BK / 8);
      const int k = k0 + (c % (BK / 8)) * 8;  // K % 8 == 0: a chunk is all in or all out
      const int m = m0 + r;
      xr[i] = (m < a.M && k < a.K)
                  ? *reinterpret_cast<const int4*>(xb + static_cast<size_t>(m) * a.K + k)
                  : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int k = k0 + wr + WROWS * i;
      wq[i] = (wcol && k < a.K)
                  ? __ldcs(reinterpret_cast<const int4*>(qb + static_cast<size_t>(k) * a.N +
                                                         n0 + wc))
                  : make_int4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * NT;
      *reinterpret_cast<int4*>(&xs[(c / (BK / 8)) * LDX + (c % (BK / 8)) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const uint32_t words[4] = {static_cast<uint32_t>(wq[i].x), static_cast<uint32_t>(wq[i].y),
                                 static_cast<uint32_t>(wq[i].z), static_cast<uint32_t>(wq[i].w)};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w = words[j / 2];
        const int lo = 2 * (j % 2);
        packed[j] = nxd::pack_bf16(__fmul_rn(byte_f(w, lo), sc[2 * j]),
                                   __fmul_rn(byte_f(w, lo + 1), sc[2 * j + 1]));
      }
      int4* dst = reinterpret_cast<int4*>(&ws[(wr + WROWS * i) * LDW + wc]);
      dst[0] = make_int4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_int4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  float acc[MI][2 * NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nb = 0; nb < 2 * NJ; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nb][r] = 0.f;

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        nxd::ldsm_x4(af[mi], &xs[(wm * WTM + mi * 16) * LDX + kk * 16] +
                                 nxd::a_offset(lane, LDX));
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        uint32_t bf[4];
        nxd::ldsm_x4_t(bf, &ws[(kk * 16) * LDW + wn * WTN + nj * 16] + nxd::a_offset(lane, LDW));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          nxd::mma_bf16(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          nxd::mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nb = 0; nb < 2 * NJ; ++nb) {
      const int n = n0 + wn * WTN + nb * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WTM + mi * 16 + g + 8 * h;
        if (m < a.M && n < a.N)
          store_pair<__nv_bfloat16>(a, b, split, m, n, acc[mi][nb][2 * h], acc[mi][nb][2 * h + 1]);
      }
    }
}

}  // namespace tc

// fp32: SIMT FMAs, 64 x 64 output tile, thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j
constexpr int F_NT = 256;
constexpr int F_BM = 64;
constexpr int F_BN = 64;
constexpr int F_BK = 16;

__global__ void __launch_bounds__(F_NT) gemm_f32_kernel(Args a) {
  __shared__ float xs[F_BM][F_BK + 1];
  __shared__ float ws[F_BK][F_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * F_BN;
  const int m0 = blockIdx.y * F_BM;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int ktiles = (a.K + F_BK - 1) / F_BK;
  const int kt0 = split * a.kt_per;
  const int kt1 = min(ktiles, kt0 + a.kt_per);
  const int e = a.idx[b];
  const float* xb = static_cast<const float*>(a.x) + b * a.x_bs;
  const int8_t* qb = a.q + static_cast<size_t>(e) * a.K * a.N;
  const float* sb = a.scale + static_cast<size_t>(e) * a.s_es;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * F_BK;
#pragma unroll
    for (int i = 0; i < F_BM * F_BK / F_NT; ++i) {
      const int c = tid + i * F_NT;
      const int r = c / F_BK;
      const int kc = c % F_BK;
      const int m = m0 + r;
      const int k = k0 + kc;
      xs[r][kc] = (m < a.M && k < a.K) ? xb[static_cast<size_t>(m) * a.K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < F_BK * F_BN / F_NT; ++i) {
      const int c = tid + i * F_NT;
      const int r = c / F_BN;
      const int nc = c % F_BN;
      const int k = k0 + r;
      const int n = n0 + nc;
      ws[r][nc] = (k < a.K && n < a.N)
                      ? __fmul_rn(static_cast<float>(qb[static_cast<size_t>(k) * a.N + n]),
                                  sb[static_cast<size_t>(n) * a.s_ns])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= a.N) continue;
      if (a.splits == 1)
        static_cast<float*>(a.out)[(static_cast<size_t>(b) * a.M + m) * a.N + n] = acc[i][j];
      else
        a.work[((static_cast<size_t>(split) * a.B + b) * a.M + m) * a.N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over splits s = 0, 1, ... of work[s][i], in that order
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ work, T* __restrict__ out, long long n,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = work[i];
    for (int sp = 1; sp < splits; ++sp) s += work[sp * n + i];
    out[i] = nxd::from_f<T>(s);
  }
}

}  // namespace

// x, q, scale, idx, out, work (fp32, splits * B * M * N when splits > 1),
// B, M, K, N, x batch stride (elements), scale expert stride, scale column
// stride, splits, k tiles per split (64-deep for bf16, 16-deep for fp32),
// dtype (0 fp32 / 1 bf16), stream
extern "C" int w8a16_gemm(const void* x, const void* q, const void* scale, const void* idx,
                          void* out, void* work, int B, int M, int K, int N, long long x_bs,
                          int s_es, int s_ns, int splits, int kt_per, int dtype, void* stream) {
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale),
         static_cast<const int*>(idx), out, static_cast<float*>(work), B, M, K, N, x_bs,
         s_es, s_ns, splits, kt_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (M <= 16) {
      dim3 grid((N + tc::BN - 1) / tc::BN, (M + 15) / 16, B * splits);
      tc::gemm_kernel<16, 1><<<grid, tc::NT, 0, s>>>(a);
    } else {
      dim3 grid((N + tc::BN - 1) / tc::BN, (M + 63) / 64, B * splits);
      tc::gemm_kernel<64, 2><<<grid, tc::NT, 0, s>>>(a);
    }
  } else {
    dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, B * splits);
    gemm_f32_kernel<<<grid, F_NT, 0, s>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * M * N;
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 132 * 16));
  if (dtype == 1)
    reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(a.work, static_cast<__nv_bfloat16*>(out),
                                                        n, splits);
  else
    reduce_kernel<float><<<blocks, 256, 0, s>>>(a.work, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
