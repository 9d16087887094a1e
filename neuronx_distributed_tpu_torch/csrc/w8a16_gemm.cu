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
// (4096, 14336): 0.49 ms). The wrapper (kernels/w8a16.py `_route`) picks
// one of three routes from the shapes alone.
//
// Route "wgmma" (bf16, M > 16; tc::wgmma_kernel<MW>): bound by operations,
// so it runs on Hopper's warpgroup products. Persistent CTAs (one per SM)
// walk work units (b, n tile, m tile, k split) with the m tiles of one
// weight panel adjacent, so the CTAs running at one time share that panel
// in L2. A tile is 128 MW rows (MW = 1 up to 128 rows, else 2) x 128
// columns. Each CTA is four warpgroups over a ring of stages in shared
// memory, each stage a 128 MW x 64 bf16 x tile, a 64 x 128 int8 weight
// tile and the 64 x 128 bf16 weight tile made from it:
//   warpgroup 0, the producer (one thread): TMA loads of the x tile (3-D map
//     (K, M, B); a batch stride of 0 reads batch 0's rows for every b) and
//     of the int8 tile (3-D map (N, K, E) at expert idx[b], so a ragged last
//     k tile reads zeros, not the next expert's rows), both 128-byte
//     swizzled, onto the stage's `full` barrier;
//   warpgroup 1, dequant: int8 -> fp32 (exact, by the 2^23 bias trick) x
//     the column's scale (fp32, RN) -> bf16 (RN) into the stage's bf16 tile
//     in the MN-major swizzled layout the wgmma descriptor reads (the
//     transpose bit set for B), then the `deq` barrier. A warpgroup of its
//     own and not the consumers: converting a 64 x 128 tile takes about as
//     many instructions as the consumers need cycles for the tile's
//     products, so done by the consumers it would stop their tensor cores
//     for each tile; done beside them it overlaps the products of the
//     stage before;
//   warpgroups 2 and 3, the consumers: 64 MW rows x 128 columns each, fp32
//     accumulators in registers, wgmma m64n128k16 with A (x) and B (the bf16
//     tile) from shared memory, one group of 4 MW products in flight; a
//     stage goes back to the producer (`empty`) when its products are done.
//     Epilogue: fp32 -> bf16 into `out` (4-byte stores), rows past M and
//     columns past N masked, or fp32 partials into the workspace when K is
//     split.
// setmaxnreg lowers the producer's registers to 40 and the dequant
// warpgroup's to 104 and raises the consumers'. Split K only where the
// tiles are too few for the SMs (the wrapper's `_splits`); partials are
// summed in split order. Tried and dropped on an H100 (slower there):
// clusters of two CTAs multicasting the x tile (the pair waits on each
// other's releases), and one `deq` arrival a warp instead of a thread.
//
// Route "decode" (bf16, M <= 16): bound by the weight bytes; two kernels,
// picked by the number of batch entries.
//   One entry (the dense layers; tc::dense_decode_kernel, register-staged):
//     one CTA of 4 warps per (16 rows, 128 columns, k split); each 64-deep
//     k tile is read with 16-byte streaming loads into registers, the next
//     tile's loads in flight while the tensor cores (mma.sync) work on the
//     current one, dequantized into a bf16 tile in shared memory. The
//     wrapper splits K until about 528 CTAs are in flight.
//   Several entries (all_experts, selective pairs; tc::decode_kernel): one
//     CTA of 4 warps per (batch entry, k split, 128 columns, 16 rows), batch
//     entries fastest so the CTAs of routed pairs that share an expert run
//     together and meet its tiles in L2. A ring of D_STAGES stages of int8
//     weight tiles (64 x 128) and x tiles, filled with 16-byte cp.async,
//     keeps three tiles (24 KB of weights) in flight per CTA, four CTAs an
//     SM (one wave: the wrapper splits K into as many parts as fit it). Each
//     warp dequantizes its own 32 columns straight into mma.sync's B
//     fragments: ldmatrix.trans of the int8 tile read as 16-bit pairs hands
//     a lane two k rows of two neighbouring columns, which become the
//     fragments of an even-column and an odd-column n-block (the
//     accumulators' columns are put back in order at the store). So no bf16
//     tile and one CTA barrier a k tile.
//   The ring was measured against the register-staged kernel (the route's
//   first design) in the same calls on an
//   H100: faster with several entries, a little slower with one, so each
//   keeps the cases it wins.
//
// Route "f32" (fp32; gemm_f32_kernel): SIMT fp32 FMAs, 256 threads per
// 64 x 64 tile, 16-deep k tiles through shared memory, the same split-K.
//
// Split K: the fp32 partials go to a workspace and reduce_kernel adds them
// in split order (deterministic: a rerun gives the same bits; no atomics).
// With one split the product kernel writes the output itself.

#include <algorithm>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
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
  int m_tiles, n_tiles, units;  // the wgmma route's work units
};

// the fp32 sums of two neighbouring bf16 output elements (n even) go to
// `out` as one 4-byte store (one split) or to this split's slice of the
// workspace
__device__ __forceinline__ void store_pair(const Args& a, int b, int split, int m, int n,
                                           float v0, float v1) {
  if (a.splits == 1) {
    __nv_bfloat16* o =
        static_cast<__nv_bfloat16*>(a.out) + (static_cast<size_t>(b) * a.M + m) * a.N + n;
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    float* w = a.work + ((static_cast<size_t>(split) * a.B + b) * a.M + m) * a.N + n;
    *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
  }
}

// 8 signed bytes (w0: columns 0-3, w1: 4-7, lowest byte first) times their
// 8 scales, each product an fp32 rounded to bf16, nearest even: the twin's
// (q.float() * scale).to(bf16). A byte b becomes the float 2^23 + (b + 128)
// by a byte permute (the biased byte as the low mantissa byte), and the
// exact subtraction of 2^23 + 128 leaves b: a permute and an add in place
// of an int-to-float conversion, which would share the conversion unit with
// the rounding of every product to bf16.
__device__ __forceinline__ uint4 dequant8(uint32_t w0, uint32_t w1, const float* sc) {
  const uint32_t u[2] = {w0 ^ 0x80808080u, w1 ^ 0x80808080u};
  uint32_t p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t word = u[j / 2];
    const int lo = 2 * (j % 2);
    const float f0 = __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + lo)),
                               8388736.f);
    const float f1 = __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7441 + lo)),
                               8388736.f);
    p[j] = nxd::pack_bf16(__fmul_rn(f0, sc[2 * j]), __fmul_rn(f1, sc[2 * j + 1]));
  }
  return make_uint4(p[0], p[1], p[2], p[3]);
}

namespace tc {

constexpr int BN = 128;
constexpr int BK = 64;

// --- route "decode", one batch entry (register-staged) --------------------------

constexpr int NT = 128;
constexpr int D_BM = 16;
constexpr int LDW = BN + 8;  // bf16 weight rows of 272 bytes: 17 chunks of 16 B

// signed bytes of a 32-bit word, lowest first
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// One CTA of 4 warps per (16 rows, 128 columns, k split) of the single
// batch entry. Each 64-deep k tile is read from device memory with 16-byte
// streaming loads into registers (the int8 weights and the bf16
// activations), and the next tile's loads are in flight while the tensor
// cores (mma.sync m16n8k16) work on the current one from shared memory,
// where the tile was dequantized.
__global__ void __launch_bounds__(NT) dense_decode_kernel(Args a) {
  constexpr int NJ = 2;  // 4 warps along N, 32 columns each
  __shared__ __align__(16) __nv_bfloat16 xs[D_BM * (BK + 8)];
  __shared__ __align__(16) __nv_bfloat16 ws[BK * LDW];
  constexpr int LDXS = BK + 8;
  constexpr int WSTRIP = BN / 16;
  constexpr int WROW = NT / WSTRIP;
  constexpr int WCHK = BK / WROW;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * D_BM;
  const int split = blockIdx.z;
  const int ktiles = (a.K + BK - 1) / BK;
  const int kt0 = split * a.kt_per;
  const int kt1 = min(ktiles, kt0 + a.kt_per);
  const int e = a.idx[0];
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x);
  const int8_t* qb = a.q + static_cast<size_t>(e) * a.K * a.N;

  // this thread's weight strip: columns wc .. wc + 15 of the tile, rows
  // wr + WROW * i
  const int wc = (tid % WSTRIP) * 16;
  const int wr = tid / WSTRIP;
  const bool wcol = n0 + wc < a.N;  // N % 16 == 0: a strip is all in or all out
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    sc[j] = wcol ? a.scale[static_cast<size_t>(e) * a.s_es +
                           static_cast<size_t>(n0 + wc + j) * a.s_ns]
                 : 0.f;

  int4 xr;
  int4 wq[WCHK];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    const int r = tid / (BK / 8);
    const int k = k0 + (tid % (BK / 8)) * 8;  // K % 8 == 0: a chunk is all in or all out
    const int m = m0 + r;
    xr = (m < a.M && k < a.K)
             ? *reinterpret_cast<const int4*>(xb + static_cast<size_t>(m) * a.K + k)
             : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < WCHK; ++i) {
      const int kw = k0 + wr + WROW * i;
      wq[i] = (wcol && kw < a.K)
                  ? __ldcs(reinterpret_cast<const int4*>(qb + static_cast<size_t>(kw) * a.N +
                                                         n0 + wc))
                  : make_int4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
    *reinterpret_cast<int4*>(&xs[(tid / (BK / 8)) * LDXS + (tid % (BK / 8)) * 8]) = xr;
#pragma unroll
    for (int i = 0; i < WCHK; ++i) {
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
      int4* dst = reinterpret_cast<int4*>(&ws[(wr + WROW * i) * LDW + wc]);
      dst[0] = make_int4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_int4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  float acc[2 * NJ][4];
#pragma unroll
  for (int nb = 0; nb < 2 * NJ; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      nxd::ldsm_x4(af, &xs[kk * 16] + nxd::a_offset(lane, LDXS));
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        uint32_t bf[4];
        nxd::ldsm_x4_t(bf, &ws[(kk * 16) * LDW + wn * 32 + nj * 16] + nxd::a_offset(lane, LDW));
        nxd::mma_bf16(acc[2 * nj], af, bf[0], bf[1]);
        nxd::mma_bf16(acc[2 * nj + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 2 * NJ; ++nb) {
    const int n = n0 + wn * 32 + nb * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      if (m < a.M && n < a.N)
        store_pair(a, 0, split, m, n, acc[nb][2 * h], acc[nb][2 * h + 1]);
    }
  }
}

// --- route "decode", batched (all_experts, selective) ---------------------------

constexpr int D_STAGES = 4;
constexpr int LDX = BK + 8;   // x rows of 144 bytes: 9 chunks of 16 B, conflict-free ldmatrix
constexpr int LDQ = BN + 16;  // int8 rows of 144 bytes, for the same reason
constexpr int D_XS = D_BM * LDX;  // bf16 elements of an x stage
constexpr int D_QS = BK * LDQ;    // bytes of an int8 weight stage
constexpr int DECODE_SMEM = D_STAGES * (D_XS * 2 + D_QS);
constexpr int WSTRIPS = BN / 16;     // 16-byte strips of a weight row
constexpr int WROWS = NT / WSTRIPS;  // weight rows a pass of the CTA covers
constexpr int WCH = BK / WROWS;      // weight rows per thread per tile

// b0 / b1 of mma.sync's B fragment for two n-blocks from one ldmatrix.trans
// register of int8 pairs, r = [W(k, n), W(k, n + 1), W(k + 1, n), W(k + 1, n + 1)]:
// the even column (bytes 0, 2) with scale se, the odd one (bytes 1, 3) with so,
// each element rounded as dequant8 rounds
__device__ __forceinline__ void dequant_pairs(uint32_t r, float se, float so, uint32_t& even,
                                              uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  auto f = [&](int byte) {
    return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + byte)), 8388736.f);
  };
  even = nxd::pack_bf16(__fmul_rn(f(0), se), __fmul_rn(f(2), se));
  odd = nxd::pack_bf16(__fmul_rn(f(1), so), __fmul_rn(f(3), so));
}

__global__ void __launch_bounds__(NT) decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* qs = smem + D_STAGES * D_XS * 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;  // this warp's 32 columns: 32 wn .. 32 wn + 31
  const int b = blockIdx.x % a.B;
  const int split = blockIdx.x / a.B;
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * D_BM;
  const int ktiles = (a.K + BK - 1) / BK;
  const int kt0 = split * a.kt_per;
  const int n_kt = min(ktiles, kt0 + a.kt_per) - kt0;
  const int e = a.idx[b];
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x) + b * a.x_bs;
  const int8_t* qb = a.q + static_cast<size_t>(e) * a.K * a.N;

  // copies: this thread's weight strip (columns wc .. wc + 15, rows wr +
  // WROWS * i) and x chunk (row xr, columns xc .. xc + 7)
  const int wc = (tid % WSTRIPS) * 16;
  const int wr = tid / WSTRIPS;
  const int xr = tid / (BK / 8);
  const int xc = (tid % (BK / 8)) * 8;
  const bool wcol = n0 + wc < a.N;  // N % 16 == 0: a strip is all in or all out

  // tile kt into ring stage st; zeros past M, K or N (K % 8 == 0: a chunk
  // is all in or all out)
  auto issue = [&](int kt, int st) {
    const int k0 = kt * BK;
    const int m = m0 + xr;
    const bool xin = m < a.M && k0 + xc < a.K;
    nxd::cp_async16(&xs[st * D_XS + xr * LDX + xc],
                    xin ? xb + static_cast<size_t>(m) * a.K + k0 + xc : xb, xin);
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int k = k0 + wr + WROWS * i;
      const bool in = wcol && k < a.K;
      nxd::cp_async16(&qs[st * D_QS + (wr + WROWS * i) * LDQ + wc],
                      in ? qb + static_cast<size_t>(k) * a.N + n0 + wc : qb, in);
    }
  };

  // products: ldmatrix.trans of the int8 tile read as 16-bit pairs gives
  // lane (g, t) = (lane / 4, lane % 4) the bytes of rows k = 2t, 2t + 1 at
  // columns 2g, 2g + 1 of a 16-column group: b fragments of two n-blocks,
  // one of the group's even columns and one of its odd ones. So n-block
  // 2h + p of this warp holds columns 32 wn + 16 h + 2 j + p (j = 0 .. 7),
  // and this lane's scales are those of columns 32 wn + 16 h + 2g + p.
  const int g = lane >> 2;
  const int t = lane & 3;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 32 * wn + 16 * (j >> 1) + 2 * g + (j & 1);
    sc[j] = n < a.N ? a.scale[static_cast<size_t>(e) * a.s_es + static_cast<size_t>(n) * a.s_ns]
                    : 0.f;
  }
  // this lane's row of the four 8 x 8 matrices: k rows +0 / +8, columns
  // 16-byte group 0 / 1
  const int q_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + 32 * wn + (lane >> 4) * 16;

  float acc[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;

#pragma unroll
  for (int i = 0; i < D_STAGES - 1; ++i) {
    if (i < n_kt) issue(kt0 + i, i);
    nxd::cp_async_commit();
  }
  for (int i = 0; i < n_kt; ++i) {
    nxd::cp_async_wait<D_STAGES - 2>();
    // tile i has landed for every thread, and every warp is done with the
    // products of tile i - 1: its stage is free
    __syncthreads();
    if (i + D_STAGES - 1 < n_kt) issue(kt0 + i + D_STAGES - 1, (i + D_STAGES - 1) % D_STAGES);
    nxd::cp_async_commit();
    const int st = i % D_STAGES;
    const __nv_bfloat16* xt = xs + st * D_XS;
    const unsigned char* qt = qs + st * D_QS + q_lane;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4], qf[4], bf[4][2];
      nxd::ldsm_x4(af, &xt[kk * 16] + nxd::a_offset(lane, LDX));
      nxd::ldsm_x4_t(qf, qt + kk * 16 * LDQ);
      // qf: (k 0-7, group 0), (k 8-15, group 0), (k 0-7, group 1), (k 8-15, group 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          dequant_pairs(qf[2 * h + kh], sc[2 * h], sc[2 * h + 1], bf[2 * h][kh], bf[2 * h + 1][kh]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) nxd::mma_bf16(acc[nb], af, bf[nb][0], bf[nb][1]);
    }
  }

  // n-block 2h + p, accumulator columns 2t, 2t + 1: columns 16 h + 4t + p and
  // 16 h + 4t + 2 + p of this warp, so (p = 0, 1) pairs are neighbours
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 32 * wn + 16 * h + 4 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + g + 8 * r;
      if (m < a.M && n < a.N) {
        store_pair(a, b, split, m, n, acc[2 * h][2 * r], acc[2 * h + 1][2 * r]);
        store_pair(a, b, split, m, n + 2, acc[2 * h][2 * r + 1], acc[2 * h + 1][2 * r + 1]);
      }
    }
  }
}

// --- route "wgmma" ------------------------------------------------------------

// The tile is 128 * MW rows: each consumer warpgroup holds MW 64-row
// accumulators (MW = 2 halves the dequant work and the B-operand reads a
// product, at 128 accumulator registers a thread).
template <int MW>
struct Wg {
  static constexpr int BM = 128 * MW;
  static constexpr int STAGES = MW == 1 ? 5 : 4;
  static constexpr int XBYTES = BM * BK * 2;  // x tile: BM rows of 128 bytes, swizzled
  static constexpr int QBYTES = BK * BN;      // int8 tile: 64 rows of 128 bytes, swizzled
  static constexpr int WBYTES = BK * BN * 2;  // bf16 tile: two 64-column halves, MN-major
  static constexpr int STAGE = XBYTES + QBYTES + WBYTES;  // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 3 * STAGES * 8 + 1024;  // + barriers, alignment
  static constexpr int CONSUMER_REGS = MW == 1 ? 160 : 184;
};
constexpr int W_HALF = BK * 128;  // bytes of one 64-column half of the bf16 tile
constexpr int W_THREADS = 4 * 128;
constexpr int PRODUCER_REGS = 40;
constexpr int DEQUANT_REGS = 104;

struct Unit {
  int b, mt, nt, split, kt0, kt1;
};

// work unit u: (b, column tile, m tile, split), the m tiles of one weight
// panel adjacent
__device__ __forceinline__ Unit unit_of(const Args& a, int u, int ktiles) {
  Unit w;
  w.split = u % a.splits;
  u /= a.splits;
  w.mt = u % a.m_tiles;
  u /= a.m_tiles;
  w.nt = u % a.n_tiles;
  w.b = u / a.n_tiles;
  w.kt0 = w.split * a.kt_per;
  w.kt1 = min(ktiles, w.kt0 + a.kt_per);
  return w;
}

template <int MW>
__global__ void __launch_bounds__(W_THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap qmap, Args a) {
  using C = Wg<MW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte aligned stages
  unsigned char* smem = smem_raw + ((1024 - (nxd::hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* deq = full + C::STAGES;
  uint64_t* empty = deq + C::STAGES;
  auto xtile = [&](int s) { return smem + s * C::STAGE; };
  auto qtile = [&](int s) { return smem + s * C::STAGE + C::XBYTES; };
  auto wtile = [&](int s) { return smem + s * C::STAGE + C::XBYTES + C::QBYTES; };

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31;
  const int ktiles = (a.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      nxd::hop::mbar_init(&full[s], 1);     // the producer's arrival + the TMA bytes
      nxd::hop::mbar_init(&deq[s], 128);    // every dequant thread
      nxd::hop::mbar_init(&empty[s], 8);    // each consumer warp
    }
    nxd::hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer
    nxd::hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (t == 0) {
      nxd::hop::prefetch_tensormap(&xmap);
      nxd::hop::prefetch_tensormap(&qmap);
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const Unit w = unit_of(a, u, ktiles);
        const int e = a.idx[w.b];
        const int bx = a.x_bs ? w.b : 0;
        for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
          const int s = it % C::STAGES;
          nxd::hop::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          nxd::hop::mbar_arrive_expect_tx(&full[s], C::XBYTES + C::QBYTES);
          nxd::hop::tma_load_3d(xtile(s), &xmap, &full[s], kt * BK, w.mt * C::BM, bx);
          nxd::hop::tma_load_3d(qtile(s), &qmap, &full[s], w.nt * BN, kt * BK, e);
        }
      }
    }
  } else if (wg == 1) {
    // dequant: thread (c, row base) owns int8 columns 8c .. 8c + 7 of each
    // 64-column half and rows rb + 16 i. Eight threads of a row write the
    // eight 16-byte chunks of a swizzled 128-byte row (no bank conflict);
    // a half warp reads rows rb and rb + 4, whose swizzles differ in bit 2,
    // so its 8-byte reads fall on all 32 banks once.
    nxd::hop::setmaxnreg_dec<DEQUANT_REGS>();
    const int c = lane & 7;
    const int rb = ((t >> 5) & 1) * 2 + (lane >> 4) + 4 * ((lane >> 3) & 1) + 8 * (t >> 6);
    const int x7 = rb & 7;
    int it = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit w = unit_of(a, u, ktiles);
      const int e = a.idx[w.b];
      float sc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = w.nt * BN + (j / 8) * 64 + 8 * c + (j % 8);
        sc[j] = n < a.N ? a.scale[static_cast<size_t>(e) * a.s_es +
                                  static_cast<size_t>(n) * a.s_ns]
                        : 0.f;
      }
      for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
        const int s = it % C::STAGES;
        nxd::hop::mbar_wait(&full[s], (it / C::STAGES) & 1);
        const unsigned char* q = qtile(s);
        unsigned char* wt = wtile(s);
#pragma unroll
        for (int i = 0; i < BK / 16; ++i) {
          const int row = rb + 16 * i;
          const unsigned char* qr = q + row * 128 + ((c & 1) << 3);
          const uint2 lo = *reinterpret_cast<const uint2*>(qr + ((((c >> 1)) ^ x7) << 4));
          const uint2 hi = *reinterpret_cast<const uint2*>(qr + (((4 + (c >> 1)) ^ x7) << 4));
          *reinterpret_cast<uint4*>(wt + row * 128 + ((c ^ x7) << 4)) = dequant8(lo.x, lo.y, sc);
          *reinterpret_cast<uint4*>(wt + W_HALF + row * 128 + ((c ^ x7) << 4)) =
              dequant8(hi.x, hi.y, sc + 8);
        }
        nxd::hop::fence_proxy_async();  // the bf16 tile is read by wgmma (the async proxy)
        nxd::hop::mbar_arrive(&deq[s]);
      }
    }
  } else {
    // consumers: warpgroup g computes rows 64 MW g .. 64 MW (g + 1) - 1 of the tile
    nxd::hop::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int g = wg - 2;
    int it = 0;
    auto release = [&](int s) {  // this warp is done with stage s
      if (lane == 0) nxd::hop::mbar_arrive(&empty[s]);
    };
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit w = unit_of(a, u, ktiles);
      float acc[MW][64];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;
      for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
        const int s = it % C::STAGES;
        const uint32_t ph = (it / C::STAGES) & 1;
        nxd::hop::mbar_wait(&full[s], ph);
        nxd::hop::mbar_wait(&deq[s], ph);
        const unsigned char* xt = xtile(s) + g * MW * (64 * 128);
        const unsigned char* wt = wtile(s);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) nxd::hop::fence_regs(acc[mi]);
        nxd::hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
            nxd::hop::wgmma_m64n128k16_bf16(
                acc[mi], nxd::hop::desc_sw128(xt + mi * (64 * 128) + kk * 32, 16, 1024),
                nxd::hop::desc_sw128(wt + kk * 2048, W_HALF, 1024));
        nxd::hop::wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) nxd::hop::fence_regs(acc[mi]);
        // the products of the tile before are done: give its stage back
        nxd::hop::wgmma_wait<1>();
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) nxd::hop::fence_regs(acc[mi]);
        if (kt > w.kt0) release((it + C::STAGES - 1) % C::STAGES);
      }
      nxd::hop::wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) nxd::hop::fence_regs(acc[mi]);
      release((it + C::STAGES - 1) % C::STAGES);
      // accumulator fragment: warp v of the warpgroup holds rows 16 v + lane / 4
      // (+ 8) of each 64-row block; register 4 j + r holds columns
      // 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        const int row = w.mt * C::BM + (g * MW + mi) * 64 + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = w.nt * BN + 8 * j + 2 * (lane & 3);
          if (n >= a.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row + 8 * h;
            if (m < a.M)
              store_pair(a, w.b, w.split, m, n, acc[mi][4 * j + 2 * h],
                         acc[mi][4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// CTAs of wgmma_kernel<MW> that fit on the card at once: the persistent
// grid (one a SM)
template <int MW>
int max_ctas() {
  static const int n = [] {
    int per_sm = 0, device = 0, sms = 0;
    if (nxd::allow_smem(wgmma_kernel<MW>, Wg<MW>::SMEM) != cudaSuccess ||
        cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgmma_kernel<MW>, W_THREADS,
                                                      Wg<MW>::SMEM) != cudaSuccess)
      return 0;
    return per_sm * sms;
  }();
  return n;
}

// the persistent launch over the work units
template <int MW>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& qmap, const Args& a,
                         cudaStream_t stream) {
  const int fit = max_ctas<MW>();
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const cudaError_t allowed = nxd::allow_smem(wgmma_kernel<MW>, Wg<MW>::SMEM);
  if (allowed != cudaSuccess) return allowed;
  wgmma_kernel<MW><<<std::min(a.units, fit), W_THREADS, Wg<MW>::SMEM, stream>>>(xmap, qmap, a);
  return cudaGetLastError();
}

}  // namespace tc

// --- route "f32" ------------------------------------------------------------------

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

// cuTensorMapEncodeTiled from the CUDA driver API, found through the runtime so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D tiled map over `base` (dims innermost first; strides in bytes of
// dims 1 and 2), 128-byte swizzle, zeros outside the tensor
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
                const cuuint32_t (&box)[3]) {
  EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x, q, scale, idx, out, work (fp32, splits * B * M * N when splits > 1),
// B, M, K, N, E (experts in q), x batch stride (elements), scale expert
// stride, scale column stride, splits, k tiles per split (64-deep for bf16,
// 16-deep for fp32), route (0 f32 / 1 decode, batched / 2 wgmma with 128-row
// tiles / 3 wgmma with 256-row tiles / 4 decode, one batch entry), stream
extern "C" int w8a16_gemm(const void* x, const void* q, const void* scale, const void* idx,
                          void* out, void* work, int B, int M, int K, int N, int E,
                          long long x_bs, int s_es, int s_ns, int splits, int kt_per, int route,
                          void* stream) {
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale),
         static_cast<const int*>(idx), out, static_cast<float*>(work), B, M, K, N, x_bs,
         s_es, s_ns, splits, kt_per, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2 || route == 3) {
    const int mw = route == 2 ? 1 : 2;
    a.m_tiles = (M + 128 * mw - 1) / (128 * mw);
    a.n_tiles = (N + tc::BN - 1) / tc::BN;
    a.units = B * a.m_tiles * a.n_tiles * splits;
    CUtensorMap xmap, qmap;
    const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M),
                                 static_cast<cuuint64_t>(x_bs ? B : 1)};
    const cuuint64_t xstr[2] = {static_cast<cuuint64_t>(K) * 2,
                                static_cast<cuuint64_t>(M) * K * 2};
    const cuuint32_t xbox[3] = {tc::BK, static_cast<cuuint32_t>(128 * mw), 1};
    const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                                 static_cast<cuuint64_t>(E)};
    const cuuint64_t qstr[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K) * N};
    const cuuint32_t qbox[3] = {tc::BN, tc::BK, 1};
    if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, xdims, xstr, xbox) ||
        !tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, qdims, qstr, qbox))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = mw == 1 ? tc::launch_wgmma<1>(xmap, qmap, a, s)
                                    : tc::launch_wgmma<2>(xmap, qmap, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (route == 4) {
    dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::D_BM - 1) / tc::D_BM, splits);
    tc::dense_decode_kernel<<<grid, tc::NT, 0, s>>>(a);
  } else if (route == 1) {
    const cudaError_t allowed = nxd::allow_smem(tc::decode_kernel, tc::DECODE_SMEM);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    dim3 grid(B * splits, (N + tc::BN - 1) / tc::BN, (M + tc::D_BM - 1) / tc::D_BM);
    tc::decode_kernel<<<grid, tc::NT, tc::DECODE_SMEM, s>>>(a);
  } else {
    dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, B * splits);
    gemm_f32_kernel<<<grid, F_NT, 0, s>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * M * N;
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 132 * 16));
  if (route != 0)
    reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(a.work, static_cast<__nv_bfloat16*>(out),
                                                        n, splits);
  else
    reduce_kernel<float><<<blocks, 256, 0, s>>>(a.work, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a launch of `route` asks for (bytes; 0 for f32)
extern "C" int w8a16_smem(int route) {
  return route == 3 ? tc::Wg<2>::SMEM : route == 2 ? tc::Wg<1>::SMEM
         : route == 1 ? tc::DECODE_SMEM : 0;  // the others use static shared memory
}
