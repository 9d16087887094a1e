// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: neuronx_distributed_tpu/kernels/flash_attn.py, _fwd_kernel
// (driven by _fwd; Pallas call site in _fwd).
//
// Computes, per flattened (batch*head) row, blocked attention with an
// online softmax: out = softmax(q k^T * scale) v and the log-sum-exp, where
// key j is visible to query i iff kpos[j] <= qpos[i]. K/V stay compact
// under GQA: q row bh reads kv row bh / group. A fully masked query row
// gives out 0 and lse -1e30 (the l == 0 rule of the TPU kernel).
//
// Layouts (contiguous): q, out (bh, sq, D); k, v (bh / group, sk, D);
// qpos (b, sq), kpos (b, sk) int32 with b = bh / h; lse (bh, sq) fp32.
//
// What bounds it on this card: at prefill widths the work is
// 4 * h * D * (visible query-key pairs) operations against a few MB of
// operands, so the bound is the tensor-core rate (989 TFLOP/s bf16). Two
// routes:
// - bf16 (namespace tc below): warp-level mma.sync products on the tensor
//   cores from bf16 tiles in shared memory; wgmma and TMA are later work.
// - fp32: fp32 FMAs from fp32 shared-memory tiles (the kernel right below),
//   exact to fp32 summation order; a TF32 or bf16 product would round the
//   operands.
//
// fp32 design: one CTA of 256 threads per (row, 64-query tile); an inner
// loop over 64-key tiles takes the place of the TPU's sequential kv grid
// axis. Q and each K/V tile are staged in shared memory as fp32 (rows
// padded by one word so the 16 threads of a half-warp read 16 different
// banks). Thread (ty, tx) owns query rows ty + 16i and key columns tx + 16j
// of a tile, so the row max and row sum of the online softmax are shuffles
// within a half-warp. A key tile none of whose positions is visible to any
// query of the tile is skipped whole (the TPU kernel's block skip); masks
// apply per element. m, l and the accumulator stay fp32; p is rounded to
// the operand dtype before the PV product, as the TPU kernel casts p to v's
// dtype.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int group, int h,
                 float sm_scale) {
  constexpr int LD = D + 1;   // padded row stride of q and k tiles
  constexpr int LP = BK + 1;  // padded row stride of the p tile
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* ks = qs + BQ * LD;    // BK x LD
  float* vs = ks + BK * LD;    // BK x D
  float* ps = vs + BK * D;     // BQ x LP
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int b = bh / h;
  const int kvrow = bh / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const T* kb = k + static_cast<size_t>(kvrow) * sk * D;
  const T* vb = v + static_cast<size_t>(kvrow) * sk * D;
  const int* qpb = qpos + static_cast<size_t>(b) * sq;
  const int* kpb = kpos + static_cast<size_t>(b) * sk;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, row = q0 + r;
    qs[r * LD + c] = row < sq ? nxd::to_f(qb[static_cast<size_t>(row) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    const int row = q0 + tid;
    qp_s[tid] = row < sq ? qpb[row] : INT_MIN;  // rows past sq see no key
  }
  __syncthreads();
  int qmax = INT_MIN;
  for (int r = 0; r < BQ; ++r) qmax = max(qmax, qp_s[r]);

  int my_qp[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    my_qp[i] = qp_s[ty + 16 * i];
    m[i] = nxd::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    if (tid < BK) {
      const int col = k0 + tid;
      kp_s[tid] = col < sk ? kpb[col] : INT_MAX;  // keys past sk are never visible
    }
    // block skip: uniform across the CTA (the barrier returns one value)
    if (!__syncthreads_or(tid < BK && kp_s[tid] <= qmax)) continue;

    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, col = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (col < sk) {
        kv = nxd::to_f(kb[static_cast<size_t>(col) * D + c]);
        vv = nxd::to_f(vb[static_cast<size_t>(col) * D + c]);
      }
      ks[r * LD + c] = kv;
      vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    int my_kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) my_kp[j] = kp_s[tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rowmax = nxd::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = my_kp[j] <= my_qp[i] ? s[i][j] * sm_scale : nxd::kNegInf;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: xor offsets < 16 stay inside it
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_new = fmaxf(m[i], rowmax);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // exp under the mask: a fully masked row has s - m_new == 0
        const float p = my_kp[j] <= my_qp[i] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = nxd::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps and kp_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* ob = out + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = nxd::from_f<T>(acc[i][j] / l_safe);
    if (tx == 0) lse[static_cast<size_t>(bh) * sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int bh, int sq, int sk,
                   int group, int h, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = nxd::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qpos,
      kpos, static_cast<T*>(out), lse, sq, sk, group, h, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, float* lse, int bh, int sq, int sk,
                       int group, int h, float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, qpos, kpos, out, lse, bh, sq, sk, group, h, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, qpos, kpos, out, lse, bh, sq, sk, group, h, sm_scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, qpos, kpos, out, lse, bh, sq, sk, group, h, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// --- bf16: warp-level tensor-core products ----------------------------------------
//
// One CTA of 4 warps per (q row, 64-query tile); each warp owns 16 query
// rows, whose Q fragments stay in registers for the whole key loop. K and V
// tiles of 64 keys are staged as bf16 in shared memory, rows padded by 16
// bytes so ldmatrix is free of bank conflicts, by cp.async into two buffers
// so the next tile lands while this one is multiplied (87 KB at D = 128:
// two CTAs an SM). Per key tile each warp forms S (16 x 64) = Q K^T with
// mma.sync m16n8k16 (K through ldmatrix), masks per element only on tiles
// that some query of the CTA cannot fully see (the diagonal, pad keys, the
// ragged end), runs the online softmax on the accumulators (row max and row
// sum are shuffles among the four lanes of a row), rounds p to bf16 (the
// twin rounds p to v's dtype) and packs it from the accumulators straight
// into A fragments, then adds P V to its 16 x D fp32 accumulator (V through
// ldmatrix.trans). m, l and O stay fp32 in registers.
// The block skip reads per-tile key-position bounds that each CTA computes
// once into shared memory; the latest query tiles (the heaviest under a
// causal mask) start first. No atomics: a rerun gives the same bits.
// Sums: as in flash_bwd.cu's tensor-core kernels, each mma.sync sums from
// zero over one 16-deep step (S) or one 64-key tile (P V), and fp32 adds
// (rounded to nearest, as the twin's sums are) fold the steps in. Folding P V
// per 32 keys instead read the same against the twin and the fp64 value on
// an H100 and spilled at D = 128. Registers (-Xptxas -v): D = 128 241,
// D = 64 160, no spills.
// D = 256: the Q fragments (64 registers) and a 256-wide O (128) do not fit
// beside the rest, so Q stays in shared memory and its fragments are read
// at each 16-deep step, and a CTA owns DC = 128 of the D output columns (the
// grid's third axis; with all 256 the kernel spilled 72 bytes at 255
// registers, with 128 it takes 214 and spills none): both CTAs of a query
// tile form the same S, so m, l and the LSE agree bit for bit, and the one
// of columns 0..127 writes the LSE. The tiles take 170 KB of shared memory,
// one CTA an SM.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NTH = 128;   // 4 warps
constexpr int TILE = 64;   // queries of a CTA (16 a warp) and keys of a tile
constexpr int PAD = 8;     // bf16 elements of row padding (16 bytes)

// rows [r0, r0 + TILE) of a (rows, D) operand into a padded tile, zero rows
// past the end
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int rows,
                                           int tid) {
  constexpr int LDS = D + PAD, CH = D / 8;   // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < TILE * CH; i += NTH) {
    const int r = i / CH, c = (i % CH) * 8, row = r0 + r;
    const bool in = row < rows;
    nxd::cp_async16(dst + r * LDS + c, src + static_cast<size_t>(in ? row : 0) * D + c, in);
  }
}

template <int D, int DC>
__global__ void __launch_bounds__(NTH, 2)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const int* __restrict__ qpos, const int* __restrict__ kpos, bf16* __restrict__ out,
           float* __restrict__ lse, int sq, int sk, int group, int h, float sm_scale) {
  constexpr int LDS = D + PAD;
  constexpr int DK = D / 16;          // 16-deep k steps of the head dim
  constexpr int DN = DC / 8;          // 8-wide n-blocks of this CTA's output columns
  constexpr bool QREG = D <= 128;     // Q fragments in registers (else read from qs)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // TILE x LDS
  bf16* ks = qs + TILE * LDS;                 // 2 buffers of TILE x LDS
  bf16* vs = ks + 2 * TILE * LDS;             // 2 buffers of TILE x LDS
  int* kp_s = reinterpret_cast<int*>(vs + 2 * TILE * LDS);   // 2 x TILE
  const int nkt = (sk + TILE - 1) / TILE;
  int* kmin_s = kp_s + 2 * TILE;   // per key tile: earliest position
  int* kmax_s = kmin_s + nkt;      // per key tile: latest (INT_MAX past sk)

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;   // latest query tiles first
  const int c0 = blockIdx.z * DC;                       // this CTA's output columns
  const int b = bh / h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int* qpb = qpos + static_cast<size_t>(b) * sq;
  const int* kpb = kpos + static_cast<size_t>(b) * sk;
  const bf16* kb = k + static_cast<size_t>(bh / group) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh / group) * sk * D;

  // the tile's latest and earliest query (each warp reduces the same 64;
  // rows past sq see no key) and this thread's two rows qr, qr + 8
  const int qa = q0 + lane < sq ? qpb[q0 + lane] : INT_MIN;
  const int qb = q0 + 32 + lane < sq ? qpb[q0 + 32 + lane] : INT_MIN;
  const int qmax = __reduce_max_sync(~0u, max(qa, qb));
  const int qmin = __reduce_min_sync(~0u, min(qa, qb));
  const int qr = q0 + warp * 16 + (lane >> 2);
  const int qp[2] = {qr < sq ? qpb[qr] : INT_MIN, qr + 8 < sq ? qpb[qr + 8] : INT_MIN};
  for (int kt = warp; kt < nkt; kt += NTH / 32) {   // warp-uniform
    const int c = kt * TILE + lane;
    const int a = c < sk ? kpb[c] : INT_MAX, z = c + 32 < sk ? kpb[c + 32] : INT_MAX;
    const int lo = __reduce_min_sync(~0u, min(a, z));
    const int hi = __reduce_max_sync(~0u, max(a, z));
    if (lane == 0) {
      kmin_s[kt] = lo;
      kmax_s[kt] = hi;
    }
  }
  __syncthreads();
  // block skip: the next key tile with a key some query of this tile sees
  auto next_visible = [&](int kt) {
    while (kt < nkt && kmin_s[kt] > qmax) ++kt;
    return kt;
  };
  auto stage = [&](int kt, int buf) {
    stage_rows<D>(ks + buf * TILE * LDS, kb, kt * TILE, sk, tid);
    stage_rows<D>(vs + buf * TILE * LDS, vb, kt * TILE, sk, tid);
    if (tid < TILE) {
      const int c = kt * TILE + tid;
      if (c < sk)
        nxd::cp_async4(kp_s + buf * TILE + tid, kpb + c);
      else   // keys past sk are never visible
        kp_s[buf * TILE + tid] = INT_MAX;
    }
  };

  float o[DN][4], m[2] = {nxd::kNegInf, nxd::kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int first = next_visible(0);
  if (first < nkt) {
    stage_rows<D>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    nxd::cp_async_commit();
    stage(first, 0);
    nxd::cp_async_commit();
    nxd::cp_async_wait<1>();   // Q has landed
    __syncthreads();
    uint32_t qf[QREG ? DK : 1][4];
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        nxd::ldsm_x4(qf[kk], qs + warp * 16 * LDS + nxd::a_offset(lane, LDS) + 16 * kk);
    }
    int kt = first, buf = 0;
    while (true) {
      const int nk = next_visible(kt + 1);
      const bool more = nk < nkt;
      if (more) stage(nk, buf ^ 1);   // lands while this tile is multiplied
      nxd::cp_async_commit();
      nxd::cp_async_wait<1>();
      __syncthreads();
      const bf16* kt_s = ks + buf * TILE * LDS;
      const bf16* vt_s = vs + buf * TILE * LDS;
      const int* kpt = kp_s + buf * TILE;

      // S = Q K^T: 16 queries x 64 keys, 8 n-blocks, 16 keys at a time
      // (both loops unrolled whole: the Q fragments are indexed by the step)
      float s[8][4] = {};
      auto s_step = [&](const uint32_t(&a)[4], int j, int kk) {
        uint32_t bfr[4];
        nxd::ldsm_x4(bfr, kt_s + 16 * j * LDS + nxd::bt_offset(lane, LDS) + 16 * kk);
        float part[2][4] = {};
        nxd::mma_bf16(part[0], a, bfr[0], bfr[1]);
        nxd::mma_bf16(part[1], a, bfr[2], bfr[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * j][e] += part[0][e];
          s[2 * j + 1][e] += part[1][e];
        }
      };
      if constexpr (QREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) s_step(qf[kk], j, kk);
      } else {   // each S element sums its k steps in the same order
#pragma unroll 2
        for (int kk = 0; kk < DK; ++kk) {
          uint32_t af[4];
          nxd::ldsm_x4(af, qs + warp * 16 * LDS + nxd::a_offset(lane, LDS) + 16 * kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) s_step(af, j, kk);
        }
      }
      // scores at rows qr (e < 2), qr + 8 and keys 8 n + 2t, +1; the mask
      // only where some query of the CTA does not see every key of the tile
      const bool masked = kmax_s[kt] > qmin;
      uint32_t vis = ~0u;   // bit 4 n + e: the key is visible to the row
      float mx[2] = {nxd::kNegInf, nxd::kNegInf};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[n][e], sm_scale);
          if (masked && kpt[8 * n + 2 * t + (e & 1)] > qp[e >> 1]) {
            x = nxd::kNegInf;
            vis &= ~(1u << (4 * n + e));
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(__fsub_rn(m[i], m_new));
        m[i] = m_new;
      }
      // p under the mask (a fully masked row has s - m_new == 0), summed
      // unrounded into l and rounded to bf16 into the A fragments of four
      // 16-key k steps
      uint32_t pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (vis >> (4 * n + e)) & 1u ? expf(__fsub_rn(s[n][e], m[e >> 1])) : 0.f;
          sum[e >> 1] += p[e];
        }
        pa[n >> 1][(n & 1) * 2] = nxd::pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = nxd::pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(~0u, sum[i], 1);
        sum[i] += __shfl_xor_sync(~0u, sum[i], 2);
        l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum[i]);
      }
      // O = O * corr + P V, columns c0 + c..c0 + c + 15 at a time over the
      // tile's 64 keys
#pragma unroll
      for (int c = 0; c < DC; c += 16) {
        float part[2][4] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bfr[4];
          nxd::ldsm_x4_t(bfr, vt_s + 16 * j * LDS + nxd::a_offset(lane, LDS) + c0 + c);
          nxd::mma_bf16(part[0], pa[j], bfr[0], bfr[1]);
          nxd::mma_bf16(part[1], pa[j], bfr[2], bfr[3]);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& acc = o[c / 8 + x][e];
            acc = __fadd_rn(__fmul_rn(acc, corr[e >> 1]), part[x][e]);
          }
      }
      __syncthreads();   // the next stage overwrites this buffer
      if (!more) break;
      kt = nk;
      buf ^= 1;
    }
  }

  // rows qr, qr + 8; columns c0 + 8 n + 2t, +1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr + 8 * i;
    if (r >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    bf16* ob = out + (static_cast<size_t>(bh) * sq + r) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * i] / l_safe, o[n][2 * i + 1] / l_safe);
    if (t == 0 && c0 == 0) lse[static_cast<size_t>(bh) * sq + r] = m[i] + logf(l_safe);
  }
}

// cp.async moves 16-byte chunks: the bf16 operands must start 16-byte aligned
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int D, int DC = D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, float* lse, int bh, int sq, int sk, int group,
                   int h, float sm_scale, cudaStream_t stream) {
  const int nqt = (sq + TILE - 1) / TILE, nkt = (sk + TILE - 1) / TILE;
  // five bf16 tiles, two 64-entry position arrays, two bounds per key tile
  const size_t smem = sizeof(bf16) * 5 * TILE * (D + PAD) + sizeof(int) * (2 * TILE + 2 * nkt);
  if (nqt > 65535) return cudaErrorInvalidValue;
  cudaError_t err = nxd::allow_smem(fwd_kernel<D, DC>, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<D, DC><<<dim3(bh, nqt, D / DC), NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      qpos, kpos, static_cast<bf16*>(out), lse, sq, sk, group, h, sm_scale);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, float* lse, int bh, int sq, int sk,
                       int group, int h, float sm_scale, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return cudaErrorMisalignedAddress;
  switch (d) {
    case 64:
      return launch<64>(q, k, v, qpos, kpos, out, lse, bh, sq, sk, group, h, sm_scale, stream);
    case 128:
      return launch<128>(q, k, v, qpos, kpos, out, lse, bh, sq, sk, group, h, sm_scale, stream);
    case 256:
      return launch<256, 128>(q, k, v, qpos, kpos, out, lse, bh, sq, sk, group, h, sm_scale,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* qpos,
                         const void* kpos, void* out, void* lse, int bh, int sq, int sk,
                         int d, int group, int h, float sm_scale, int dtype, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, qp, kp, out, ls, bh, sq, sk, group, h, sm_scale, st);
  else if (dtype == 1)
    err = tc::dispatch_d(d, q, k, v, qp, kp, out, ls, bh, sq, sk, group, h, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
