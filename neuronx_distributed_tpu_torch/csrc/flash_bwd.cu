// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ by recompute.
//
// Replaces: neuronx_distributed_tpu/kernels/flash_attn.py, _bwd_dkdv_kernel
// and _bwd_dq_kernel (driven by flash_block_grads; Pallas call sites there).
//
// Both kernels rebuild p = exp(q k^T * scale - lse) from a log-sum-exp and
// take delta = rowsum(dO * O) from the caller (the forward's own statistics,
// or global ones under ring attention):
//   dV = P^T dO                      (P rounded to dO's dtype first)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale    (rounded to q's dtype before each product)
//   dK = dS^T Q,   dQ = dS K
// Key j is visible to query i iff kpos[j] <= qpos[i]. A masked pair gets
// p = 0 by a select before any use: a fully masked row carries lse = -1e30,
// where exp(s - lse) overflows, and contributes nothing (never inf * 0).
//
// Layouts (contiguous): q, do, dq (bh, sq, D); k, v, dk, dv (bh / group,
// sk, D); lse, delta (bh, sq) fp32; qpos (b, sq), kpos (b, sk) int32 with
// b = bh / h. Query rows are grouped per kv head: q row = kv row * group + g.
//
// What bounds it on this card: 8 * D (dK/dV) and 6 * D (dQ) operations per
// visible query-key pair against a few MB of operands, so the bound is the
// tensor-core rate (989 TFLOP/s bf16). Two routes:
// - bf16 (namespace tc below): warp-level mma.sync products on the tensor
//   cores, bf16 tiles in shared memory; wgmma, TMA and warp specialisation
//   are later work.
// - fp32: fp32 FMAs from fp32 shared-memory tiles (the kernels right
//   below), exact to fp32 summation order; a TF32 or bf16 product would
//   round the operands.
//
// Shared design. dK/dV: one CTA per (kv row, 64-key tile) stages its K and
// V tile once, then loops over the group's q heads and over every 64-query
// tile (the TPU kernel's sequential (group, q_blocks) grid axes), streaming
// Q, dO, lse and delta, and writes dK and dV once: no atomics, so the result
// is deterministic. dQ: one CTA per (q row, 64-query tile) loops over 64-key
// tiles. A (query tile, key tile) pair with no visible pair is skipped whole
// (the TPU kernel's block skip); masks apply per element.
//
// fp32 tiles live in shared memory rows padded by one word so the 16
// threads of a half-warp read 16 different banks (165 KB for dK/dV and
// 149 KB for dQ at D = 128, opted in above 48 KB). Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j of each BQ x 64 tile, and rows ty + 16 i by
// columns tx + 16 j of its fp32 accumulators. Query tiles are BQ = 64 rows
// up to D = 128 and 32 at D = 256, where 64-row tiles would need 296 KB.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BK = 64;
constexpr int NT = 256;

// query rows of an fp32 tile at head dim D
template <int D>
__host__ __device__ constexpr int query_tile() { return D > 128 ? 32 : 64; }

// Stage rows [r0, r0 + R) of a (rows, D) operand as fp32 (zeros past the end).
template <typename T, int D, int R = 64>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0, int rows, int tid) {
  constexpr int LD = D + 1;
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * LD + c] = row < rows ? nxd::to_f(src[static_cast<size_t>(row) * D + c]) : 0.f;
  }
}

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over an (16 RA) x D and
// a 64 x D tile, and the same for the pair (a2, b2) into s2.
template <int D, int RA>
__device__ __forceinline__ void tile_products(const float* a, const float* b, const float* a2,
                                              const float* b2, int ty, int tx, float (&s)[RA][4],
                                              float (&s2)[RA][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = 0.f;
  for (int c = 0; c < D; ++c) {
    float av[RA], a2v[RA], bv[4], b2v[4];
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      av[i] = a[(ty + 16 * i) * LD + c];
      a2v[i] = a2[(ty + 16 * i) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * LD + c];
      b2v[j] = b2[(tx + 16 * j) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        s2[i][j] = fmaf(a2v[i], b2v[j], s2[i][j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ qpos, const int* __restrict__ kpos,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int group,
                      int h, float sm_scale) {
  constexpr int LD = D + 1;   // padded row stride of the 64 x D tiles
  constexpr int LP = BK + 1;  // padded row stride of the p and ds tiles
  constexpr int DJ = D / 16;  // accumulator columns per thread
  constexpr int BQ = query_tile<D>();
  constexpr int RI = BQ / 16;  // query rows per thread
  extern __shared__ float smem[];
  float* ks = smem;            // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* qs = vs + BK * LD;    // BQ x LD
  float* dos = qs + BQ * LD;   // BQ x LD
  float* ps = dos + BQ * LD;   // BQ x LP, p rounded to T
  float* dss = ps + BQ * LP;   // BQ x LP, ds rounded to T
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int bk = blockIdx.y;  // kv row
  const int k0 = blockIdx.x * BK;
  const int b = bk / (h / group);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  stage_tile<T, D>(ks, k + static_cast<size_t>(bk) * sk * D, k0, sk, tid);
  stage_tile<T, D>(vs, v + static_cast<size_t>(bk) * sk * D, k0, sk, tid);
  if (tid < BK) {
    const int col = k0 + tid;
    kp_s[tid] = col < sk ? kpos[static_cast<size_t>(b) * sk + col] : INT_MAX;
  }
  __syncthreads();
  int kmin = INT_MAX;
  for (int c = 0; c < BK; ++c) kmin = min(kmin, kp_s[c]);
  int my_kp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) my_kp[j] = kp_s[tx + 16 * j];

  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int row = bk * group + g;
    const T* qb = q + static_cast<size_t>(row) * sq * D;
    const T* dob = dout + static_cast<size_t>(row) * sq * D;
    for (int q0 = 0; q0 < sq; q0 += BQ) {
      if (tid < BQ) {
        const int r = q0 + tid;
        qp_s[tid] = r < sq ? qpos[static_cast<size_t>(b) * sq + r] : INT_MIN;
      }
      // block skip: does any query of the tile see a key of this tile?
      // (uniform across the CTA: the barrier returns one value)
      if (!__syncthreads_or(tid < BQ && qp_s[tid] >= kmin)) continue;

      stage_tile<T, D, BQ>(qs, qb, q0, sq, tid);
      stage_tile<T, D, BQ>(dos, dob, q0, sq, tid);
      if (tid < BQ) {
        const int r = q0 + tid;
        lse_s[tid] = r < sq ? lse[static_cast<size_t>(row) * sq + r] : 0.f;
        delta_s[tid] = r < sq ? delta[static_cast<size_t>(row) * sq + r] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T at rows ty + 16 i (queries), columns
      // tx + 16 j (keys)
      float s[RI][4], dp[RI][4];
      tile_products<D, RI>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        const int qp = qp_s[r];
        const float l = lse_s[r];
        const float dl = delta_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = my_kp[j] <= qp ? expf(s[i][j] * sm_scale - l) : 0.f;
          ps[r * LP + tx + 16 * j] = nxd::round_to<T>(p);
          dss[r * LP + tx + 16 * j] = nxd::round_to<T>(p * (dp[i][j] - dl) * sm_scale);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q at rows ty + 16 i (keys), columns
      // tx + 16 j (head dim), summed over the tile's queries
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * LP + ty + 16 * i];
          dsv[i] = dss[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dov = dos[r * LD + tx + 16 * j];
          const float qv = qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_dv[i][j] = fmaf(pv[i], dov, acc_dv[i][j]);
            acc_dk[i][j] = fmaf(dsv[i], qv, acc_dk[i][j]);
          }
        }
      }
      __syncthreads();  // the next tile overwrites qs, dos, ps, dss and the row stats
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= sk) continue;
    const size_t base = (static_cast<size_t>(bk) * sk + col) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = nxd::from_f<T>(acc_dk[i][j]);
      dv[base + tx + 16 * j] = nxd::from_f<T>(acc_dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ qpos, const int* __restrict__ kpos,
                    T* __restrict__ dq, int sq, int sk, int group, int h, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int DJ = D / 16;
  constexpr int BQ = query_tile<D>();
  constexpr int RI = BQ / 16;  // query rows per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x LD
  float* dos = qs + BQ * LD;   // BQ x LD
  float* ks = dos + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;    // BK x LD
  float* dss = vs + BK * LD;   // BQ x LP, ds rounded to T
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int b = bh / h;
  const int kvrow = bh / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* kb = k + static_cast<size_t>(kvrow) * sk * D;
  const T* vb = v + static_cast<size_t>(kvrow) * sk * D;
  const int* kpb = kpos + static_cast<size_t>(b) * sk;

  stage_tile<T, D, BQ>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
  stage_tile<T, D, BQ>(dos, dout + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
  if (tid < BQ) {
    const int r = q0 + tid;
    qp_s[tid] = r < sq ? qpos[static_cast<size_t>(b) * sq + r] : INT_MIN;  // rows past sq see no key
  }
  __syncthreads();
  int qmax = INT_MIN;
  for (int r = 0; r < BQ; ++r) qmax = max(qmax, qp_s[r]);
  int my_qp[RI];
  float my_l[RI], my_dl[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    my_qp[i] = qp_s[ty + 16 * i];
    my_l[i] = r < sq ? lse[static_cast<size_t>(bh) * sq + r] : 0.f;
    my_dl[i] = r < sq ? delta[static_cast<size_t>(bh) * sq + r] : 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    if (tid < BK) {
      const int col = k0 + tid;
      kp_s[tid] = col < sk ? kpb[col] : INT_MAX;  // keys past sk are never visible
    }
    // block skip, uniform across the CTA
    if (!__syncthreads_or(tid < BK && kp_s[tid] <= qmax)) continue;

    stage_tile<T, D>(ks, kb, k0, sk, tid);
    stage_tile<T, D>(vs, vb, k0, sk, tid);
    __syncthreads();

    float s[RI][4], dp[RI][4];
    tile_products<D, RI>(qs, ks, dos, vs, ty, tx, s, dp);
    int my_kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) my_kp[j] = kp_s[tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = my_kp[j] <= my_qp[i] ? expf(s[i][j] * sm_scale - my_l[i]) : 0.f;
        dss[(ty + 16 * i) * LP + tx + 16 * j] =
            nxd::round_to<T>(p * (dp[i][j] - my_dl[i]) * sm_scale);
      }
    __syncthreads();

    // dQ += dS K at rows ty + 16 i (queries), columns tx + 16 j (head dim)
    for (int c = 0; c < BK; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dss[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, dss and kp_s
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* out = dq + (static_cast<size_t>(bh) * sq + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = nxd::from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const int* qpos, const int* kpos,
                        void* dk, void* dv, int bkv, int sq, int sk, int group, int h,
                        float sm_scale, cudaStream_t stream) {
  constexpr int BQ = query_tile<D>();
  const size_t smem = sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1));
  cudaError_t err = nxd::allow_smem(flash_bwd_dkdv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BK - 1) / BK, bkv);
  flash_bwd_dkdv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, qpos, kpos, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, group, h, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* qpos, const int* kpos,
                      void* dq, int bh, int sq, int sk, int group, int h, float sm_scale,
                      cudaStream_t stream) {
  constexpr int BQ = query_tile<D>();
  const size_t smem = sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  cudaError_t err = nxd::allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, qpos, kpos, static_cast<T*>(dq), sq, sk, group,
      h, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkdv_d(int d, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* qpos, const int* kpos,
                   void* dk, void* dv, int bkv, int sq, int sk, int group, int h,
                   float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk,
                                group, h, sm_scale, stream);
    case 128:
      return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk,
                                 group, h, sm_scale, stream);
    case 256:
      return launch_dkdv<T, 256>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk,
                                 group, h, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dq_d(int d, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const int* qpos, const int* kpos,
                 void* dq, int bh, int sq, int sk, int group, int h, float sm_scale,
                 cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, qpos, kpos, dq, bh, sq, sk, group, h,
                              sm_scale, stream);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, qpos, kpos, dq, bh, sq, sk, group,
                               h, sm_scale, stream);
    case 256:
      return launch_dq<T, 256>(q, k, v, dout, lse, delta, qpos, kpos, dq, bh, sq, sk, group,
                               h, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// --- bf16: warp-level tensor-core products ----------------------------------------
//
// bf16 operands go through mma.sync m16n8k16 (fp32 accumulators, mma.cuh)
// fed by ldmatrix from bf16 tiles in shared memory, rows padded by 16 bytes
// so ldmatrix is free of bank conflicts, streamed with cp.async into two
// buffers so the next tile lands while this one is multiplied. 4 warps a
// CTA, each owning 16 rows of the CTA's 64; 106 KB of shared memory at
// D = 128, so two CTAs share an SM.
//
// dK/dV: each warp owns 16 keys, and so 16 rows of dK and dV in fp32
// registers. Per 32-query step it forms S^T = K Q^T and dP^T = V dO^T (one
// accumulator row per key), turns them into P^T and dS^T in the
// accumulators, packs those to bf16 A fragments and adds P^T dO to dV and
// dS^T Q to dK, with Q and dO read as B through ldmatrix.trans. K and V stay
// in shared memory and their fragments are re-read every step: the D
// accumulator registers a thread leave no room for them. Key tiles are the grid's
// slow axis, so under a causal mask the heaviest (earliest) start first.
// dQ: each warp owns 16 queries. Per 32-key step S = Q K^T and dP = dO V^T,
// then dQ += dS K with dS from registers and K through ldmatrix.trans. The
// latest query tiles (the heaviest under a causal mask) start first.
// The block skip reads per-tile position bounds that each CTA computes once
// into shared memory.
// Sums: a tensor-core accumulator chained over many steps rounds otherwise
// than fp32 adds; at the training shape chained dV accumulators needed a
// floor of 3.7e-3 against the twin, nine times what these need. So each
// mma.sync sums from zero over one 16-deep step (S, dP) or one 32-row step
// (dK, dV, dQ), and fp32 adds fold the steps into the accumulators.
// Registers (-Xptxas -v, D = 128): dK/dV 255, dQ 201, no spills.
// D = 256: a CTA owns DC = 128 of the D columns of its accumulators (the
// grid's third axis) and forms S and dP over the whole head dim, so both
// CTAs of a tile recompute the same S and dP: the accumulators keep their
// D = 128 register budget (dK/dV 255 registers, dQ 201, no spills; a
// 256-wide dQ spilled 12 bytes). Six 64 x 256 tiles take 204 KB of shared
// memory, one CTA an SM.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NTH = 128;   // 4 warps
constexpr int TILE = 64;   // rows of every staged tile: 16 per warp
constexpr int STEP = 32;   // queries (dK/dV) or keys (dQ) per inner step
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

// out[i] = max (kMax) or min of pos over rows [i * TILE, (i + 1) * TILE) of
// n; every thread of the CTA calls it
template <bool kMax>
__device__ void tile_bounds(int* out, const int* __restrict__ pos, int n, int tid) {
  constexpr int FILL = kMax ? INT_MIN : INT_MAX;
  constexpr int U = 8;   // loads in flight a thread
  const int lane = tid & 31;
  for (int i = tid; i < (n + TILE - 1) / TILE; i += NTH) out[i] = FILL;
  __syncthreads();
  // each warp reduces 32-row chunks (each within one tile) and merges them
  for (int base = (tid >> 5) * 32; base < n; base += U * NTH) {   // warp-uniform
    int x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * NTH + lane;
      x[u] = r < n ? pos[r] : FILL;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * NTH;
      if (c >= n) break;
      const int m = kMax ? __reduce_max_sync(~0u, x[u]) : __reduce_min_sync(~0u, x[u]);
      if (lane == 0) {
        if (kMax)
          atomicMax(out + c / TILE, m);
        else
          atomicMin(out + c / TILE, m);
      }
    }
  }
  __syncthreads();
}

// p = exp(s * scale - lse) and ds = p * (dp - delta) * scale with every
// product and difference rounded to nearest in fp32, as the twin rounds them
// (no FMA contraction)
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// One 16-deep k step (columns kk..kk + 15) of the 16 x 32 product of this
// warp's 16 rows of `a` with the transpose of 32 rows of `b` (both padded
// TILE x D tiles); acc[n] holds b rows 8 n..8 n + 7. The tensor cores sum
// from zero and an fp32 add folds the step in, so every sum is rounded to
// nearest in fp32, as the twin's are: an accumulator chained through the
// tensor cores drifts further from the twin with every step.
template <int D>
__device__ __forceinline__ void product_step(float (&acc)[4][4], const bf16* a, const bf16* b,
                                             int kk, int lane) {
  constexpr int LDS = D + PAD;
  uint32_t af[4];
  nxd::ldsm_x4(af, a + nxd::a_offset(lane, LDS) + kk);
  float part[4][4] = {};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t bf[4];
    nxd::ldsm_x4(bf, b + 16 * j * LDS + nxd::bt_offset(lane, LDS) + kk);
    nxd::mma_bf16(part[2 * j], af, bf[0], bf[1]);
    nxd::mma_bf16(part[2 * j + 1], af, bf[2], bf[3]);
  }
  nxd::add_to(acc, part);
}

// acc[n] and acc[n + 1] (16 rows x 16 columns) += the A fragments `frag`
// (16 rows x 32, two k steps) times rows 0..31, columns c..c + 15 of the
// padded tile `b`; summed from zero, folded in by fp32 adds
template <int D, int N>
__device__ __forceinline__ void accumulate_step(float (&acc)[N][4],
                                                const uint32_t (&frag)[2][4], const bf16* b,
                                                int c, int n, int lane) {
  constexpr int LDS = D + PAD;
  float part[2][4] = {};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t bf[4];
    nxd::ldsm_x4_t(bf, b + 16 * s * LDS + nxd::a_offset(lane, LDS) + c);
    nxd::mma_bf16(part[0], frag[s], bf[0], bf[1]);
    nxd::mma_bf16(part[1], frag[s], bf[2], bf[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[n][e] += part[0][e];
    acc[n + 1][e] += part[1][e];
  }
}

template <int D, int DC>
__global__ void __launch_bounds__(NTH, 2)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, const int* __restrict__ qpos,
            const int* __restrict__ kpos, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int sq, int sk, int group, int h, float sm_scale) {
  constexpr int LDS = D + PAD;
  constexpr int DN = DC / 8;   // 8-wide n-blocks of this CTA's columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // TILE x LDS
  bf16* vs = ks + TILE * LDS;                 // TILE x LDS
  bf16* qs = vs + TILE * LDS;                 // 2 buffers of TILE x LDS
  bf16* dos = qs + 2 * TILE * LDS;            // 2 buffers of TILE x LDS
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE * LDS);   // 2 x TILE
  float* dl_s = lse_s + 2 * TILE;                                   // 2 x TILE
  int* qp_s = reinterpret_cast<int*>(dl_s + 2 * TILE);              // 2 x TILE
  int* qmax_s = qp_s + 2 * TILE;                                    // one per query tile

  const int bk = blockIdx.x;   // kv row
  const int k0 = blockIdx.y * TILE;
  const int c0 = blockIdx.z * DC;   // this CTA's columns of dK and dV
  const int b = bk / (h / group);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int nqt = (sq + TILE - 1) / TILE;
  const int* qpb = qpos + static_cast<size_t>(b) * sq;
  const int* kpb = kpos + static_cast<size_t>(b) * sk;

  // the tile's earliest key (each warp reduces the same 64) and this
  // thread's two keys, rows kr and kr + 8
  int kmin = min(k0 + lane < sk ? kpb[k0 + lane] : INT_MAX,
                 k0 + 32 + lane < sk ? kpb[k0 + 32 + lane] : INT_MAX);
  kmin = __reduce_min_sync(~0u, kmin);
  const int kr = k0 + warp * 16 + (lane >> 2);
  const int kp0 = kr < sk ? kpb[kr] : INT_MAX;
  const int kp1 = kr + 8 < sk ? kpb[kr + 8] : INT_MAX;
  tile_bounds<true>(qmax_s, qpb, sq, tid);
  // block skip: the next query tile with a query that sees a key of this tile
  auto next_visible = [&](int qt) {
    while (qt < nqt && qmax_s[qt] < kmin) ++qt;
    return qt;
  };
  auto stage = [&](int gi, int qt, int buf) {
    const size_t row = static_cast<size_t>(bk) * group + gi;
    stage_rows<D>(qs + buf * TILE * LDS, q + row * sq * D, qt * TILE, sq, tid);
    stage_rows<D>(dos + buf * TILE * LDS, dout + row * sq * D, qt * TILE, sq, tid);
    if (tid < TILE) {
      const int r = qt * TILE + tid, i = buf * TILE + tid;
      if (r < sq) {
        nxd::cp_async4(lse_s + i, lse + row * sq + r);
        nxd::cp_async4(dl_s + i, delta + row * sq + r);
        nxd::cp_async4(qp_s + i, qpb + r);
      } else {   // rows past sq see no key
        lse_s[i] = 0.f;
        dl_s[i] = 0.f;
        qp_s[i] = INT_MIN;
      }
    }
  };

  float acc_dk[DN][4], acc_dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  const int first = next_visible(0);
  if (first < nqt) {
    stage_rows<D>(ks, k + static_cast<size_t>(bk) * sk * D, k0, sk, tid);
    stage_rows<D>(vs, v + static_cast<size_t>(bk) * sk * D, k0, sk, tid);
    stage(0, first, 0);
    nxd::cp_async_commit();
    const bf16* kw = ks + warp * 16 * LDS;   // this warp's 16 keys
    const bf16* vw = vs + warp * 16 * LDS;
    int gi = 0, qt = first, buf = 0;
    while (true) {
      int ng = gi, nq = next_visible(qt + 1);
      if (nq == nqt) {
        ++ng;
        nq = first;
      }
      const bool more = ng < group;
      if (more) stage(ng, nq, buf ^ 1);   // lands while this tile is multiplied
      nxd::cp_async_commit();
      nxd::cp_async_wait<1>();
      __syncthreads();
      const bf16* qt_s = qs + buf * TILE * LDS;
      const bf16* dot_s = dos + buf * TILE * LDS;
      const float* lt = lse_s + buf * TILE;
      const float* dlt = dl_s + buf * TILE;
      const int* qpt = qp_s + buf * TILE;
#pragma unroll 1
      for (int q0 = 0; q0 < TILE; q0 += STEP) {
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries, 4 n-blocks
        float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll 2   // a full unroll hoists every step's fragments and spills
        for (int kk = 0; kk < D; kk += 16) {
          product_step<D>(st, kw, qt_s + q0 * LDS, kk, lane);
          product_step<D>(dpt, vw, dot_s + q0 * LDS, kk, lane);
        }
        // P^T and dS^T at key rows kr, kr + 8 and queries q0 + 8 n + 2t, +1,
        // packed to bf16 A fragments of two 16-query k steps
        uint32_t pa[2][4], dsa[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + 8 * n + 2 * t + (e & 1);
            p[e] = (e < 2 ? kp0 : kp1) <= qpt[qi] ? prob(st[n][e], sm_scale, lt[qi]) : 0.f;
            ds[e] = dscore(p[e], dpt[n][e], dlt[qi], sm_scale);
          }
          pa[n >> 1][(n & 1) * 2] = nxd::pack_bf16(p[0], p[1]);
          pa[n >> 1][(n & 1) * 2 + 1] = nxd::pack_bf16(p[2], p[3]);
          dsa[n >> 1][(n & 1) * 2] = nxd::pack_bf16(ds[0], ds[1]);
          dsa[n >> 1][(n & 1) * 2 + 1] = nxd::pack_bf16(ds[2], ds[3]);
        }
        // dV += P^T dO and dK += dS^T Q over the step's 32 queries
#pragma unroll
        for (int c = 0; c < DC; c += 16) {
          accumulate_step<D>(acc_dv, pa, dot_s + q0 * LDS, c0 + c, c / 8, lane);
          accumulate_step<D>(acc_dk, dsa, qt_s + q0 * LDS, c0 + c, c / 8, lane);
        }
      }
      __syncthreads();   // the next stage overwrites this buffer
      if (!more) break;
      gi = ng;
      qt = nq;
      buf ^= 1;
    }
  }

  // rows kr, kr + 8; columns c0 + 8 n + 2t, +1 (zeros for a tile no query sees)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr + 8 * i;
    if (key >= sk) continue;
    const size_t base = (static_cast<size_t>(bk) * sk + key) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * n) =
          __floats2bfloat162_rn(acc_dk[n][2 * i], acc_dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * n) =
          __floats2bfloat162_rn(acc_dv[n][2 * i], acc_dv[n][2 * i + 1]);
    }
  }
}

template <int D, int DC>
__global__ void __launch_bounds__(NTH, 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, const int* __restrict__ qpos,
          const int* __restrict__ kpos, bf16* __restrict__ dq, int sq, int sk, int group,
          int h, float sm_scale) {
  constexpr int LDS = D + PAD;
  constexpr int DN = DC / 8;   // 8-wide n-blocks of this CTA's columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // TILE x LDS
  bf16* dos = qs + TILE * LDS;                // TILE x LDS
  bf16* ks = dos + TILE * LDS;                // 2 buffers of TILE x LDS
  bf16* vs = ks + 2 * TILE * LDS;             // 2 buffers of TILE x LDS
  int* kp_s = reinterpret_cast<int*>(vs + 2 * TILE * LDS);   // 2 x TILE
  int* kmin_s = kp_s + 2 * TILE;                             // one per key tile

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;   // latest query tiles first
  const int c0 = blockIdx.z * DC;                       // this CTA's columns of dQ
  const int b = bh / h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int nkt = (sk + TILE - 1) / TILE;
  const int* qpb = qpos + static_cast<size_t>(b) * sq;
  const int* kpb = kpos + static_cast<size_t>(b) * sk;
  const bf16* kb = k + static_cast<size_t>(bh / group) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh / group) * sk * D;

  // the tile's latest query (each warp reduces the same 64) and this
  // thread's two rows qr, qr + 8 (rows past sq see no key)
  int qmax = max(q0 + lane < sq ? qpb[q0 + lane] : INT_MIN,
                 q0 + 32 + lane < sq ? qpb[q0 + 32 + lane] : INT_MIN);
  qmax = __reduce_max_sync(~0u, qmax);
  const int qr = q0 + warp * 16 + (lane >> 2);
  int qp[2];
  float l[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr + 8 * i;
    const bool in = r < sq;
    qp[i] = in ? qpb[r] : INT_MIN;
    l[i] = in ? lse[static_cast<size_t>(bh) * sq + r] : 0.f;
    dl[i] = in ? delta[static_cast<size_t>(bh) * sq + r] : 0.f;
  }
  tile_bounds<false>(kmin_s, kpb, sk, tid);
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

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int first = next_visible(0);
  if (first < nkt) {
    stage_rows<D>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    stage_rows<D>(dos, dout + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    stage(first, 0);
    nxd::cp_async_commit();
    const bf16* qw = qs + warp * 16 * LDS;   // this warp's 16 queries
    const bf16* dow = dos + warp * 16 * LDS;
    int kt = first, buf = 0;
    while (true) {
      const int nk = next_visible(kt + 1);
      const bool more = nk < nkt;
      if (more) stage(nk, buf ^ 1);
      nxd::cp_async_commit();
      nxd::cp_async_wait<1>();
      __syncthreads();
      const bf16* kt_s = ks + buf * TILE * LDS;
      const bf16* vt_s = vs + buf * TILE * LDS;
      const int* kpt = kp_s + buf * TILE;
#pragma unroll 1
      for (int k_step = 0; k_step < TILE; k_step += STEP) {
        // S = Q K^T and dP = dO V^T: 16 queries x 32 keys, 4 n-blocks
        float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 2   // a full unroll hoists every step's fragments and spills
        for (int kk = 0; kk < D; kk += 16) {
          product_step<D>(s, qw, kt_s + k_step * LDS, kk, lane);
          product_step<D>(dp, dow, vt_s + k_step * LDS, kk, lane);
        }
        // dS at rows qr, qr + 8 and keys k_step + 8 n + 2t, +1, packed to bf16
        // A fragments of two 16-key k steps
        uint32_t dsa[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p =
                kpt[k_step + 8 * n + 2 * t + (e & 1)] <= qp[i] ? prob(s[n][e], sm_scale, l[i])
                                                                : 0.f;
            ds[e] = dscore(p, dp[n][e], dl[i], sm_scale);
          }
          dsa[n >> 1][(n & 1) * 2] = nxd::pack_bf16(ds[0], ds[1]);
          dsa[n >> 1][(n & 1) * 2 + 1] = nxd::pack_bf16(ds[2], ds[3]);
        }
        // dQ += dS K over the step's 32 keys
#pragma unroll
        for (int c = 0; c < DC; c += 16)
          accumulate_step<D>(acc, dsa, kt_s + k_step * LDS, c0 + c, c / 8, lane);
      }
      __syncthreads();   // the next stage overwrites this buffer
      if (!more) break;
      kt = nk;
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr + 8 * i;
    if (r >= sq) continue;
    bf16* out = dq + (static_cast<size_t>(bh) * sq + r) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// cp.async moves 16-byte chunks: the bf16 operands must start 16-byte aligned
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// six bf16 tiles, three (dK/dV) or one (dQ) pairs of 64-entry word arrays,
// and one position bound per tile of the looped-over axis
template <int D>
size_t smem_bytes(int tiles) {
  return sizeof(bf16) * 6 * TILE * (D + PAD) + sizeof(int) * (6 * TILE + tiles);
}

template <int D, int DC = D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const int* qpos, const int* kpos,
                        void* dk, void* dv, int bkv, int sq, int sk, int group, int h,
                        float sm_scale, cudaStream_t stream) {
  const int nkt = (sk + TILE - 1) / TILE;
  const size_t smem = smem_bytes<D>((sq + TILE - 1) / TILE);
  if (nkt > 65535) return cudaErrorInvalidValue;
  cudaError_t err = nxd::allow_smem(dkdv_kernel<D, DC>, smem);
  if (err != cudaSuccess) return err;
  dkdv_kernel<D, DC><<<dim3(bkv, nkt, D / DC), NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, qpos, kpos, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, group, h, sm_scale);
  return cudaGetLastError();
}

template <int D, int DC = D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* qpos, const int* kpos,
                      void* dq, int bh, int sq, int sk, int group, int h, float sm_scale,
                      cudaStream_t stream) {
  const int nqt = (sq + TILE - 1) / TILE;
  const size_t smem = smem_bytes<D>((sk + TILE - 1) / TILE);
  if (nqt > 65535) return cudaErrorInvalidValue;
  cudaError_t err = nxd::allow_smem(dq_kernel<D, DC>, smem);
  if (err != cudaSuccess) return err;
  dq_kernel<D, DC><<<dim3(bh, nqt, D / DC), NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, qpos, kpos, static_cast<bf16*>(dq), sq, sk,
      group, h, sm_scale);
  return cudaGetLastError();
}

cudaError_t dkdv_d(int d, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* qpos, const int* kpos,
                   void* dk, void* dv, int bkv, int sq, int sk, int group, int h,
                   float sm_scale, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 64:
      return launch_dkdv<64>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk, group,
                             h, sm_scale, stream);
    case 128:
      return launch_dkdv<128>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk,
                              group, h, sm_scale, stream);
    case 256:
      return launch_dkdv<256, 128>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, bkv, sq, sk,
                                   group, h, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dq_d(int d, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const int* qpos, const int* kpos,
                 void* dq, int bh, int sq, int sk, int group, int h, float sm_scale,
                 cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, qpos, kpos, dq, bh, sq, sk, group, h,
                           sm_scale, stream);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, qpos, kpos, dq, bh, sq, sk, group, h,
                            sm_scale, stream);
    case 256:
      return launch_dq<256, 128>(q, k, v, dout, lse, delta, qpos, kpos, dq, bh, sq, sk, group, h,
                                 sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Each returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* qpos,
                              const void* kpos, void* dk, void* dv, int bkv, int sq, int sk,
                              int d, int group, int h, float sm_scale, int dtype,
                              void* stream) {
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dkdv_d<float>(d, q, k, v, dout, ls, dl, qp, kp, dk, dv, bkv, sq, sk, group, h,
                        sm_scale, st);
  else if (dtype == 1)
    err = tc::dkdv_d(d, q, k, v, dout, ls, dl, qp, kp, dk, dv, bkv, sq, sk, group, h, sm_scale,
                     st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* qpos,
                            const void* kpos, void* dq, int bh, int sq, int sk, int d, int group,
                            int h, float sm_scale, int dtype, void* stream) {
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dq_d<float>(d, q, k, v, dout, ls, dl, qp, kp, dq, bh, sq, sk, group, h, sm_scale, st);
  else if (dtype == 1)
    err = tc::dq_d(d, q, k, v, dout, ls, dl, qp, kp, dq, bh, sq, sk, group, h, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
