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
// tensor-core rate (989 TFLOP/s bf16). This first version does the products
// with fp32 FMAs from shared memory, as the forward does, and sits far below
// that bound; wgmma operands and TMA staging are later work.
//
// Design. dK/dV: one CTA of 256 threads per (kv row, 64-key tile) stages its
// K and V tile once, then loops over the group's q heads and over every
// 64-query tile (the TPU kernel's sequential (group, q_blocks) grid axes),
// streaming Q, dO, lse and delta, and writes dK and dV once: no atomics, so
// the result is deterministic. dQ: one CTA per (q row, 64-query tile) loops
// over 64-key tiles. A (query tile, key tile) pair with no visible pair is
// skipped whole (the TPU kernel's block skip); masks apply per element.
// Tiles live in shared memory as fp32, rows padded by one word so the 16
// threads of a half-warp read 16 different banks (165 KB for dK/dV and
// 149 KB for dQ at D = 128, opted in above 48 KB). Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j of each 64 x 64 tile, and rows ty + 16 i by
// columns tx + 16 j of its 64 x D fp32 accumulators.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// Stage rows [r0, r0 + 64) of a (rows, D) operand as fp32 (zeros past the end).
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0, int rows, int tid) {
  constexpr int LD = D + 1;
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * LD + c] = row < rows ? nxd::to_f(src[static_cast<size_t>(row) * D + c]) : 0.f;
  }
}

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over two 64 x D tiles,
// and the same for the pair (a2, b2) into s2.
template <int D>
__device__ __forceinline__ void tile_products(const float* a, const float* b, const float* a2,
                                              const float* b2, int ty, int tx, float (&s)[4][4],
                                              float (&s2)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = 0.f;
  for (int c = 0; c < D; ++c) {
    float av[4], a2v[4], bv[4], b2v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * LD + c];
      a2v[i] = a2[(ty + 16 * i) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * LD + c];
      b2v[j] = b2[(tx + 16 * j) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
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

      stage_tile<T, D>(qs, qb, q0, sq, tid);
      stage_tile<T, D>(dos, dob, q0, sq, tid);
      if (tid < BQ) {
        const int r = q0 + tid;
        lse_s[tid] = r < sq ? lse[static_cast<size_t>(row) * sq + r] : 0.f;
        delta_s[tid] = r < sq ? delta[static_cast<size_t>(row) * sq + r] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T at rows ty + 16 i (queries), columns
      // tx + 16 j (keys)
      float s[4][4], dp[4][4];
      tile_products<D>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
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

  stage_tile<T, D>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
  stage_tile<T, D>(dos, dout + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
  if (tid < BQ) {
    const int r = q0 + tid;
    qp_s[tid] = r < sq ? qpos[static_cast<size_t>(b) * sq + r] : INT_MIN;  // rows past sq see no key
  }
  __syncthreads();
  int qmax = INT_MIN;
  for (int r = 0; r < BQ; ++r) qmax = max(qmax, qp_s[r]);
  int my_qp[4];
  float my_l[4], my_dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    my_qp[i] = qp_s[ty + 16 * i];
    my_l[i] = r < sq ? lse[static_cast<size_t>(bh) * sq + r] : 0.f;
    my_dl[i] = r < sq ? delta[static_cast<size_t>(bh) * sq + r] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
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

    float s[4][4], dp[4][4];
    tile_products<D>(qs, ks, dos, vs, ty, tx, s, dp);
    int my_kp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) my_kp[j] = kp_s[tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = my_kp[j] <= my_qp[i] ? expf(s[i][j] * sm_scale - my_l[i]) : 0.f;
        dss[(ty + 16 * i) * LP + tx + 16 * j] =
            nxd::round_to<T>(p * (dp[i][j] - my_dl[i]) * sm_scale);
      }
    __syncthreads();

    // dQ += dS K at rows ty + 16 i (queries), columns tx + 16 j (head dim)
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, dss and kp_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
    default:
      return cudaErrorInvalidValue;
  }
}

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
    err = dkdv_d<__nv_bfloat16>(d, q, k, v, dout, ls, dl, qp, kp, dk, dv, bkv, sq, sk, group,
                                h, sm_scale, st);
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
    err = dq_d<__nv_bfloat16>(d, q, k, v, dout, ls, dl, qp, kp, dq, bh, sq, sk, group, h,
                              sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
