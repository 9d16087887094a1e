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
// operands, so the bound is the tensor-core rate (989 TFLOP/s bf16). This
// first version does the products with fp32 FMAs from shared memory and
// sits far below that bound; wgmma operands and TMA staging are later work.
//
// Design: one CTA of 256 threads per (row, 64-query tile); an inner loop over
// 64-key tiles takes the place of the TPU's sequential kv grid axis. Q and
// each K/V tile are staged in shared memory as fp32 (rows padded by one word
// so the 16 threads of a half-warp read 16 different banks). Thread (ty, tx)
// owns query rows ty + 16i and key columns tx + 16j of a tile, so the row
// max and row sum of the online softmax are shuffles within a half-warp. A
// key tile none of whose positions is visible to any query of the tile is
// skipped whole (the TPU kernel's block skip); masks apply per element. m,
// l and the accumulator stay fp32; p is rounded to the operand dtype before
// the PV product, as the TPU kernel casts p to v's dtype.

#include <climits>

#include "common.cuh"

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
    default:
      return cudaErrorInvalidValue;
  }
}

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
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, qp, kp, out, ls, bh, sq, sk, group, h,
                                    sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
