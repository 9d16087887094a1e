// Fused AdamW step on an fp32 master copy, for Hopper (sm_90a).
//
// Replaces: neuronx_distributed_tpu/optimizer/fused_kernel.py, _kernel
// (driven by fused_adamw_leaf; Pallas call site there).
//
// Per element, in the JAX kernel's order of operations:
//   g  = grad * clip_scale
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + (1 - b2) * g * g
//   ms = ms - lr * ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd * ms)
//   p  = ms cast to the parameter dtype
// mu, nu and the master ms are updated in place (the JAX kernel's aliases);
// p is written to its own buffer. The scalars [clip_scale, lr, bc1, bc2]
// are read from device memory, so a training step needs no host sync.
//
// What bounds it on this card: with a bf16 grad and param it moves 28
// bytes per element (read g, mu, nu, ms; write mu, nu, ms, p) for about 17
// operations, so memory bandwidth (3.35 TB/s). Design: a grid-stride loop
// over groups of four consecutive elements, each operand loaded and stored
// as one 16-byte (fp32) or 8-byte (bf16) access. Every operation is an
// IEEE-rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so
// nvcc contracts nothing into an FMA: the kernel rounds where the plain
// PyTorch version, one operation at a time, rounds.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 4096;

struct alignas(8) bf16x4 {
  __nv_bfloat16 v[4];
};

__device__ __forceinline__ void load4(const float* p, long long i, float (&o)[4]) {
  const float4 t = reinterpret_cast<const float4*>(p)[i];
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i, float (&o)[4]) {
  const bf16x4 t = reinterpret_cast<const bf16x4*>(p)[i];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __bfloat162float(t.v[e]);
}

__device__ __forceinline__ void store4(float* p, long long i, const float (&o)[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, const float (&o)[4]) {
  bf16x4 t;
#pragma unroll
  for (int e = 0; e < 4; ++e) t.v[e] = __float2bfloat16(o[e]);
  reinterpret_cast<bf16x4*>(p)[i] = t;
}

template <typename G, typename Pt>
__global__ void __launch_bounds__(NT)
fused_adamw_kernel(const G* __restrict__ g, float* __restrict__ mu, float* __restrict__ nu,
                   float* __restrict__ ms, Pt* __restrict__ p,
                   const float* __restrict__ scalars, long long n4, float b1, float omb1,
                   float b2, float omb2, float eps, float wd) {
  const float scale = scalars[0];
  const float lr = scalars[1];
  const float bc1 = scalars[2];
  const float bc2 = scalars[3];
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  for (long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x; i < n4;
       i += stride) {
    float gv[4], m[4], v[4], w[4];
    load4(g, i, gv);
    load4(mu, i, m);
    load4(nu, i, v);
    load4(ms, i, w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gs = __fmul_rn(gv[e], scale);
      m[e] = __fadd_rn(__fmul_rn(b1, m[e]), __fmul_rn(omb1, gs));
      v[e] = __fadd_rn(__fmul_rn(b2, v[e]), __fmul_rn(__fmul_rn(omb2, gs), gs));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[e], bc2)), eps);
      const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(m[e], bc1), den), __fmul_rn(wd, w[e]));
      w[e] = __fsub_rn(w[e], __fmul_rn(lr, upd));
    }
    store4(mu, i, m);
    store4(nu, i, v);
    store4(ms, i, w);
    store4(p, i, w);
  }
}

template <typename G, typename Pt>
cudaError_t launch(const void* g, void* mu, void* nu, void* ms, void* p, const float* scalars,
                   long long n, float b1, float omb1, float b2, float omb2, float eps, float wd,
                   cudaStream_t stream) {
  const long long n4 = n / 4;
  const long long want = (n4 + NT - 1) / NT;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  if (blocks == 0) return cudaSuccess;
  fused_adamw_kernel<G, Pt><<<blocks, NT, 0, stream>>>(
      static_cast<const G*>(g), static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<float*>(ms), static_cast<Pt*>(p), scalars, n4, b1, omb1, b2, omb2, eps, wd);
  return cudaGetLastError();
}

}  // namespace

// g_dtype, p_dtype: 0 = fp32, 1 = bf16; n a multiple of 4 and every buffer
// 16-byte aligned (the wrapper checks both). Returns cudaGetLastError()
// after the launch.
extern "C" int fused_adamw(const void* g, void* mu, void* nu, void* ms, void* p,
                           const void* scalars, long long n, float b1, float omb1, float b2,
                           float omb2, float eps, float wd, int g_dtype, int p_dtype,
                           void* stream) {
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (g_dtype == 0 && p_dtype == 0)
    err = launch<float, float>(g, mu, nu, ms, p, sc, n, b1, omb1, b2, omb2, eps, wd, st);
  else if (g_dtype == 0 && p_dtype == 1)
    err = launch<float, __nv_bfloat16>(g, mu, nu, ms, p, sc, n, b1, omb1, b2, omb2, eps, wd,
                                       st);
  else if (g_dtype == 1 && p_dtype == 0)
    err = launch<__nv_bfloat16, float>(g, mu, nu, ms, p, sc, n, b1, omb1, b2, omb2, eps, wd,
                                       st);
  else if (g_dtype == 1 && p_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, mu, nu, ms, p, sc, n, b1, omb1, b2, omb2,
                                               eps, wd, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
