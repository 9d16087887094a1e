// Paged decode attention for Hopper (sm_90a).
//
// Replaces: neuronx_distributed_tpu/inference/paged_kernel.py, _decode_kernel
// (driven by paged_decode_attention; Pallas call site there).
//
// Computes single-token attention straight off the KV page pool: query row
// b (at position cache_len[b]) attends to logical positions 0..cache_len[b]
// of its own sequence, whose keys live in the physical pages named by
// block_table[b, :]. Pages past cache_len[b] are never read; inside the last
// page, key position j * page_size + r is visible iff <= cache_len[b].
// int8 pools are dequantized in the tile with one fp32 scale per
// (page, kv head). The softmax runs online in fp32; the output is written in
// q's dtype.
//
// Layouts (contiguous): q, out (b, 1, n_kv * group, hd); k_pages, v_pages
// (num_pages, page_size, n_kv, hd); k_scale, v_scale (num_pages, n_kv) fp32
// or null; block_table (b, pages_per_seq) int32; cache_len (b,) int32;
// workspace fp32, (b * n_kv * group, n_split, 2) for (m, l) then
// (b * n_kv * group, n_split, hd) for the partial sums.
//
// What bounds it on this card: each step reads every visible K/V page once
// and does ~4 * group * hd operations per key, far below the card's
// operations-per-byte balance, so the bound is memory bandwidth (3.35 TB/s);
// at serving sizes the few MB a step reads take microseconds, so latency and
// parallelism decide.
//
// Design: split-K over pages. The grid comes from shapes alone (no host
// read of cache_len): one CTA of 4 warps per (batch row, kv head, chunk of
// up to 4 query rows of the GQA group, split of about 128 keys in whole
// pages). A CTA reads cache_len[b] itself; if its pages lie past it, it
// writes an empty partial (m = -1e30, l = 0) and returns. Otherwise each
// warp walks its own pages of the split (no barrier in the page loop): lanes
// load K/V rows in chunks of VB bytes, 16 (8 bf16, 16 int8 or 4 fp32) where
// a row's byte length is a multiple of 16 and 4 otherwise (such rows do not
// all start 16-byte aligned: bf16 hd 36, int8 hd 40). A row of up to 32
// chunks takes a group of the next power of two lanes whose spare lanes hold
// zeros (e.g. 12 of 16 at hd 96 in bf16), the rest of the warp on the next
// keys; a longer row (fp32 at hd > 128: 64 chunks at hd 256) takes the whole
// warp, each lane up to NCM chunks 32 apart. Head dims run up to 256. The query
// rows stay in registers, dot products reduce by warp shuffles, and each
// lane keeps an online (m, l, acc) over its keys, rescaled only when the
// row max grows (exp(0) = 1 otherwise, so skipping it changes no bit). The
// warps' states merge in shared memory in warp order into the split's
// partial; a second small kernel folds the partials of each query row in
// split order. No atomics: a rerun gives the same bits.

#include "common.cuh"

namespace {

constexpr int NT = 128;               // 4 warps
constexpr int NW = NT / 32;
constexpr int GMAX = 4;               // query rows of a kv head a CTA holds in registers
constexpr int KEYS_PER_SPLIT = 128;   // keys of a split, in whole pages
constexpr int HD_MAX = 256;           // the widest head dim (paged_kernel.py _MAX_HEAD_DIM)

// The rule the wrapper sizes the workspace by (paged_kernel.py _n_split).
__host__ __device__ inline int pages_per_split(int page_size) {
  return page_size >= KEYS_PER_SPLIT ? 1 : KEYS_PER_SPLIT / page_size;
}

// VB bytes of a pool row as floats, times `scale` for int8 pools
template <typename P, int VB> struct Chunk;
template <> struct Chunk<float, 16> {
  static constexpr int E = 4;
  __device__ static void load(float* f, const float* p, float) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  }
};
template <> struct Chunk<float, 4> {
  static constexpr int E = 1;
  __device__ static void load(float* f, const float* p, float) { f[0] = __ldg(p); }
};
template <> struct Chunk<__nv_bfloat16, 16> {
  static constexpr int E = 8;
  __device__ static void load(float* f, const __nv_bfloat16* p, float) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
    }
  }
};
template <> struct Chunk<__nv_bfloat16, 4> {
  static constexpr int E = 2;
  __device__ static void load(float* f, const __nv_bfloat16* p, float) {
    const unsigned x = __ldg(reinterpret_cast<const unsigned*>(p));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
    f[0] = v.x, f[1] = v.y;
  }
};
template <> struct Chunk<int8_t, 16> {
  static constexpr int E = 16;
  __device__ static void load(float* f, const int8_t* p, float scale) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = static_cast<float>(c[i]) * scale;   // in-tile dequant
  }
};
template <> struct Chunk<int8_t, 4> {
  static constexpr int E = 4;
  __device__ static void load(float* f, const int8_t* p, float scale) {
    const int x = __ldg(reinterpret_cast<const int*>(p));
    const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = static_cast<float>(c[i]) * scale;
  }
};

template <typename T, typename P, int VB>
__global__ void __launch_bounds__(NT)
split_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
             const P* __restrict__ v_pages, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ block_table,
             const int* __restrict__ cache_len, float* __restrict__ part_ml,
             float* __restrict__ part_acc, int n_kv, int group, int hd, int page_size,
             int pages_per_seq, float sm_scale) {
  constexpr int E = Chunk<P, VB>::E;
  // chunks a lane holds: enough for a row of HD_MAX over 32 lanes
  constexpr int NCM = (HD_MAX * static_cast<int>(sizeof(P)) / VB + 31) / 32;
  constexpr int W = NCM * E;   // row elements a lane holds
  extern __shared__ float smem[];
  float* w_acc = smem;                    // NW x GMAX x hd
  float* w_m = w_acc + NW * GMAX * hd;    // NW x GMAX
  float* w_l = w_m + NW * GMAX;           // NW x GMAX

  const int ngc = (group + GMAX - 1) / GMAX;
  const int gc = blockIdx.x % ngc;
  const int hi = (blockIdx.x / ngc) % n_kv;
  const int bi = blockIdx.x / (ngc * n_kv);
  const int split = blockIdx.y, n_split = gridDim.y;
  const int g0 = gc * GMAX, nr = min(GMAX, group - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // partial rows: q heads hi * group + g0 + g of batch row bi
  const size_t row0 =
      (static_cast<size_t>(bi) * n_kv + hi) * static_cast<size_t>(group) + g0;
  const int qpos = cache_len[bi];
  const int last = min(qpos / page_size, pages_per_seq - 1);
  const int pps = pages_per_split(page_size);
  const int j0 = split * pps, j1 = min(j0 + pps, last + 1);
  if (j0 > last) {   // the split lies past cache_len: an empty partial
    if (tid < nr) {
      part_ml[((row0 + tid) * n_split + split) * 2] = nxd::kNegInf;
      part_ml[((row0 + tid) * n_split + split) * 2 + 1] = 0.f;
    }
    return;
  }

  const int C = hd / E;     // chunks a pool row spans (at most 32 NCM)
  int CP = 32;              // lanes of a row's group: the next power of two up to 32
  if (C <= 32) {
    CP = 1;
    while (CP < C) CP <<= 1;
  }
  const int rl = lane / CP;   // this lane's key within a step of 32 / CP keys
  const int cl = lane % CP;   // and its first chunk of the row (then cl + 32, ...)
  bool on[NCM];               // a spare lane or chunk holds zeros
#pragma unroll
  for (int i = 0; i < NCM; ++i) on[i] = cl + 32 * i < C;
  float qv[GMAX][W], acc[GMAX][W], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = nxd::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NCM; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qv[g][i * E + e] =
            g < nr && on[i] ? nxd::to_f(q[(row0 + g) * hd + (cl + 32 * i) * E + e]) : 0.f;
        acc[g][i * E + e] = 0.f;
      }
  }
  const int* table = block_table + static_cast<size_t>(bi) * pages_per_seq;
  const size_t row_stride = static_cast<size_t>(n_kv) * hd;

  for (int j = j0 + warp; j < j1; j += NW) {   // this warp's pages
    const int page = table[j];
    float ksc = 1.f, vsc = 1.f;
    if (k_scale != nullptr) {
      ksc = k_scale[static_cast<size_t>(page) * n_kv + hi];
      vsc = v_scale[static_cast<size_t>(page) * n_kv + hi];
    }
    const size_t base = static_cast<size_t>(page) * page_size * row_stride +
                        static_cast<size_t>(hi) * hd + cl * E;
    for (int r0 = 0; r0 < page_size; r0 += 32 / CP) {
      const int r = r0 + rl;
      const bool vis = r < page_size && j * page_size + r <= qpos;
      float kf[W] = {}, vf[W] = {};
#pragma unroll
      for (int i = 0; i < NCM; ++i)
        if (vis && on[i]) {
          const size_t at = base + r * row_stride + 32 * i * E;
          Chunk<P, VB>::load(kf + i * E, k_pages + at, ksc);
          Chunk<P, VB>::load(vf + i * E, v_pages + at, vsc);
        }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) d = fmaf(qv[g][e], kf[e], d);
        for (int off = 1; off < CP; off <<= 1) d += __shfl_xor_sync(~0u, d, off);
        const float s = vis ? __fmul_rn(d, sm_scale) : nxd::kNegInf;
        float mx = s;
        for (int off = CP; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off));
        if (mx > m[g]) {   // warp-uniform: every lane holds the same m and mx
          const float corr = expf(__fsub_rn(m[g], mx));
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < W; ++e) acc[g][e] *= corr;
          m[g] = mx;
        }
        // exp under the mask: a row that saw no key yet has s - m == 0
        const float p = vis ? expf(__fsub_rn(s, m[g])) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // the warp's state: sums over its key lanes, then into shared memory
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    for (int off = CP; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(~0u, l[g], off);
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] += __shfl_xor_sync(~0u, acc[g][e], off);
    }
    if (g < nr && rl == 0) {
#pragma unroll
      for (int i = 0; i < NCM; ++i)
        if (on[i]) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            w_acc[(warp * GMAX + g) * hd + (cl + 32 * i) * E + e] = acc[g][i * E + e];
        }
      if (lane == 0) {
        w_m[warp * GMAX + g] = m[g];
        w_l[warp * GMAX + g] = l[g];
      }
    }
  }
  __syncthreads();
  // the split's partial: the warps' states folded in warp order (warp 0
  // holds the split's first page, so its l > 0)
  for (int i = tid; i < nr * hd; i += NT) {
    const int g = i / hd, d = i % hd;
    float mx = nxd::kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, w_m[w * GMAX + g]);
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(__fsub_rn(w_m[w * GMAX + g], mx));
      a += w_acc[(w * GMAX + g) * hd + d] * f;
      s += w_l[w * GMAX + g] * f;
    }
    const size_t row = (row0 + g) * n_split + split;
    part_acc[row * hd + d] = a;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = s;
    }
  }
}

// One CTA per query row: the row's partials with l > 0 folded in split
// order.
template <typename T>
__global__ void __launch_bounds__(NT)
merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
             T* __restrict__ out, int hd, int n_split) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float mx = nxd::kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) l += ml[2 * s + 1] * expf(__fsub_rn(ml[2 * s], mx));
  const float l_safe = l == 0.f ? 1.f : l;
  for (int d = threadIdx.x; d < hd; d += NT) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (ml[2 * s + 1] > 0.f)
        a += part_acc[(row * n_split + s) * hd + d] * expf(__fsub_rn(ml[2 * s], mx));
    out[row * hd + d] = nxd::from_f<T>(a / l_safe);
  }
}

template <typename T, typename P, int VB>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* bt, const int* cl, void* out, float* ws, int b,
                   int n_kv, int group, int hd, int page_size, int pages_per_seq,
                   float sm_scale, cudaStream_t stream) {
  if (hd < 1 || hd > HD_MAX || hd % Chunk<P, VB>::E != 0) return cudaErrorInvalidValue;
  const int pps = pages_per_split(page_size);
  const int n_split = (pages_per_seq + pps - 1) / pps;
  if (n_split > 65535) return cudaErrorInvalidValue;
  const int rows = b * n_kv * group;
  float* part_ml = ws;
  float* part_acc = ws + static_cast<size_t>(rows) * n_split * 2;
  const dim3 grid(b * n_kv * ((group + GMAX - 1) / GMAX), n_split);
  const size_t smem = sizeof(float) * NW * GMAX * (hd + 2);
  split_kernel<T, P, VB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp), ks, vs,
      bt, cl, part_ml, part_acc, n_kv, group, hd, page_size, pages_per_seq, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T><<<rows, NT, 0, stream>>>(part_ml, part_acc, static_cast<T*>(out), hd,
                                           n_split);
  return cudaGetLastError();
}

// chunks of 16 bytes where a pool row's byte length allows, else of 4
template <typename T, typename P>
cudaError_t dispatch_chunk(const void* q, const void* kp, const void* vp, const float* ks,
                           const float* vs, const int* bt, const int* cl, void* out, float* ws,
                           int b, int n_kv, int group, int hd, int page_size, int pages_per_seq,
                           float sm_scale, cudaStream_t st) {
  const int row_bytes = hd * static_cast<int>(sizeof(P));
  if (row_bytes % 16 == 0)
    return launch<T, P, 16>(q, kp, vp, ks, vs, bt, cl, out, ws, b, n_kv, group, hd, page_size,
                            pages_per_seq, sm_scale, st);
  if (row_bytes % 4 == 0)
    return launch<T, P, 4>(q, kp, vp, ks, vs, bt, cl, out, ws, b, n_kv, group, hd, page_size,
                           pages_per_seq, sm_scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_pool(int pool_dtype, const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* bt, const int* cl,
                          void* out, float* ws, int b, int n_kv, int group, int hd,
                          int page_size, int pages_per_seq, float sm_scale, cudaStream_t st) {
  switch (pool_dtype) {
    case 0:
      return dispatch_chunk<T, float>(q, kp, vp, ks, vs, bt, cl, out, ws, b, n_kv, group, hd,
                                      page_size, pages_per_seq, sm_scale, st);
    case 1:
      return dispatch_chunk<T, __nv_bfloat16>(q, kp, vp, ks, vs, bt, cl, out, ws, b, n_kv,
                                              group, hd, page_size, pages_per_seq, sm_scale,
                                              st);
    case 2:
      return dispatch_chunk<T, int8_t>(q, kp, vp, ks, vs, bt, cl, out, ws, b, n_kv, group, hd,
                                       page_size, pages_per_seq, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = fp32, 1 = bf16; pool_dtype: 0 = fp32, 1 = bf16, 2 = int8
// (then k_scale and v_scale are required). The pools must start 16-byte
// aligned; hd * sizeof(pool element) must be a multiple of 4 bytes and hd at
// most 256. Returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scale, const void* v_scale, const void* block_table,
                            const void* cache_len, void* out, void* workspace, int b, int n_kv,
                            int group, int hd, int page_size, int pages_per_seq, float sm_scale,
                            int q_dtype, int pool_dtype, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_table);
  const int* cl = static_cast<const int*>(cache_len);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((pool_dtype == 2) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_pool<float>(pool_dtype, q, k_pages, v_pages, ks, vs, bt, cl, out, ws, b,
                               n_kv, group, hd, page_size, pages_per_seq, sm_scale, st);
  else if (q_dtype == 1)
    err = dispatch_pool<__nv_bfloat16>(pool_dtype, q, k_pages, v_pages, ks, vs, bt, cl, out,
                                       ws, b, n_kv, group, hd, page_size, pages_per_seq,
                                       sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
