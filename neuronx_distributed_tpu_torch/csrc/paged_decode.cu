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
// or null; block_table (b, pages_per_seq) int32; cache_len (b,) int32.
//
// What bounds it on this card: each step reads every visible K/V page once
// and does ~4 * group * hd operations per key, far below the card's
// operations-per-byte balance, so the bound is memory bandwidth (3.35 TB/s).
//
// Design: one CTA of 128 threads per (batch row, kv head); the CTA holds the
// `group` query rows of that kv head (GQA folded into the tile, no repeat),
// reads block_table[b, j] itself and walks j = 0 .. cache_len[b] / page_size
// (the block skip). Each page's (page_size, hd) K and V tiles are staged in
// shared memory at stride n_kv * hd in the pool. Known weakness, left for a
// later PR: b * n_kv CTAs (64 at Llama-3-8B with 8 rows) leave most of the
// 132 SMs idle, and the page loop is serial within a CTA; a split-K pass
// over pages would spread the work.

#include "common.cuh"

namespace {

constexpr int NT = 128;

template <typename T, typename P>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ block_table,
                    const int* __restrict__ cache_len, T* __restrict__ out, int n_kv,
                    int group, int hd, int page_size, int pages_per_seq, float sm_scale) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;                 // padded K row: dot products read across rows
  float* qs = smem;                       // group x hd
  float* kt = qs + group * hd;            // page_size x ldk
  float* vt = kt + page_size * ldk;       // page_size x hd
  float* sc = vt + page_size * hd;        // group x page_size (scores, then p)
  float* acc = sc + group * page_size;    // group x hd
  float* m_s = acc + group * hd;          // group
  float* l_s = m_s + group;               // group
  float* corr = l_s + group;              // group

  const int bi = blockIdx.x / n_kv;
  const int hi = blockIdx.x % n_kv;
  const int tid = threadIdx.x;
  const int n_q = n_kv * group;
  const T* qb = q + (static_cast<size_t>(bi) * n_q + static_cast<size_t>(hi) * group) * hd;

  for (int i = tid; i < group * hd; i += NT) {
    qs[i] = nxd::to_f(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = nxd::kNegInf;
    l_s[tid] = 0.f;
  }
  const int qpos = cache_len[bi];
  const int last = min(qpos / page_size, pages_per_seq - 1);
  const int* table = block_table + static_cast<size_t>(bi) * pages_per_seq;
  const size_t row_stride = static_cast<size_t>(n_kv) * hd;
  __syncthreads();

  for (int j = 0; j <= last; ++j) {
    const int page = table[j];
    float ksc = 1.f, vsc = 1.f;
    if (k_scale != nullptr) {
      ksc = k_scale[static_cast<size_t>(page) * n_kv + hi];
      vsc = v_scale[static_cast<size_t>(page) * n_kv + hi];
    }
    const size_t base = static_cast<size_t>(page) * page_size * row_stride +
                        static_cast<size_t>(hi) * hd;
    for (int i = tid; i < page_size * hd; i += NT) {
      const int r = i / hd, d = i % hd;
      const size_t off = base + r * row_stride + d;
      kt[r * ldk + d] = nxd::to_f(k_pages[off]) * ksc;   // in-tile dequant
      vt[r * hd + d] = nxd::to_f(v_pages[off]) * vsc;
    }
    __syncthreads();

    for (int t = tid; t < group * page_size; t += NT) {
      const int g = t / page_size, r = t % page_size;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qs[g * hd + d], kt[r * ldk + d], dot);
      sc[t] = (j * page_size + r <= qpos) ? dot * sm_scale : nxd::kNegInf;
    }
    __syncthreads();

    if (tid < group) {
      float* srow = sc + tid * page_size;
      float mx = nxd::kNegInf;
      for (int r = 0; r < page_size; ++r) mx = fmaxf(mx, srow[r]);
      const float m_new = fmaxf(m_s[tid], mx);
      float sum = 0.f;
      for (int r = 0; r < page_size; ++r) {
        // exp under the mask: exp(-1e30 - m) may be exp(0) on a masked row
        const float p = (j * page_size + r <= qpos) ? expf(srow[r] - m_new) : 0.f;
        srow[r] = p;
        sum += p;
      }
      const float alpha = expf(m_s[tid] - m_new);
      l_s[tid] = alpha * l_s[tid] + sum;
      m_s[tid] = m_new;
      corr[tid] = alpha;
    }
    __syncthreads();

    for (int t = tid; t < group * hd; t += NT) {
      const int g = t / hd, d = t % hd;
      const float* prow = sc + g * page_size;
      float a = 0.f;
      for (int r = 0; r < page_size; ++r) a = fmaf(prow[r], vt[r * hd + d], a);
      acc[t] = acc[t] * corr[g] + a;
    }
    __syncthreads();  // the next page overwrites kt, vt and sc
  }

  T* ob = out + (static_cast<size_t>(bi) * n_q + static_cast<size_t>(hi) * group) * hd;
  for (int t = tid; t < group * hd; t += NT) {
    const float l = l_s[t / hd];
    ob[t] = nxd::from_f<T>(acc[t] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* bt, const int* cl, void* out, int b, int n_kv,
                   int group, int hd, int page_size, int pages_per_seq, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (group * hd + page_size * (hd + 1) + page_size * hd +
                                       group * page_size + group * hd + 3 * group);
  cudaError_t err = nxd::allow_smem(paged_decode_kernel<T, P>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, P><<<b * n_kv, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp), ks, vs,
      bt, cl, static_cast<T*>(out), n_kv, group, hd, page_size, pages_per_seq, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pool(int pool_dtype, const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* bt, const int* cl,
                          void* out, int b, int n_kv, int group, int hd, int page_size,
                          int pages_per_seq, float sm_scale, cudaStream_t st) {
  switch (pool_dtype) {
    case 0:
      return launch<T, float>(q, kp, vp, ks, vs, bt, cl, out, b, n_kv, group, hd, page_size,
                              pages_per_seq, sm_scale, st);
    case 1:
      return launch<T, __nv_bfloat16>(q, kp, vp, ks, vs, bt, cl, out, b, n_kv, group, hd,
                                      page_size, pages_per_seq, sm_scale, st);
    case 2:
      return launch<T, int8_t>(q, kp, vp, ks, vs, bt, cl, out, b, n_kv, group, hd, page_size,
                               pages_per_seq, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = fp32, 1 = bf16; pool_dtype: 0 = fp32, 1 = bf16, 2 = int8
// (then k_scale and v_scale are required). Returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scale, const void* v_scale, const void* block_table,
                            const void* cache_len, void* out, int b, int n_kv, int group, int hd,
                            int page_size, int pages_per_seq, float sm_scale, int q_dtype,
                            int pool_dtype, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_table);
  const int* cl = static_cast<const int*>(cache_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((pool_dtype == 2) != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_pool<float>(pool_dtype, q, k_pages, v_pages, ks, vs, bt, cl, out, b, n_kv,
                               group, hd, page_size, pages_per_seq, sm_scale, st);
  else if (q_dtype == 1)
    err = dispatch_pool<__nv_bfloat16>(pool_dtype, q, k_pages, v_pages, ks, vs, bt, cl, out, b,
                                       n_kv, group, hd, page_size, pages_per_seq, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
