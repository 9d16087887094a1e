// Warp-level bf16 tensor-core building blocks (sm_80 instructions, built for
// sm_90a): ldmatrix fragment loads, mma.sync m16n8k16 with fp32
// accumulation, bf16 packing, and cp.async staging into shared memory.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane >> 2, t = lane & 3):
//   A (16 x 16, 4 registers of 2 bf16): a0 = (row g, cols 2t, 2t+1),
//     a1 = (row g+8, cols 2t, 2t+1), a2 = (row g, cols 2t+8, 2t+9),
//     a3 = (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n, 2 registers): b0 = (k 2t, 2t+1; col g),
//     b1 = (k 2t+8, 2t+9; col g);
//   C (16 x 8 fp32): c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = (row g+8, ...).
// Two neighbouring C tiles (n-blocks j, j+1) packed to bf16 as (c0, c1),
// (c2, c3) of j and then of j+1 are one A fragment of a 16-wide k step, so
// a product's result feeds the next product from registers.
//
// Addressing rules for a 16 x 16 block of a row-major bf16 tile in shared
// memory (row stride `ld` elements, rows padded so 8 rows of 16 bytes fall
// in 8 different bank groups):
//   A from rows (m) x cols (k):            ldsm_x4(a, tile + a_offset(lane, ld))
//   B = tile^T, tile rows are n, cols k:   ldsm_x4(b, tile + bt_offset(lane, ld))
//       gives b0, b1 of n-block 0 in r[0], r[1] and of n-block 1 in r[2], r[3]
//   B = tile, tile rows are k, cols n:     ldsm_x4_t(b, tile + a_offset(lane, ld))
//       the same register order.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace nxd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// lane's row address within a 16 x 16 block: matrices (rows 0-7, cols 0-7),
// (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15)
__device__ __forceinline__ int a_offset(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);
}

// matrices (rows 0-7, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols
// 0-7), (rows 8-15, cols 8-15): b0, b1 of the n-block of rows 0-7, then of
// rows 8-15
__device__ __forceinline__ int bt_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += p, element by element: fp32 adds, rounded to nearest
template <int N>
__device__ __forceinline__ void add_to(float (&d)[N][4], const float (&p)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] += p[n][e];
}

// two fp32 values rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared, bypassing L1; zeros instead when !full (src
// must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace nxd
