// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the flash
// attention kernels: asynchronous 16-byte copies into padded shared-memory
// tiles, ldmatrix fragment loads and mma.sync.m16n8k16 (bf16 operands, fp32
// accumulators).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register two bf16 or the accumulator's fp32 values:
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                            a2 (g, 2t+8..+9)   a3 (g+8, 2t+8..+9)
//   B (16 x 8, k x n):       b0 (k 2t..2t+1, n g)   b1 (k 2t+8..+9, n g)
//   C (16 x 8, fp32):        c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// So the accumulators of two neighbouring 8-column tiles, packed pairwise to
// bf16x2, are the A fragment of the next product over those 16 columns
// (`pack_bf16x2`): P and dS never leave registers.
//
// Tiles hold rows of D bf16 at a pitch of D + 8 elements: the 16 extra bytes
// move each row 4 banks on, so the 8 row addresses of one ldmatrix phase hit
// 32 distinct banks for every D in {16, 32, 64, 96, 128, 256}, and every row start
// stays 16-byte aligned for cp.async and ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {
namespace {

template <int D> __host__ __device__ constexpr int pitch() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with valid false the 16 bytes are
// zero-filled and nothing is read (src-size 0).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (the per-row fp32 statistics), zero-filled likewise
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, valid) of a (ROWS, D) bf16 tile at `src` (rows D apart) into a
// padded shared tile; rows past `valid` are zero-filled and never read.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                int valid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CPR, ch = c % CPR;
    const bool ok = r < valid;
    cp_async_16(dst + r * pitch<D>() + ch * 8, ok ? src + (size_t)r * D + ch * 8 : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The lane's address for each fragment load of a padded tile `s` (pitch P):
// A of the 16 x 16 block at (row0, col0) of a row-major (m, k) tile
template <int D>
__device__ __forceinline__ const __nv_bfloat16* a_frag_addr(const __nv_bfloat16* s, int row0,
                                                            int col0, int lane) {
  return s + (row0 + (lane & 15)) * pitch<D>() + col0 + (lane >> 4) * 8;
}
// B of two 8-column tiles n0..n0+15, k col0..col0+15, from an (n, k) tile
// (ldsm_x4: r0, r1 are b0, b1 of columns n0..n0+7; r2, r3 of n0+8..n0+15)
template <int D>
__device__ __forceinline__ const __nv_bfloat16* b_frag_addr_nk(const __nv_bfloat16* s, int n0,
                                                               int col0, int lane) {
  return s + (n0 + (lane >> 4) * 8 + (lane & 7)) * pitch<D>() + col0 + ((lane >> 3) & 1) * 8;
}
// B of two 8-column tiles n0..n0+15, k row0..row0+15, from a (k, n) tile
// (ldsm_x4_trans, same register order)
template <int D>
__device__ __forceinline__ const __nv_bfloat16* b_frag_addr_kn(const __nv_bfloat16* s, int row0,
                                                               int n0, int lane) {
  return s + (row0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pitch<D>() + n0 + (lane >> 4) * 8;
}

// d += a . b on the tensor cores: (16 x 16 bf16) x (16 x 8 bf16) -> 16 x 8 fp32
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded (to nearest even) into one bf16x2 register, lo first
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 columns) from the accumulators of the two
// neighbouring 8-column tiles c (columns 0..7) and c8 (columns 8..15)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[4],
                                         const float (&c8)[4]) {
  a[0] = pack_bf16x2(c[0], c[1]);
  a[1] = pack_bf16x2(c[2], c[3]);
  a[2] = pack_bf16x2(c8[0], c8[1]);
  a[3] = pack_bf16x2(c8[2], c8[3]);
}

// max and sum over the four lanes of a quad, which share accumulator rows
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
}  // namespace mma_bf16
