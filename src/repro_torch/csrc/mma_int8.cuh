// int8 tensor-core building blocks for Hopper (sm_90a), shared by the slot
// loop of unary_gemm.cu (tuGEMM, tubGEMM) and the packed GEMM of
// int_gemm.cuh (quant_gemm): masked word loads of row-major int8 matrices,
// the 4 x 4 byte transpose that turns four rows into k-packed column words,
// bit-7 replication per byte, and mma.sync.m16n8k32 with s8 operands.
// The cp.async helpers come from mma_bf16.cuh.
//
// An s8 fragment register of mma.m16n8k32 holds four consecutive k of one
// row of A (or one column of B), low byte first (lane = 4 g + t):
//   a0 (row g, k 4t..)  a1 (row g+8, k 4t..)  a2 (row g, k 16+4t..)  a3 (row g+8, k 16+4t..)
//   b0 (column g, k 4t..)  b1 (column g, k 16+4t..)
//   d0, d1 (row g, columns 2t, 2t+1)  d2, d3 (row g+8, columns 2t, 2t+1)

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"   // cp.async helpers

// Every function is inline (a template or __forceinline__), so each including
// file gets its own copy without an unnamed namespace: a using-directive for
// mma_int8 at namespace scope then brings no second unnamed namespace into
// the includer's (the host stub nvcc writes names the file's own unnamed
// namespace, and two would make that name ambiguous).
namespace mma_int8 {

// Four consecutive bytes c..c+3 of row r of a row-major int8 matrix (row
// pitch `stride` bytes), low byte first; zero outside [0, rows) x [0, cols).
// `aligned`: every row start is 4-byte aligned (stride % 4 == 0 and an
// aligned base), so a word that lies wholly inside is one load.
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ p, int r, int c,
                                              int rows, int cols, int stride, bool aligned) {
  if (r >= rows || c >= cols) return 0u;
  const int8_t* q = p + (size_t)r * stride + c;
  if (aligned && c + 3 < cols) return *reinterpret_cast<const uint32_t*>(q);
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < cols) w |= (uint32_t)(uint8_t)q[i] << (8 * i);
  return w;
}

// The words idx = threadIdx.x + i * NT (i < WORDS) of the tile at rows m0..,
// columns kt.. of a row-major (M, K) int8 matrix, 4 KW columns wide: row
// idx / KW, k word idx % KW; zero past M and past k_end.
template <int WORDS, int NT, int KW>
__device__ __forceinline__ void load_tile_words(uint32_t (&w)[WORDS], const int8_t* __restrict__ p,
                                                int m0, int kt, int M, int K, int k_end,
                                                bool aligned) {
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const int idx = threadIdx.x + i * NT;
    w[i] = load_word(p, m0 + idx / KW, kt + 4 * (idx % KW), M, k_end, K, aligned);
  }
}

// Four rows r0..r3 of four bytes (consecutive k, consecutive n) -> four
// words, one per column, each holding that column's four k (low byte first).
__device__ __forceinline__ uint4 transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  return make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                    __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
}

// 0xff in each byte whose bit 7 is set, else 0x00 (prmt's sign-replicate mode)
__device__ __forceinline__ uint32_t byte_signs(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %1, 0xBA98;\n" : "=r"(r) : "r"(x));
  return r;
}

// d += a . b on the tensor cores: (16 x 32 s8) x (32 x 8 s8) -> 16 x 8 s32, exact.
__device__ __forceinline__ void mma_16832(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The K splits: `splits` (clamped to [1, k_tiles]) slices of whole BK-wide
// K tiles; returns the k per slice and sets `z` to the number of slices.
inline int k_slice(int K, int BK, int splits, int& z) {
  const int k_tiles = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > k_tiles) splits = k_tiles > 0 ? k_tiles : 1;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  z = k_tiles > 0 ? (k_tiles + tiles_per_split - 1) / tiles_per_split : 1;
  return (tiles_per_split > 0 ? tiles_per_split : 1) * BK;
}

}  // namespace mma_int8
