// Packed low-bit integer GEMM for Hopper (sm_90a): the template behind
// quant_gemm.cu (int8-container weights, 8/bits values per byte) and
// packed_gemm.cu (int32-word weight stores, 32/bits codes per word).
//
//   x (M,K) int8 codes  @  unpack(w) (K,N)  ->  (M,N) int32, or with the
//   fused dequant epilogue float32(acc) * scales[n]   (one rounding)
//
// Only the unpack differs between the two kernels; both sign-extend a
// bits-wide field j of an unsigned container v as
//   (int32_t)(v << (32 - bits*(j+1))) >> (32 - bits)
// (a left shift on unsigned, then an arithmetic right shift on int), lowest
// field first, so -2^(bits-1) survives.
//
// Layout of one block: a (BM x 128) output tile, BM = 8*TM, walked over K in
// tiles of 64.  Per K tile the x tile lands in shared memory as words of
// four consecutive k of one row; the weight tile is unpacked on its way into
// shared memory into words of four consecutive k of one column; each thread
// then owns TM rows x 4 columns and contracts one dp4a per (row, column,
// four k).  Products are exact int32 (K <= 14336 at 8 bits stays below
// 2^31).
//
// What bounds it on an H100: at decode (M = 8) the packed weight bytes,
// K*N*bits/8 read once, i.e. memory.  Narrow outputs are split over K across
// blockIdx.z so that the grid fills the SMs.  Under a split each block adds
// its partial sums into an int32 workspace with atomicAdd (exact in any
// order), fences, and takes a ticket from the tile's counter; the block that
// draws the last ticket reads the finished sums back (from L2) and alone
// runs the epilogue, so the fused float32 output is bit-exact.  At prefill
// rows dp4a throughput bounds it; wgmma, TMA and a pipelined K loop are
// later work.
//
// Ragged M, N, K are masked in the loads and stores: no operand is read
// past its end and there is no host padding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Everything has internal linkage: each including .cu file gets its own copy
// and instantiates only its own weight format.
namespace int_gemm {
namespace {

constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // k per shared-memory tile
constexpr int KW = BK / 4;     // k quads per tile
constexpr int NTHREADS = 256;  // 32 column quads x 8 row groups

// field j (bits wide) of the unsigned container v, sign-extended
template <int BITS>
__device__ __forceinline__ int sext_field(uint32_t v, int j) {
  return (int32_t)(v << (32 - BITS * (j + 1))) >> (32 - BITS);
}

__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return ((uint32_t)c0 & 0xffu) | (((uint32_t)c1 & 0xffu) << 8) |
         (((uint32_t)c2 & 0xffu) << 16) | (((uint32_t)c3 & 0xffu) << 24);
}

// Four consecutive k (4*kq .. 4*kq+3) of weight column n as dp4a bytes.
// WORDS = false: int8 container, (K*BITS/8, N), 8/BITS values per byte.
// WORDS = true : int32 words, (ceil(K/cpw), N), cpw = 32/BITS codes a word.
// `rows` is the store's row count; rows past it read as zero codes.
template <bool WORDS, int BITS>
__device__ __forceinline__ uint32_t load_w_quad(const void* __restrict__ w,
                                                int kq, int n, int N,
                                                int rows) {
  if (WORDS) {
    constexpr int CPW = 32 / BITS;
    const int r = (4 * kq) / CPW;
    if (r >= rows) return 0u;
    const uint32_t v =
        (uint32_t)static_cast<const int32_t*>(w)[(size_t)r * N + n];
    if (BITS == 8) return v;  // four 8-bit lanes, low first: already dp4a order
    const int j0 = (4 * kq) % CPW;
    return pack4(sext_field<BITS>(v, j0), sext_field<BITS>(v, j0 + 1),
                 sext_field<BITS>(v, j0 + 2), sext_field<BITS>(v, j0 + 3));
  } else {
    const int8_t* wp = static_cast<const int8_t*>(w);
    if (BITS == 8) {
      uint32_t out = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * kq + i;
        if (r < rows) out |= (uint32_t)(uint8_t)wp[(size_t)r * N + n] << (8 * i);
      }
      return out;
    } else if (BITS == 4) {
      int c[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * kq + i;
        const uint32_t b = r < rows ? (uint32_t)(uint8_t)wp[(size_t)r * N + n] : 0u;
        c[2 * i] = sext_field<4>(b, 0);      // low nibble first
        c[2 * i + 1] = sext_field<4>(b, 1);
      }
      return pack4(c[0], c[1], c[2], c[3]);
    } else {  // BITS == 2: one byte holds the four k
      const int r = kq;
      const uint32_t b = r < rows ? (uint32_t)(uint8_t)wp[(size_t)r * N + n] : 0u;
      return pack4(sext_field<2>(b, 0), sext_field<2>(b, 1),
                   sext_field<2>(b, 2), sext_field<2>(b, 3));
    }
  }
}

__device__ __forceinline__ uint32_t load_x_word(const int8_t* __restrict__ x,
                                                int m, int k, int M, int K,
                                                int k_end, bool aligned) {
  // four consecutive k of row m, zero outside [0,M) x [.., k_end)
  if (m >= M) return 0u;
  const int8_t* p = x + (size_t)m * K + k;
  if (aligned && k + 3 < k_end) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < k_end) v |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return v;
}

__device__ __forceinline__ void store_out(void* out, bool fuse,
                                          const float* __restrict__ scales,
                                          size_t idx, int n, int32_t acc) {
  if (fuse)
    static_cast<float*>(out)[idx] = __fmul_rn(__int2float_rn(acc), scales[n]);
  else
    static_cast<int32_t*>(out)[idx] = acc;
}

template <int TM, bool WORDS, int BITS>
__global__ void __launch_bounds__(NTHREADS)
int_gemm_kernel(const int8_t* __restrict__ x, const void* __restrict__ w,
                const float* __restrict__ scales, void* __restrict__ out,
                int32_t* __restrict__ ws, int32_t* __restrict__ counters,
                int M, int K, int N, int w_rows, int k_per_split, bool fuse) {
  constexpr int BM = 8 * TM;
  __shared__ uint32_t x_s[BM][KW + 1];             // +1: no bank conflicts
  __shared__ __align__(16) uint32_t w_s[KW][BN];   // w_s[kq][n]

  const int tid = threadIdx.x;
  const int tx = tid & 31;   // column quad: columns 4*tx .. 4*tx+3
  const int ty = tid >> 5;   // row group: rows ty*TM .. ty*TM+TM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool x_aligned = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 3) == 0);

  int32_t acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    for (int idx = tid; idx < BM * KW; idx += NTHREADS) {
      const int r = idx / KW, q = idx % KW;
      x_s[r][q] = load_x_word(x, m0 + r, kt + 4 * q, M, K, k_end, x_aligned);
    }
    // neighbouring threads take neighbouring columns: coalesced row loads
    for (int idx = tid; idx < KW * BN; idx += NTHREADS) {
      const int q = idx / BN, c = idx % BN;
      const int n = n0 + c;
      w_s[q][c] = n < N ? load_w_quad<WORDS, BITS>(w, kt / 4 + q, n, N, w_rows)
                        : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < KW; ++q) {
      const uint4 wc = *reinterpret_cast<const uint4*>(&w_s[q][4 * tx]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int a = (int)x_s[ty * TM + i][q];
        acc[i][0] = __dp4a(a, (int)wc.x, acc[i][0]);
        acc[i][1] = __dp4a(a, (int)wc.y, acc[i][1]);
        acc[i][2] = __dp4a(a, (int)wc.z, acc[i][2]);
        acc[i][3] = __dp4a(a, (int)wc.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n < N) store_out(out, fuse, scales, (size_t)m * N + n, n, acc[i][j]);
      }
    }
    return;
  }

  // ---- split K: partial sums into the workspace, the last block finishes
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) atomicAdd(ws + (size_t)m * N + n, acc[i][j]);
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) {
        const size_t idx = (size_t)m * N + n;
        store_out(out, fuse, scales, idx, n, __ldcg(ws + idx));
      }
    }
  }
}

template <int TM, bool WORDS, int BITS>
cudaError_t launch_tm(const int8_t* x, const void* w, const float* scales,
                      void* out, int32_t* ws, int32_t* counters, int M, int K,
                      int N, int w_rows, int splits, bool fuse,
                      cudaStream_t stream) {
  constexpr int BM = 8 * TM;
  const int k_tiles = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > k_tiles) splits = k_tiles > 0 ? k_tiles : 1;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  const int k_per_split = (tiles_per_split > 0 ? tiles_per_split : 1) * BK;
  const int z = k_tiles > 0 ? (k_tiles + tiles_per_split - 1) / tiles_per_split : 1;
  if (z > 1 && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  int_gemm_kernel<TM, WORDS, BITS><<<grid, NTHREADS, 0, stream>>>(
      x, w, scales, out, ws, counters, M, K, N, w_rows, k_per_split, fuse);
  return cudaGetLastError();
}

template <bool WORDS, int BITS>
cudaError_t launch_bits(const int8_t* x, const void* w, const float* scales,
                        void* out, int32_t* ws, int32_t* counters, int M, int K,
                        int N, int w_rows, int splits, bool fuse,
                        cudaStream_t s) {
  if (M <= 8)
    return launch_tm<1, WORDS, BITS>(x, w, scales, out, ws, counters, M, K, N,
                                     w_rows, splits, fuse, s);
  if (M <= 16)
    return launch_tm<2, WORDS, BITS>(x, w, scales, out, ws, counters, M, K, N,
                                     w_rows, splits, fuse, s);
  if (M <= 32)
    return launch_tm<4, WORDS, BITS>(x, w, scales, out, ws, counters, M, K, N,
                                     w_rows, splits, fuse, s);
  return launch_tm<8, WORDS, BITS>(x, w, scales, out, ws, counters, M, K, N,
                                   w_rows, splits, fuse, s);
}

// Entry shared by both C interfaces.  With splits > 1 the caller hands in a
// zeroed int32 workspace of M*N and a zeroed counter per output tile
// (ceil(N/128) * ceil(M/BM)); with splits == 1 both may be null.  `scales`
// is read only when `fuse`.  Launches on `stream`, allocates nothing, does
// not synchronise, and returns cudaGetLastError().
template <bool WORDS>
int launch(const void* x, const void* w, const void* scales, void* out,
           void* ws, void* counters, int M, int K, int N, int w_rows, int bits,
           int splits, int fuse, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || w_rows < 0) return (int)cudaErrorInvalidValue;
  if (fuse && scales == nullptr) return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const float* sp = static_cast<const float*>(scales);
  int32_t* wsp = static_cast<int32_t*>(ws);
  int32_t* cp = static_cast<int32_t*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = fuse != 0;
  switch (bits) {
    case 2: return (int)launch_bits<WORDS, 2>(xp, w, sp, out, wsp, cp, M, K, N, w_rows, splits, f, s);
    case 4: return (int)launch_bits<WORDS, 4>(xp, w, sp, out, wsp, cp, M, K, N, w_rows, splits, f, s);
    case 8: return (int)launch_bits<WORDS, 8>(xp, w, sp, out, wsp, cp, M, K, N, w_rows, splits, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace int_gemm
