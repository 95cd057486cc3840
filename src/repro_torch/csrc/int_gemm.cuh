// Packed low-bit integer GEMMs for Hopper (sm_90a): the kernel behind
// quant_gemm.cu (int8-container weights, 8/bits values per byte) and
// packed_gemm.cu (int32-word weight stores, 32/bits codes per word).
//
//   x (M,K) int8 codes  @  unpack(w) (K,N)  ->  (M,N) int32, or with the
//   fused dequant epilogue float32(acc) * scales[n]   (one rounding)
//
// One kernel, int_mma_kernel<WORDS, BITS, ...>, runs both weight formats on
// the int8 tensor cores.  It computes out^T = unpack(w)^T . x^T with
// mma.sync.m16n8k32 s8 (mma_int8.cuh): the mma's 16-row side takes 16
// output columns and its 8-column side 8 rows of x, so a decode step's 8
// rows fill it with no padding.  A block walks a (BM x 128) output tile over
// K in tiles of 64.  A tile of either format is 1024 * bits bytes: 64 *
// bits/8 rows of 128 container bytes, or 64 * bits/32 rows of 128 int32
// words.  It arrives raw through a four-stage ring of 16-byte cp.async
// copies and is unpacked once in shared memory into k-packed column words
// (four consecutive k of one column, low byte first), which are exactly the
// A fragments; the x words, loaded one tile ahead in registers, are the B
// fragments.  Every mma then reads the same unpacked words.  Only the unpack
// differs between the formats:
//
//  - container (WORDS = false): a 4 x 4 byte transpose of four packed rows
//    after per-byte sign extension (unpack_quads);
//  - words (WORDS = true; word r holds k = r*cpw .. r*cpw + cpw - 1, lowest
//    field first): at 8 bits a word already is the fragment word; at 4 bits
//    the two per-byte nibble planes (k even, k odd) interleave into two
//    fragment words by one __byte_perm each; at 2 bits the four crumb planes
//    go through the 4 x 4 transpose into four fragment words (unpack_word).
//
// Both sign-extend bits-wide fields lowest first, so -2^(bits-1) survives.
// Products are exact int32 (K <= 14336 at 8 bits stays below 2^31).
//
// What bounds it on an H100: at decode (M = 8) the packed weight bytes,
// K*N*bits/8 read once, i.e. memory.  Narrow outputs are split over K across
// blockIdx.z so that the grid fills the SMs.  Under a split each block adds
// its partial sums into an int32 workspace with atomicAdd (exact in any
// order), fences, and takes a ticket from the tile's counter; the block that
// draws the last ticket reads the finished sums back (from L2) and alone
// runs the epilogue, so the fused float32 output is bit-exact.  At prefill
// rows the int8 tensor cores' multiply rate bounds it.
//
// Ragged M, N, K are masked in the loads and stores: no operand is read
// past its end and there is no host padding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"   // word loads, byte transpose, mma.m16n8k32 (+ cp.async)

// Everything has internal linkage: each including .cu file gets its own copy
// and instantiates only its own weight format.
namespace int_gemm {
namespace {

using namespace mma_int8;

constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // k per shared-memory tile
constexpr int KW = BK / 4;     // k quads per tile
constexpr int MMA_NT = 128;    // tensor cores: 4 warps
constexpr int STAGES = 4;      // weight tiles in the cp.async ring
constexpr int WT_PITCH = BN + 8;   // words: fragment loads hit 32 banks
constexpr int XS_PITCH = KW + 4;   // words: likewise

// field j (bits wide) of each of the four bytes of v, sign-extended within
// its byte: f ^ h - h per byte, with h = 2^(bits-1) (no borrow between bytes)
template <int BITS>
__device__ __forceinline__ uint32_t sext_bytes(uint32_t v, int j) {
  constexpr uint32_t mask = ((1u << BITS) - 1) * 0x01010101u;
  constexpr uint32_t half = (1u << (BITS - 1)) * 0x01010101u;
  return __vsub4(((v >> (BITS * j)) & mask) ^ half, half);
}

// Four k-packed column words (columns 4 nq .. 4 nq + 3, k 4 kw .. 4 kw + 3)
// from a raw int8-container tile: `s4` is word nq of packed row kw * BITS/2,
// and the tile's rows are BN / 4 words apart.  8 bits: four rows of one k
// each; 4 bits: two rows of two k (low nibble first); 2 bits: one row of
// four k (low crumb first).
template <int BITS>
__device__ __forceinline__ uint4 unpack_quads(const uint32_t* s4) {
  constexpr int ROW = BN / 4;
  if constexpr (BITS == 8) {
    return transpose4x4(s4[0], s4[ROW], s4[2 * ROW], s4[3 * ROW]);
  } else if constexpr (BITS == 4) {
    return transpose4x4(sext_bytes<4>(s4[0], 0), sext_bytes<4>(s4[0], 1),
                        sext_bytes<4>(s4[ROW], 0), sext_bytes<4>(s4[ROW], 1));
  } else {
    static_assert(BITS == 2, "the container packs 2, 4 or 8 bits");
    return transpose4x4(sext_bytes<2>(s4[0], 0), sext_bytes<2>(s4[0], 1),
                        sext_bytes<2>(s4[0], 2), sext_bytes<2>(s4[0], 3));
  }
}

// The k-packed column words of one raw int32 word of column n (word row r
// of a tile holds k = r*cpw .. r*cpw + cpw - 1, cpw = 32/BITS, lowest field
// first): f[j] holds k 4 (r*cpw/4 + j) .. + 3, for j < cpw / 4.
//  8 bits: the word itself.
//  4 bits: lo = nibbles 0,2,4,6 and hi = nibbles 1,3,5,7, one per byte;
//    (k0 k1 k2 k3) = bytes lo0 hi0 lo1 hi1, (k4 k5 k6 k7) = lo2 hi2 lo3 hi3.
//  2 bits: plane j = crumbs j, 4+j, 8+j, 12+j, one per byte; byte i of the
//    four planes is (k 4i .. 4i+3): the 4 x 4 transpose.
template <int BITS>
__device__ __forceinline__ void unpack_word(uint32_t v, uint32_t (&f)[32 / BITS / 4]) {
  if constexpr (BITS == 8) {
    f[0] = v;
  } else if constexpr (BITS == 4) {
    const uint32_t lo = sext_bytes<4>(v, 0), hi = sext_bytes<4>(v, 1);
    f[0] = __byte_perm(lo, hi, 0x5140);
    f[1] = __byte_perm(lo, hi, 0x7362);
  } else {
    static_assert(BITS == 2, "a word store packs 2, 4 or 8 bits");
    const uint4 t = transpose4x4(sext_bytes<2>(v, 0), sext_bytes<2>(v, 1),
                                 sext_bytes<2>(v, 2), sext_bytes<2>(v, 3));
    f[0] = t.x;
    f[1] = t.y;
    f[2] = t.z;
    f[3] = t.w;
  }
}

__device__ __forceinline__ void store_out(void* out, bool fuse,
                                          const float* __restrict__ scales,
                                          size_t idx, int n, int32_t acc) {
  if (fuse)
    static_cast<float*>(out)[idx] = __fmul_rn(__int2float_rn(acc), scales[n]);
  else
    static_cast<int32_t*>(out)[idx] = acc;
}

// ---------------------------------------------------------------------------
// The kernel: int8-container (quant_gemm) or int32-word (packed_gemm) weights
// on the int8 tensor cores
// ---------------------------------------------------------------------------
// One block: BN = 128 output columns x BM = WARPS_M * WM * 8 rows; warp w
// owns WN 16-column tiles x WM 8-row tiles of out^T.  Per K tile of 64: the
// raw packed tile (landed by cp.async, STAGES - 1 tiles ahead) is unpacked
// into wt, the x tile (loaded into registers one tile ahead) is stored to
// xs, and then, per 32 k, one mma per fragment pair.
// smem: raw [STAGES][RR][BN] store elements (bytes, or words with WORDS),
// wt [KW][WT_PITCH] words, xs [BM][XS_PITCH] words
template <bool WORDS, int BITS, int WN, int WM, int WARPS_N, int WARPS_M>
__global__ void __launch_bounds__(MMA_NT)
int_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scales, void* __restrict__ out,
               int32_t* __restrict__ ws, int32_t* __restrict__ counters, int M, int K, int N,
               int w_rows, int k_per_split, bool fuse, int w_vec) {
  using namespace mma_bf16;
  constexpr int BM = WARPS_M * WM * 8;
  constexpr int ES = WORDS ? 4 : 1;                       // bytes a store element
  constexpr int ROW = BN * ES;                            // bytes a raw tile row
  constexpr int RR = WORDS ? BK * BITS / 32 : BK * BITS / 8;   // raw rows per K tile
  constexpr int TILE = RR * ROW;                          // 1024 * BITS bytes either way
  constexpr int X_WORDS = BM * KW / MMA_NT;    // x words a thread loads per K tile
  static_assert(WARPS_N * WARPS_M * 32 == MMA_NT && WARPS_N * WN * 16 == BN, "tile shape");
  static_assert((BM * KW) % MMA_NT == 0 && (TILE / 16) % MMA_NT == 0,
                "whole words and chunks per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;
  uint32_t* wt = reinterpret_cast<uint32_t*>(raw + STAGES * TILE);
  uint32_t* xs = wt + KW * WT_PITCH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = (warp % WARPS_N) * WN * 16, wm = (warp / WARPS_N) * WM * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  // this split's raw rows end (a split starts on a whole tile, so never
  // inside a word; the last word's padding lanes hold zero codes and meet
  // zero x past K)
  const int r_end = min(w_rows, (k_end * RR + BK - 1) / BK);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const bool x_aligned = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 3) == 0);
  const bool w_aligned = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(w) & 3) == 0);

  // raw weight tile `it` into its ring stage: 16-byte cp.async when the rows
  // are 16-byte aligned (w_vec: N % (16 / ES) == 0), else plain word loads
  auto fill_w = [&](int it) {
    unsigned char* dst = raw + (it % STAGES) * TILE;
    const int r0 = (k_begin / BK + it) * RR;
    if (w_vec) {
#pragma unroll
      for (int i = 0; i < TILE / 16 / MMA_NT; ++i) {
        const int c = tid + i * MMA_NT, r = c / (ROW / 16), cb = (c % (ROW / 16)) * 16;
        const bool ok = r0 + r < r_end && n0 + cb / ES < N;
        cp_async_16(dst + r * ROW + cb,
                    ok ? w + ((size_t)(r0 + r) * N + n0 + cb / ES) * ES : w, ok);
      }
    } else if constexpr (WORDS) {
      const int32_t* w32 = reinterpret_cast<const int32_t*>(w);
#pragma unroll 1
      for (int q = tid; q < RR * BN; q += MMA_NT) {
        const int r = q / BN, col = q % BN;
        reinterpret_cast<int32_t*>(dst)[q] =
            r0 + r < r_end && n0 + col < N ? w32[(size_t)(r0 + r) * N + n0 + col] : 0;
      }
    } else {
      // kept rolled (see the epilogue's note on spills)
#pragma unroll 1
      for (int q = tid; q < RR * BN / 4; q += MMA_NT) {
        const int r = q / (BN / 4), col = (q % (BN / 4)) * 4;
        *reinterpret_cast<uint32_t*>(dst + r * BN + col) =
            load_word(w, r0 + r, n0 + col, r_end, N, N, w_aligned);
      }
    }
  };
  uint32_t x_next[X_WORDS];                    // the next x tile, in flight

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) fill_w(st);
    cp_async_commit();
  }
  if (n_tiles > 0)
    load_tile_words<X_WORDS, MMA_NT, KW>(x_next, x, m0, k_begin, M, K, k_end, x_aligned);

  int32_t acc[WN][WM][4];
#pragma unroll
  for (int i = 0; i < WN; ++i)
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();             // tile `it` has landed (this thread's copies)
    __syncthreads();                         // ... everyone's; the last tile's products are done
    if (it + STAGES - 1 < n_tiles) fill_w(it + STAGES - 1);
    cp_async_commit();
    const uint32_t* src = reinterpret_cast<const uint32_t*>(raw + (it % STAGES) * TILE);
    if constexpr (WORDS) {
      // each thread reads four neighbouring raw words of one row once and
      // writes their cpw / 4 fragment words per column
      constexpr int FW = 32 / BITS / 4;
#pragma unroll
      for (int i = 0; i < RR * (BN / 4) / MMA_NT; ++i) {
        const int blk = tid + i * MMA_NT, r = blk / (BN / 4), nq = blk % (BN / 4);
        const uint4 v = reinterpret_cast<const uint4*>(src)[blk];
        uint32_t f0[FW], f1[FW], f2[FW], f3[FW];
        unpack_word<BITS>(v.x, f0);
        unpack_word<BITS>(v.y, f1);
        unpack_word<BITS>(v.z, f2);
        unpack_word<BITS>(v.w, f3);
#pragma unroll
        for (int j = 0; j < FW; ++j)
          *reinterpret_cast<uint4*>(wt + (r * FW + j) * WT_PITCH + 4 * nq) =
              make_uint4(f0[j], f1[j], f2[j], f3[j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < KW * (BN / 4) / MMA_NT; ++i) {
        const int blk = tid + i * MMA_NT, kw = blk / (BN / 4), nq = blk % (BN / 4);
        *reinterpret_cast<uint4*>(wt + kw * WT_PITCH + 4 * nq) =
            unpack_quads<BITS>(src + kw * (BITS / 2) * (BN / 4) + nq);
      }
    }
#pragma unroll
    for (int i = 0; i < X_WORDS; ++i) {
      const int idx = tid + i * MMA_NT;
      xs[(idx / KW) * XS_PITCH + idx % KW] = x_next[i];
    }
    if (it + 1 < n_tiles)                    // lands under this tile's products
      load_tile_words<X_WORDS, MMA_NT, KW>(x_next, x, m0, k_begin + (it + 1) * BK, M, K,
                                           k_end, x_aligned);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // A = unpack(w)^T: 16 output columns x 32 k per tile
      uint32_t af[WN][4];
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const uint32_t* p0 = wt + (ks * 8 + t) * WT_PITCH + wn + i * 16 + g;
        af[i][0] = p0[0];
        af[i][1] = p0[8];
        af[i][2] = p0[4 * WT_PITCH];
        af[i][3] = p0[4 * WT_PITCH + 8];
      }
      // B = x^T: 32 k x 8 rows of x per tile
#pragma unroll
      for (int j = 0; j < WM; ++j) {
        const uint32_t* p1 = xs + (wm + j * 8 + g) * XS_PITCH + ks * 8 + t;
        const uint32_t b0 = p1[0], b1 = p1[4];
#pragma unroll
        for (int i = 0; i < WN; ++i) mma_16832(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();                        // no copy outlives the block

  // acc[i][j][e] is out[m][n] for n = wn + 16 i + g (+ 8 for e >= 2) and
  // m = wm + 8 j + 2 t (+ 1 for odd e).  Unsplit, each result is stored;
  // split over K, the partial sums go into the workspace, and the block that
  // draws the tile's last ticket stores the finished sums.  Written out
  // twice, with the word-load loop above kept rolled: ptxas for sm_90a
  // spilled 4 bytes in one container instance or another when either was
  // changed (the two epilogues shared through a lambda, or that loop
  // unrolled).
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < WN; ++i)
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wn + i * 16 + g + (e >> 1) * 8;
        const int m = m0 + wm + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        if (split) atomicAdd(ws + (size_t)m * N + n, acc[i][j][e]);
        else store_out(out, fuse, scales, (size_t)m * N + n, n, acc[i][j][e]);
      }
  if (!split) return;
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0)
    is_last = atomicAdd(counters + blockIdx.y * gridDim.x + blockIdx.x, 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < WN; ++i)
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wn + i * 16 + g + (e >> 1) * 8;
        const int m = m0 + wm + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t idx = (size_t)m * N + n;
        store_out(out, fuse, scales, idx, n, __ldcg(ws + idx));
      }
}

// Launches the instance, or, with `resident` set, launches nothing and
// stores how many of its blocks one SM holds at once.
template <bool WORDS, int BITS, int WN, int WM, int WARPS_N, int WARPS_M>
cudaError_t launch_mma(const int8_t* x, const int8_t* w, const float* scales, void* out,
                       int32_t* ws, int32_t* counters, int M, int K, int N, int w_rows,
                       int splits, bool fuse, cudaStream_t stream, int* resident) {
  constexpr int BM = WARPS_M * WM * 8;
  constexpr size_t smem = (size_t)STAGES * 1024 * BITS +   // raw tiles, either format
                          sizeof(uint32_t) * ((size_t)KW * WT_PITCH + (size_t)BM * XS_PITCH);
  static_assert(smem <= 48 * 1024 - 16, "static shared-memory window (no opt-in)");
  auto kernel = int_mma_kernel<WORDS, BITS, WN, WM, WARPS_N, WARPS_M>;
  if (resident) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, MMA_NT, smem);
  int z;
  const int k_per_split = k_slice(K, BK, splits, z);
  if (z > 1 && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  // 16-byte rows: 16 container bytes or 4 words of a row, from a 16-byte aligned store
  const int w_vec = N % (WORDS ? 4 : 16) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  kernel<<<grid, MMA_NT, smem, stream>>>(x, w, scales, out, ws, counters, M, K, N, w_rows,
                                         k_per_split, fuse, w_vec);
  return cudaGetLastError();
}

// the instance for M rows: 8, 16, 32 or 64 rows a block
template <bool WORDS, int BITS>
cudaError_t launch_rows(const int8_t* x, const void* w, const float* scales, void* out,
                        int32_t* ws, int32_t* counters, int M, int K, int N, int w_rows,
                        int splits, bool fuse, cudaStream_t s, int* resident = nullptr) {
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (M <= 8)
    return launch_mma<WORDS, BITS, 2, 1, 4, 1>(x, wp, scales, out, ws, counters, M, K, N, w_rows, splits, fuse, s, resident);
  if (M <= 16)
    return launch_mma<WORDS, BITS, 2, 2, 4, 1>(x, wp, scales, out, ws, counters, M, K, N, w_rows, splits, fuse, s, resident);
  if (M <= 32)
    return launch_mma<WORDS, BITS, 2, 4, 4, 1>(x, wp, scales, out, ws, counters, M, K, N, w_rows, splits, fuse, s, resident);
  return launch_mma<WORDS, BITS, 4, 4, 2, 2>(x, wp, scales, out, ws, counters, M, K, N, w_rows, splits, fuse, s, resident);
}

// Entry shared by both C interfaces: WORDS selects the int32-word store
// (packed_gemm), else the int8 container (quant_gemm).  With splits > 1
// the caller hands in a zeroed int32 workspace of M*N and a zeroed counter
// per output tile (ceil(N/128) * ceil(M/rows a block)); with splits == 1
// both may be null.  `scales` is read only when `fuse`.  Launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
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
    case 2: return (int)launch_rows<WORDS, 2>(xp, w, sp, out, wsp, cp, M, K, N, w_rows, splits, f, s);
    case 4: return (int)launch_rows<WORDS, 4>(xp, w, sp, out, wsp, cp, M, K, N, w_rows, splits, f, s);
    case 8: return (int)launch_rows<WORDS, 8>(xp, w, sp, out, wsp, cp, M, K, N, w_rows, splits, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many blocks of the instance that M rows and `bits` select one SM of
// the current device holds at once (registers, shared memory, threads), into
// *blocks; returns the CUDA error code.  The host's split plan reads it.
template <bool WORDS>
int resident_blocks(int M, int bits, int* blocks) {
  const auto query = [&](auto fn) {
    return (int)fn(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M, 0, 0, 0, 1,
                       false, nullptr, blocks);
  };
  switch (bits) {
    case 2: return query(launch_rows<WORDS, 2>);
    case 4: return query(launch_rows<WORDS, 4>);
    case 8: return query(launch_rows<WORDS, 8>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace int_gemm
