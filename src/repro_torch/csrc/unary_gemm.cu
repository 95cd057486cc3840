// Temporal-unary slot-loop GEMMs for Hopper (sm_90a): tubGEMM and tuGEMM.
//
// Replaces the TPU kernels repro/kernels/unary_gemm.py:tub_gemm_kernel and
// tu_gemm_kernel.  (M,K) int8 w-bit codes x (K,N) int8 -> (M,N) int32,
// bit-identical to an integer GEMM, but executed on the unit's slot schedule:
//
//   tubGEMM: |a| = 2*v1 + v0; slot t of 2^(w-2) adds
//            ((2*[t < v1] + [t == 0]*v0) * sign(a)) * b
//   tuGEMM : slot i of 2^(w-1) adds ([i < |a|] * sign(a)) * b
//
// The slot loop is literal: every slot forms its pulse operand and executes its
// own multiply-accumulate; nothing collapses the slots into one a*b product.
//
// Both kernels walk a (BM x 128) output tile over K in tiles of 64 and keep
// B transposed in shared memory, each 32-bit word holding four consecutive k
// of one column (a 4 x 4 byte transpose through __byte_perm).  Two designs:
//
//  - tubGEMM, unary_gemm_kernel (CUDA cores): per K tile the A tile is
//    decomposed ONCE into per-byte planes in shared memory (v1, v0, sign
//    mask); a slot's pulses for four k are built with per-byte SIMD
//    intrinsics and contracted with one dp4a per output column.
//  - tuGEMM, unary_mma_kernel (int8 tensor cores): a k-packed word is
//    exactly an s8 fragment register of mma.sync.m16n8k32, so every slot is
//    one mma per fragment pair with exact int32 accumulation.  It computes
//    out^T = B^T . pulses^T: the mma's 16-row side takes 16 output columns
//    and its 8-column side 8 rows of A, so a decode step's 8 rows waste
//    nothing.  B arrives through a four-stage ring of 16-byte cp.async
//    copies; each tile is transposed once into shared memory, and its
//    fragments are read once per 32 k and reused by every slot.  The pulse
//    builder is a template parameter (TuPulses), so tub's can plug in later.
//
// What bounds it on an H100: at decode (M = 8) the weight codes, K*N bytes
// read once, i.e. memory; K is split across blockIdx.z (int32 atomicAdd is
// exact in any order) so that narrow N still fills the SMs.  At prefill
// (M = 512) or many slots (tu at 8 bits runs 128 slots) the multiply rate
// bounds it: dp4a for tub, the int8 tensor cores for tu.
//
// Ragged M, N, K are masked in the loads and stores; there is no host padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"   // cp.async helpers

namespace {

constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // k per shared-memory tile
constexpr int KW = BK / 4;     // k words per tile
constexpr int NTHREADS = 256;  // 32 column-quads x 8 row groups

constexpr int MODE_TUB = 0;
constexpr int MODE_TU = 1;

__device__ __forceinline__ uint32_t load_a_word(const int8_t* __restrict__ a,
                                                int m, int k, int M, int K,
                                                int k_end, bool aligned) {
  // four consecutive k of row m, zero outside [0,M) x [.., k_end)
  if (m >= M) return 0u;
  const int8_t* p = a + (size_t)m * K + k;
  if (aligned && k + 3 < k_end) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < k_end) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return w;
}

__device__ __forceinline__ uint32_t load_b_word(const int8_t* __restrict__ b,
                                                int k, int n, int N, int k_end,
                                                bool aligned) {
  // four consecutive n of row k, zero outside
  if (k >= k_end || n >= N) return 0u;
  const int8_t* p = b + (size_t)k * N + n;
  if (aligned && n + 3 < N) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return w;
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

// tubGEMM on the CUDA cores
template <int TM>
__global__ void __launch_bounds__(NTHREADS)
unary_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int32_t* __restrict__ out, int M, int K, int N, int n_slots,
                  int k_per_split) {
  constexpr int BM = 8 * TM;
  // A planes, one word = four consecutive k of one row
  __shared__ uint32_t a_mag[BM][KW];   // v1
  __shared__ uint32_t a_odd[BM][KW];   // v0
  __shared__ uint32_t a_neg[BM][KW];   // 0xff where a < 0
  // B transposed: b_t[kw][n] = four consecutive k of column n
  __shared__ __align__(16) uint32_t b_t[KW][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 31;   // column quad: columns 4*tx .. 4*tx+3
  const int ty = tid >> 5;   // row group: rows ty*TM .. ty*TM+TM-1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  const bool a_aligned = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a) & 3) == 0);
  const bool b_aligned = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(b) & 3) == 0);

  int32_t acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    // ---- A tile: decompose once per K tile into the per-byte planes ----
    for (int idx = tid; idx < BM * KW; idx += NTHREADS) {
      const int r = idx / KW, kw = idx % KW;
      const uint32_t w = load_a_word(a, m0 + r, kt + 4 * kw, M, K, k_end, a_aligned);
      const uint32_t neg = __vcmplts4(w, 0u);   // 0xff where the byte is < 0
      const uint32_t mag = __vabs4(w);          // |a| per byte (128 stays 128)
      a_mag[r][kw] = (mag >> 1) & 0x7f7f7f7fu;  // v1 = |a| / 2
      a_odd[r][kw] = mag & 0x01010101u;         // v0 = |a| % 2
      a_neg[r][kw] = neg;
    }
    // ---- B tile: 4(k) x 4(n) byte blocks, transposed into k-packed words ----
    for (int blk = tid; blk < KW * (BN / 4); blk += NTHREADS) {
      const int kw = blk / (BN / 4), nq = blk % (BN / 4);
      const int k = kt + 4 * kw, n = n0 + 4 * nq;
      const uint32_t r0 = load_b_word(b, k + 0, n, N, k_end, b_aligned);
      const uint32_t r1 = load_b_word(b, k + 1, n, N, k_end, b_aligned);
      const uint32_t r2 = load_b_word(b, k + 2, n, N, k_end, b_aligned);
      const uint32_t r3 = load_b_word(b, k + 3, n, N, k_end, b_aligned);
      *reinterpret_cast<uint4*>(&b_t[kw][4 * nq]) = transpose4x4(r0, r1, r2, r3);
    }
    __syncthreads();

    // ---- the slot schedule ----
#pragma unroll 2
    for (int kw = 0; kw < KW; ++kw) {
      const uint4 bc = *reinterpret_cast<const uint4*>(&b_t[kw][4 * tx]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const uint32_t mag = a_mag[r][kw];
        const uint32_t neg = a_neg[r][kw];
        const uint32_t odd = a_odd[r][kw];
        for (int t = 0; t < n_slots; ++t) {
          const uint32_t tw = (uint32_t)t * 0x01010101u;
          // weight-2 slots while t < v1; the odd bit rides slot 0
          uint32_t gate = __vcmpgtu4(mag, tw) & 0x02020202u;
          if (t == 0) gate |= odd;
          // apply the sign per byte: (g ^ neg) - neg
          const int pulse = (int)__vsub4(gate ^ neg, neg);
          acc[i][0] = __dp4a(pulse, (int)bc.x, acc[i][0]);
          acc[i][1] = __dp4a(pulse, (int)bc.y, acc[i][1]);
          acc[i][2] = __dp4a(pulse, (int)bc.z, acc[i][2]);
          acc[i][3] = __dp4a(pulse, (int)bc.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: masked store, or exact int32 atomics under split-K ----
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      int32_t* dst = out + (size_t)m * N + n;
      if (split) atomicAdd(dst, acc[i][j]);
      else *dst = acc[i][j];
    }
  }
}

// the K splits: `splits` (clamped to [1, k_tiles]) slices of whole 64-wide
// K tiles; returns the k per slice and sets `z` to the number of slices
int k_slice(int K, int splits, int& z) {
  const int k_tiles = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > k_tiles) splits = k_tiles > 0 ? k_tiles : 1;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  z = k_tiles > 0 ? (k_tiles + tiles_per_split - 1) / tiles_per_split : 1;
  return (tiles_per_split > 0 ? tiles_per_split : 1) * BK;
}

template <int TM>
cudaError_t launch_tub(const int8_t* a, const int8_t* b, int32_t* out, int M, int K, int N,
                       int n_slots, int splits, cudaStream_t stream) {
  constexpr int BM = 8 * TM;
  int z;
  const int kps = k_slice(K, splits, z);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  unary_gemm_kernel<TM><<<grid, NTHREADS, 0, stream>>>(a, b, out, M, K, N, n_slots, kps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tuGEMM on the int8 tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;                  // 4 warps
constexpr int STAGES = 4;                    // B tiles in the cp.async ring
constexpr int BT_PITCH = BN + 8;             // words: fragment loads hit 32 banks
constexpr int PL_PITCH = KW + 4;             // words: likewise

// 0xff in each byte whose bit 7 is set, else 0x00 (prmt's sign-replicate mode)
__device__ __forceinline__ uint32_t byte_signs(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %1, 0xBA98;\n" : "=r"(r) : "r"(x));
  return r;
}

// tuGEMM's pulse builder.  Planes of a word of four codes: |a| + 127 per
// byte (at most 255: no carry between bytes) and sign(a) as an int8 (+1 or
// -1).  For slot i, |a| + 127 - i has bit 7 set exactly when i < |a| (and
// never borrows, since i <= 127), so the pulse word [i < |a|] * sign(a) is
// three instructions.  A zero code gives no pulse in any slot.
struct TuPulses {
  static constexpr int PLANES = 2;
  __device__ static void planes(uint32_t a, uint32_t (&p)[PLANES]) {
    const uint32_t neg = byte_signs(a);                        // 0xff where a < 0
    p[0] = (a ^ neg) + (neg & 0x01010101u) + 0x7f7f7f7fu;     // |a| + 127
    p[1] = neg | 0x01010101u;                                  // sign(a)
  }
  // `slot` is i in every byte (i * 0x01010101)
  __device__ static uint32_t pulses(const uint32_t (&p)[PLANES], uint32_t slot) {
    return byte_signs(p[0] - slot) & p[1];
  }
};

// d += a . b on the tensor cores: (16 x 32 s8) x (32 x 8 s8) -> 16 x 8 s32, exact.
// Fragments (lane = 4 g + t), each register four consecutive k, low byte first:
//   a0 (row g, k 4t..)  a1 (row g+8, k 4t..)  a2 (row g, k 16+4t..)  a3 (row g+8, k 16+4t..)
//   b0 (column g, k 4t..)  b1 (column g, k 16+4t..)
//   d0, d1 (row g, columns 2t, 2t+1)  d2, d3 (row g+8, columns 2t, 2t+1)
__device__ __forceinline__ void mma_16832(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A words idx = threadIdx.x + i * MMA_NT (row idx / KW, k word idx % KW) of
// the K tile at kt
template <int A_WORDS>
__device__ __forceinline__ void load_a_tile(uint32_t (&w)[A_WORDS], const int8_t* __restrict__ a,
                                            int m0, int kt, int M, int K, int k_end,
                                            bool aligned) {
#pragma unroll
  for (int i = 0; i < A_WORDS; ++i) {
    const int idx = threadIdx.x + i * MMA_NT;
    w[i] = load_a_word(a, m0 + idx / KW, kt + 4 * (idx % KW), M, K, k_end, aligned);
  }
}

// One block: BN = 128 output columns x BM = WARPS_M * WM * 8 rows; warp w
// owns WN 16-column tiles x WM 8-row tiles of out^T.  Per K tile of 64:
// the raw B tile (landed by cp.async, STAGES - 1 tiles ahead) is transposed
// into bt, the A tile (loaded into registers one tile ahead) is decomposed
// into the pulse planes, and then, per 32 k, every slot's pulses are built
// in registers and contracted with the B fragments on the tensor cores.
// smem: raw [STAGES][BK][BN] bytes, bt [KW][BT_PITCH] words,
//       planes [PLANES][BM][PL_PITCH] words
template <class Pulses, int WN, int WM, int WARPS_N, int WARPS_M>
__global__ void __launch_bounds__(MMA_NT)
unary_mma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int32_t* __restrict__ out, int M, int K, int N, int n_slots, int k_per_split,
                 int b_vec) {
  using namespace mma_bf16;
  constexpr int BM = WARPS_M * WM * 8, NPL = Pulses::PLANES;
  constexpr int A_WORDS = BM * KW / MMA_NT;    // A words a thread loads per K tile
  static_assert(WARPS_N * WARPS_M * 32 == MMA_NT && WARPS_N * WN * 16 == BN, "tile shape");
  static_assert((BM * KW) % MMA_NT == 0 && BK % 32 == 0, "whole words per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;
  uint32_t* bt = reinterpret_cast<uint32_t*>(raw + STAGES * BK * BN);
  uint32_t* pl = bt + KW * BT_PITCH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = (warp % WARPS_N) * WN * 16, wm = (warp / WARPS_N) * WM * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const bool a_aligned = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a) & 3) == 0);
  const bool b_aligned = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(b) & 3) == 0);

  // raw B tile `it` into its ring stage: 16-byte cp.async when the rows are
  // 16-byte aligned (b_vec: N % 16 == 0), else plain word loads
  auto fill_b = [&](int it) {
    unsigned char* dst = raw + (it % STAGES) * BK * BN;
    const int kt = k_begin + it * BK;
    if (b_vec) {
#pragma unroll
      for (int i = 0; i < BK * BN / 16 / MMA_NT; ++i) {
        const int c = tid + i * MMA_NT, r = c / (BN / 16), col = (c % (BN / 16)) * 16;
        const bool ok = kt + r < k_end && n0 + col < N;
        cp_async_16(dst + r * BN + col, ok ? b + (size_t)(kt + r) * N + n0 + col : b, ok);
      }
    } else {
      for (int w = tid; w < BK * BN / 4; w += MMA_NT) {
        const int r = w / (BN / 4), col = (w % (BN / 4)) * 4;
        *reinterpret_cast<uint32_t*>(dst + r * BN + col) =
            load_b_word(b, kt + r, n0 + col, N, k_end, b_aligned);
      }
    }
  };
  uint32_t a_next[A_WORDS];                    // the next A tile, in flight

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) fill_b(st);
    cp_async_commit();
  }
  if (n_tiles > 0) load_a_tile<A_WORDS>(a_next, a, m0, k_begin, M, K, k_end, a_aligned);

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
    if (it + STAGES - 1 < n_tiles) fill_b(it + STAGES - 1);
    cp_async_commit();
    const uint32_t* src = reinterpret_cast<const uint32_t*>(raw + (it % STAGES) * BK * BN);
#pragma unroll
    for (int i = 0; i < KW * (BN / 4) / MMA_NT; ++i) {
      const int blk = tid + i * MMA_NT, kw = blk / (BN / 4), nq = blk % (BN / 4);
      const uint32_t* s4 = src + kw * BN + nq;  // row 4 kw, columns 4 nq..4 nq + 3
      *reinterpret_cast<uint4*>(bt + kw * BT_PITCH + 4 * nq) =
          transpose4x4(s4[0], s4[BN / 4], s4[BN / 2], s4[3 * BN / 4]);
    }
#pragma unroll
    for (int i = 0; i < A_WORDS; ++i) {
      const int idx = tid + i * MMA_NT;
      uint32_t p[NPL];
      Pulses::planes(a_next[i], p);
#pragma unroll
      for (int j = 0; j < NPL; ++j) pl[(j * BM + idx / KW) * PL_PITCH + idx % KW] = p[j];
    }
    if (it + 1 < n_tiles)                    // lands under this tile's products
      load_a_tile<A_WORDS>(a_next, a, m0, k_begin + (it + 1) * BK, M, K, k_end, a_aligned);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // A = B^T: 16 output columns x 32 k per tile, read once for every slot
      uint32_t af[WN][4];
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const uint32_t* p0 = bt + (ks * 8 + t) * BT_PITCH + wn + i * 16 + g;
        af[i][0] = p0[0];
        af[i][1] = p0[8];
        af[i][2] = p0[4 * BT_PITCH];
        af[i][3] = p0[4 * BT_PITCH + 8];
      }
      // the planes of B = pulses^T: 32 k x 8 rows of A per tile
      uint32_t pw[WM][2][NPL];
#pragma unroll
      for (int j = 0; j < WM; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < NPL; ++q)
            pw[j][h][q] = pl[(q * BM + wm + j * 8 + g) * PL_PITCH + ks * 8 + 4 * h + t];
      // the slot schedule: each slot its own pulses and its own products
      for (int slot = 0; slot < n_slots; ++slot) {
        const uint32_t sw = (uint32_t)slot * 0x01010101u;
#pragma unroll
        for (int j = 0; j < WM; ++j) {
          const uint32_t b0 = Pulses::pulses(pw[j][0], sw), b1 = Pulses::pulses(pw[j][1], sw);
#pragma unroll
          for (int i = 0; i < WN; ++i) mma_16832(acc[i][j], af[i], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();                        // no copy outlives the block

  // acc[i][j][e] is out[m][n] for n = wn + 16 i + g (+ 8 for e >= 2) and
  // m = wm + 8 j + 2 t (+ 1 for odd e); exact int32 atomics under split-K
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
        int32_t* dst = out + (size_t)m * N + n;
        if (split) atomicAdd(dst, acc[i][j][e]);
        else *dst = acc[i][j][e];
      }
}

// Launches the instance, or, with `resident` set, launches nothing and
// stores how many of its blocks one SM holds at once.
template <class Pulses, int WN, int WM, int WARPS_N, int WARPS_M>
cudaError_t launch_mma(const int8_t* a, const int8_t* b, int32_t* out, int M, int K, int N,
                       int n_slots, int splits, cudaStream_t stream, int* resident) {
  constexpr int BM = WARPS_M * WM * 8;
  constexpr size_t smem = (size_t)STAGES * BK * BN +
                          sizeof(uint32_t) * ((size_t)KW * BT_PITCH +
                                              (size_t)Pulses::PLANES * BM * PL_PITCH);
  auto kernel = unary_mma_kernel<Pulses, WN, WM, WARPS_N, WARPS_M>;
  static bool ready = false;
  if (!ready && smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ready = true;
  if (resident) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, MMA_NT, smem);
  int z;
  const int kps = k_slice(K, splits, z);
  const int b_vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  kernel<<<grid, MMA_NT, smem, stream>>>(a, b, out, M, K, N, n_slots, kps, b_vec);
  return cudaGetLastError();
}

// tuGEMM's instance for M rows: rows per block 8, 16, 32, 64 as tub's
cudaError_t launch_tu(const int8_t* a, const int8_t* b, int32_t* out, int M, int K, int N,
                      int n_slots, int splits, cudaStream_t s, int* resident) {
  if (M <= 8) return launch_mma<TuPulses, 2, 1, 4, 1>(a, b, out, M, K, N, n_slots, splits, s, resident);
  if (M <= 16) return launch_mma<TuPulses, 2, 2, 4, 1>(a, b, out, M, K, N, n_slots, splits, s, resident);
  if (M <= 32) return launch_mma<TuPulses, 2, 4, 4, 1>(a, b, out, M, K, N, n_slots, splits, s, resident);
  return launch_mma<TuPulses, 4, 4, 2, 2>(a, b, out, M, K, N, n_slots, splits, s, resident);
}

}  // namespace

// mode: 0 = tubGEMM, 1 = tuGEMM.  With splits > 1 the caller must hand in a
// zeroed `out` (the K splits accumulate into it with atomicAdd); with
// splits == 1 `out` may be uninitialised (splits is only ever clamped
// down, to the number of K tiles).  Launches on `stream`, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
extern "C" int unary_gemm_launch(int mode, const void* a, const void* b,
                                 void* out, int M, int K, int N, int n_slots,
                                 int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (mode != MODE_TUB && mode != MODE_TU) return (int)cudaErrorInvalidValue;
  if (n_slots < 1 || n_slots > 128) return (int)cudaErrorInvalidValue;
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == MODE_TUB) {
    if (M <= 8) err = launch_tub<1>(ap, bp, op, M, K, N, n_slots, splits, s);
    else if (M <= 16) err = launch_tub<2>(ap, bp, op, M, K, N, n_slots, splits, s);
    else if (M <= 32) err = launch_tub<4>(ap, bp, op, M, K, N, n_slots, splits, s);
    else err = launch_tub<8>(ap, bp, op, M, K, N, n_slots, splits, s);
  } else {
    err = launch_tu(ap, bp, op, M, K, N, n_slots, splits, s, nullptr);
  }
  return (int)err;
}

// How many blocks of the tuGEMM instance that M rows select one SM of the
// current device holds at once (registers, shared memory, threads), into
// *blocks; returns the CUDA error code.  The host's split plan reads it.
extern "C" int unary_tu_resident_blocks(int M, int* blocks) {
  return (int)launch_tu(nullptr, nullptr, nullptr, M, 0, 0, 1, 1, nullptr, blocks);
}
