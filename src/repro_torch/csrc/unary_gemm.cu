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
// Both designs run on the int8 tensor cores, as instances of one kernel,
// unary_mma_kernel, whose pulse builder is a template parameter (TuPulses,
// TubPulses).  A k-packed word is exactly an s8 fragment register of
// mma.sync.m16n8k32 (mma_int8.cuh), so every slot is one mma per fragment
// pair with exact int32 accumulation.  The kernel computes
// out^T = B^T . pulses^T: the mma's 16-row side takes 16 output columns and
// its 8-column side 8 rows of A, so a decode step's 8 rows waste nothing.
// A block walks a (BM x 128) output tile over K in tiles of 64.  B arrives
// through a four-stage ring of 16-byte cp.async copies; each tile is
// transposed once into shared memory (each 32-bit word four consecutive k of
// one column, a 4 x 4 byte transpose through __byte_perm), and its fragments
// are read once per 32 k and reused by every slot.  The A tile is decomposed
// once per K tile into the policy's pulse planes.
//
// What bounds it on an H100: at decode (M = 8) the weight codes, K*N bytes
// read once, i.e. memory; K is split across blockIdx.z (int32 atomicAdd is
// exact in any order) so that narrow N still fills the SMs.  At prefill
// (M = 512) or many slots (tu at 8 bits runs 128 slots) the int8 tensor-core
// rate on the slot schedule bounds it: n_slots * 2*M*K*N operations.
//
// Ragged M, N, K are masked in the loads and stores; there is no host padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"   // word loads, byte transpose, mma.m16n8k32 (+ cp.async)

namespace {

using namespace mma_int8;

constexpr int BN = 128;                      // output columns per block
constexpr int BK = 64;                       // k per shared-memory tile
constexpr int KW = BK / 4;                   // k words per tile
constexpr int MMA_NT = 128;                  // 4 warps
constexpr int STAGES = 4;                    // B tiles in the cp.async ring
constexpr int BT_PITCH = BN + 8;             // words: fragment loads hit 32 banks
constexpr int PL_PITCH = KW + 4;             // words: likewise

constexpr int MODE_TUB = 0;
constexpr int MODE_TU = 1;

// A pulse builder turns a word of four codes into PLANES plane words once
// per K tile (`planes`), and each slot's plane words into that slot's pulse
// word, four int8 pulses (`pulses`, `slot` = the slot number in every byte,
// slot * 0x01010101).  With FIRST set, slot 0 takes `first` instead.
//
// |a| per byte, in both builders: (a ^ neg) + (neg & 1), with neg = 0xff
// where a < 0.  The xor leaves at most 0x7f in a negative byte, so the +1
// never carries, and -128 stays magnitude 128 (no saturation).

// tuGEMM's pulse builder.  Planes: |a| + 127 per byte (at most 255: no
// carry between bytes) and sign(a) as an int8 (+1 or -1).  For slot i,
// |a| + 127 - i has bit 7 set exactly when i < |a| (and never borrows, since
// i <= 127), so the pulse word [i < |a|] * sign(a) is three instructions.
// A zero code gives no pulse in any slot.
struct TuPulses {
  static constexpr int PLANES = 2;
  static constexpr bool FIRST = false;
  __device__ static void planes(uint32_t a, uint32_t (&p)[PLANES]) {
    const uint32_t neg = byte_signs(a);                        // 0xff where a < 0
    p[0] = (a ^ neg) + (neg & 0x01010101u) + 0x7f7f7f7fu;     // |a| + 127
    p[1] = neg | 0x01010101u;                                  // sign(a)
  }
  __device__ static uint32_t pulses(const uint32_t (&p)[PLANES], uint32_t slot) {
    return byte_signs(p[0] - slot) & p[1];
  }
};

// tubGEMM's pulse builder, |a| = 2 v1 + v0.  Planes: v1 + 127 per byte (v1
// <= 64, so at most 191: no carry), 2 sign(a) as an int8 (+2 or -2), and the
// whole slot-0 pulse word (2 [v1 > 0] + v0) sign(a), in -3..3 per byte.  For
// slot t >= 1 (t <= 63), v1 + 127 - t has bit 7 set exactly when t < v1, as
// in tu, so a later slot's pulse word is three instructions too.
struct TubPulses {
  static constexpr int PLANES = 3;
  static constexpr bool FIRST = true;
  __device__ static void planes(uint32_t a, uint32_t (&p)[PLANES]) {
    const uint32_t neg = byte_signs(a);                        // 0xff where a < 0
    const uint32_t mag = (a ^ neg) + (neg & 0x01010101u);     // |a|
    const uint32_t v1 = (mag >> 1) & 0x7f7f7f7fu;
    p[0] = v1 + 0x7f7f7f7fu;                                   // v1 + 127
    p[1] = __vsub4(0x02020202u ^ neg, neg);                    // 2 sign(a)
    // slot 0: the weight-2 pulse while 0 < v1, plus the odd bit v0, signed
    // per byte as (g ^ neg) - neg
    const uint32_t gate = (__vcmpgtu4(v1, 0u) & 0x02020202u) | (mag & 0x01010101u);
    p[2] = __vsub4(gate ^ neg, neg);
  }
  __device__ static uint32_t pulses(const uint32_t (&p)[PLANES], uint32_t slot) {
    return byte_signs(p[0] - slot) & p[1];
  }
  __device__ static uint32_t first(const uint32_t (&p)[PLANES]) { return p[2]; }
};

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
            load_word(b, kt + r, n0 + col, k_end, N, N, b_aligned);
      }
    }
  };
  uint32_t a_next[A_WORDS];                    // the next A tile, in flight

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) fill_b(st);
    cp_async_commit();
  }
  if (n_tiles > 0) load_tile_words<A_WORDS, MMA_NT, KW>(a_next, a, m0, k_begin, M, K, k_end, a_aligned);

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
      load_tile_words<A_WORDS, MMA_NT, KW>(a_next, a, m0, k_begin + (it + 1) * BK, M, K, k_end, a_aligned);
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
      int slot = 0;
      if constexpr (Pulses::FIRST) {         // slot 0 from its own plane
#pragma unroll
        for (int j = 0; j < WM; ++j) {
          const uint32_t b0 = Pulses::first(pw[j][0]), b1 = Pulses::first(pw[j][1]);
#pragma unroll
          for (int i = 0; i < WN; ++i) mma_16832(acc[i][j], af[i], b0, b1);
        }
        slot = 1;
      }
      for (; slot < n_slots; ++slot) {
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
  const int kps = k_slice(K, BK, splits, z);
  const int b_vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  kernel<<<grid, MMA_NT, smem, stream>>>(a, b, out, M, K, N, n_slots, kps, b_vec);
  return cudaGetLastError();
}

// The design's instance for M rows: 8, 16, 32 or 64 rows a block
template <class Pulses>
cudaError_t launch_rows(const int8_t* a, const int8_t* b, int32_t* out, int M, int K, int N,
                        int n_slots, int splits, cudaStream_t s, int* resident) {
  if (M <= 8) return launch_mma<Pulses, 2, 1, 4, 1>(a, b, out, M, K, N, n_slots, splits, s, resident);
  if (M <= 16) return launch_mma<Pulses, 2, 2, 4, 1>(a, b, out, M, K, N, n_slots, splits, s, resident);
  if (M <= 32) return launch_mma<Pulses, 2, 4, 4, 1>(a, b, out, M, K, N, n_slots, splits, s, resident);
  return launch_mma<Pulses, 4, 4, 2, 2>(a, b, out, M, K, N, n_slots, splits, s, resident);
}

cudaError_t launch(int mode, const int8_t* a, const int8_t* b, int32_t* out, int M, int K,
                   int N, int n_slots, int splits, cudaStream_t s, int* resident) {
  if (mode == MODE_TUB)
    return launch_rows<TubPulses>(a, b, out, M, K, N, n_slots, splits, s, resident);
  if (mode == MODE_TU)
    return launch_rows<TuPulses>(a, b, out, M, K, N, n_slots, splits, s, resident);
  return cudaErrorInvalidValue;
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
  if (n_slots < 1 || n_slots > 128) return (int)cudaErrorInvalidValue;
  return (int)launch(mode, static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                     static_cast<int32_t*>(out), M, K, N, n_slots, splits,
                     static_cast<cudaStream_t>(stream), nullptr);
}

// How many blocks of the instance that `mode` and M rows select one SM of
// the current device holds at once (registers, shared memory, threads), into
// *blocks; returns the CUDA error code.  The host's split plan reads it.
extern "C" int unary_resident_blocks(int mode, int M, int* blocks) {
  return (int)launch(mode, nullptr, nullptr, nullptr, M, 0, 0, 1, 1, nullptr, blocks);
}
