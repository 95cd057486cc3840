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
// Layout of one block: a (BM x 128) output tile, BM = 8*TM, walked over K in
// tiles of 64.  Per K tile the A tile is decomposed ONCE into per-byte planes
// in shared memory (v1, v0, sign mask for tub; |a|, sign mask for tu), four
// consecutive k packed into one 32-bit word; the B tile is transposed on its
// way into shared memory so that each word holds four consecutive k of one
// column.  A slot's pulses for four k are then built with per-byte SIMD
// intrinsics and contracted with one dp4a per output column.
//
// What bounds it on an H100: at decode (M = 8) the weight codes, K*N bytes
// read once, i.e. memory; the design answers with coalesced row loads of B and
// a split of K across blockIdx.z (int32 atomicAdd is exact in any order) so
// that narrow N still fills the SMs.  At prefill (M = 512) or many slots (tu
// at 8 bits runs 128 slots) the dp4a throughput bounds it.
//
// Ragged M, N, K are masked in the loads and stores; there is no host padding.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int TM, int MODE>
__global__ void __launch_bounds__(NTHREADS)
unary_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int32_t* __restrict__ out, int M, int K, int N, int n_slots,
                  int k_per_split) {
  constexpr int BM = 8 * TM;
  // A planes, one word = four consecutive k of one row
  __shared__ uint32_t a_mag[BM][KW];   // tub: v1   | tu: |a|
  __shared__ uint32_t a_odd[BM][KW];   // tub: v0   | tu: unused
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
      if (MODE == MODE_TUB) {
        a_mag[r][kw] = (mag >> 1) & 0x7f7f7f7fu;  // v1 = |a| / 2
        a_odd[r][kw] = mag & 0x01010101u;         // v0 = |a| % 2
      } else {
        a_mag[r][kw] = mag;
      }
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
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      uint4 cols;
      cols.x = __byte_perm(t0, t1, 0x5410);
      cols.y = __byte_perm(t0, t1, 0x7632);
      cols.z = __byte_perm(t2, t3, 0x5410);
      cols.w = __byte_perm(t2, t3, 0x7632);
      *reinterpret_cast<uint4*>(&b_t[kw][4 * nq]) = cols;
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
        const uint32_t odd = (MODE == MODE_TUB) ? a_odd[r][kw] : 0u;
        for (int t = 0; t < n_slots; ++t) {
          const uint32_t tw = (uint32_t)t * 0x01010101u;
          uint32_t gate;
          if (MODE == MODE_TUB) {
            // weight-2 slots while t < v1; the odd bit rides slot 0
            gate = __vcmpgtu4(mag, tw) & 0x02020202u;
            if (t == 0) gate |= odd;
          } else {
            // one pulse while i < |a|
            gate = __vcmpgtu4(mag, tw) & 0x01010101u;
          }
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

template <int TM>
cudaError_t launch_tm(int mode, const int8_t* a, const int8_t* b, int32_t* out,
                      int M, int K, int N, int n_slots, int splits,
                      cudaStream_t stream) {
  constexpr int BM = 8 * TM;
  const int k_tiles = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > k_tiles) splits = k_tiles > 0 ? k_tiles : 1;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  const int k_per_split = (tiles_per_split > 0 ? tiles_per_split : 1) * BK;
  const int z = k_tiles > 0 ? (k_tiles + tiles_per_split - 1) / tiles_per_split : 1;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, z);
  if (mode == MODE_TUB)
    unary_gemm_kernel<TM, MODE_TUB><<<grid, NTHREADS, 0, stream>>>(
        a, b, out, M, K, N, n_slots, k_per_split);
  else
    unary_gemm_kernel<TM, MODE_TU><<<grid, NTHREADS, 0, stream>>>(
        a, b, out, M, K, N, n_slots, k_per_split);
  return cudaGetLastError();
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
  if (M <= 8) err = launch_tm<1>(mode, ap, bp, op, M, K, N, n_slots, splits, s);
  else if (M <= 16) err = launch_tm<2>(mode, ap, bp, op, M, K, N, n_slots, splits, s);
  else if (M <= 32) err = launch_tm<4>(mode, ap, bp, op, M, K, N, n_slots, splits, s);
  else err = launch_tm<8>(mode, ap, bp, op, M, K, N, n_slots, splits, s);
  return (int)err;
}
