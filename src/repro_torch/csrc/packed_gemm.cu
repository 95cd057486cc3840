// Fused unpack-and-contract GEMM over int32-word weight stores for Hopper
// (sm_90a): packed_gemm.
//
// Replaces the TPU kernel repro/kernels/packed_gemm.py:packed_gemm_kernel
// (pallas_call at packed_gemm.py:124), reached through packed_matmul over a
// core/packing.py PackedQuantized store:
//
//   x (M,K) int8  @  unpack_words(words) (K,N)  ->  (M,N) int32 or float32
//
// words is the (ceil(K/cpw), N) int32 store pack_codes emits, cpw = 32/bits
// codes a word, lane j of word r holding k = r*cpw + j (low lanes first);
// the padding lanes of the last word hold zero codes.  Neither the float
// weight nor the int8 code matrix ever exists in device memory: each K tile
// is sign-extended on its way into shared memory.  The kernel
// (int_gemm_kernel, dp4a), its bound and its split-K epilogue are in
// int_gemm.cuh, beside quant_gemm's tensor-core kernel.

#include "int_gemm.cuh"

// bits in {2, 4, 8}; w_rows = ceil(K / (32/bits)).  See int_gemm::launch for
// the workspace contract.
extern "C" int packed_gemm_launch(const void* x, const void* words,
                                  const void* scales, void* out, void* ws,
                                  void* counters, int M, int K, int N,
                                  int w_rows, int bits, int splits, int fuse,
                                  void* stream) {
  return int_gemm::launch<true>(x, words, scales, out, ws, counters, M, K, N,
                                w_rows, bits, splits, fuse, stream);
}
