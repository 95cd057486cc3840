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
// weight nor the int8 code matrix ever exists in device memory: each 64-k
// tile of words lands raw in shared memory and is unpacked there once into
// the A fragments of the int8 tensor cores.  The kernel (int_mma_kernel
// with WORDS = true, the template quant_gemm's int8 container runs on), its
// bound and its split-K epilogue are in int_gemm.cuh.

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

// How many blocks of the instance that M rows and `bits` select one SM of
// the current device holds at once, into *blocks; returns the CUDA error
// code.  The host's split plan reads it.
extern "C" int packed_gemm_resident_blocks(int M, int bits, int* blocks) {
  return int_gemm::resident_blocks<true>(M, bits, blocks);
}
