// Packed int8-container GEMM for Hopper (sm_90a): quant_gemm.
//
// Replaces the TPU kernel repro/kernels/quant_gemm.py:quant_gemm_kernel
// (pallas_call at quant_gemm.py:125), the reference's "PE array stand-in"
// that every dense site of a cfg.quant_kernel model runs through
// ops.quantized_matmul:
//
//   x (M,K) int8  @  unpack(w_packed) (K,N)  ->  (M,N) int32 or float32
//
// w_packed is (K*bits/8, N) int8 with 8/bits consecutive k of one column in
// a byte, low nibble/crumb first (ops.pack_values).  The kernel
// (int_mma_kernel, on the int8 tensor cores), its bound and its split-K
// epilogue are in int_gemm.cuh, shared with packed_gemm.cu.

#include "int_gemm.cuh"

// bits in {2, 4, 8}; w_rows = K*bits/8.  See int_gemm::launch for the
// workspace contract.
extern "C" int quant_gemm_launch(const void* x, const void* w_packed,
                                 const void* scales, void* out, void* ws,
                                 void* counters, int M, int K, int N,
                                 int w_rows, int bits, int splits, int fuse,
                                 void* stream) {
  return int_gemm::launch<false>(x, w_packed, scales, out, ws, counters, M, K,
                                 N, w_rows, bits, splits, fuse, stream);
}

// How many blocks of the instance that M rows and `bits` select one SM of
// the current device holds at once (registers, shared memory, threads), into
// *blocks; returns the CUDA error code.  The host's split plan reads it.
extern "C" int quant_gemm_resident_blocks(int M, int bits, int* blocks) {
  return int_gemm::resident_blocks<false>(M, bits, blocks);
}
