// Per-tile bit-sparsity statistics for Hopper (sm_90a): block_stats.
//
// Replaces the TPU kernel repro/kernels/bitsparsity.py:bitsparsity_kernel
// (pallas_call at bitsparsity.py:57), the input of the paper's Eq. 1:
//
//   q (M,N) int8 codes -> maxes, zeros: (ceil(M/32), ceil(N/32)) int32
//   maxes[i][j] = max |q| over the 32x32 tile (i, j)
//   zeros[i][j] = count of q == 0 in it; cells past M or N count as zeros
//                 (the caller subtracts them, as the reference's does)
//
// One block of 256 threads covers a 32-row x 128-column strip, four tiles:
// warp w reads rows w, w+8, w+16, w+24; lane l reads the four bytes of
// columns 4l .. 4l+3 (one 32-bit load when the row is aligned), so a warp
// reads 128 consecutive bytes of a row.  Per-byte |q| and zero tests, then a
// shuffle over the 8 lanes of a tile and a pass over the 8 warps in shared
// memory.  What bounds it: the M*N code bytes read once (memory); the TPU's
// (256, 128) block is a tiling detail of that machine and not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int STRIP = 128;      // columns per block: four tiles
constexpr int NTHREADS = 256;   // 8 warps

__global__ void __launch_bounds__(NTHREADS)
block_stats_kernel(const int8_t* __restrict__ q, int32_t* __restrict__ maxes,
                   int32_t* __restrict__ zeros, int M, int N, int n_tiles) {
  __shared__ int s_max[8][4];
  __shared__ int s_zero[8][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * STRIP + 4 * lane;
  const int r0 = blockIdx.y * TILE;
  const bool aligned = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(q) & 3) == 0);
  int mx = 0, nz = 0;   // max |q| and count of non-zero cells read
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int r = r0 + warp + 8 * i;
    if (r >= M) continue;
    const int8_t* row = q + (size_t)r * N;
    if (aligned && c0 + 3 < N) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(row + c0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int x = (int)(int8_t)(v >> (8 * b));
        mx = max(mx, abs(x));
        nz += x != 0;
      }
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (c0 + b >= N) break;
        const int x = row[c0 + b];
        mx = max(mx, abs(x));
        nz += x != 0;
      }
    }
  }
  // the 8 lanes of one tile: lanes 8t .. 8t+7
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    nz += __shfl_xor_sync(0xffffffffu, nz, off);
  }
  if ((lane & 7) == 0) {
    s_max[warp][lane >> 3] = mx;
    s_zero[warp][lane >> 3] = nz;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int t = threadIdx.x;
    const int tj = blockIdx.x * 4 + t;
    if (tj < n_tiles) {
      int m = 0, nonzero = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        m = max(m, s_max[w][t]);
        nonzero += s_zero[w][t];
      }
      const size_t o = (size_t)blockIdx.y * n_tiles + tj;
      maxes[o] = m;
      zeros[o] = TILE * TILE - nonzero;   // pad cells count as zeros
    }
  }
}

}  // namespace

// q (M,N) int8 row-major; maxes, zeros (ceil(M/32), ceil(N/32)) int32.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError().
extern "C" int block_stats_launch(const void* q, void* maxes, void* zeros,
                                  int M, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int n_tiles = (N + TILE - 1) / TILE;
  dim3 grid((N + STRIP - 1) / STRIP, (M + TILE - 1) / TILE);
  block_stats_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<int32_t*>(maxes),
      static_cast<int32_t*>(zeros), M, N, n_tiles);
  return (int)cudaGetLastError();
}
