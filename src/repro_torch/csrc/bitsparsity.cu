// Per-tile bit-sparsity statistics for Hopper (sm_90a): block_stats.
//
// Replaces the TPU kernel repro/kernels/bitsparsity.py:bitsparsity_kernel
// (pallas_call at bitsparsity.py:57), the input of the paper's Eq. 1:
//
//   q (M,N) int8 codes, tile T in {1, 2, 4, ..., 128} (every tile that
//   divides the reference's (256, 128) block) ->
//   maxes, zeros: (ceil(M/T), ceil(N/T)) int32
//   maxes[i][j] = max |q| over the T x T tile (i, j)
//   zeros[i][j] = count of q == 0 in it; cells past M or N count as zeros
//                 (the caller subtracts them, as the reference's does)
//   sums = [sum of maxes, sum of zeros] (int64), from the same launch
//
// What bounds it on an H100: the M*N code bytes, read once (memory).  The
// TPU walked (256, 128) blocks in a grid; here a grid of at most SMs x
// resident blocks walks the tiles in a loop, so a block's fixed cost is
// paid once and not per tile, and the tile's reduction stays in registers:
//  - T >= 16 (the paper's T = 32 on every path): one warp a block, tasks of
//    T rows x 256 columns.  Lane l owns the 16 columns 16 (l % 16) .. of the
//    task in rows l / 16, l / 16 + 2, ..., and reads them with 16-byte
//    non-coherent loads, 16 in flight (a T = 32 task in one round trip).
//    Per byte, |q| by the non-saturating __vabs4 (-128 stays 0x80, read
//    unsigned as 128; the saturating __vabsss4 would give 127) into an
//    unsigned __vmaxu4, and zeros by __vcmpeq4 + __popc.  The 2 T / 16 lanes
//    of a tile combine by shuffles: no shared memory, no barrier.  At most
//    16 blocks an SM.  (Timed on the H100 against tasks of T x 512 columns,
//    8 or 32 loads in flight, blocks of 1 to 8 warps and 8 to 32 blocks an
//    SM: this was fastest at the site shapes and level at (4096, 14336).)
//  - T <= 8: one thread a tile, byte loads (off every path).
// Rows past M and columns past N read as zero.  The two sums: each warp
// reduces its own and adds them with integer atomics (order-free) to a
// per-device accumulator `state`, then takes a ticket; the warp that draws
// the last ticket moves the totals into `sums` and zeroes `state` for the
// next launch.  So one launch, no memset, and launches that share `state`
// must be ordered (one stream a device).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;   // threads a block of the small-tile kernel
constexpr int CHUNKS = 16;      // 16-byte chunks across a warp's task
constexpr int STRIP = 16 * CHUNKS;   // columns of a warp's task
constexpr int GROUPS = 32 / CHUNKS;  // row groups: lane l reads rows l / CHUNKS + GROUPS i
constexpr int INFLIGHT = 16;    // 16-byte loads a lane keeps in flight
constexpr int VEC_BLOCKS_PER_SM = 16;   // one-warp blocks: more only add tail atomics
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// fold 16 code bytes into the lane's per-byte max |q| and zero-bit count
// (8 bits a zero byte)
__device__ __forceinline__ void fold(const uint4& v, uint32_t& mx, uint32_t& zbits) {
  mx = __vmaxu4(mx, __vabs4(v.x));
  mx = __vmaxu4(mx, __vabs4(v.y));
  mx = __vmaxu4(mx, __vabs4(v.z));
  mx = __vmaxu4(mx, __vabs4(v.w));
  zbits += __popc(__vcmpeq4(v.x, 0u)) + __popc(__vcmpeq4(v.y, 0u)) +
           __popc(__vcmpeq4(v.z, 0u)) + __popc(__vcmpeq4(v.w, 0u));
}

// 16 code bytes of row r from column c, byte by byte; past M or N, zero
__device__ __forceinline__ uint4 load16_edge(const int8_t* __restrict__ q, int M, int N, int r,
                                             int c) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};          // unrolled: stays in registers
  if (r < M && c < N) {
    const int8_t* p = q + (size_t)r * N + c;
    const int n = min(16, N - c);
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < n) w[b >> 2] |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The lanes' sums over the warp, into the accumulator state[0..1]; the warp
// that draws the last ticket (state[2]) publishes them and resets state.
// Every warp of the grid calls it once.
__device__ __forceinline__ void add_sums(unsigned long long* state, unsigned long long* sums,
                                         unsigned long long s_max, unsigned long long s_zero) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_max += __shfl_xor_sync(FULL, s_max, o);
    s_zero += __shfl_xor_sync(FULL, s_zero, o);
  }
  if ((threadIdx.x & 31) != 0) return;
  if (s_max | s_zero) {
    atomicAdd(state, s_max);
    atomicAdd(state + 1, s_zero);
  }
  __threadfence();
  const unsigned long long n_warps = (unsigned long long)gridDim.x * (blockDim.x / 32);
  if (atomicAdd(state + 2, 1ull) == n_warps - 1) {
    __threadfence();
    sums[0] = atomicExch(state, 0ull);
    sums[1] = atomicExch(state + 1, 0ull);
    atomicExch(state + 2, 0ull);
  }
}

// T >= 16: one warp a block, tasks of T rows x STRIP columns, row-tile major.
// `vec`: rows start 16-byte aligned (N % 16 == 0 and q aligned).
template <int T>
__global__ void __launch_bounds__(32)
block_stats_vec_kernel(const int8_t* __restrict__ q, int32_t* __restrict__ maxes,
                       int32_t* __restrict__ zeros, unsigned long long* __restrict__ state,
                       unsigned long long* __restrict__ sums, int M, int N, int tile_cols,
                       int strips, long long n_tasks, int vec) {
  constexpr int L = T / 16;                    // chunk columns a tile spans
  constexpr int R = T / GROUPS;                // rows a lane reads
  constexpr int INF = R < INFLIGHT ? R : INFLIGHT;
  static_assert(R % INF == 0 && L >= 1 && L <= CHUNKS, "tile");
  const int lane = threadIdx.x, cc = lane % CHUNKS, rg = lane / CHUNKS;
  unsigned long long s_max = 0, s_zero = 0;
  for (long long task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    const int tr = (int)(task / strips), r0 = tr * T;
    const int c = (int)(task % strips) * STRIP + cc * 16;
    uint32_t mx = 0u, zbits = 0u;
    if (vec && c + 16 <= N && r0 + T <= M) {
      const uint4* p = reinterpret_cast<const uint4*>(q + (size_t)(r0 + rg) * N + c);
      const size_t pitch = (size_t)N / 16 * GROUPS;   // uint4 between a lane's rows
#pragma unroll 1
      for (int i = 0; i < R; i += INF) {
        uint4 v[INF];
#pragma unroll
        for (int u = 0; u < INF; ++u) v[u] = __ldg(p + (size_t)(i + u) * pitch);
#pragma unroll
        for (int u = 0; u < INF; ++u) fold(v[u], mx, zbits);
      }
    } else {                                   // the ragged edge
#pragma unroll 1
      for (int i = 0; i < R; ++i) fold(load16_edge(q, M, N, r0 + rg + GROUPS * i, c), mx, zbits);
    }
    int m = (int)max(max(mx & 0xffu, (mx >> 8) & 0xffu), max((mx >> 16) & 0xffu, mx >> 24));
    int z = (int)(zbits >> 3);
    // the tile's lanes: chunk bits below L, and every row-group bit
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o >= L && o < CHUNKS) continue;
      m = max(m, __shfl_xor_sync(FULL, m, o));
      z += __shfl_xor_sync(FULL, z, o);
    }
    const int tc = c / T;
    if (rg == 0 && cc % L == 0 && tc < tile_cols) {
      const size_t o = (size_t)tr * tile_cols + tc;
      maxes[o] = m;
      zeros[o] = z;
      s_max += (unsigned)m;
      s_zero += (unsigned)z;
    }
  }
  add_sums(state, sums, s_max, s_zero);
}

// T <= 8: one thread a tile
__global__ void __launch_bounds__(NTHREADS)
block_stats_small_kernel(const int8_t* __restrict__ q, int32_t* __restrict__ maxes,
                         int32_t* __restrict__ zeros, unsigned long long* __restrict__ state,
                         unsigned long long* __restrict__ sums, int M, int N, int T,
                         int tile_cols, long long n_tiles) {
  unsigned long long s_max = 0, s_zero = 0;
  const long long stride = (long long)gridDim.x * NTHREADS;
  for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x; i < n_tiles; i += stride) {
    const int r0 = (int)(i / tile_cols) * T, c0 = (int)(i % tile_cols) * T;
    int m = 0, z = 0;
    for (int r = r0; r < r0 + T; ++r)
      for (int c = c0; c < c0 + T; ++c) {
        const int x = (r < M && c < N) ? (int)__ldg(q + (size_t)r * N + c) : 0;
        m = max(m, abs(x));
        z += x == 0;
      }
    maxes[i] = m;
    zeros[i] = z;
    s_max += (unsigned)m;
    s_zero += (unsigned)z;
  }
  add_sums(state, sums, s_max, s_zero);
}

// Blocks of `kernel` the current device holds at once (its SMs x the blocks
// one SM holds, at most `cap`), asked of the occupancy calculator once a
// device.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int threads, int cap, int (&cache)[MAX_DEVICES],
                        int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return e;
    cache[dev] = sms * (per_sm < 1 ? 1 : per_sm < cap ? per_sm : cap);
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

long long grid_size(long long work_blocks, int wave) {
  return work_blocks < wave ? work_blocks : wave;
}

template <int T>
cudaError_t launch_vec(const int8_t* q, int32_t* maxes, int32_t* zeros,
                       unsigned long long* state, unsigned long long* sums, int M, int N,
                       int tile_rows, int tile_cols, cudaStream_t stream) {
  static int cache[MAX_DEVICES] = {};
  int wave = 0;
  cudaError_t e = wave_blocks(block_stats_vec_kernel<T>, 32, VEC_BLOCKS_PER_SM, cache, &wave);
  if (e != cudaSuccess) return e;
  const int strips = (N + STRIP - 1) / STRIP;
  const long long n_tasks = (long long)tile_rows * strips;
  const int vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  block_stats_vec_kernel<T><<<(unsigned)grid_size(n_tasks, wave), 32, 0, stream>>>(
      q, maxes, zeros, state, sums, M, N, tile_cols, strips, n_tasks, vec);
  return cudaGetLastError();
}

cudaError_t launch_small(const int8_t* q, int32_t* maxes, int32_t* zeros,
                         unsigned long long* state, unsigned long long* sums, int M, int N,
                         int T, int tile_rows, int tile_cols, cudaStream_t stream) {
  static int cache[MAX_DEVICES] = {};
  int wave = 0;
  cudaError_t e = wave_blocks(block_stats_small_kernel, NTHREADS, 2048 / NTHREADS, cache, &wave);
  if (e != cudaSuccess) return e;
  const long long n_tiles = (long long)tile_rows * tile_cols;
  const long long grid = grid_size((n_tiles + NTHREADS - 1) / NTHREADS, wave);
  block_stats_small_kernel<<<(unsigned)grid, NTHREADS, 0, stream>>>(q, maxes, zeros, state, sums,
                                                                     M, N, T, tile_cols, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// q (M,N) int8 row-major; maxes, zeros (ceil(M/tile), ceil(N/tile)) int32;
// sums (2,) int64 written; state (3,) int64, zero before the launch and
// left zero after it (the caller keeps one a device, and orders the
// launches that share it).  tile a power of two from 1 to 128.  Launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
extern "C" int block_stats_launch(const void* q, void* maxes, void* zeros, void* state,
                                  void* sums, int M, int N, int tile, void* stream) {
  if (tile < 1 || tile > 128 || (tile & (tile - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  int32_t* mp = static_cast<int32_t*>(maxes);
  int32_t* zp = static_cast<int32_t*>(zeros);
  unsigned long long* st = static_cast<unsigned long long*>(state);
  unsigned long long* sp = static_cast<unsigned long long*>(sums);
  const int tile_rows = (M + tile - 1) / tile, tile_cols = (N + tile - 1) / tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return (int)launch_vec<16>(qp, mp, zp, st, sp, M, N, tile_rows, tile_cols, s);
    case 32: return (int)launch_vec<32>(qp, mp, zp, st, sp, M, N, tile_rows, tile_cols, s);
    case 64: return (int)launch_vec<64>(qp, mp, zp, st, sp, M, N, tile_rows, tile_cols, s);
    case 128: return (int)launch_vec<128>(qp, mp, zp, st, sp, M, N, tile_rows, tile_cols, s);
    default: return (int)launch_small(qp, mp, zp, st, sp, M, N, tile, tile_rows, tile_cols, s);
  }
}
