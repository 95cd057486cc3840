// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py: _fwd_kernel
// (pallas_call at :95), _dq_kernel (:230) and _dkv_kernel (:248).  q (BH,Sq,D),
// k and v (BH,Skv,D), all float32 or all bfloat16, rows of D contiguous and
// each (S,D) slab at its own stride; D in {16, 32, 64, 128}.  Scores are
// q.k in fp32, times `scale`, -1e30 where a key is masked (causal: qpos >=
// kpos, both counted from 0; and every key at or past Skv); fp32 online
// softmax; P is rounded to the operands' type before P.V, dS before dS.K and
// dS^T.Q, P before P^T.dO -- the reference's rounding points.  The forward
// writes o in the operands' type and lse = m + log(max(l, 1e-30)) in fp32.
//
// The TPU grid walked its last axis in order and carried the running state
// in VMEM scratch between grid steps.  Here one block of 256 threads owns one
// (slab, 64-row tile) and LOOPS over the other axis, with the running state
// in registers: the forward and dQ over 64-key tiles of K/V, dK/dV over
// 64-row tiles of Q/dO (no atomics: the reference's two-kernel split).  Tiles
// are staged through shared memory as fp32, rows padded by one float against
// bank conflicts.  Causal tiles above the diagonal are never visited.  Ragged
// lengths are masked by the true Sq and Skv: rows past them are zero-filled
// in shared memory and never read from global memory, so whatever lies in a
// padded tail of the caller's buffers cannot reach the results.
//
// What bounds it on an H100: operations (4, 6 and 8 x BH x Sq x Skv x D
// multiply-adds counted as 2, halved when causal) against the bf16 tensor
// cores.  This first version multiplies on the CUDA cores in fp32 (each
// thread a 4 x 4 block of the score tile and 4 rows x D/16 columns of the
// output tile); mma/wgmma and TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: ty = tid / 16 (16 values), tx = tid % 16
constexpr int PS = BK + 1;      // pitch of a (BQ, BK) tile of P or dS
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round an fp32 value to T and back (a rounding point of the reference)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Stage rows [0, valid) of a (rows, D) tile at `src` into shared memory as
// fp32 with row pitch `pitch`; rows past `valid` are zero and never read.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* __restrict__ src,
                                          int rows, int valid) {
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * pitch + c] = r < valid ? to_f32(src[(size_t)r * D + c]) : 0.0f;
  }
}

// reductions over the 16 lanes that share a ty (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[i][j] += sum_d x[(ty + 16 i) * pitch + d] * y[(tx + 16 j) * pitch + d]
template <int D>
__device__ __forceinline__ void tile_dot(float (&a)[4][4], const float* x, const float* y,
                                         int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float xr[4], yr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xr[i] = x[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) yr[j] = y[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xr[i], yr[j], a[i][j]);
  }
}

__device__ __forceinline__ bool masked(int qpos, int kpos, int sq, int skv, int causal) {
  return kpos >= skv || qpos >= sq || (causal && qpos < kpos);
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(Sq / BQ), BH)
// smem: q_s [BQ][D+1], k_s [BK][D+1], v_s [BK][D], p_s [BQ][BK+1]
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int skv, long long q_bs,
                 long long k_bs, long long v_bs, float scale, int causal) {
  constexpr int P = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* p_s = v_s + BK * D;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + bh * k_bs;
  const T* vb = v + bh * v_bs;
  const int q_valid = min(BQ, sq - q0);
  load_tile<T, D>(q_s, P, q + bh * q_bs + (size_t)q0 * D, BQ, q_valid);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  // causal: keys up to the tile's last valid query only
  const int kend = causal ? min(skv, q0 + q_valid) : skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                       // the previous tile is consumed
    const int k_valid = min(BK, skv - k0);
    load_tile<T, D>(k_s, P, kb + (size_t)k0 * D, BK, k_valid);
    load_tile<T, D>(v_s, D, vb + (size_t)k0 * D, BK, k_valid);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = s[i][j] * scale;
        s[i][j] = masked(qpos, k0 + tx + 16 * j, sq, skv, causal) ? NEG_INF : sv;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[(size_t)(q0 + r) * D + tx + 16 * j] = from_f32<T>(acc[i][j] / li);
    if (tx == 0) lse[(size_t)bh * sq + q0 + r] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (ceil(Sq / BQ), BH)
// smem: q_s, do_s [BQ][D+1], k_s, v_s [BK][D+1], ds_s [BQ][BK+1]
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int skv,
                    long long q_bs, long long k_bs, long long v_bs, long long do_bs,
                    float scale, int causal) {
  constexpr int P = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * P;
  float* k_s = do_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* ds_s = v_s + BK * P;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + bh * k_bs;
  const T* vb = v + bh * v_bs;
  const int q_valid = min(BQ, sq - q0);
  load_tile<T, D>(q_s, P, q + bh * q_bs + (size_t)q0 * D, BQ, q_valid);
  load_tile<T, D>(do_s, P, dout + bh * do_bs + (size_t)q0 * D, BQ, q_valid);
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    lse_r[i] = r < q_valid ? lse[(size_t)bh * sq + q0 + r] : 0.0f;
    delta_r[i] = r < q_valid ? delta[(size_t)bh * sq + q0 + r] : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  const int kend = causal ? min(skv, q0 + q_valid) : skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    const int k_valid = min(BK, skv - k0);
    load_tile<T, D>(k_s, P, kb + (size_t)k0 * D, BK, k_valid);
    load_tile<T, D>(v_s, P, vb + (size_t)k0 * D, BK, k_valid);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = masked(qpos, k0 + tx + 16 * j, sq, skv, causal) ? NEG_INF
                                                                          : s[i][j] * scale;
        const float p = expf(sv - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = ds_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = k_s[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dr[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = dq + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqb[(size_t)(q0 + r) * D + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (ceil(Skv / BK), BH)
// smem: k_s, v_s [BK][D+1], q_s, do_s [BQ][D+1], p_s, ds_s [BQ][BK+1],
//       lse_s, delta_s [BQ]
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int skv, long long q_bs, long long k_bs, long long v_bs,
                     long long do_bs, float scale, int causal) {
  constexpr int P = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * P;
  float* q_s = v_s + BK * P;
  float* do_s = q_s + BQ * P;
  float* p_s = do_s + BQ * P;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + bh * q_bs;
  const T* dob = dout + bh * do_bs;
  const int k_valid = min(BK, skv - k0);
  load_tile<T, D>(k_s, P, k + bh * k_bs + (size_t)k0 * D, BK, k_valid);
  load_tile<T, D>(v_s, P, v + bh * v_bs + (size_t)k0 * D, BK, k_valid);
  // thread owns key rows ty + 16 i and columns tx + 16 j of dK and dV
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  // causal: the first query tile whose last row reaches this key tile
  for (int qs = causal ? (k0 / BQ) * BQ : 0; qs < sq; qs += BQ) {
    __syncthreads();
    const int q_valid = min(BQ, sq - qs);
    load_tile<T, D>(q_s, P, qb + (size_t)qs * D, BQ, q_valid);
    load_tile<T, D>(do_s, P, dob + (size_t)qs * D, BQ, q_valid);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      lse_s[r] = r < q_valid ? lse[(size_t)bh * sq + qs + r] : 0.0f;
      delta_s[r] = r < q_valid ? delta[(size_t)bh * sq + qs + r] : 0.0f;
    }
    __syncthreads();

    // rows ty + 16 i are queries here, columns tx + 16 j keys
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse_i = lse_s[r], delta_i = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sv = masked(qs + r, k0 + c, sq, skv, causal) ? NEG_INF : s[i][j] * scale;
        const float p = expf(sv - lse_i);
        const float ds = p * (dp[i][j] - delta_i) * scale;
        p_s[r * PS + c] = round_to<T>(p);
        ds_s[r * PS + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < q_valid; ++r) {
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = p_s[r * PS + ty + 16 * i];
        dr[i] = ds_s[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = do_s[r * P + tx + 16 * j];
        const float qv = q_s[r * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pr[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dr[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

  T* dkb = dk + (size_t)bh * skv * D;
  T* dvb = dv + (size_t)bh * skv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c >= k_valid) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[(size_t)(k0 + c) * D + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dvb[(size_t)(k0 + c) * D + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PS + 2 * BQ);
}

// Dynamic shared memory above 48 KB must be allowed per kernel, once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
                int skv, long long q_bs, long long k_bs, long long v_bs, float scale,
                int causal, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t bytes = fwd_smem<D>();
  cudaError_t e = allow_smem(kernel, bytes, ready);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, skv, q_bs, k_bs, v_bs, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int sq, int skv,
                   long long q_bs, long long k_bs, long long v_bs, long long do_bs, float scale,
                   int causal, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t bytes = dq_smem<D>();
  cudaError_t e = allow_smem(kernel, bytes, ready);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, skv, q_bs, k_bs, v_bs, do_bs,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                    int skv, long long q_bs, long long k_bs, long long v_bs, long long do_bs,
                    float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t bytes = dkv_smem<D>();
  cudaError_t e = allow_smem(kernel, bytes, ready);
  if (e != cudaSuccess) return e;
  dim3 grid((skv + BK - 1) / BK, bh);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, skv,
      q_bs, k_bs, v_bs, do_bs, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int bh, int sq, int skv) {
  return bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0;
}

// dispatch on (dtype code, head dim): 0 = float32, 1 = bfloat16
#define FLASH_DISPATCH(FN, ...)                                                       \
  switch (dtype * 1000 + d) {                                                         \
    case 16: return (int)FN<float, 16>(__VA_ARGS__);                                  \
    case 32: return (int)FN<float, 32>(__VA_ARGS__);                                  \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                                  \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                                \
    case 1016: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__);                        \
    case 1032: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);                        \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);                        \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);                       \
    default: return (int)cudaErrorInvalidValue;                                       \
  }

}  // namespace

// q (BH,Sq,D), k and v (BH,Skv,D): rows of D contiguous, slab b at b * *_bs
// elements.  o (BH,Sq,D) and lse (BH,Sq) fp32 are contiguous outputs; for the
// backward, dout is laid out like q, lse and delta (BH,Sq) fp32 contiguous,
// dq like q and dk/dv like k, contiguous.  Launch on `stream`, allocate
// nothing, do not synchronise; the return value is cudaGetLastError().
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int bh, int sq, int skv, int d, long long q_bs, long long k_bs,
                                long long v_bs, float scale, int causal, int dtype,
                                void* stream) {
  if (bad_shape(bh, sq, skv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, bh, sq, skv, q_bs, k_bs, v_bs, scale, causal, s)
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int bh, int sq, int skv, int d, long long q_bs,
                                   long long k_bs, long long v_bs, long long do_bs, float scale,
                                   int causal, int dtype, void* stream) {
  if (bad_shape(bh, sq, skv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, bh, sq, skv, q_bs, k_bs, v_bs, do_bs,
                 scale, causal, s)
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int sq, int skv, int d,
                                    long long q_bs, long long k_bs, long long v_bs,
                                    long long do_bs, float scale, int causal, int dtype,
                                    void* stream) {
  if (bad_shape(bh, sq, skv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, bh, sq, skv, q_bs, k_bs, v_bs,
                 do_bs, scale, causal, s)
}
