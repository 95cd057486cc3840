// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py: _fwd_kernel
// (pallas_call at :95), _dq_kernel (:230) and _dkv_kernel (:248).  q (BH,Sq,D),
// k and v (BH,Skv,D), all float32 or all bfloat16, rows of D contiguous and
// each (S,D) slab at its own stride; D in {16, 32, 64, 96, 128, 192, 256}
// (192: MLA's q/k head dim, whose narrower V the wrapper zero-pads).  Scores are
// q.k in fp32, times `scale`, -1e30 where a key is masked (causal: qpos >=
// kpos, both counted from 0; and every key at or past Skv); fp32 online
// softmax; P is rounded to the operands' type before P.V, dS before dS.K and
// dS^T.Q, P before P^T.dO -- the reference's rounding points.  The forward
// writes o in the operands' type and lse = m + log(max(l, 1e-30)) in fp32.
//
// The TPU grid walked its last axis in order and carried the running state
// in VMEM scratch between grid steps.  Here one block owns one (slab, 64-row
// tile) and LOOPS over the other axis, with the running state in registers:
// the forward and dQ over 64-key tiles of K/V, dK/dV over 64-row tiles of
// Q/dO (no atomics: the reference's two-kernel split).  Causal tiles above
// the diagonal are never visited.  Ragged lengths are masked by the true Sq
// and Skv: rows past them are zero-filled in shared memory and never read
// from global memory, so whatever lies in a padded tail of the caller's
// buffers cannot reach the results.
//
// What bounds it on an H100: operations (4, 6 and 8 x BH x Sq x Skv x D
// multiply-adds counted as 2, halved when causal) against the bf16 tensor
// cores.  Two designs:
//  - bf16 (flash_*_mma_kernel): tensor cores.  bf16 tiles padded against
//    bank conflicts, filled by 16-byte cp.async through a two-stage ring so
//    the next tile loads under this one's products; ldmatrix fragments;
//    mma.sync.m16n8k16 with fp32 accumulators.  The first product's
//    accumulators are the second's A operand once packed to bf16 (the
//    reference's rounding point), so P and dS stay in registers.  dK/dV
//    forms S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T come out
//    in that layout.  The reference's rounding points are exactly the tensor
//    cores' operand types; only the order of the fp32 sums moves.
//  - fp32: CUDA cores in fp32 (each thread a 4 x 4 block of the score tile
//    and 4 rows x D/16 columns of the output), tiles staged as fp32 with
//    rows padded by one float.  Tensor cores take fp32 only as TF32, which
//    would break the fp32 contract.
//
// Head dim 256 needs more than one SM's 232,448 bytes of shared memory or
// 255 registers a thread in three instances, so those split their work
// without changing the 64-wide tiles (the plain versions walk the same; the
// bf16 split also serves 192, whose fp32 kernels fit as they are):
//  - fp32 dQ stages K and V in one buffer in turn (V for dP, then K for S
//    and dS.K), fp32 dK/dV Q and dO in one buffer (dO for dP, Q for S and
//    dS^T.Q, dO again for P^T.dO): one more tile load an iteration.
//  - bf16 (all three kernels): 8 warps, the two warps of a pair share 16
//    rows and each owns half of D's output columns, so the accumulators are
//    D/4 fp32 registers a thread per output (dK/dV: 2 x D/8 at D <= 128 is
//    D, near or above the limit at 192 and 256).  Both warps of a pair
//    form the same S and dP (and run the same online softmax, so they agree
//    bit for bit); the forward re-reads Q's fragments from shared memory
//    there instead of holding them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: ty = tid / 16 (16 values), tx = tid % 16
constexpr int PS = BK + 1;      // pitch of a (BQ, BK) tile of P or dS
constexpr float NEG_INF = -1e30f;

// Stage rows [0, valid) of a (rows, D) fp32 tile at `src` into shared memory
// with row pitch `pitch`; rows past `valid` are zero and never read.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* __restrict__ src,
                                          int rows, int valid) {
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * pitch + c] = r < valid ? src[(size_t)r * D + c] : 0.0f;
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
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int sq, int skv, long long q_bs, long long k_bs, long long v_bs, float scale,
                 int causal) {
  constexpr int P = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* p_s = v_s + BK * D;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = k + bh * k_bs;
  const float* vb = v + bh * v_bs;
  const int q_valid = min(BQ, sq - q0);
  load_tile<D>(q_s, P, q + bh * q_bs + (size_t)q0 * D, BQ, q_valid);

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
    load_tile<D>(k_s, P, kb + (size_t)k0 * D, BK, k_valid);
    load_tile<D>(v_s, D, vb + (size_t)k0 * D, BK, k_valid);
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
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
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

  float* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[(size_t)(q0 + r) * D + tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) lse[(size_t)bh * sq + q0 + r] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (ceil(Sq / BQ), BH)
// smem: q_s, do_s [BQ][D+1], k_s, v_s [BK][D+1], ds_s [BQ][BK+1]; where
// that is too much (dq_one_kv), K and V take one buffer in turn
// ---------------------------------------------------------------------------
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block, sm_90

template <int D> __host__ __device__ constexpr bool dq_one_kv() {
  return sizeof(float) * ((size_t)2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS) > MAX_SMEM;
}
template <int D> __host__ __device__ constexpr bool dkv_one_qdo() {
  return sizeof(float) * ((size_t)2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PS + 2 * BQ) >
         MAX_SMEM;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int sq, int skv, long long q_bs, long long k_bs,
                    long long v_bs, long long do_bs, float scale, int causal) {
  constexpr int P = D + 1, NJ = D / 16;
  constexpr bool ONE_KV = dq_one_kv<D>();
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * P;
  float* k_s = do_s + BQ * P;
  float* v_s = ONE_KV ? k_s : k_s + BK * P;
  float* ds_s = v_s + BK * P;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = k + bh * k_bs;
  const float* vb = v + bh * v_bs;
  const int q_valid = min(BQ, sq - q0);
  load_tile<D>(q_s, P, q + bh * q_bs + (size_t)q0 * D, BQ, q_valid);
  load_tile<D>(do_s, P, dout + bh * do_bs + (size_t)q0 * D, BQ, q_valid);
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
    float s[4][4] = {}, dp[4][4] = {};
    if constexpr (ONE_KV) {                // V for dP, then K in its place
      load_tile<D>(v_s, P, vb + (size_t)k0 * D, BK, k_valid);
      __syncthreads();
      tile_dot<D>(dp, do_s, v_s, ty, tx);
      __syncthreads();
      load_tile<D>(k_s, P, kb + (size_t)k0 * D, BK, k_valid);
      __syncthreads();
      tile_dot<D>(s, q_s, k_s, ty, tx);
    } else {
      load_tile<D>(k_s, P, kb + (size_t)k0 * D, BK, k_valid);
      load_tile<D>(v_s, P, vb + (size_t)k0 * D, BK, k_valid);
      __syncthreads();
      tile_dot<D>(s, q_s, k_s, ty, tx);
      tile_dot<D>(dp, do_s, v_s, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = masked(qpos, k0 + tx + 16 * j, sq, skv, causal) ? NEG_INF
                                                                          : s[i][j] * scale;
        const float p = expf(sv - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] = ds;
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

  float* dqb = dq + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqb[(size_t)(q0 + r) * D + tx + 16 * j] = acc[i][j];
  }
}

// acc[i][j] += sum_r w[r][ty + 16 i] * x[r][tx + 16 j] over the valid query
// rows r (dK += dS^T Q and dV += P^T dO)
template <int D>
__device__ __forceinline__ void accumulate_rows(float (&acc)[4][D / 16], const float* w_s,
                                                const float* x_s, int q_valid, int ty, int tx) {
  constexpr int P = D + 1, NJ = D / 16;
#pragma unroll 2
  for (int r = 0; r < q_valid; ++r) {
    float wr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wr[i] = w_s[r * PS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float xv = x_s[r * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wr[i], xv, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (ceil(Skv / BK), BH)
// smem: k_s, v_s [BK][D+1], q_s, do_s [BQ][D+1], p_s, ds_s [BQ][BK+1],
//       lse_s, delta_s [BQ]; where that is too much (dkv_one_qdo), Q and dO
//       take one buffer in turn
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
                     long long q_bs, long long k_bs, long long v_bs, long long do_bs,
                     float scale, int causal) {
  constexpr int P = D + 1, NJ = D / 16;
  constexpr bool ONE_QDO = dkv_one_qdo<D>();
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * P;
  float* q_s = v_s + BK * P;
  float* do_s = ONE_QDO ? q_s : q_s + BQ * P;
  float* p_s = do_s + BQ * P;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + bh * q_bs;
  const float* dob = dout + bh * do_bs;
  const int k_valid = min(BK, skv - k0);
  load_tile<D>(k_s, P, k + bh * k_bs + (size_t)k0 * D, BK, k_valid);
  load_tile<D>(v_s, P, v + bh * v_bs + (size_t)k0 * D, BK, k_valid);
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
    if constexpr (!ONE_QDO) load_tile<D>(q_s, P, qb + (size_t)qs * D, BQ, q_valid);
    load_tile<D>(do_s, P, dob + (size_t)qs * D, BQ, q_valid);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      lse_s[r] = r < q_valid ? lse[(size_t)bh * sq + qs + r] : 0.0f;
      delta_s[r] = r < q_valid ? delta[(size_t)bh * sq + qs + r] : 0.0f;
    }
    __syncthreads();

    // rows ty + 16 i are queries here, columns tx + 16 j keys
    float s[4][4] = {}, dp[4][4] = {};
    if constexpr (ONE_QDO) {               // dP from dO, then Q in its place
      tile_dot<D>(dp, do_s, v_s, ty, tx);
      __syncthreads();
      load_tile<D>(q_s, P, qb + (size_t)qs * D, BQ, q_valid);
      __syncthreads();
      tile_dot<D>(s, q_s, k_s, ty, tx);
    } else {
      tile_dot<D>(s, q_s, k_s, ty, tx);
      tile_dot<D>(dp, do_s, v_s, ty, tx);
    }
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
        p_s[r * PS + c] = p;
        ds_s[r * PS + c] = ds;
      }
    }
    __syncthreads();
    // dK += dS^T Q, then dV += P^T dO (with ONE_QDO, dO back in Q's place)
    accumulate_rows<D>(dk_acc, ds_s, q_s, q_valid, ty, tx);
    if constexpr (ONE_QDO) {
      __syncthreads();
      load_tile<D>(do_s, P, dob + (size_t)qs * D, BQ, q_valid);
      __syncthreads();
    }
    accumulate_rows<D>(dv_acc, p_s, do_s, q_valid, ty, tx);
  }

  float* dkb = dk + (size_t)bh * skv * D;
  float* dvb = dv + (size_t)bh * skv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c >= k_valid) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[(size_t)(k0 + c) * D + tx + 16 * j] = dk_acc[i][j];
      dvb[(size_t)(k0 + c) * D + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma_bf16.cuh): 4 warps, each 16 rows of a 64-row
// tile, operands in padded bf16 shared tiles filled by cp.async through a
// two-stage ring, fragments by ldmatrix, products on mma.sync.m16n8k16 with
// fp32 accumulators.  Scores are kept in the log2 domain (scale * log2(e)
// folded into one multiply, exp2f); lse is written in natural log.  With
// SPLIT = 2 (D = 192, 256) the block has 8 warps: warp w takes rows of warp w % 4
// and output columns [(w / 4) D / 2, (w / 4 + 1) D / 2).
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;                    // 4 warps: one per 16 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ways the bf16 kernels split D's output columns between warps
template <int D> __host__ __device__ constexpr int col_split() { return D > 128 ? 2 : 1; }

// forward: grid (BH, ceil(Sq / BQ)), query tiles longest-first when causal
// smem: q_s [BQ][D+8], k_s [2][BK][D+8], v_s [2][BK][D+8] (bf16)
template <int D, int SPLIT>
__global__ void __launch_bounds__(MMA_NT * SPLIT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, long long q_bs, long long k_bs,
                     long long v_bs, float scale_log2, int causal) {
  using namespace mma_bf16;
  constexpr int P = pitch<D>(), KD = D / 16, NS = BK / 8, NTH = MMA_NT * SPLIT;
  constexpr int ND = D / 8 / SPLIT;            // this warp's 8-column output tiles
  constexpr bool Q_REGS = SPLIT == 1;          // Q's fragments held, or re-read
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* k_s = q_s + BQ * P;
  __nv_bfloat16* v_s = k_s + 2 * BK * P;

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, q_valid = min(BQ, sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3, d0 = (warp >> 2) * (D / SPLIT);   // row group, first column
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + rw * 16 + g;           // query of c0, c1; row0 + 8 of c2, c3
  const __nv_bfloat16* kb = k + bh * k_bs;
  const __nv_bfloat16* vb = v + bh * v_bs;
  // causal: keys up to the tile's last valid query only
  const int kend = causal ? min(skv, q0 + q_valid) : skv;
  const int n_tiles = (kend + BK - 1) / BK;

  load_tile_async<BQ, D, NTH>(q_s, q + bh * q_bs + (size_t)q0 * D, q_valid);
  cp_async_commit();
  load_tile_async<BK, D, NTH>(k_s, kb, min(BK, skv));
  load_tile_async<BK, D, NTH>(v_s, vb, min(BK, skv));
  cp_async_commit();
  cp_async_wait<1>();                        // Q has landed
  __syncthreads();
  uint32_t qf[Q_REGS ? KD : 1][4];             // with Q_REGS its fragments stay in registers
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(qf[kd], a_frag_addr<D>(q_s, rw * 16, kd * 16, lane));
  }

  float acc[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {                  // prefetch the next K/V tile
      const int k1 = k0 + BK, nv = min(BK, skv - k1), st = (it + 1) & 1;
      load_tile_async<BK, D, NTH>(k_s + st * BK * P, kb + (size_t)k1 * D, nv);
      load_tile_async<BK, D, NTH>(v_s + st * BK * P, vb + (size_t)k1 * D, nv);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // this tile has landed
    __syncthreads();
    const __nv_bfloat16* ks = k_s + (it & 1) * BK * P;
    const __nv_bfloat16* vs = v_s + (it & 1) * BK * P;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        ldsm_x4(a, a_frag_addr<D>(q_s, rw * 16, kd * 16, lane));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_frag_addr_nk<D>(ks, np * 16, kd * 16, lane));
        mma_16816(s[2 * np], a, b[0], b[1]);
        mma_16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // scale; mask only a tile that crosses the diagonal or the end of K
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1), qpos = row0 + (e >> 1) * 8;
          if (kpos >= skv || (causal && qpos < kpos)) x = NEG_INF;
        }
        s[j][e] = x;
      }
    // online softmax in registers (rows row0 and row0 + 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = quad_max(mx);
      const float corr = exp2f(m[h] - mx);
      m[h] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - mx);
          sum += s[j][e];
        }
      l[h] = l[h] * corr + sum;              // this lane's share of the row sum
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }
    // O += bf16(P) V, P straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_frag_addr_kn<D>(vs, kk * 16, d0 + dp * 16, lane));
        mma_16816(acc[2 * dp], a, b[0], b[1]);
        mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                         // this stage is free for the prefetch
  }

  __nv_bfloat16* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float li = fmaxf(quad_sum(l[h]), 1e-30f);
    const int r = row0 + 8 * h;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r * D + d0 + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * h] / li, acc[j][2 * h + 1] / li);
    if (t == 0 && d0 == 0) lse[(size_t)bh * sq + r] = m[h] * LN2 + logf(li);
  }
}

// dQ: grid (BH, ceil(Sq / BQ)), query tiles longest-first when causal.  Each
// warp owns 16 query rows, as in the forward: per 64-key tile S = Q K^T and
// dP = dO V^T, P = exp(S scale - lse), dS = P (dP - delta) scale in fp32, and
// dQ += bf16(dS) K with dS packed from the accumulators into the A fragment
// and K entering through ldmatrix.trans.  dQ alone is 64 accumulators a
// thread at d=128, so the Q and dO fragments are re-read from shared memory
// per product rather than kept in registers.
// smem: q_s, do_s [BQ][D+8], k_s, v_s [2][BK][D+8] (bf16), lse_s, delta_s
// [BQ] (fp32)
template <int D, int SPLIT>
__global__ void __launch_bounds__(MMA_NT * SPLIT)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq,
                        int skv, long long q_bs, long long k_bs, long long v_bs,
                        long long do_bs, float scale, float scale_log2, int causal) {
  using namespace mma_bf16;
  constexpr int P = pitch<D>(), KD = D / 16, NS = BK / 8, NTH = MMA_NT * SPLIT;
  constexpr int ND = D / 8 / SPLIT;            // this warp's 8-column output tiles
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* do_s = q_s + BQ * P;
  __nv_bfloat16* k_s = do_s + BQ * P;
  __nv_bfloat16* v_s = k_s + 2 * BK * P;
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * BK * P);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, q_valid = min(BQ, sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3, d0 = (warp >> 2) * (D / SPLIT);   // row group, first column
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + rw * 16 + g;           // query of c0, c1; row0 + 8 of c2, c3
  const __nv_bfloat16* kb = k + bh * k_bs;
  const __nv_bfloat16* vb = v + bh * v_bs;
  // causal: keys up to the tile's last valid query only
  const int kend = causal ? min(skv, q0 + q_valid) : skv;
  const int n_tiles = (kend + BK - 1) / BK;

  load_tile_async<BQ, D, NTH>(q_s, q + bh * q_bs + (size_t)q0 * D, q_valid);
  load_tile_async<BQ, D, NTH>(do_s, dout + bh * do_bs + (size_t)q0 * D, q_valid);
  if (threadIdx.x < 2 * BQ) {                  // threads 0..63 lse, 64..127 delta
    const int r = threadIdx.x & (BQ - 1);
    const bool ok = r < q_valid;
    const float* src = (threadIdx.x < BQ ? lse : delta) + (size_t)bh * sq + q0;
    cp_async_4((threadIdx.x < BQ ? lse_s : delta_s) + r, ok ? src + r : src, ok);
  }
  cp_async_commit();
  load_tile_async<BK, D, NTH>(k_s, kb, min(BK, skv));
  load_tile_async<BK, D, NTH>(v_s, vb, min(BK, skv));
  cp_async_commit();
  cp_async_wait<1>();                        // Q, dO and the row statistics have landed
  __syncthreads();
  float lse2[2], dl[2];                        // lse in log2 units, delta; rows row0, row0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = lse_s[rw * 16 + g + 8 * h] * LOG2E;
    dl[h] = delta_s[rw * 16 + g + 8 * h];
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {                  // prefetch the next K/V tile
      const int k1 = k0 + BK, nv = min(BK, skv - k1), st = (it + 1) & 1;
      load_tile_async<BK, D, NTH>(k_s + st * BK * P, kb + (size_t)k1 * D, nv);
      load_tile_async<BK, D, NTH>(v_s + st * BK * P, vb + (size_t)k1 * D, nv);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // this tile has landed
    __syncthreads();
    const __nv_bfloat16* ks = k_s + (it & 1) * BK * P;
    const __nv_bfloat16* vs = v_s + (it & 1) * BK * P;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, a_frag_addr<D>(q_s, rw * 16, kd * 16, lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_frag_addr_nk<D>(ks, np * 16, kd * 16, lane));
        mma_16816(s[2 * np], a, b[0], b[1]);
        mma_16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // P = exp(S scale - lse); mask only a tile that crosses the diagonal or
    // the end of K
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1), qpos = row0 + (e >> 1) * 8;
          if (kpos >= skv || (causal && qpos < kpos)) x = NEG_INF;
        }
        s[j][e] = exp2f(x - lse2[e >> 1]);
      }
    // dP = dO V^T
    float dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, a_frag_addr<D>(do_s, rw * 16, kd * 16, lane));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_frag_addr_nk<D>(vs, np * 16, kd * 16, lane));
        mma_16816(dp[2 * np], a, b[0], b[1]);
        mma_16816(dp[2 * np + 1], a, b[2], b[3]);
      }
    }
    // dS = P (dP - delta) scale, in place of dP
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]) * scale;
    // dQ += bf16(dS) K, dS straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dpair = 0; dpair < ND / 2; ++dpair) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_frag_addr_kn<D>(ks, kk * 16, d0 + dpair * 16, lane));
        mma_16816(acc[2 * dpair], a, b[0], b[1]);
        mma_16816(acc[2 * dpair + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                         // this stage is free for the prefetch
  }
  cp_async_wait<0>();                        // no copy outlives the block

  __nv_bfloat16* dqb = dq + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r * D + d0 + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// dK/dV: grid (BH, ceil(Skv / BK)).  Each warp owns 16 keys and forms the
// transposed products, so P^T and dS^T come out in the accumulator layout
// and feed the next product from registers; a 64-row Q/dO tile is taken in
// two 32-row halves to keep the live accumulators at dK + dV + 2 x 16.
// smem: k_s, v_s [BK][D+8], q_s, do_s [2][BQ][D+8] (bf16), lse_s, delta_s
// [2][BQ] (fp32)
template <int D, int SPLIT>
__global__ void __launch_bounds__(MMA_NT * SPLIT)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int skv, long long q_bs,
                         long long k_bs, long long v_bs, long long do_bs, float scale,
                         float scale_log2, int causal) {
  using namespace mma_bf16;
  constexpr int P = pitch<D>(), KD = D / 16, HQ = BQ / 2, NS = HQ / 8, NTH = MMA_NT * SPLIT;
  constexpr int ND = D / 8 / SPLIT;            // this warp's 8-column dK, dV tiles
  static_assert(BQ == BK, "a causal key tile starts at the query tile of its own index");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* v_s = k_s + BK * P;
  __nv_bfloat16* q_s = v_s + BK * P;
  __nv_bfloat16* do_s = q_s + 2 * BQ * P;
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * P);
  float* delta_s = lse_s + 2 * BQ;

  const int bh = blockIdx.x, k0 = blockIdx.y * BK, k_valid = min(BK, skv - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp & 3, d0 = (warp >> 2) * (D / SPLIT);   // key group, first column
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + rw * 16 + g;           // key of c0, c1; key0 + 8 of c2, c3
  const __nv_bfloat16* qb = q + bh * q_bs;
  const __nv_bfloat16* dob = dout + bh * do_bs;
  const float* lse_b = lse + (size_t)bh * sq;
  const float* delta_b = delta + (size_t)bh * sq;
  // causal: the first query tile that reaches this key tile
  const int qstart = causal ? k0 : 0;
  const int n_tiles = qstart < sq ? (sq - qstart + BQ - 1) / BQ : 0;

  auto load_q_tile = [&](int qs, int st) {
    const int nv = min(BQ, sq - qs);
    load_tile_async<BQ, D, NTH>(q_s + st * BQ * P, qb + (size_t)qs * D, nv);
    load_tile_async<BQ, D, NTH>(do_s + st * BQ * P, dob + (size_t)qs * D, nv);
    const int r = threadIdx.x & (BQ - 1);
    const bool ok = r < nv;
    if (threadIdx.x < BQ)
      cp_async_4(lse_s + st * BQ + r, ok ? lse_b + qs + r : lse_b, ok);
    else if (threadIdx.x < 2 * BQ)
      cp_async_4(delta_s + st * BQ + r, ok ? delta_b + qs + r : delta_b, ok);
  };

  load_tile_async<BK, D, NTH>(k_s, k + bh * k_bs + (size_t)k0 * D, k_valid);
  load_tile_async<BK, D, NTH>(v_s, v + bh * v_bs + (size_t)k0 * D, k_valid);
  if (n_tiles > 0) load_q_tile(qstart, 0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int qs = qstart + it * BQ;
    if (it + 1 < n_tiles) load_q_tile(qs + BQ, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* qt_s = q_s + (it & 1) * BQ * P;
    const __nv_bfloat16* dot_s = do_s + (it & 1) * BQ * P;
    const float* lse_t = lse_s + (it & 1) * BQ;
    const float* delta_t = delta_s + (it & 1) * BQ;
    const bool edge = qs + BQ > sq || k0 + BK > skv || (causal && qs < k0 + BK - 1);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * HQ;                // first query of the half, in the tile
      // S^T = K Q^T: 16 keys x 32 queries a warp
      float p[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldsm_x4(a, a_frag_addr<D>(k_s, rw * 16, kd * 16, lane));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b_frag_addr_nk<D>(qt_s, c0 + np * 16, kd * 16, lane));
          mma_16816(p[2 * np], a, b[0], b[1]);
          mma_16816(p[2 * np + 1], a, b[2], b[3]);
        }
      }
      // P^T = exp(S^T scale - lse[q]), masked where a query may not see a key
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = c0 + j * 8 + 2 * t;
        const float2 lq = *reinterpret_cast<const float2*>(lse_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = p[j][e] * scale_log2;
          if (edge) {
            const int qpos = qs + col + (e & 1), kpos = key0 + (e >> 1) * 8;
            if (qpos >= sq || kpos >= skv || (causal && qpos < kpos)) x = NEG_INF;
          }
          p[j][e] = exp2f(x - ((e & 1) ? lq.y : lq.x) * LOG2E);
        }
      }
      // dV += bf16(P^T) dO
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t a[4];
        acc_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
        for (int dpair = 0; dpair < ND / 2; ++dpair) {
          uint32_t b[4];
          ldsm_x4_trans(b, b_frag_addr_kn<D>(dot_s, c0 + kk * 16, d0 + dpair * 16, lane));
          mma_16816(dv_acc[2 * dpair], a, b[0], b[1]);
          mma_16816(dv_acc[2 * dpair + 1], a, b[2], b[3]);
        }
      }
      // dP^T = V dO^T
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldsm_x4(a, a_frag_addr<D>(v_s, rw * 16, kd * 16, lane));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b_frag_addr_nk<D>(dot_s, c0 + np * 16, kd * 16, lane));
          mma_16816(dp[2 * np], a, b[0], b[1]);
          mma_16816(dp[2 * np + 1], a, b[2], b[3]);
        }
      }
      // dS^T = P^T (dP^T - delta[q]) scale, in place of dP^T
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + c0 + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = p[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
      // dK += bf16(dS^T) Q
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t a[4];
        acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dpair = 0; dpair < ND / 2; ++dpair) {
          uint32_t b[4];
          ldsm_x4_trans(b, b_frag_addr_kn<D>(qt_s, c0 + kk * 16, d0 + dpair * 16, lane));
          mma_16816(dk_acc[2 * dpair], a, b[0], b[1]);
          mma_16816(dk_acc[2 * dpair + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                         // this stage is free for the prefetch
  }
  cp_async_wait<0>();                        // no copy outlives the block

  __nv_bfloat16* dkb = dk + (size_t)bh * skv * D;
  __nv_bfloat16* dvb = dv + (size_t)bh * skv * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key0 + 8 * h;
    if (r >= skv) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)r * D + d0 + j * 8 + 2 * t) =
          pack_bf16x2(dk_acc[j][2 * h], dk_acc[j][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)r * D + d0 + j * 8 + 2 * t) =
          pack_bf16x2(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
    }
  }
}

template <int D> constexpr size_t fwd_mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * mma_bf16::pitch<D>();
}
template <int D> constexpr size_t dq_mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BQ + 4 * BK) * mma_bf16::pitch<D>() +
         sizeof(float) * 2 * BQ;
}
template <int D> constexpr size_t dkv_mma_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BK + 4 * BQ) * mma_bf16::pitch<D>() +
         sizeof(float) * 4 * BQ;
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) *
         ((size_t)2 * BQ * (D + 1) + (dq_one_kv<D>() ? 1 : 2) * BK * (D + 1) + BQ * PS);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)2 * BK * (D + 1) + (dkv_one_qdo<D>() ? 1 : 2) * BQ * (D + 1) +
                          2 * BQ * PS + 2 * BQ);
}

// Allow a kernel dynamic shared memory above 48 KB (once: `ready`), launch it
// on `stream` and return the launch's error.
template <typename K, typename... Args>
cudaError_t launch(K kernel, bool& ready, dim3 grid, int threads, size_t bytes,
                   cudaStream_t stream, Args... args) {
  if (!ready && bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
  }
  ready = true;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// bf16 runs the tensor-core kernel (grid (BH, tiles): the y axis holds at
// most 65535 tiles), fp32 the CUDA-core one
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
                int skv, long long q_bs, long long k_bs, long long v_bs, float scale,
                int causal, cudaStream_t stream) {
  static_assert(fwd_smem<D>() <= MAX_SMEM && fwd_mma_smem<D>() <= MAX_SMEM,
                "one block's shared memory must fit an SM");
  static bool ready = false;
  const int nq = (sq + BQ - 1) / BQ;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (nq > 65535) return cudaErrorInvalidValue;
    return launch(flash_fwd_mma_kernel<D, col_split<D>()>, ready, dim3(bh, nq),
                  MMA_NT * col_split<D>(), fwd_mma_smem<D>(),
                  stream, qt, kt, vt, static_cast<T*>(o), static_cast<float*>(lse), sq, skv,
                  q_bs, k_bs, v_bs, scale * LOG2E, causal);
  } else {
    return launch(flash_fwd_kernel<D>, ready, dim3(nq, bh), NT, fwd_smem<D>(), stream, qt, kt,
                  vt, static_cast<T*>(o), static_cast<float*>(lse), sq, skv, q_bs, k_bs, v_bs,
                  scale, causal);
  }
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int sq, int skv,
                   long long q_bs, long long k_bs, long long v_bs, long long do_bs, float scale,
                   int causal, cudaStream_t stream) {
  static_assert(dq_smem<D>() <= MAX_SMEM && dq_mma_smem<D>() <= MAX_SMEM,
                "one block's shared memory must fit an SM");
  static bool ready = false;
  const int nq = (sq + BQ - 1) / BQ;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const float *lsef = static_cast<const float*>(lse), *deltaf = static_cast<const float*>(delta);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (nq > 65535) return cudaErrorInvalidValue;
    return launch(flash_bwd_dq_mma_kernel<D, col_split<D>()>, ready, dim3(bh, nq),
                  MMA_NT * col_split<D>(), dq_mma_smem<D>(),
                  stream, qt, kt, vt, dot, lsef, deltaf, static_cast<T*>(dq), sq, skv, q_bs,
                  k_bs, v_bs, do_bs, scale, scale * LOG2E, causal);
  } else {
    return launch(flash_bwd_dq_kernel<D>, ready, dim3(nq, bh), NT, dq_smem<D>(), stream, qt, kt,
                  vt, dot, lsef, deltaf, static_cast<T*>(dq), sq, skv, q_bs, k_bs, v_bs, do_bs,
                  scale, causal);
  }
}

// bf16 runs the tensor-core kernel, fp32 the CUDA-core one (as fwd, bwd_dq)
template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                    int skv, long long q_bs, long long k_bs, long long v_bs, long long do_bs,
                    float scale, int causal, cudaStream_t stream) {
  static_assert(dkv_smem<D>() <= MAX_SMEM && dkv_mma_smem<D>() <= MAX_SMEM,
                "one block's shared memory must fit an SM");
  static bool ready = false;
  const int nk = (skv + BK - 1) / BK;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const float *lsef = static_cast<const float*>(lse), *deltaf = static_cast<const float*>(delta);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (nk > 65535) return cudaErrorInvalidValue;
    return launch(flash_bwd_dkv_mma_kernel<D, col_split<D>()>, ready, dim3(bh, nk),
                  MMA_NT * col_split<D>(), dkv_mma_smem<D>(),
                  stream, qt, kt, vt, dot, lsef, deltaf, static_cast<T*>(dk),
                  static_cast<T*>(dv), sq, skv, q_bs, k_bs, v_bs, do_bs, scale,
                  scale * LOG2E, causal);
  } else {
    return launch(flash_bwd_dkv_kernel<D>, ready, dim3(nk, bh), NT, dkv_smem<D>(), stream, qt,
                  kt, vt, dot, lsef, deltaf, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv,
                  q_bs, k_bs, v_bs, do_bs, scale, causal);
  }
}

bool bad_shape(int bh, int sq, int skv) {
  return bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0;
}

// dispatch on (dtype code, head dim): 0 = float32, 1 = bfloat16 (every
// kernel sends bfloat16 on to its mma version)
#define FLASH_DISPATCH(FN, ...)                                                       \
  switch (dtype * 1000 + d) {                                                         \
    case 16: return (int)FN<float, 16>(__VA_ARGS__);                                  \
    case 32: return (int)FN<float, 32>(__VA_ARGS__);                                  \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                                  \
    case 96: return (int)FN<float, 96>(__VA_ARGS__);                                  \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                                \
    case 192: return (int)FN<float, 192>(__VA_ARGS__);                                \
    case 256: return (int)FN<float, 256>(__VA_ARGS__);                                \
    case 1016: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__);                        \
    case 1032: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);                        \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);                        \
    case 1096: return (int)FN<__nv_bfloat16, 96>(__VA_ARGS__);                        \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);                       \
    case 1192: return (int)FN<__nv_bfloat16, 192>(__VA_ARGS__);                       \
    case 1256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);                       \
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
