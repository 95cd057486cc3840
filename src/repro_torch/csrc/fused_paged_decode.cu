// Fused block-table paged-decode GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/paged_attention_fused.py:_fused_decode_kernel.  One decode
// query per request, q (B,1,H,hd), attends over paged K/V pools
// (P,page,KVH,hd) through block_table (B,max_blocks) int32 and
// kv_valid_len (B,) int32 (>= 1): scores q.k / sqrt(hd) with the H query
// heads grouped per KV head (pages are never repeated), -1e30 past the valid
// length, fp32 online softmax, output in q's dtype.
//
// The TPU grid (B, max_blocks) ran in order and carried max / denominator /
// accumulator between page steps; here one block owns one (request, KV head)
// pair and LOOPS over the request's pages, keeping the running fp32 state in
// shared memory.  The block reads its own block-table row and length from
// global memory and walks j < ceil(len / page) only: pages past the valid
// length are never dereferenced.  A loop step stages a chunk of consecutive
// pages (about 64 tokens) of K and of V through shared memory as fp32.
//
// What bounds it on an H100: the live K/V bytes, read once (memory).  The
// walk reads exactly those pages at KV-head width; what this first version
// leaves on the table is parallelism along the context (one block per
// (request, KV head); a split-KV axis with a log-sum-exp merge is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory layout (floats), G = H / KVH, TOK = pages_per_chunk * page:
//   q_s   [G][hd]        the group's queries
//   acc_s [G][hd]        running output accumulator
//   k_s   [TOK][hd + 1]  K chunk (row padded: a warp reads one d of 32 rows)
//   v_s   [TOK][hd]      V chunk
//   s_s   [G][TOK]       scores, then softmax numerators
//   m_s, l_s, alpha_s [G]
template <typename QT, typename PT>
__global__ void __launch_bounds__(NTHREADS)
fused_paged_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ pool_k,
                          const PT* __restrict__ pool_v,
                          const int* __restrict__ block_table,
                          const int* __restrict__ kv_valid_len,
                          QT* __restrict__ out, int H, int KVH, int hd, int page,
                          int max_blocks, int pages_per_chunk) {
  extern __shared__ float smem[];
  const int G = H / KVH;
  const int TOK = pages_per_chunk * page;
  const int kstride = hd + 1;
  float* q_s = smem;
  float* acc_s = q_s + G * hd;
  float* k_s = acc_s + G * hd;
  float* v_s = k_s + TOK * kstride;
  float* s_s = v_s + TOK * hd;
  float* m_s = s_s + G * TOK;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NWARPS = NTHREADS / 32;

  const int valid = kv_valid_len[b];
  const int n_blocks = min((valid + page - 1) / page, max_blocks);
  const int* bt_row = block_table + (size_t)b * max_blocks;
  const float root_hd = sqrtf((float)hd);

  // queries of this KV head's group, and zeroed running state
  const QT* q_grp = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int e = tid; e < G * hd; e += NTHREADS) {
    q_s[e] = to_f32(q_grp[e]);
    acc_s[e] = 0.0f;
  }
  for (int g = tid; g < G; g += NTHREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < n_blocks; j0 += pages_per_chunk) {
    const int tok0 = j0 * page;
    // ---- stage the chunk: live pages only; dead slots are zero-filled ----
    for (int e = tid; e < TOK * hd; e += NTHREADS) {
      const int t = e / hd, d = e - t * hd;
      const int j = j0 + t / page;
      float kval = 0.0f, vval = 0.0f;
      if (j < n_blocks && tok0 + t < valid) {
        const int pid = bt_row[j];
        const size_t off = (((size_t)pid * page + (t % page)) * KVH + kvh) * hd + d;
        kval = to_f32(pool_k[off]);
        vval = to_f32(pool_v[off]);
      }
      k_s[t * kstride + d] = kval;
      v_s[e] = vval;
    }
    __syncthreads();

    // ---- scores: one (group head, token) pair per thread ----
    for (int p = tid; p < G * TOK; p += NTHREADS) {
      const int g = p / TOK, t = p - g * TOK;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + t * kstride;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float s = dot / root_hd;
      s_s[p] = (tok0 + t < valid) ? s : MASK_VALUE;
    }
    __syncthreads();

    // ---- online softmax update: one warp per group head ----
    for (int g = warp; g < G; g += NWARPS) {
      float* sr = s_s + g * TOK;
      float mx = -INFINITY;
      for (int t = lane; t < TOK; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < TOK; t += 32) {
        const float pr = expf(sr[t] - m_new);
        sr[t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- accumulator: acc = alpha * acc + p @ V ----
    for (int e = tid; e < G * hd; e += NTHREADS) {
      const int g = e / hd, d = e - g * hd;
      const float* pr = s_s + g * TOK;
      float a = alpha_s[g] * acc_s[e];
      for (int t = 0; t < TOK; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  QT* o_grp = out + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int e = tid; e < G * hd; e += NTHREADS) {
    const int g = e / hd;
    store_out(o_grp + e, acc_s[e] / l_s[g]);
  }
}

template <typename QT, typename PT>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* block_table, const int* kv_valid_len, void* out,
                   int B, int H, int KVH, int hd, int page, int max_blocks,
                   cudaStream_t stream) {
  const int G = H / KVH;
  int ppc = 64 / page;
  if (ppc < 1) ppc = 1;
  if (ppc > max_blocks) ppc = max_blocks;
  const int TOK = ppc * page;
  const size_t floats = (size_t)2 * G * hd + (size_t)TOK * (hd + 1) +
                        (size_t)TOK * hd + (size_t)G * TOK + (size_t)3 * G;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = fused_paged_decode_kernel<QT, PT>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, KVH);
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(pool_k),
      static_cast<const PT*>(pool_v), block_table, kv_valid_len,
      static_cast<QT*>(out), H, KVH, hd, page, max_blocks, ppc);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q/out are (B,1,H,hd) contiguous,
// pools (P,page,KVH,hd) contiguous, block_table (B,max_blocks) int32,
// kv_valid_len (B,) int32 with every entry >= 1.  Launches on `stream`,
// allocates nothing, does not synchronise, returns cudaGetLastError().
extern "C" int fused_paged_decode_launch(const void* q, const void* pool_k,
                                         const void* pool_v,
                                         const void* block_table,
                                         const void* kv_valid_len, void* out,
                                         int B, int H, int KVH, int hd, int page,
                                         int max_blocks, int q_dtype,
                                         int pool_dtype, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || page <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(kv_valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && pool_dtype == 0)
    err = launch<float, float>(q, pool_k, pool_v, bt, ln, out, B, H, KVH, hd, page, max_blocks, s);
  else if (q_dtype == 0 && pool_dtype == 1)
    err = launch<float, __nv_bfloat16>(q, pool_k, pool_v, bt, ln, out, B, H, KVH, hd, page, max_blocks, s);
  else if (q_dtype == 1 && pool_dtype == 0)
    err = launch<__nv_bfloat16, float>(q, pool_k, pool_v, bt, ln, out, B, H, KVH, hd, page, max_blocks, s);
  else if (q_dtype == 1 && pool_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, pool_k, pool_v, bt, ln, out, B, H, KVH, hd, page, max_blocks, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
