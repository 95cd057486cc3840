// Fused block-table paged-decode GQA attention for Hopper (sm_90a), with
// the KV walk split across blocks and a log-sum-exp merge.
//
// Replaces the TPU kernel
// repro/kernels/paged_attention_fused.py:_fused_decode_kernel.  One decode
// query per request, q (B,1,H,hd), attends over paged K/V pools
// (P,page,KVH,hd) through block_table (B,max_blocks) int32 and
// kv_valid_len (B,) int32 (>= 1): scores q.k / sqrt(hd) in fp32 with the H
// query heads grouped per KV head (pages are never repeated), fp32 online
// softmax, output in q's dtype.  Tokens past the valid length weigh exactly
// zero, as the reference's -1e30 fill makes them (exp underflows to 0).
//
// What bounds it on an H100: the live K/V bytes, read once (memory).  With
// G = H/KVH queries per KV head it does about 2 G flops per K/V element, far
// below the fp32 rate over the HBM rate, so the design is all about keeping
// enough loads in flight; tensor cores would not help (and TF32 would break
// the fp32 tolerance).  The TPU grid (B, max_blocks) ran its page axis in
// order; here:
//
//  - grid (B * KVH * head tiles, S): S splits of the page axis, each
//    ceil(max_blocks / S) pages (both handed in), planned on the host from B, KVH,
//    max_blocks, the SM count and the instance's resident blocks (never
//    from kv_valid_len, which stays on the device).  A block reads its own
//    length; a split past the request's last page exits at once, and no
//    page past ceil(len / page) is dereferenced.
//  - inside a split, four warps take tokens in turn.  The lanes of a warp
//    split a K/V row into 16-byte chunks (L = 8, 16 or 32 lanes a row,
//    R = 32 / L rows a warp at once), and a warp step loads U tokens of each
//    row group (U x GT <= L, U at most 8, and 8 / C on the widest rows)
//    into registers before any math.
//    The queries of the head tile and each lane's slice of the accumulator
//    live in registers.  The step's U x GT dot products reduce in one
//    butterfly over the row's lanes: each round a lane sends half of the
//    values it still holds and adds its partner's other half, so
//    log2(U GT) rounds leave one dot product a lane (about U GT shuffles in
//    all, not log2(L) a product).  The lane then runs the online softmax
//    for its own (head, token), one division and one exp, and the weights
//    reach every lane's accumulator slice by broadcast.  No K/V chunk is
//    staged in shared memory, and the walk has no __syncthreads at all.
//  - the four warps' states merge through shared memory (one barrier), in
//    warp order.  A request with one live split writes its output there;
//    otherwise each live split writes (m, l, acc) in fp32 to a workspace,
//    fences and takes a ticket from its row's counter, and the block that
//    draws the last ticket merges the live splits in split order
//    (m = max m_s, l = sum e^(m_s - m) l_s, acc likewise), writes the
//    output and resets the counter to 0.  One launch a call; the result does
//    not depend on the order in which blocks finish.  Launches that share
//    the counters must not overlap: the host keeps one buffer a device and
//    launches on one stream.
//
// A row whose hd is not a multiple of the 16-byte chunk, or pools that are
// not 16-byte aligned, take masked element loads inside the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                 // threads a block: four warps
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// A 16-byte chunk of a row as four raw 32-bit words, and its element v as fp32
template <typename PT> struct Elem;
template <> struct Elem<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float get(const uint32_t (&w)[4], int v) {
    return __uint_as_float(w[v]);
  }
  static __device__ __forceinline__ uint32_t bits(const float* p, int d) {
    return __float_as_uint(__ldg(p + d));
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], int v, uint32_t b) { w[v] = b; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float get(const uint32_t (&w)[4], int v) {
    return __uint_as_float((v & 1) ? (w[v >> 1] & 0xffff0000u) : (w[v >> 1] << 16));
  }
  static __device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p, int d) {
    return __ldg(reinterpret_cast<const unsigned short*>(p) + d);
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], int v, uint32_t b) {
    w[v >> 1] |= b << (16 * (v & 1));
  }
};

// Chunk c of a row (elements (c * L + lr) * VEC ..), zero past hd: one
// 16-byte load when `vec`, else element by element.
template <typename PT, int C>
__device__ __forceinline__ void load_row(const PT* __restrict__ row, int lr, int L, int hd,
                                         bool vec, uint32_t (&w)[C][4]) {
  constexpr int VEC = Elem<PT>::VEC;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d0 = (c * L + lr) * VEC;
    w[c][0] = w[c][1] = w[c][2] = w[c][3] = 0u;
    if (vec) {
      if (d0 < hd) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + d0));
        w[c][0] = x.x;
        w[c][1] = x.y;
        w[c][2] = x.z;
        w[c][3] = x.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (d0 + v < hd) Elem<PT>::put(w[c], v, Elem<PT>::bits(row, d0 + v));
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_o(void* out, size_t i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// e^(m_s - m), 0 for a state that saw no token (m_s = -inf)
__device__ __forceinline__ float rescale(float m_s, float m) {
  return m_s == -INFINITY ? 0.0f : expf(m_s - m);
}

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// One block: row blockIdx.x = (b, kvh, head tile of GT query heads), split
// blockIdx.y.  L lanes a K/V row (8, 16 or 32), C chunks of VEC elements a
// lane (C * L * VEC >= hd).  A warp step takes U tokens of each of its
// R = 32 / L row groups, U * GT = N <= L dot products a row group.
// smem: [NWARPS][GT][hd + 2] floats (each warp's acc, m, l)
// ws:   [rows][S][GT][hd + 2] floats (each split's acc, m, l)
template <typename PT, int C, int GT, int L>
__global__ void __launch_bounds__(NT)
fused_decode_split_kernel(const void* __restrict__ q, const PT* __restrict__ pool_k,
                          const PT* __restrict__ pool_v, const int* __restrict__ block_table,
                          const int* __restrict__ kv_valid_len, void* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ counters, int H, int KVH,
                          int hd, int page, int max_blocks, int pages_per_split, int n_gtiles,
                          bool q_bf16, bool vec) {
  constexpr int VEC = Elem<PT>::VEC;
  constexpr int R = 32 / L;
  // tokens a row group takes a step: at most 8, and 8 / C for the wide
  // rows (C >= 4), whose K/V registers would spill at 8
  constexpr int U_MAX = C >= 4 ? 8 / C : 8;
  constexpr int U = L / GT >= U_MAX ? U_MAX : L / GT;
  constexpr int N = U * GT;                   // dot products a row group a step
  constexpr int SHIFT = ilog2(L) - ilog2(N);  // lane bits below a dot's index
  static_assert(U >= 1 && N <= L && (L & (L - 1)) == 0, "instance shape");
  extern __shared__ float red[];

  const int row = blockIdx.x, split = blockIdx.y;
  const int gt = row % n_gtiles, kvh = (row / n_gtiles) % KVH, b = row / n_gtiles / KVH;
  const int G = H / KVH;
  const int valid = kv_valid_len[b];
  const int n_blocks = min((valid + page - 1) / page, max_blocks);
  const int n_live = (n_blocks + pages_per_split - 1) / pages_per_split;
  if (split > 0 && split >= n_live) return;   // past the request's last page

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / L, lr = lane % L;     // row group, lane within the row
  // after the butterfly each lane holds one dot product: head my_g, token my_u
  const int idx = lr >> SHIFT, my_g = idx / U, my_u = idx % U;
  const float root_hd = sqrtf((float)hd);
  const int t_begin = split * pages_per_split * page;
  const int t_end = min(min(t_begin + pages_per_split * page, n_blocks * page), valid);
  const int* bt_row = block_table + (size_t)b * max_blocks;

  // the head tile's queries, this lane's elements (heads past G repeat the
  // last one and are never stored)
  float qv[GT][C][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const size_t h = (size_t)b * H + (size_t)kvh * G + min(gt * GT + g, G - 1);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int d = (c * L + lr) * VEC + v;
        qv[g][c][v] = d < hd ? load_q(q, h * hd + d, q_bf16) : 0.0f;
      }
  }

  // running max and denominator of head my_g (the same in every lane of that
  // head, over all row groups); accumulators of every head, this lane's slice
  float m_run = -INFINITY, l_run = 0.0f;
  float acc[GT][C][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[g][c][v] = 0.0f;

  for (int base = t_begin + warp * U * R; base < t_end; base += NWARPS * U * R) {
    uint32_t kr[U][C][4], vr[U][C][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = base + u * R + rg;
      if (tok < t_end) {
        const int j = tok / page;
        const size_t off = (((size_t)bt_row[j] * page + (tok - j * page)) * KVH + kvh) * hd;
        load_row<PT, C>(pool_k + off, lr, L, hd, vec, kr[u]);
        load_row<PT, C>(pool_v + off, lr, L, hd, vec, vr[u]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) kr[u][c][e] = vr[u][c][e] = 0u;
      }
    }
    // the N partial dot products of this lane's slice, then a butterfly over
    // the row's L lanes: each round sends half of the values still held and
    // adds the partner's other half, until one is left, which the remaining
    // rounds sum (x + y on one lane, y + x on its partner: equal)
    float sv[N];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot = fmaf(qv[g][c][v], Elem<PT>::get(kr[u][c], v), dot);
        sv[g * U + u] = dot;
      }
#pragma unroll
    for (int r = 0; r < ilog2(L); ++r) {
      const int o = L >> (r + 1);
      if (r < ilog2(N)) {
        const int n = N >> (r + 1);           // values a lane keeps this round
        const bool upper = (lane & o) != 0;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          if (i < n) {
            const float send = upper ? sv[i] : sv[i + n];
            const float keep = upper ? sv[i + n] : sv[i];
            sv[i] = keep + __shfl_xor_sync(FULL, send, o);
          }
        }
      } else {
        sv[0] += __shfl_xor_sync(FULL, sv[0], o);
      }
    }
    // online softmax of head my_g over this step's tokens of every row group
    const bool ok = base + my_u * R + rg < t_end;
    const float sc = ok ? sv[0] / root_hd : -INFINITY;
    float mx = sc;
#pragma unroll
    for (int o = 1 << SHIFT; o < (U << SHIFT); o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
#pragma unroll
    for (int o = L; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = rescale(m_run, m_new);  // 0 before the first token
    const float p = ok ? expf(sc - m_new) : 0.0f;
    float ps = p;
#pragma unroll
    for (int o = 1 << SHIFT; o < (U << SHIFT); o <<= 1) ps += __shfl_xor_sync(FULL, ps, o);
#pragma unroll
    for (int o = L; o < 32; o <<= 1) ps += __shfl_xor_sync(FULL, ps, o);
    l_run = alpha * l_run + ps;
    m_run = m_new;
    // every lane's accumulator slice takes each head's alpha and each of its
    // row group's weights from the lanes that hold them
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float ag = __shfl_sync(FULL, alpha, rg * L + ((g * U) << SHIFT));
      float pg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) pg[u] = __shfl_sync(FULL, p, rg * L + ((g * U + u) << SHIFT));
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float a = ag * acc[g][c][v];
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(pg[u], Elem<PT>::get(vr[u][c], v), a);
          acc[g][c][v] = a;
        }
    }
  }

  // the row groups of a warp share m and l: sum their acc, then the four
  // warps' states meet in shared memory
  const int sp = hd + 2;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float* dst = red + (warp * GT + g) * sp;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float a = acc[g][c][v];
#pragma unroll
        for (int o = L; o < 32; o <<= 1) a += __shfl_xor_sync(FULL, a, o);
        const int d = (c * L + lr) * VEC + v;
        if (rg == 0 && d < hd) dst[d] = a;
      }
  }
  if (rg == 0 && my_u == 0 && (lr & ((1 << SHIFT) - 1)) == 0) {
    float* dst = red + (warp * GT + my_g) * sp;
    dst[hd] = m_run;
    dst[hd + 1] = l_run;
  }
  __syncthreads();


  const int heads = min(GT, G - gt * GT);
  const size_t o_base = ((size_t)b * H + (size_t)kvh * G + (size_t)gt * GT) * hd;
  const bool merge = n_live > 1;
  float* part = merge ? ws + ((size_t)row * gridDim.y + split) * GT * sp : nullptr;
  for (int e = tid; e < GT * hd; e += NT) {
    const int g = e / hd, d = e - g * hd;
    float mw = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mw = fmaxf(mw, red[(w * GT + g) * sp + hd]);
    float lw = 0.0f, aw = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* src = red + (w * GT + g) * sp;
      const float sc = rescale(src[hd], mw);
      lw = __fadd_rn(lw, __fmul_rn(sc, src[hd + 1]));
      aw = __fadd_rn(aw, __fmul_rn(sc, src[d]));
    }
    if (!merge) {
      if (g < heads) store_o(out, o_base + e, aw / lw, q_bf16);
    } else {
      part[g * sp + d] = aw;
      if (d == 0) {
        part[g * sp + hd] = mw;
        part[g * sp + hd + 1] = lw;
      }
    }
  }
  if (!merge) return;

  // ---- split merge: the block that draws the row's last ticket
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) {
    is_last = atomicAdd(counters + row, 1) == n_live - 1;
    if (is_last) atomicExch(counters + row, 0);   // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = ws + (size_t)row * gridDim.y * GT * sp;
  const size_t stride = (size_t)GT * sp;         // one split's partial
  for (int e = tid; e < heads * hd; e += NT) {
    const int g = e / hd, d = e - g * hd;
    const float* p0 = parts + g * sp;
    float mm = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, __ldcg(p0 + s * stride + hd));
    float ls = 0.0f, as = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float* ps = p0 + s * stride;
      const float sc = rescale(__ldcg(ps + hd), mm);
      ls = __fadd_rn(ls, __fmul_rn(sc, __ldcg(ps + hd + 1)));
      as = __fadd_rn(as, __fmul_rn(sc, __ldcg(ps + d)));
    }
    store_o(out, o_base + e, as / ls, q_bf16);
  }
}

struct Args {
  const void *q, *pool_k, *pool_v;
  const int *block_table, *kv_valid_len;
  void* out;
  float* ws;
  int* counters;
  int B, H, KVH, hd, page, max_blocks, pages_per_split, n_splits, q_bf16;
  cudaStream_t stream;
};

// Launches the instance, or, with `resident` set, launches nothing and
// stores how many of its blocks one SM holds at once.
template <typename PT, int C, int GT, int L>
cudaError_t run(const Args& a, int* resident) {
  constexpr int VEC = Elem<PT>::VEC;
  auto kernel = fused_decode_split_kernel<PT, C, GT, L>;
  const size_t smem = sizeof(float) * NWARPS * GT * (a.hd + 2);
  if (C * L * VEC < a.hd) return cudaErrorInvalidValue;
  if (resident) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, NT, smem);
  const int G = a.H / a.KVH;
  const int n_gtiles = (G + GT - 1) / GT;
  if (a.n_splits > 1 && (a.ws == nullptr || a.counters == nullptr)) return cudaErrorInvalidValue;
  const bool vec = a.hd % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.pool_k) | reinterpret_cast<uintptr_t>(a.pool_v)) & 15) == 0;
  dim3 grid((unsigned)a.B * a.KVH * n_gtiles, a.n_splits);
  kernel<<<grid, NT, smem, a.stream>>>(a.q, static_cast<const PT*>(a.pool_k),
                                       static_cast<const PT*>(a.pool_v), a.block_table,
                                       a.kv_valid_len, a.out, a.ws, a.counters, a.H, a.KVH, a.hd,
                                       a.page, a.max_blocks, a.pages_per_split, n_gtiles,
                                       a.q_bf16 != 0, vec);
  return cudaGetLastError();
}

// The instances (the host's decode_geometry maps every head dim to
// 1024 onto one): lanes a row L, chunks a lane C and query heads a block GT.
// Rows of one chunk a lane (hd to 32 chunks) and fp32 rows of two take
// head tiles of 4 (llama3-8b's G; a larger group runs as several tiles, a
// smaller one repeats its last head); wider rows take one head a block,
// C = 8 chunks for fp32 pools and 4 for bf16 ones.  Every instance holds
// GT * C * VEC = 32 query and 32 accumulator values a lane in registers.
template <typename PT>
cudaError_t dispatch(const Args& a, int lanes, int chunks, int gtile, int* resident) {
  constexpr bool F32 = sizeof(PT) == 4;
  if (chunks == 1 && gtile == 4) {
    if (lanes == 8) return run<PT, 1, 4, 8>(a, resident);
    if (lanes == 16) return run<PT, 1, 4, 16>(a, resident);
    if (lanes == 32) return run<PT, 1, 4, 32>(a, resident);
  }
  if (lanes != 32) return cudaErrorInvalidValue;
  if constexpr (F32) {
    if (chunks == 2 && gtile == 4) return run<PT, 2, 4, 32>(a, resident);
    if (chunks == 8 && gtile == 1) return run<PT, 8, 1, 32>(a, resident);
  } else {
    if (chunks == 4 && gtile == 1) return run<PT, 4, 1, 32>(a, resident);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dtype(const Args& a, int pool_dtype, int lanes, int chunks, int gtile,
                           int* resident) {
  if (pool_dtype == 0) return dispatch<float>(a, lanes, chunks, gtile, resident);
  if (pool_dtype == 1) return dispatch<__nv_bfloat16>(a, lanes, chunks, gtile, resident);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q/out are (B,1,H,hd) contiguous,
// pools (P,page,KVH,hd) contiguous, block_table (B,max_blocks) int32,
// kv_valid_len (B,) int32 with every entry >= 1.  The page axis runs as
// `n_splits` splits of `pages_per_split` pages (the host's split_geometry;
// checked here: the splits cover max_blocks and none is empty); `lanes`,
// `chunks` and `gtile` select the instance (the host's decode_geometry).
// With more than one split the caller hands in a float32 workspace of
// B * KVH * ceil(G / gtile) * n_splits * gtile * (hd + 2) and a zeroed int32
// counter per row (B * KVH * ceil(G / gtile)), which the kernel leaves
// zeroed; launches that share the counters must be ordered (one stream).
// Launches on `stream`, allocates nothing, does not synchronise, returns
// cudaGetLastError().
extern "C" int fused_paged_decode_launch(const void* q, const void* pool_k, const void* pool_v,
                                         const void* block_table, const void* kv_valid_len,
                                         void* out, void* ws, void* counters, int B, int H,
                                         int KVH, int hd, int page, int max_blocks,
                                         int pages_per_split, int n_splits, int lanes, int chunks,
                                         int gtile, int q_dtype, int pool_dtype, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || page <= 0 || max_blocks <= 0 ||
      pages_per_split < 1 || n_splits < 1 || n_splits > 65535 ||
      (long long)(n_splits - 1) * pages_per_split >= max_blocks ||
      (long long)n_splits * pages_per_split < max_blocks || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, pool_k, pool_v, static_cast<const int*>(block_table),
               static_cast<const int*>(kv_valid_len), out, static_cast<float*>(ws),
               static_cast<int*>(counters), B, H, KVH, hd, page, max_blocks, pages_per_split,
               n_splits, q_dtype, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_dtype(a, pool_dtype, lanes, chunks, gtile, nullptr);
}

// How many blocks of the instance (lanes, chunks, gtile) for head dim hd and
// pool dtype one SM of the current device holds at once, into *blocks;
// returns the CUDA error code.  The host's split plan reads it.
extern "C" int fused_paged_decode_resident_blocks(int hd, int lanes, int chunks, int gtile,
                                                  int pool_dtype, int* blocks) {
  Args a{};
  a.hd = hd;
  return (int)dispatch_dtype(a, pool_dtype, lanes, chunks, gtile, blocks);
}
