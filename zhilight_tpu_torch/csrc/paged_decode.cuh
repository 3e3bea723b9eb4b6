// Paged decode attention over separate slot-major K and V pools, shared by
// paged_attention.cu (bf16 pools) and paged_attention_q.cu (int8 pools with
// fp32 scales).
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py
// paged_decode_attention (:364; kernels _kernel :48 and _kernel_bs :179) and
// paged_decode_attention_q (:971; kernel _kernel_bs_q :884).
//
// Computes, for each sequence b and query head h = hkv * G + g, over the
// tokens t in [start, ctx), ctx = context_lens[b], start = max(0, ctx -
// window) when a sliding window is set, token t living at slot =
// page_tables[b, t / S] * S + t % S of pools K, V [N, Hkv, D]:
//   s[t]      = scale * q[b, h] . K[slot, hkv]            (bf16 pools)
//   s[t]      = scale * (q[b, h] . K_i8[slot, hkv]) * k_scales[hkv, slot]
//   out[b, h] = sum_t p[t] * V[slot, hkv] / l             (bf16 pools)
//   out[b, h] = sum_t (p[t] * v_scales[hkv, slot]) * V_i8[slot, hkv] / l
// with p, l from an fp32 online softmax of s (NEG_INF = -2e38, the max(l,
// 1e-20) floor of the TPU kernels, so an empty slot gives zeros). Nothing is
// rounded before the output: not the probabilities, not a dequantized row.
// The scales are head-major [Hkv, scale_stride >= N] (the reference keeps them
// [N, Hkv]).
//
// Bound on the H100: bytes. Each (b, KV head) streams ctx * D elements of K
// and of V once, one row of D elements per token at (slot * Hkv + hkv) * D:
// at B = 8, ctx 3712, 8 KV heads of 80 that is 76.0 MB per layer in bf16
// (22.7 us at 3.35 TB/s) and 38.0 MB + 1.9 MB of scales in int8 (11.9 us).
// The arithmetic is 4 * G flops per element, far under the card's 295 flops
// per byte.
//
// Design. Any D up to 256 and any G. A row is read in vectors of VEC
// elements, the widest of 8, 2 or 1 that the row's alignment allows (a
// token's row is 16-byte aligned only when D % 8 == 0: the host decides from
// D and the pointers, never by giving way to a plain version). LPT lanes, the
// least power of two that covers the row's vectors (at most 32), read one
// token, so a warp reads 32 / LPT tokens at once (2 at D = 80: 10 of each 16
// lanes load 16 bytes); a lane keeps NC vectors of the row and masks those
// past D. UNROLL such loads are issued before any is used (a lane group past
// the range reads the range's last token again and masks it, so no load waits
// on a branch): consecutive tokens of one head are Hkv * D elements apart, so
// a page's rows of one head are strided and each token is its own request.
// Grid (splits, Hkv * groups, B): a block owns up to 8 query heads of one KV head (4 when a lane holds 8
// elements; larger G is cut into groups) and reads each K and V row once for
// all of them, and the context is cut into `splits` ranges so that a batch of
// 8 sequences on 8 KV heads still fills 132 SMs. Each lane group keeps its
// own (m, l, acc); groups merge by shuffle, warps through shared memory, and
// a second kernel merges the splits (skipped when splits == 1). No tensor
// cores and no asynchronous copies yet.
//
// Fused write + attend (FUSED, bf16 pools only; paged_attention_fused.cu):
// context_lens include this step's token, whose K and V rows (k_new, v_new
// [B, Hkv, D], already in the pool's dtype) are not in the pool yet. The
// context loop covers the pool tokens t < ctx - 1 only and never reads row
// ctx - 1: another block of the same sequence writes it during the launch.
// The new token's column (s = scale * q . k_new, value v_new) is folded into
// the fp32 softmax once per (b, query head): by the block itself when
// splits == 1, else by the merge kernel, as one more partial (m = s, l = 1,
// acc = v_new). An empty context therefore gives v_new, not zeros. Split 0,
// head group 0 of each (b, KV head) writes that head's rows at
// slot_mapping[b] when it is >= 0 (and ctx >= 1, as the TPU kernel writes
// only inside a context). A stored row is rs elements long; K sits at its
// start, V at v_pool - k_pool elements into it: separate pools (rs = D,
// v_pool its own array) or the packed single pool [N, Hkv, 2D] (rs = 2D,
// v_pool = k_pool + D).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace zt_paged {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -2.0e38f;
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int UNROLL = 4;
constexpr int DMAX = 256;

__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* f) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  f[0] = x.x;
  f[1] = x.y;
}

__device__ __forceinline__ void i8x4_to_f(uint32_t w, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(&w);
  f[0] = (float)c.x;
  f[1] = (float)c.y;
  f[2] = (float)c.z;
  f[3] = (float)c.w;
}

// VEC elements at p (aligned to VEC elements) as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f);

template <>
__device__ __forceinline__ void load_vec<bf16, 8>(const bf16* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  bf16x2_to_f(r.x, f);
  bf16x2_to_f(r.y, f + 2);
  bf16x2_to_f(r.z, f + 4);
  bf16x2_to_f(r.w, f + 6);
}

template <>
__device__ __forceinline__ void load_vec<bf16, 2>(const bf16* p, float* f) {
  bf16x2_to_f(*reinterpret_cast<const uint32_t*>(p), f);
}

template <>
__device__ __forceinline__ void load_vec<bf16, 1>(const bf16* p, float* f) {
  f[0] = __bfloat162float(*p);
}

template <>
__device__ __forceinline__ void load_vec<int8_t, 8>(const int8_t* p, float* f) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  i8x4_to_f(r.x, f);
  i8x4_to_f(r.y, f + 4);
}

template <>
__device__ __forceinline__ void load_vec<int8_t, 2>(const int8_t* p, float* f) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  f[0] = (float)c.x;
  f[1] = (float)c.y;
}

template <>
__device__ __forceinline__ void load_vec<int8_t, 1>(const int8_t* p, float* f) {
  f[0] = (float)*p;
}

// The fused mode's extra inputs (null pointers otherwise).
struct FusedRows {
  const bf16* k_new;      // [B, Hkv, D] this step's rows, in the pool's dtype
  const bf16* v_new;      // [B, Hkv, D]
  const int32_t* slots;   // [B] pool slot of each row; < 0 => not written
  bf16* k_dst;            // the pools again, written at slots[b] only
  bf16* v_dst;
};

// sum of x over the block's 128 threads, returned to every thread
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float red[NWARPS];
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // a previous call's readers are done with red
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) s += red[w];
  return s;
}

// scale * a . b over n bf16 elements, for the block's 128 threads
__device__ __forceinline__ float block_dot(const bf16* a, const bf16* b, int n, float scale) {
  float x = 0.f;
  for (int d = threadIdx.x; d < n; d += NT) x += __bfloat162float(a[d]) * __bfloat162float(b[d]);
  return block_sum(x) * scale;
}

// T: bf16 (model-dtype pools) or int8 (quantized pools, read with scales).
// VEC elements per load, NC loads per lane and token, GMAX query rows held;
// FUSED: write this step's rows and fold their column in (header).
template <typename T, int VEC, int NC, int GMAX, bool FUSED>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    bf16* __restrict__ out,                   // [B, Hq, D] (splits == 1)
    float* __restrict__ part_acc,             // [B, Hq, splits, D] (splits > 1)
    float* __restrict__ part_ml,              // [B, Hq, splits, 2]
    const bf16* __restrict__ q,               // [B, Hq, D]
    const T* __restrict__ k_pool,             // [N, Hkv, rs]: K at the row's start
    const T* __restrict__ v_pool,             // V at the same stride
    const float* __restrict__ k_scales,       // [Hkv, scale_stride] (int8 pools)
    const float* __restrict__ v_scales,       // [Hkv, scale_stride] (int8 pools)
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    FusedRows fz, int Hkv, int G, int gt, int D, long long rs, long long N,
    long long scale_stride, int maxp, int S, float scale, int window, int lpt_log2) {
  constexpr int EPL = VEC * NC;  // elements of a row a lane holds
  constexpr bool QUANT = sizeof(T) == 1;
  static_assert(!(FUSED && QUANT), "the fused mode takes bf16 pools");
  const int split = blockIdx.x, splits = gridDim.x;
  const int groups = gridDim.y / Hkv;
  const int hkv = blockIdx.y / groups;
  const int g0 = (blockIdx.y % groups) * gt;
  const int gn = min(gt, G - g0);  // query rows of this block
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int LPT = 1 << lpt_log2;   // lanes that read one token
  const int TPW = 32 >> lpt_log2;  // tokens a warp reads at once
  const int sub = lane & (LPT - 1);
  const int tsel = lane >> lpt_log2;
  const int Hq = Hkv * G;
  const long long num_pages = N / S;

  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S));
  // the fused mode's row ctx - 1 comes from k_new / v_new, never the pool
  const int end = FUSED ? max(ctx - 1, 0) : ctx;
  const int start = window > 0 ? max(0, ctx - window) : 0;
  const int per = (end - start + splits - 1) / splits;
  const int t_begin = start + split * per;
  const int t_end = min(t_begin + per, end);

  if constexpr (FUSED) {
    const long long slot = fz.slots[b];
    if (split == 0 && g0 == 0 && slot >= 0 && slot < N && ctx >= 1) {
      const long long src = ((long long)b * Hkv + hkv) * D;
      const long long dst = (slot * Hkv + hkv) * rs;
      for (int d = threadIdx.x; d < D; d += NT) {
        fz.k_dst[dst + d] = fz.k_new[src + d];
        fz.v_dst[dst + d] = fz.v_new[src + d];
      }
    }
  }

  float qv[GMAX][EPL], acc[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = 0.f;
    }
    if (g < gn) {
      const bf16* qrow = q + ((long long)b * Hq + hkv * G + g0 + g) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e0 = (c * LPT + sub) * VEC;
        if (e0 < D) load_vec<bf16, VEC>(qrow + e0, &qv[g][c * VEC]);
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] *= scale;
    }
  }

  const int32_t* pt = page_tables + (long long)b * maxp;
  const int step = UNROLL * TPW;
  for (int t0 = t_begin + warp * step; t0 < t_end; t0 += NWARPS * step) {
    float kf[UNROLL][EPL], vf[UNROLL][EPL];
    float ksc[UNROLL], vsc[UNROLL];
    long long row[UNROLL];
    bool valid[UNROLL];
    // every lane group reads a real token (a past-the-range one reads the
    // range's last token and is masked below), so the page-table reads and
    // then all K and V loads issue unconditionally, back to back
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * TPW + tsel;
      valid[u] = t < t_end;
      const int tc = valid[u] ? t : t_end - 1;
      long long page = pt[tc / S];
      page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
      const long long slot = page * S + tc % S;
      row[u] = (slot * Hkv + hkv) * rs;
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      if constexpr (QUANT) {
        ksc[u] = k_scales[hkv * scale_stride + slot];
        vsc[u] = v_scales[hkv * scale_stride + slot];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kf[u][e] = 0.f;
        vf[u][e] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e0 = (c * LPT + sub) * VEC;
        if (e0 < D) {
          load_vec<T, VEC>(k_pool + row[u] + e0, &kf[u][c * VEC]);
          load_vec<T, VEC>(v_pool + row[u] + e0, &vf[u][c * VEC]);
        }
      }
    }
    // partial scores of this lane's elements, summed over the token's lanes
    float s[UNROLL][GMAX];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qv[g][e] * kf[u][e];
        s[u][g] = d;
      }
    }
    for (int off = LPT >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
    }
    // blockwise online softmax over this lane group's UNROLL tokens
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float x = s[u][g];
        if constexpr (QUANT) x *= ksc[u];
        s[u][g] = valid[u] ? x : NEG_INF;
        m_new = fmaxf(m_new, s[u][g]);
      }
      const float alpha = __expf(m[g] - m_new);
      float lsum = 0.f;
      float upd[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) upd[e] = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = valid[u] ? __expf(s[u][g] - m_new) : 0.f;
        lsum += p;
        const float pv = QUANT ? p * vsc[u] : p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) upd[e] += pv * vf[u][e];
      }
      l[g] = l[g] * alpha + lsum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + upd[e];
      m[g] = m_new;
    }
  }

  // the lane groups of a warp hold the states of different tokens
  for (int off = LPT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], m_o);
      const float fa = __expf(m[g] - M), fb = __expf(m_o - M);
      l[g] = l[g] * fa + l_o * fb;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * fa + a_o * fb;
      }
      m[g] = M;
    }
  }

  // the warps merge through shared memory: [NWARPS][GMAX] m and l, then
  // [NWARPS][GMAX][D] accumulators
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = sm_m + NWARPS * GMAX;
  float* sm_acc = sm_l + NWARPS * GMAX;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (lane == 0) {
      sm_m[warp * GMAX + g] = m[g];
      sm_l[warp * GMAX + g] = l[g];
    }
    if (tsel == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e0 = (c * LPT + sub) * VEC;
        if (e0 < D) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            sm_acc[(warp * GMAX + g) * D + e0 + i] = acc[g][c * VEC + i];
        }
      }
    }
  }
  __syncthreads();
  // the new token's scores, when this block is the only split (block-uniform)
  __shared__ float sm_new[GMAX];
  const bool fold = FUSED && splits == 1;
  if (fold) {
    const bf16* kn = fz.k_new + ((long long)b * Hkv + hkv) * D;
    for (int g = 0; g < gn; ++g) {
      const float s_new = block_dot(q + ((long long)b * Hq + hkv * G + g0 + g) * D, kn, D, scale);
      if (threadIdx.x == 0) sm_new[g] = s_new;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < gn * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w * GMAX + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = __expf(sm_m[w * GMAX + g] - M);
      L += sm_l[w * GMAX + g] * f;
      A += sm_acc[(w * GMAX + g) * D + d] * f;
    }
    if (fold) {  // one more partial: m = s_new, l = 1, acc = v_new
      const float s_new = sm_new[g];
      const float M2 = fmaxf(M, s_new);
      const float fa = __expf(M - M2), fb = __expf(s_new - M2);
      const float vn = __bfloat162float(fz.v_new[((long long)b * Hkv + hkv) * D + d]);
      L = L * fa + fb;
      A = A * fa + vn * fb;
    }
    const long long bh = (long long)b * Hq + hkv * G + g0 + g;
    if (splits == 1) {
      out[bh * D + d] = __float2bfloat16(A / fmaxf(L, 1e-20f));
    } else {
      const long long p = bh * splits + split;
      part_acc[p * D + d] = A;
      if (d == 0) {
        part_ml[p * 2] = M;
        part_ml[p * 2 + 1] = L;
      }
    }
  }
}

// out[b, h, :] = sum_s acc_s * exp(m_s - M) / max(sum_s l_s * exp(m_s - M), 1e-20);
// FUSED adds the new token's column as one more partial (m = scale * q .
// k_new, l = 1, acc = v_new)
template <bool FUSED>
__global__ void __launch_bounds__(NT) paged_decode_merge_kernel(
    bf16* __restrict__ out,            // [B * Hq, D]
    const float* __restrict__ part_acc,  // [B * Hq, splits, D]
    const float* __restrict__ part_ml,   // [B * Hq, splits, 2]
    const bf16* __restrict__ q,          // [B * Hq, D] (FUSED)
    FusedRows fz, int Hkv, int G, int D, int splits, float scale) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float M = NEG_INF;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  const bf16* vn = nullptr;
  float s_new = NEG_INF;
  if constexpr (FUSED) {
    const long long kv_row = (bh / (Hkv * G)) * Hkv + (bh % (Hkv * G)) / G;
    s_new = block_dot(q + bh * D, fz.k_new + kv_row * D, D, scale);
    vn = fz.v_new + kv_row * D;
    M = fmaxf(M, s_new);
  }
  float L = FUSED ? __expf(s_new - M) : 0.f;
  for (int s = 0; s < splits; ++s) L += ml[2 * s + 1] * __expf(ml[2 * s] - M);
  const float inv = 1.f / fmaxf(L, 1e-20f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    if constexpr (FUSED) a = __bfloat162float(vn[d]) * __expf(s_new - M);
    for (int s = 0; s < splits; ++s) a += part_acc[(bh * splits + s) * D + d] * __expf(ml[2 * s] - M);
    out[bh * D + d] = __float2bfloat16(a * inv);
  }
}

template <typename T, int VEC, int NC, int GMAX, bool FUSED>
int launch(void* out, void* part_acc, void* part_ml, const void* q, const void* k_pool,
           const void* v_pool, const void* k_scales, const void* v_scales,
           const void* page_tables, const void* context_lens, const FusedRows& fz, int B,
           int Hkv, int G, int groups, int gt, int D, long long rs, long long N,
           long long scale_stride, int maxp, int S, float scale, int window, int lpt_log2,
           int splits, cudaStream_t stream) {
  const size_t smem = (size_t)NWARPS * GMAX * (2 + D) * sizeof(float);
  paged_decode_kernel<T, VEC, NC, GMAX, FUSED>
      <<<dim3(splits, Hkv * groups, B), NT, smem, stream>>>(
          (bf16*)out, (float*)part_acc, (float*)part_ml, (const bf16*)q, (const T*)k_pool,
          (const T*)v_pool, (const float*)k_scales, (const float*)v_scales,
          (const int32_t*)page_tables, (const int32_t*)context_lens, fz, Hkv, G, gt, D, rs, N,
          scale_stride, maxp, S, scale, window, lpt_log2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  paged_decode_merge_kernel<FUSED><<<B * Hkv * G, NT, 0, stream>>>(
      (bf16*)out, (const float*)part_acc, (const float*)part_ml, (const bf16*)q, fz, Hkv, G, D,
      splits, scale);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// Picks the vector width, the lanes per token and the query-row groups from D,
// G, the row stride rs and the pointers, and the context ranges from the
// block count, then launches the matching instantiation.
template <typename T, bool FUSED>
int dispatch(void* out, void* part_acc, void* part_ml, const void* q, const void* k_pool,
             const void* v_pool, const void* k_scales, const void* v_scales,
             const void* page_tables, const void* context_lens, const FusedRows& fz, int B,
             int Hkv, int G, int D, long long rs, long long N, long long scale_stride, int maxp,
             int S, float scale, int window, int target_blocks, int max_splits,
             cudaStream_t stream) {
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  if (D < 1 || D > DMAX || rs < D || S < 1 || max_splits < 1) return (int)cudaErrorInvalidValue;
  const int es = (int)sizeof(T);
  auto fits = [&](int vec) {
    return D % vec == 0 && rs % vec == 0 && aligned(q, 2 * vec) && aligned(k_pool, es * vec) &&
           aligned(v_pool, es * vec);
  };
  const int vec = fits(8) ? 8 : (fits(2) ? 2 : 1);
  const int nv = D / vec;
  int lpt_log2 = 0;
  while ((1 << lpt_log2) < nv && lpt_log2 < 5) ++lpt_log2;
  const int need = (nv + (1 << lpt_log2) - 1) >> lpt_log2;
  int nc = 1;
  while (nc < need) nc <<= 1;
  // a lane holding 8 elements keeps at most 4 query rows (registers)
  const int cap = vec * nc == 8 ? 4 : 8;
  const int groups = (G + cap - 1) / cap;
  const int gt = (G + groups - 1) / groups;
  int gmax = 1;
  while (gmax < gt) gmax <<= 1;
  // context ranges: enough blocks to reach target_blocks, at most max_splits
  // (the ranges the host's partial buffers hold)
  const long long cells = (long long)B * Hkv * groups;
  const int splits = (int)std::max(1LL, std::min<long long>((target_blocks + cells - 1) / cells,
                                                            max_splits));
#define ZT_CASE(V, C, GM)                                                                   \
  if (vec == V && nc == C && gmax == GM)                                                    \
    return launch<T, V, C, GM, FUSED>(out, part_acc, part_ml, q, k_pool, v_pool, k_scales,  \
                                      v_scales, page_tables, context_lens, fz, B, Hkv, G,   \
                                      groups, gt, D, rs, N, scale_stride, maxp, S, scale,   \
                                      window, lpt_log2, splits, stream);
  // eight elements a lane: D % 8 == 0; even D of 130-256; odd D of 129-256
  ZT_CASE(8, 1, 1) ZT_CASE(8, 1, 2) ZT_CASE(8, 1, 4)
  ZT_CASE(2, 4, 1) ZT_CASE(2, 4, 2) ZT_CASE(2, 4, 4)
  ZT_CASE(1, 8, 1) ZT_CASE(1, 8, 2) ZT_CASE(1, 8, 4)
  // fewer: other even D (up to 64, 128), odd D (up to 32, 64, 128)
  ZT_CASE(2, 1, 1) ZT_CASE(2, 1, 2) ZT_CASE(2, 1, 4) ZT_CASE(2, 1, 8)
  ZT_CASE(2, 2, 1) ZT_CASE(2, 2, 2) ZT_CASE(2, 2, 4) ZT_CASE(2, 2, 8)
  ZT_CASE(1, 1, 1) ZT_CASE(1, 1, 2) ZT_CASE(1, 1, 4) ZT_CASE(1, 1, 8)
  ZT_CASE(1, 2, 1) ZT_CASE(1, 2, 2) ZT_CASE(1, 2, 4) ZT_CASE(1, 2, 8)
  ZT_CASE(1, 4, 1) ZT_CASE(1, 4, 2) ZT_CASE(1, 4, 4) ZT_CASE(1, 4, 8)
#undef ZT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace zt_paged
