// Paged decode attention over the head-major packed K|V pool.
//
// Replaces: zhilight_tpu/ops/pallas/attn_headmajor.py
// paged_decode_attention_hm (:151), kernel _kernel_hm (:54), in its default
// mode (normalized output; no emit_partial, no MLA v_dim).
//
// Computes, for each sequence b and query head h = hkv * G + g:
//   out[b, h] = softmax(scale * q[b, h] . K[t]) . V[t] over the tokens
//   t in [start, ctx), ctx = context_lens[b], start = max(0, ctx - window)
//   when a sliding window is set; token t lives at pool[hkv, page*S + t%S]
//   with page = page_tables[b, t / S]; K is lanes [:D], V lanes [D:].
// fp32 scores and online softmax with NEG_INF = -2e38 and the max(l, 1e-20)
// floor of the TPU kernel, so an empty slot (ctx == 0) yields zeros.
//
// Bound on the H100: bytes. Each (b, kv head) streams ctx * 2D elements of
// the pool once; at B=16, ctx 512, 36 heads, D=64 in bf16 that is 75.5 MB per
// layer, 22.5 us at 3.35 TB/s; the arithmetic is G*4D flops per 4D bytes.
// Design: grid (B, Hkv), so a block owns the G query rows of one KV head and
// reads each K|V row once for all of them. Only the ceil(ctx / S) valid
// pages are walked (the TPU kernel fetched every page-table slot, clamped).
// Each of the block's warps takes every NWARPS-th group of UNROLL tokens;
// lane l holds elements [l*D/32, (l+1)*D/32) of q, K, V and the accumulator,
// so a warp's loads of one row are one coalesced 128- or 256-byte segment
// and a score is a 5-step shuffle reduction. Several tokens' loads are issued
// before any is used, to keep memory requests in flight. Each warp keeps its
// own (m, l, acc); the warps merge through shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NWARPS = 8;
constexpr int UNROLL = 4;

template <int EPL>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* f) {
  if constexpr (EPL == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = x.x;
    f[1] = x.y;
  } else {
    static_assert(EPL == 4, "EPL");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
}

template <int D, int GMAX>
__global__ void __launch_bounds__(NWARPS * 32) decode_hm_kernel(
    __nv_bfloat16* __restrict__ out,          // [B, Hq, D]
    const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
    const __nv_bfloat16* __restrict__ pool,   // [Hkv, N, 2D]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    int Hkv, int G, long long N, int maxp, int S, float scale, int window) {
  constexpr int EPL = D / 32;
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int Hq = Hkv * G;
  const long long num_pages = N / S;

  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S));
  const int start = window > 0 ? max(0, ctx - window) : 0;

  float qv[GMAX][EPL];
  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = 0.f;
    }
    if (g < G) {
      load_bf16<EPL>(q + ((long long)b * Hq + hkv * G + g) * D + lane * EPL, qv[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] *= scale;
    }
  }

  const __nv_bfloat16* head = pool + (long long)hkv * N * 2 * D;
  const int32_t* pt = page_tables + (long long)b * maxp;

  for (int t0 = start + warp * UNROLL; t0 < ctx; t0 += NWARPS * UNROLL) {
    float kf[UNROLL][EPL], vf[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < ctx) {
        long long page = pt[t / S];
        page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
        const __nv_bfloat16* row = head + (page * S + t % S) * 2 * D + lane * EPL;
        load_bf16<EPL>(row, kf[u]);
        load_bf16<EPL>(row + D, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u >= ctx) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qv[g][e] * kf[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        const float m_new = fmaxf(m[g], s);
        const float alpha = __expf(m[g] - m_new);
        const float p = __expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[u][e];
        m[g] = m_new;
      }
    }
  }

  __shared__ float sm_m[NWARPS][GMAX];
  __shared__ float sm_l[NWARPS][GMAX];
  __shared__ float sm_acc[NWARPS][GMAX][D];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = __expf(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    out[((long long)b * Hq + hkv * G + g) * D + d] = __float2bfloat16(A / fmaxf(L, 1e-20f));
  }
}

template <int D, int GMAX>
int launch(void* out, const void* q, const void* pool, const void* page_tables,
           const void* context_lens, int B, int Hkv, int G, long long N, int maxp,
           int S, float scale, int window, cudaStream_t stream) {
  decode_hm_kernel<D, GMAX><<<dim3(B, Hkv), NWARPS * 32, 0, stream>>>(
      (__nv_bfloat16*)out, (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool,
      (const int32_t*)page_tables, (const int32_t*)context_lens, Hkv, G, N, maxp,
      S, scale, window);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_g(void* out, const void* q, const void* pool, const void* page_tables,
               const void* context_lens, int B, int Hkv, int G, long long N,
               int maxp, int S, float scale, int window, cudaStream_t stream) {
#define ZT_G(GM)                                                                 \
  if (G <= GM)                                                                   \
    return launch<D, GM>(out, q, pool, page_tables, context_lens, B, Hkv, G, N, \
                         maxp, S, scale, window, stream);
  ZT_G(1) ZT_G(2) ZT_G(4) ZT_G(8)
  // the merge buffer of 16 query rows at D=128 would exceed 48 KB of static
  // shared memory
  if constexpr (D == 64) { ZT_G(16) }
#undef ZT_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Supported: bf16 q and pool, D = 64 with G = Hq / Hkv in [1, 16], or
// D = 128 with G in [1, 8].
extern "C" int zt_decode_attention_hm(void* out, const void* q, const void* pool,
                                      const void* page_tables,
                                      const void* context_lens, int B, int Hkv,
                                      int G, int D, long long N, int maxp, int S,
                                      float scale, int window, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return dispatch_g<64>(out, q, pool, page_tables, context_lens, B, Hkv, G, N,
                          maxp, S, scale, window, st);
  if (D == 128)
    return dispatch_g<128>(out, q, pool, page_tables, context_lens, B, Hkv, G, N,
                           maxp, S, scale, window, st);
  return (int)cudaErrorInvalidValue;
}
