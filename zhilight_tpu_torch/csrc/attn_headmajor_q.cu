// Paged decode attention over the int8 head-major packed K|V pool.
//
// Replaces: zhilight_tpu/ops/pallas/attn_headmajor.py
// paged_decode_attention_hm_q (:341), kernel _kernel_hm_q (:254), in its
// default mode (normalized output) and its emit_partial mode (:325-336, the
// flash partials of the decode-window side buffer: fp32 m, l and the
// unnormalized acc, written instead of acc / max(l, 1e-20)).
//
// Computes, for each sequence b and query head h = hkv * G + g, over the
// tokens t in [start, ctx), ctx = context_lens[b], start = max(0, ctx -
// window) when a sliding window is set, token t living at slot =
// page_tables[b, t / S] * S + t % S:
//   s[t] = scale * (q[b, h] . K_i8[hkv, slot, :D]) * k_scales[hkv, slot]
//   out[b, h] = sum_t (p[t] * v_scales[hkv, slot]) * V_i8[hkv, slot, D:] / l
// with p, l from an fp32 online softmax of s (NEG_INF = -2e38, max(l, 1e-20)
// floor, so an empty slot yields zeros). No element of K or V is multiplied
// by its scale: the K scale folds into the score and the V scale into the
// probability. p * v_scale stays fp32 here (the TPU kernel rounds it to q's
// dtype before its second matrix product).
//
// The scales are head-major [Hkv, scale_stride >= N] (the reference keeps
// them [N, Hkv]): the block of one KV head reads its tokens' scales from one
// row, 16 neighbouring floats per page, not one float per 4 * Hkv bytes.
//
// Bound on the H100: bytes. Each (b, kv head) streams ctx * 2D bytes of the
// pool and ctx * 8 bytes of scales once: at B=8, ctx 3712, 8 KV heads, D=128
// that is 62.7 MB per layer, 18.7 us at 3.35 TB/s. Design: grid (B, Hkv) as
// the bf16 kernel, so a block owns the G query rows of one KV head and reads
// each row once for all of them, walking only the valid pages. A lane holds 4
// int8 elements of K and of V (one 4-byte load each, converted to float in
// registers), so D / 4 lanes cover a token: a warp loads one token at D=128
// and two at D=64 (a half-warp each) per 128-byte request, never 2-byte
// loads. UNROLL such loads are issued before any is used. The softmax runs
// blockwise over those tokens: one running-max update and one rescale of the
// accumulator per group, and the G heads' score reductions are independent
// shuffle chains the compiler interleaves. Each half-warp keeps its own
// (m, l, acc); the halves merge by shuffle and the warps through shared
// memory at the end. Like its sibling it launches B * Hkv blocks (64 at the
// shape above, on 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NWARPS = 8;
constexpr int UNROLL = 4;
constexpr int EPL = 4;  // int8 elements of K (and of V) a lane holds

__device__ __forceinline__ void unpack_i8x4(uint32_t raw, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(&raw);
  f[0] = (float)c.x;
  f[1] = (float)c.y;
  f[2] = (float)c.z;
  f[3] = (float)c.w;
}

template <int D, int GMAX, bool EMIT>
__global__ void __launch_bounds__(NWARPS * 32) decode_hm_q_kernel(
    void* __restrict__ out,                   // [B, Hq, D]: bf16, or fp32 acc with EMIT
    float* __restrict__ m_out,                // [B, Hq] with EMIT, else unused
    float* __restrict__ l_out,                // [B, Hq] with EMIT, else unused
    const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
    const int8_t* __restrict__ pool,          // [Hkv, N, 2D]
    const float* __restrict__ k_scales,       // [Hkv, scale_stride]
    const float* __restrict__ v_scales,       // [Hkv, scale_stride]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    int Hkv, int G, long long N, long long scale_stride, int maxp, int S,
    float scale, int window) {
  constexpr int LPT = D / EPL;         // lanes that cover one token
  constexpr int TPW = 32 / LPT;        // tokens a warp loads at once
  constexpr int STEP = UNROLL * TPW;   // tokens a warp takes per iteration
  const int b = blockIdx.x;
  const int hkv = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPT;   // which 4 elements of the row
  const int tsel = lane / LPT;  // which token of the warp's load
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
      const uint2 raw = *reinterpret_cast<const uint2*>(
          q + ((long long)b * Hq + hkv * G + g) * D + sub * EPL);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      qv[g][0] = lo.x * scale;
      qv[g][1] = lo.y * scale;
      qv[g][2] = hi.x * scale;
      qv[g][3] = hi.y * scale;
    }
  }

  const int8_t* head = pool + (long long)hkv * N * 2 * D;
  const float* ks_head = k_scales + (long long)hkv * scale_stride;
  const float* vs_head = v_scales + (long long)hkv * scale_stride;
  const int32_t* pt = page_tables + (long long)b * maxp;

  for (int t0 = start + warp * STEP; t0 < ctx; t0 += NWARPS * STEP) {
    uint32_t kraw[UNROLL], vraw[UNROLL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * TPW + tsel;
      kraw[u] = 0u;
      vraw[u] = 0u;
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      if (t < ctx) {
        long long page = pt[t / S];
        page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
        const long long slot = page * S + t % S;
        const int8_t* row = head + slot * 2 * D + sub * EPL;
        kraw[u] = *reinterpret_cast<const uint32_t*>(row);
        vraw[u] = *reinterpret_cast<const uint32_t*>(row + D);
        ksc[u] = ks_head[slot];
        vsc[u] = vs_head[slot];
      }
    }
    // scores of the group's tokens for every query row of this KV head
    float s[UNROLL][GMAX];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[EPL];
      unpack_i8x4(kraw[u], kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qv[g][e] * kf[e];
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = LPT / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
    }
    // blockwise online softmax over the group
    float vf[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) unpack_i8x4(vraw[u], vf[u]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool valid = t0 + u * TPW + tsel < ctx;
        s[u][g] = valid ? s[u][g] * ksc[u] : NEG_INF;
        m_new = fmaxf(m_new, s[u][g]);
      }
      const float alpha = __expf(m[g] - m_new);
      float lsum = 0.f;
      float upd[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) upd[e] = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool valid = t0 + u * TPW + tsel < ctx;
        const float p = valid ? __expf(s[u][g] - m_new) : 0.f;
        lsum += p;
        const float pv = p * vsc[u];
#pragma unroll
        for (int e = 0; e < EPL; ++e) upd[e] += pv * vf[u][e];
      }
      l[g] = l[g] * alpha + lsum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + upd[e];
      m[g] = m_new;
    }
  }

  // the two half-warps of a D=64 warp hold states of different tokens
  if constexpr (TPW == 2) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], LPT);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], LPT);
      const float M = fmaxf(m[g], m_o);
      const float fa = __expf(m[g] - M), fb = __expf(m_o - M);
      l[g] = l[g] * fa + l_o * fb;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], LPT);
        acc[g][e] = acc[g][e] * fa + a_o * fb;
      }
      m[g] = M;
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
    if (tsel == 0) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][sub * EPL + e] = acc[g][e];
    }
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
    const long long row = (long long)b * Hq + hkv * G + g;
    if constexpr (EMIT) {
      static_cast<float*>(out)[row * D + d] = A;
      if (d == 0) {
        m_out[row] = M;
        l_out[row] = L;
      }
    } else {
      static_cast<__nv_bfloat16*>(out)[row * D + d] = __float2bfloat16(A / fmaxf(L, 1e-20f));
    }
  }
}

template <int D, int GMAX>
int launch(void* out, float* m_out, float* l_out, const void* q, const void* pool,
           const void* k_scales, const void* v_scales, const void* page_tables,
           const void* context_lens, int B, int Hkv, int G, long long N,
           long long scale_stride, int maxp, int S, float scale, int window,
           cudaStream_t stream) {
  auto kernel = m_out != nullptr ? decode_hm_q_kernel<D, GMAX, true>
                                 : decode_hm_q_kernel<D, GMAX, false>;
  kernel<<<dim3(B, Hkv), NWARPS * 32, 0, stream>>>(
      out, m_out, l_out, (const __nv_bfloat16*)q, (const int8_t*)pool,
      (const float*)k_scales, (const float*)v_scales, (const int32_t*)page_tables,
      (const int32_t*)context_lens, Hkv, G, N, scale_stride, maxp, S, scale, window);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_g(void* out, float* m_out, float* l_out, const void* q, const void* pool,
               const void* k_scales, const void* v_scales, const void* page_tables,
               const void* context_lens, int B, int Hkv, int G, long long N,
               long long scale_stride, int maxp, int S, float scale, int window,
               cudaStream_t stream) {
  // rows past G would be computed for nothing, so every G up to 8 has its
  // own instantiation (Qwen2.5-14B: G = 5)
#define ZT_G(GM)                                                                  \
  if (G <= GM)                                                                    \
    return launch<D, GM>(out, m_out, l_out, q, pool, k_scales, v_scales, page_tables, \
                         context_lens, B, Hkv, G, N, scale_stride, maxp, S, scale, \
                         window, stream);
  ZT_G(1) ZT_G(2) ZT_G(3) ZT_G(4) ZT_G(5) ZT_G(6) ZT_G(7) ZT_G(8)
  // the merge buffer of 16 query rows at D=128 would exceed 48 KB of static
  // shared memory
  if constexpr (D == 64) { ZT_G(16) }
#undef ZT_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Supported: bf16 q, int8 pool, fp32 scales; D = 64 with G = Hq / Hkv in
// [1, 16], or D = 128 with G in [1, 8]. With m_out (and l_out) non-null the
// partial mode runs: out is fp32 [B, Hq, D] and receives the unnormalized
// accumulator, m_out and l_out fp32 [B, Hq] the running max and normalizer.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_decode_attention_hm_q(void* out, float* m_out, float* l_out,
                                        const void* q, const void* pool,
                                        const void* k_scales, const void* v_scales,
                                        const void* page_tables,
                                        const void* context_lens, int B, int Hkv,
                                        int G, int D, long long N,
                                        long long scale_stride, int maxp, int S,
                                        float scale, int window, void* stream) {
  if (B == 0) return 0;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return dispatch_g<64>(out, m_out, l_out, q, pool, k_scales, v_scales, page_tables, context_lens,
                          B, Hkv, G, N, scale_stride, maxp, S, scale, window, st);
  if (D == 128)
    return dispatch_g<128>(out, m_out, l_out, q, pool, k_scales, v_scales, page_tables, context_lens,
                           B, Hkv, G, N, scale_stride, maxp, S, scale, window, st);
  return (int)cudaErrorInvalidValue;
}
