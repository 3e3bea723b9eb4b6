// Chunked-prefill flash attention over the int8 head-major packed K|V pool.
//
// Replaces: zhilight_tpu/ops/pallas/prefill_attention.py
// paged_prefill_attention_hm_packed_q (:503), kernel _kernel_prefill_hm_q
// (:380); paged_prefill_attention_hm_q (:644) is its one-segment case.
//
// Computes what prefill_attention.cu computes (NS packed segments, causal,
// optional sliding window, rows past q_lens[s] zero), over int8 K|V rows with
// one fp32 scale per (token, KV head) for K and for V:
//   s[i, j] = scale * (q[i] . K_i8[j]) * k_scales[hkv, slot(j)]
//   out[i]  = sum_j bf16(p[i, j] * v_scales[hkv, slot(j)]) * V_i8[j] / l[i]
// with p, l from the fp32 online softmax of s (NEG_INF = -2e38, max(l, 1e-20)
// floor). As in the TPU kernel, no K or V element is multiplied by a scale,
// l sums the unscaled p, and p * v_scale is rounded to bf16 before the second
// product. q is not quantized. The scales are head-major
// [Hkv, scale_stride >= N] (the reference keeps them [N, Hkv] and re-blocks
// them per call; here a tile's 64 scales are read straight from one row).
//
// Bound on the H100: operations, as for the bf16 kernel (the same two
// products per key); the K|V bytes halve. Design: the bf16 kernel's, one
// block of 4 warps per (64-query block of a segment, query head) walking
// 64-token tiles up to its causal bound, both products on WMMA 16x16x16 bf16
// tiles with fp32 accumulation. A tile's int8 rows are converted to bf16
// while they are staged into shared memory (exact: |x| <= 127), its 64 K and
// V scales are staged beside it, and the softmax pass multiplies each score
// column by its K scale before the mask and each probability by its V scale
// before rounding it to bf16. Rows past the valid context are staged as
// zeros with scale 0 and masked, so no NaN meets a zero probability.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NT = NWARPS * 32;

// two int8 values as a pair of bf16 (low half first)
__device__ __forceinline__ uint32_t pack_bf16x2(int8_t a, int8_t b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;       // bf16
  static constexpr int LDKV = 2 * D + 8;  // bf16
  static constexpr int LDS = BK + 4;      // float
  static constexpr int LDP = BK + 8;      // bf16
  static constexpr int LDO = D + 4;       // float
  static constexpr int Q_OFF = 0;
  static constexpr int KV_OFF = Q_OFF + BQ * LDQ * 2;
  static constexpr int S_OFF = KV_OFF + BK * LDKV * 2;
  static constexpr int P_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int O_OFF = P_OFF + BQ * LDP * 2;
  static constexpr int ROW_OFF = O_OFF + BQ * LDO * 4;
  static constexpr int SC_OFF = ROW_OFF + 4 * BQ * 4;  // m, l, alpha, hi
  static constexpr int BYTES = SC_OFF + 2 * BK * 4;    // k and v scales of a tile
};

template <int D>
__global__ void __launch_bounds__(NT) prefill_hm_q_kernel(
    bf16* __restrict__ out,                   // [NS*TC, Hq, D]
    const bf16* __restrict__ q,               // [NS*TC, Hq, D]
    const int8_t* __restrict__ pool,          // [Hkv, N, 2D]
    const float* __restrict__ k_scales,       // [Hkv, scale_stride]
    const float* __restrict__ v_scales,       // [Hkv, scale_stride]
    const int32_t* __restrict__ page_tables,  // [NS, maxp]
    const int32_t* __restrict__ cache_lens,   // [NS]
    const int32_t* __restrict__ q_lens,       // [NS]
    int Hq, int Hkv, long long N, long long scale_stride, int maxp, int S, int TC,
    int qblocks_per_seg, float scale, int window) {
  using L = Smem<D>;
  constexpr int D2 = 2 * D;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* sKV = reinterpret_cast<bf16*>(smem + L::KV_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* sO = reinterpret_cast<float*>(smem + L::O_OFF);
  float* sM = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* sL = sM + BQ;
  float* sAlpha = sL + BQ;
  int* sHi = reinterpret_cast<int*>(sAlpha + BQ);
  float* sKs = reinterpret_cast<float*>(smem + L::SC_OFF);
  float* sVs = sKs + BK;

  const int seg = blockIdx.x / qblocks_per_seg;
  const int row0 = (blockIdx.x % qblocks_per_seg) * BQ;
  const int hq = blockIdx.y;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long num_pages = N / S;

  const int cache_len = cache_lens[seg];
  const int q_len = q_lens[seg];
  const int total = cache_len + q_len;
  const int32_t* pt = page_tables + (long long)seg * maxp;
  const int8_t* head = pool + (long long)hkv * N * D2;
  const float* ks_head = k_scales + (long long)hkv * scale_stride;
  const float* vs_head = v_scales + (long long)hkv * scale_stride;

  // Q tile (rows past the segment are zero) and per-row state
  constexpr int QV = D / 8;  // 16-byte vectors per q row
  for (int i = tid; i < BQ * QV; i += NT) {
    const int r = i / QV, c = i % QV;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < TC)
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)seg * TC + row0 + r) * Hq + hq) * D + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c * 8) = val;
  }
  for (int r = tid; r < BQ; r += NT) {
    const int i = row0 + r;
    sHi[r] = i < q_len ? min(cache_len + i + 1, total) : 0;
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  for (int i = tid; i < BQ * D; i += NT) sO[(i / D) * L::LDO + i % D] = 0.f;

  int kv_hi = 0, kv_lo = 0;
  if (row0 < q_len) {
    kv_hi = cache_len + min(q_len, row0 + BQ);
    if (window > 0) kv_lo = max(0, cache_len + row0 + 1 - window);
  }
  kv_hi = min(kv_hi, maxp * S);
  __syncthreads();

  constexpr int KVV = D2 / 16;  // 16-byte vectors (16 int8 elements) per K|V row
  for (int j0 = (kv_lo / BK) * BK; j0 < kv_hi; j0 += BK) {
    for (int i = tid; i < BK * KVV; i += NT) {
      const int r = i / KVV, c = i % KVV;
      const int j = j0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (j < kv_hi) {
        long long page = pt[j / S];
        page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
        val = *reinterpret_cast<const uint4*>(head + (page * S + j % S) * D2 + c * 16);
      }
      // 16 int8 -> 16 bf16 (exact), two 16-byte stores
      const uint32_t words[4] = {val.x, val.y, val.z, val.w};
      uint32_t pk[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        pk[2 * w] = pack_bf16x2((int8_t)(words[w]), (int8_t)(words[w] >> 8));
        pk[2 * w + 1] = pack_bf16x2((int8_t)(words[w] >> 16), (int8_t)(words[w] >> 24));
      }
      uint4* dst = reinterpret_cast<uint4*>(sKV + r * L::LDKV + c * 16);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
    for (int r = tid; r < BK; r += NT) {
      const int j = j0 + r;
      float ks = 0.f, vs = 0.f;
      if (j < kv_hi) {
        long long page = pt[j / S];
        page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
        const long long slot = page * S + j % S;
        ks = ks_head[slot];
        vs = vs_head[slot];
      }
      sKs[r] = ks;
      sVs[r] = vs;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          wmma::load_matrix_sync(a, sQ + warp * 16 * L::LDQ + k * 16, L::LDQ);
          wmma::load_matrix_sync(b, sKV + n * 16 * L::LDKV + k * 16, L::LDKV);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, c, L::LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 columns each
    {
      const int r = warp * 16 + lane / 2;
      const int c0 = (lane % 2) * (BK / 2);
      const int hi = sHi[r];
      const int lo = window > 0 ? hi - window : 0;
      float* srow = sS + r * L::LDS;
      float mx = NEG_INF;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int j = j0 + c;
        const float s = (j < hi && j >= lo) ? srow[c] * scale * sKs[c] : NEG_INF;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      bf16* prow = sP + r * L::LDP;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int j = j0 + c;
        const float p = (j < hi && j >= lo) ? __expf(srow[c] - m_new) : 0.f;
        prow[c] = __float2bfloat16(p * sVs[c]);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (lane % 2 == 0) {
        const float alpha = __expf(m_old - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sAlpha[r] = alpha;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = warp * 16 + i / D;
      sO[r * L::LDO + i % D] *= sAlpha[r];
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        float* o = sO + warp * 16 * L::LDO + n * 16;
        wmma::load_matrix_sync(c, o, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          wmma::load_matrix_sync(a, sP + warp * 16 * L::LDP + k * 16, L::LDP);
          wmma::load_matrix_sync(b, sKV + k * 16 * L::LDKV + D + n * 16, L::LDKV);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(o, c, L::LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();  // every warp is done with sKV and the scales before the next tile
  }

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    if (row0 + r >= TC) continue;
    const float val = sO[r * L::LDO + d] / fmaxf(sL[r], 1e-20f);
    out[(((long long)seg * TC + row0 + r) * Hq + hq) * D + d] = __float2bfloat16(val);
  }
}

template <int D>
int launch(void* out, const void* q, const void* pool, const void* k_scales,
           const void* v_scales, const void* page_tables, const void* cache_lens,
           const void* q_lens, int NS, int TC, int Hq, int Hkv, long long N,
           long long scale_stride, int maxp, int S, float scale, int window,
           cudaStream_t stream) {
  const int bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_hm_q_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int qbps = (TC + BQ - 1) / BQ;
  prefill_hm_q_kernel<D><<<dim3(NS * qbps, Hq), NT, bytes, stream>>>(
      (bf16*)out, (const bf16*)q, (const int8_t*)pool, (const float*)k_scales,
      (const float*)v_scales, (const int32_t*)page_tables, (const int32_t*)cache_lens,
      (const int32_t*)q_lens, Hq, Hkv, N, scale_stride, maxp, S, TC, qbps, scale,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported: bf16 q, int8 pool, fp32 scales, D in {64, 128}, Hq a multiple of
// Hkv. Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_prefill_attention_hm_q(void* out, const void* q, const void* pool,
                                         const void* k_scales, const void* v_scales,
                                         const void* page_tables,
                                         const void* cache_lens, const void* q_lens,
                                         int NS, int TC, int Hq, int Hkv, int D,
                                         long long N, long long scale_stride,
                                         int maxp, int S, float scale, int window,
                                         void* stream) {
  if (NS == 0 || TC == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>(out, q, pool, k_scales, v_scales, page_tables, cache_lens, q_lens,
                      NS, TC, Hq, Hkv, N, scale_stride, maxp, S, scale, window, st);
  if (D == 128)
    return launch<128>(out, q, pool, k_scales, v_scales, page_tables, cache_lens, q_lens,
                       NS, TC, Hq, Hkv, N, scale_stride, maxp, S, scale, window, st);
  return (int)cudaErrorInvalidValue;
}
