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
//   out[i]  = sum_j T(p[i, j] * v_scales[hkv, slot(j)]) * V_i8[j] / l[i]
// (T: the type of q and out, bf16 or fp16)
// with p, l from the fp32 online softmax of s (NEG_INF = -2e38, max(l, 1e-20)
// floor). As in the TPU kernel, no K or V element is multiplied by a scale,
// the K scale multiplies the score before the mask, l sums the unscaled p,
// and p * v_scale is rounded to T before the second product. q is not
// quantized. The scales are head-major [Hkv, scale_stride >= N] (the
// reference keeps them [N, Hkv] and re-blocks them per call; here a tile's
// scales are read straight from one row).
//
// Bound on the H100: operations, 4 * Hq * D flops per (query, visible key),
// as for the bf16 kernel: 36.3 GFLOP for a 512-token chunk at cache 3200 with
// Qwen2.5-14B's 40 heads of 128 (36.6 us at 989 TFLOP/s), while its int8 K|V
// bytes and scales (7.6 MB + 0.2 MB) take 2.4 us.
//
// Design: prefill_attention.cu's (see its header), with int8 tiles:
// - One block of 4 warps per (64-query block of a segment, query head), the
//   blocks with the most keys launched first; warp w owns query rows [16w,
//   16w + 16) and skips the key tiles wholly masked for them. S = Q K^T and
//   O += P V run on mma.sync m16n8k16 (bf16 -> fp32); the scores, the row max
//   and sum, P (the A operand of P V) and O stay in registers. Q's fragments
//   stay in registers at D <= 128 and are re-read from the staged Q tile at
//   D 192 and 256.
// - A tile's int8 K|V rows (half the bytes of the bf16 kernel's) are
//   gathered through the page table with 16-byte cp.async copies into a ring
//   of int8 slots (page ids fetched a tile ahead, gather_tile in
//   attn_tile.cuh), its BK K and V scales with 4-byte copies beside them.
//   Rows outside the block's key range are zero-filled and their scales
//   staged as 0, so no stale bytes or scales (inf, NaN) reach a product.
// - Int8 -> bf16 is exact (|x| <= 127) and done once a tile in shared memory:
//   the thread that copied a 16-byte chunk converts it (2^23 + 128 + x built
//   in a float's mantissa, minus 2^23 + 128; the float's top half is the
//   bf16) into a bf16 K|V tile laid out as the bf16 kernel stages it, which
//   the warps then read through ldmatrix (K) and ldmatrix.trans (V). A
//   conversion in registers would build the fragments from single bytes:
//   V's B fragment pairs two keys of one column, two rows apart in the tile,
//   which ldmatrix (16-bit elements) cannot gather. Each chunk is converted
//   once a block rather than once a warp.
// - Pipeline: the bf16 tile is double-buffered, so tile it + 1 is converted
//   while tile it is multiplied, with one __syncthreads a tile. A thread
//   converts only the chunks it copied, so the int8 ring needs no barrier of
//   its own: tile it + STAGES is copied into the slot tile it left.
// - Key tiles: 64 keys at D 64, 32 at D 128 and 192, 16 at D 256, so that
//   three blocks share an SM at D <= 128 and two above.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace zt_mma;

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;  // query rows per block
constexpr int NWARPS = BQ / 16;
constexpr int NT = NWARPS * 32;

template <int D>
struct Cfg {
  static constexpr int BK = D == 64 ? 64 : D == 256 ? 16 : 32;  // keys per tile
  static constexpr int STAGES = D == 64 ? 3 : 2;                 // int8 slots
  static constexpr int D2 = 2 * D;                               // int8 per K|V row
  static constexpr int CH = BK * D2 / 16 / NT;                   // chunks a thread copies
  static constexpr int UNROLL = D == 64 ? CH : 2;
  static constexpr bool QREG = D <= 128;  // Q fragments held in registers
  static constexpr int LDQ = D + 8;       // bf16 per staged q row
  static constexpr int LDK = D2 + 8;      // bf16 per converted K|V row
  static constexpr int Q_BYTES = BQ * LDQ * 2;
  static constexpr int BUF = BK * LDK * 2 + 2 * BK * 4;  // bf16 tile, its K and V scales
  static constexpr int SLOT = BK * D2 + 2 * BK * 4;      // int8 tile, its K and V scales
  static constexpr int BYTES = Q_BYTES + 2 * BUF + STAGES * SLOT;
  static_assert(D % 64 == 0 && (BK * D2 / 16) % NT == 0 && (2 * BK) % 32 == 0, "shapes");
};

// 16 int8 -> 16 elements of T (8 pairs, low byte in the low half), exactly
template <class T>
__device__ __forceinline__ void int8x16_to(uint4 v, uint32_t* out) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) Elem<T>::i8x4(words[w], out[2 * w], out[2 * w + 1]);
}

// three blocks an SM up to D 128 (at most 170 registers a thread), two above
template <int D, class T>
__global__ void __launch_bounds__(NT, D <= 128 ? 3 : 2) prefill_hm_q_kernel(
    T* __restrict__ out,                      // [NS*TC, Hq, D]
    const T* __restrict__ q,                  // [NS*TC, Hq, D]
    const int8_t* __restrict__ pool,          // [Hkv, N, 2D]
    const float* __restrict__ k_scales,       // [Hkv, scale_stride]
    const float* __restrict__ v_scales,       // [Hkv, scale_stride]
    const int32_t* __restrict__ page_tables,  // [NS, maxp]
    const int32_t* __restrict__ cache_lens,   // [NS]
    const int32_t* __restrict__ q_lens,       // [NS]
    int Hq, int Hkv, long long N, long long scale_stride, int maxp, int S, int TC, int NS,
    int qblocks_per_seg, float scale, int window) {
  using C = Cfg<D>;
  using E = Elem<T>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  unsigned char* sBuf = smem + C::Q_BYTES;               // 2 x (T tile, scales)
  unsigned char* sSlot = sBuf + 2 * C::BUF;              // STAGES x (int8 tile, scales)

  const int hq = blockIdx.x;
  const int seg = blockIdx.y % NS;
  const int row0 = (qblocks_per_seg - 1 - blockIdx.y / NS) * BQ;  // the last blocks first
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long num_pages = N / S;

  const int cache_len = cache_lens[seg];
  const int q_len = q_lens[seg];
  const int total = cache_len + q_len;
  const int32_t* pt = page_tables + (long long)seg * maxp;
  const int8_t* head = pool + (long long)hkv * N * C::D2;
  const float* ks_head = k_scales + (long long)hkv * scale_stride;
  const float* vs_head = v_scales + (long long)hkv * scale_stride;

  // the block's keys [kv_lo, kv_hi)
  int kv_hi = 0, kv_lo = 0;
  if (row0 < q_len) {
    kv_hi = cache_len + min(q_len, row0 + BQ);
    if (window > 0) kv_lo = max(0, cache_len + row0 + 1 - window);
  }
  kv_hi = min(kv_hi, maxp * S);

  // Q tile (rows past the segment's TC are zero)
  constexpr int QV = D / 8;
  for (int i = tid; i < BQ * QV; i += NT) {
    const int r = i / QV, c = i % QV;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < TC)
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)seg * TC + row0 + r) * Hq + hq) * D + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * C::LDQ + c * 8) = val;
  }

  // the int8 ring: tile `issued` goes next into slot issued % STAGES, its
  // page ids already in `ids`
  const int s_shift = log2_if_pow2(S);
  auto page_of = [&](int t) { return s_shift >= 0 ? t >> s_shift : t / S; };
  const int jt0 = (kv_lo / BK) * BK;
  const int n = kv_hi > jt0 ? (kv_hi - jt0 + BK - 1) / BK : 0;
  int issued = 0;
  PageIds ids{};
  if (n > 0) ids = fetch_pages(pt, maxp, page_of(jt0), lane);
  auto issue = [&]() {
    if (issued < n) {
      const int j0 = jt0 + issued * BK;
      unsigned char* slot = sSlot + (issued % C::STAGES) * C::SLOT;
      gather_tile<BK, C::D2, C::D2, NT, C::UNROLL, int8_t>(
          reinterpret_cast<int8_t*>(slot), head, pt, ids, j0, kv_lo, kv_hi, S, s_shift,
          num_pages, tid);
      if (tid < 2 * BK) {  // whole warps: the K scales, then the V scales
        const int r = tid % BK, t = j0 + r;
        float* dst = reinterpret_cast<float*>(slot + BK * C::D2) + tid;
        const int pidx = page_of(t), rel = pidx - ids.p0;
        const int pa = __shfl_sync(0xffffffffu, ids.a, rel & 31);
        const int pb = __shfl_sync(0xffffffffu, ids.b, rel & 31);
        if (t >= kv_lo && t < kv_hi) {
          long long page = rel < 32 ? pa : (rel < 64 ? pb : pt[pidx]);
          page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
          const float* src = (tid < BK ? ks_head : vs_head) + page * S + (t - pidx * S);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                       "l"(src));
        } else {
          *dst = 0.f;
        }
      }
      if (++issued < n) ids = fetch_pages(pt, maxp, page_of(j0 + BK), lane);
    }
    cp_async_commit();
  };
  // tile t's chunks (and scales) this thread copied, converted into buffer t % 2
  auto convert = [&](int t) {
    const unsigned char* slot = sSlot + (t % C::STAGES) * C::SLOT;
    unsigned char* buf = sBuf + (t % 2) * C::BUF;
    constexpr int CPR = C::D2 / 16;
#pragma unroll
    for (int k = 0; k < C::CH; ++k) {
      const int i = tid + k * NT, r = i / CPR, c = i % CPR;
      uint32_t pk[8];
      int8x16_to<T>(*reinterpret_cast<const uint4*>(slot + r * C::D2 + c * 16), pk);
      uint4* dst = reinterpret_cast<uint4*>(buf + (r * C::LDK + c * 16) * 2);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
    if (tid < 2 * BK)
      reinterpret_cast<float*>(buf + BK * C::LDK * 2)[tid] =
          reinterpret_cast<const float*>(slot + BK * C::D2)[tid];
  };
#pragma unroll
  for (int s = 0; s < C::STAGES; ++s) issue();
  if (n > 0) {
    cp_async_wait<C::STAGES - 1>();  // tile 0
    convert(0);
  }

  // this thread's rows g and g + 8 of the warp's 16, their key bounds [lo, hi)
  const int g = lane / 4;
  int hi[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + warp * 16 + g + 8 * r;
    hi[r] = i < q_len ? min(cache_len + i + 1, total) : 0;
    lo[r] = window > 0 ? hi[r] - window : 0;
  }
  // the warp's extremes: tiles outside [lo_min, hi_max) are skipped, tiles
  // inside [lo_max, hi_min) need no mask
  int hi_max = max(hi[0], hi[1]), hi_min = min(hi[0], hi[1]);
  int lo_min = min(lo[0], lo[1]), lo_max = max(lo[0], lo[1]);
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    hi_max = max(hi_max, __shfl_xor_sync(0xffffffffu, hi_max, off));
    hi_min = min(hi_min, __shfl_xor_sync(0xffffffffu, hi_min, off));
    lo_min = min(lo_min, __shfl_xor_sync(0xffffffffu, lo_min, off));
    lo_max = max(lo_max, __shfl_xor_sync(0xffffffffu, lo_max, off));
  }

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  constexpr int QF = C::QREG ? D / 16 : 1;
  uint32_t qf[QF][4];
  const T* qw = sQ + warp * 16 * C::LDQ;
  const int c2 = 2 * (lane % 4);

  for (int it = 0; it < n; ++it) {
    // tile it converted (and, on the first pass, the Q tile staged); every
    // warp is done with buffer (it + 1) % 2
    __syncthreads();
    if (it + 1 < n) {
      cp_async_wait<C::STAGES - 2>();  // this thread's chunks of tile it + 1
      convert(it + 1);
    }
    issue();  // tile it + STAGES, into the slot tile it left
    if constexpr (C::QREG) {
      if (it == 0) {
#pragma unroll
        for (int k = 0; k < D / 16; ++k) ldsm_x4(qf[k], qw + a_offset(lane, C::LDQ, k * 16));
      }
    }
    const int j0 = jt0 + it * BK;
    if (j0 >= hi_max || j0 + BK <= lo_min) continue;  // warp-uniform: all masked
    const bool full = j0 + BK <= hi_min && j0 >= lo_max;
    const unsigned char* buf = sBuf + (it % 2) * C::BUF;
    const T* kv = reinterpret_cast<const T*>(buf);
    const float* sks = reinterpret_cast<const float*>(buf + BK * C::LDK * 2);
    const float* svs = sks + BK;

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      uint32_t a_ld[4];
      const uint32_t* a;
      if constexpr (C::QREG) {
        a = qf[k];
      } else {
        ldsm_x4(a_ld, qw + a_offset(lane, C::LDQ, k * 16));
        a = a_ld;
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kv + b_offset(lane, C::LDK, np * 16, k * 16));
        E::mma(s[2 * np], a, bk[0], bk[1]);
        E::mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax over the tile for rows g and g + 8; the K scale of key
    // column c multiplies its score before the mask
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float2 ksc = *reinterpret_cast<const float2*>(sks + nt * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * scale * (e & 1 ? ksc.y : ksc.x);
        if (!full) {
          const int j = j0 + nt * 8 + c2 + (e & 1);
          if (j >= hi[e >> 1] || j < lo[e >> 1]) v = NEG_INF;
        }
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // p (unscaled) into l; p times the key's V scale, rounded to T, into P
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float2 vsc = *reinterpret_cast<const float2*>(svs + nt * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] > NEG_INF ? __expf(s[nt][e] - m_r[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        s[nt][e] = p * (e & 1 ? vsc.y : vsc.x);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {E::pack(s[2 * kk][0], s[2 * kk][1]),
                              E::pack(s[2 * kk][2], s[2 * kk][3]),
                              E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, kv + bt_offset(lane, C::LDK, kk * 16, D + dp * 16));
        E::mma(o[2 * dp], pa, bv[0], bv[1]);
        E::mma(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = 1.f / fmaxf(l_r[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + warp * 16 + g + 8 * r;
    if (i >= TC) continue;
    T* orow = out + (((long long)seg * TC + i) * Hq + hq) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          E::pack(o[j][2 * r] * l_r[r], o[j][2 * r + 1] * l_r[r]);
  }
}

template <int D, class T>
int launch(void* out, const void* q, const void* pool, const void* k_scales,
           const void* v_scales, const void* page_tables, const void* cache_lens,
           const void* q_lens, int NS, int TC, int Hq, int Hkv, long long N,
           long long scale_stride, int maxp, int S, float scale, int window,
           cudaStream_t stream) {
  using C = Cfg<D>;
  static int err = -1;  // once per head dim and type
  if (err < 0) {  // and the largest carveout, so that two or three blocks share an SM
    err = (int)cudaFuncSetAttribute(prefill_hm_q_kernel<D, T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (!err)
      err = (int)cudaFuncSetAttribute(prefill_hm_q_kernel<D, T>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared);
  }
  if (err) return err;
  const int qbps = (TC + BQ - 1) / BQ;
  prefill_hm_q_kernel<D, T><<<dim3(Hq, NS * qbps), NT, C::BYTES, stream>>>(
      (T*)out, (const T*)q, (const int8_t*)pool, (const float*)k_scales,
      (const float*)v_scales, (const int32_t*)page_tables, (const int32_t*)cache_lens,
      (const int32_t*)q_lens, Hq, Hkv, N, scale_stride, maxp, S, TC, NS, qbps, scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported: bf16 q (fp16 with fp16 != 0), int8 pool, fp32 scales, D in {64, 128, 192, 256}, Hq a
// multiple of Hkv. Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_prefill_attention_hm_q(void* out, const void* q, const void* pool,
                                         const void* k_scales, const void* v_scales,
                                         const void* page_tables,
                                         const void* cache_lens, const void* q_lens,
                                         int NS, int TC, int Hq, int Hkv, int D,
                                         long long N, long long scale_stride,
                                         int maxp, int S, float scale, int window,
                                         int fp16, void* stream) {
  if (NS == 0 || TC == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define ZT_D(DD)                                                                          \
  if (D == DD)                                                                            \
    return (fp16 ? launch<DD, __half> : launch<DD, bf16>)(                               \
        out, q, pool, k_scales, v_scales, page_tables, cache_lens, q_lens, NS, TC, Hq, Hkv, \
        N, scale_stride, maxp, S, scale, window, st);
  ZT_D(64) ZT_D(128) ZT_D(192) ZT_D(256)
#undef ZT_D
  return (int)cudaErrorInvalidValue;
}
