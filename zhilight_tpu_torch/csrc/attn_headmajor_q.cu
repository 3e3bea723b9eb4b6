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
// page_tables[b, t / S] * S + t % S (the page clamped into the pool):
//   s[t] = scale * (q[b, h] . K_i8[hkv, slot, :D]) * k_scales[hkv, slot]
//   out[b, h] = sum_t T(p[t] * v_scales[hkv, slot]) * V_i8[hkv, slot, D:] / l
// with q and out of one type T, bf16 or fp16,
// and p, l from an fp32 online softmax of s (NEG_INF = -2e38, max(l, 1e-20)
// floor, so an empty slot yields zeros). As in the TPU kernel, no element of
// K or V is multiplied by its scale: the K scale multiplies the score before
// the mask, l sums the unscaled p, and p * v_scale is rounded to T as the
// A operand of the second product (the TPU kernel's (p * vs_h).astype(q.dtype),
// :319). The scales are head-major [Hkv, scale_stride >= N] (the reference
// keeps them [N, Hkv]): a tile's scales are read from one row.
//
// Bound on the H100: bytes. Each (b, kv head) streams ctx * 2D bytes of the
// pool and ctx * 8 bytes of scales once: at B=8, ctx 3712, 8 KV heads, D=128
// that is 62.7 MB per layer, 18.7 us at 3.35 TB/s. The arithmetic is 4 * G
// flops per pool element, far under the card's rate.
//
// Design: the bf16 kernel's (attn_headmajor.cu, split-context flash decoding
// on mma.sync) over int8 tiles:
// - Grid (splits, Hkv * groups of 16 query rows, B); `splits` from the shapes
//   and this kernel's occupancy (ops/cuda/attn_headmajor.py decode_splits), so
//   the blocks fill one wave; the splits' partials merge in the same launch
//   by a ticket (decode_split.cuh). Any G (groups of 16 rows) and D in {64,
//   128, 192, 256}.
// - 64-token tiles of int8 K|V rows (2D bytes, half the bf16 kernel's) are
//   gathered through the page table with 16-byte cp.async copies into a ring
//   of stages, the page ids fetched a tile ahead (attn_tile.cuh); the tile's
//   K and V scales ride along with 4-byte copies. Rows outside [start, ctx)
//   get zero bytes and zero scales.
// - No converted tile in shared memory: each lane reads the int8 words its
//   mma.sync fragments need and converts them exactly in registers (|x| <=
//   127: 2^23 + 128 + x built in a float's mantissa, minus 2^23 + 128; the
//   float's top half is the bf16). For Q K^T a lane's B fragment of key g
//   takes one word, head dims 16k + 4i .. + 3, as k slots (2i, 2i + 1, 2i + 8,
//   2i + 9): the dot product does not depend on the order of the head dims, so
//   the lane's Q fragment takes the same dims in the same slots, read as two
//   8-byte words of the staged q rows (held in registers at D <= 128). For P V
//   a lane reads the words of its four keys (2i, 2i + 1, 2i + 8, 2i + 9) at
//   head dims 32c + 4g .. + 3: byte t of them is B column g of n8-tile t, so
//   output column j of n8-tile 4c + t is head dim 32c + 4j + t; the warps'
//   merge puts the columns back. Rows of 2D + 16 bytes make both reads
//   conflict-free. K's scale multiplies the score columns before the mask; p
//   times V's scale, rounded to bf16, is the A operand of P V.
// - Warp w takes tokens [16w, 16w + 16) of each tile and keeps its own (m, l,
//   O); one __syncthreads a tile for the ring.
// - Shared memory: the ring (4 stages at D 64, 3 above) and the staged q rows;
//   the end-of-block merge reuses the ring. At D 256 a stage is 34.3 KB, the
//   block 111 KB: two blocks an SM. The trade: a converted bf16 tile (66 KB at
//   D 256) would let ldmatrix gather the fragments, at the cost of a stage and
//   a block an SM; the register conversion costs a few instructions a byte,
//   well inside the byte bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "decode_split.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace zt_mma;
using namespace zt_decode;

template <int D>
struct Cfg {
  static constexpr int LDK = 2 * D + 16;  // bytes per staged int8 K|V row
  static constexpr int LDQ = D + 8;       // bf16 per staged q row
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int STAGE = TN * LDK + 2 * TN * 4;  // bytes: rows, then K and V scales
  static constexpr int RING = STAGES * STAGE;
  static constexpr int MERGE = merge_floats<D>() * 4;
  static constexpr int BUF = RING > MERGE ? RING : MERGE;
  static constexpr int BYTES = BUF + HR * LDQ * 2;
  static constexpr int CH = TN * 2 * D / 16 / NT;  // 16-byte chunks a thread copies
  static constexpr int UNROLL = CH < 4 ? CH : 4;
  // blocks an SM: MiniCPM-2B's 576 (sequence, head) pairs in one wave at D 64
  static constexpr int MINB = D == 64 ? 5 : D == 128 ? 3 : 2;
  static_assert(D % 64 == 0 && 2 * TN == NT, "shapes");
};

template <int D, bool EMIT, class T>
__global__ void __launch_bounds__(NT, Cfg<D>::MINB) decode_hm_q_kernel(
    void* __restrict__ out,                   // [B, Hq, D]: T, or fp32 acc with EMIT
    float* __restrict__ m_out,                // [B, Hq] with EMIT, else unused
    float* __restrict__ l_out,                // [B, Hq] with EMIT, else unused
    float* __restrict__ part_acc,             // [B, Hkv * groups, splits, HR, D]
    float* __restrict__ part_ml,              // [B, Hkv * groups, splits, 2, HR]
    int* __restrict__ tickets,                // [B, Hkv * groups], zero between launches
    const T* __restrict__ q,                  // [B, Hq, D]
    const int8_t* __restrict__ pool,          // [Hkv, N, 2D]
    const float* __restrict__ k_scales,       // [Hkv, scale_stride]
    const float* __restrict__ v_scales,       // [Hkv, scale_stride]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    int Hkv, int G, int groups, long long N, long long scale_stride, int maxp, int S,
    float scale, int window) {
  using C = Cfg<D>;
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + C::BUF);
  __shared__ int s_last;

  const int split = blockIdx.x, splits = gridDim.x;
  const int hg = blockIdx.y;  // hkv * groups + group
  const int hkv = hg / groups, grp = hg % groups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i = lane % 4;
  const int Hq = Hkv * G;
  const int h0 = hkv * G + grp * HR;  // the block's first query head
  const int rows = min(HR, G - grp * HR);

  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S));
  const int start = window > 0 ? max(0, ctx - window) : 0;
  int first, last;
  const int parts = max(split_range(start, ctx, splits, split, &first, &last), 1);
  if (split >= parts) return;  // an empty split: the merge counts `parts` tickets only

  // q rows of the group (zero rows past `rows`)
  constexpr int QV = D / 8;
  for (int r0 = tid; r0 < HR * QV; r0 += NT) {
    const int r = r0 / QV, c = r0 % QV;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(q + ((long long)b * Hq + h0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * C::LDQ + c * 8) = v;
  }

  const int8_t* head = pool + (long long)hkv * N * 2 * D;
  const float* ks_head = k_scales + (long long)hkv * scale_stride;
  const float* vs_head = v_scales + (long long)hkv * scale_stride;
  const int32_t* pt = page_tables + (long long)b * maxp;
  const long long num_pages = N / S;
  const int s_shift = log2_if_pow2(S);
  auto page_of = [&](int t) { return s_shift >= 0 ? t >> s_shift : t / S; };

  // the ring: tile `first + issued` goes next, its page ids already in `ids`
  const int n = last - first;
  int issued = 0;
  PageIds ids{};
  if (n > 0) ids = fetch_pages(pt, maxp, page_of(first * TN), lane);
  auto issue = [&]() {
    if (issued < n) {
      const int t0 = (first + issued) * TN;
      unsigned char* st = smem + (issued % C::STAGES) * C::STAGE;
      gather_tile<TN, 2 * D, C::LDK, NT, C::UNROLL, int8_t>(
          reinterpret_cast<int8_t*>(st), head, pt, ids, t0, start, ctx, S, s_shift, num_pages, tid);
      {  // thread tid: the K scale of row tid (tid < 64), else the V scale of row tid - 64
        const int r = tid % TN, t = t0 + r;
        float* dst = reinterpret_cast<float*>(st + TN * C::LDK) + tid;
        const int pidx = page_of(t), rel = pidx - ids.p0;
        const int pa = __shfl_sync(0xffffffffu, ids.a, rel & 31);
        const int pb = __shfl_sync(0xffffffffu, ids.b, rel & 31);
        if (t >= start && t < ctx) {
          long long page = rel < 32 ? pa : (rel < 64 ? pb : pt[pidx]);
          page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
          const float* src = (tid < TN ? ks_head : vs_head) + page * S + (t - pidx * S);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                       "l"(src));
        } else {
          *dst = 0.f;
        }
      }
      if (++issued < n) ids = fetch_pages(pt, maxp, page_of(t0 + TN), lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) issue();

  // lane's Q fragment of head dims [16k, 16k + 16): dims 16k + 4i .. + 3 of
  // rows g and g + 8, as k slots (2i, 2i + 1, 2i + 8, 2i + 9)
  auto q_frag = [&](int k, uint32_t* a) {
    const uint2 lo = *reinterpret_cast<const uint2*>(sQ + g * C::LDQ + 16 * k + 4 * i);
    const uint2 hi = *reinterpret_cast<const uint2*>(sQ + (g + 8) * C::LDQ + 16 * k + 4 * i);
    a[0] = lo.x;
    a[1] = hi.x;
    a[2] = lo.y;
    a[3] = hi.y;
  };
  constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? D / 16 : 1][4];

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < n; ++it) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile it is in (and q staged); every warp is done with tile it - 1
    issue();          // tile it + STAGES - 1, into tile it - 1's stage
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int k = 0; k < D / 16; ++k) q_frag(k, qf[k]);
      }
    }
    const int tok0 = (first + it) * TN + warp * 16;  // this warp's 16 tokens
    if (tok0 >= ctx || tok0 + 16 <= start) continue;  // warp-uniform
    const unsigned char* st = smem + (it % C::STAGES) * C::STAGE;
    const unsigned char* kw = st + warp * 16 * C::LDK;
    const float* sks = reinterpret_cast<const float*>(st + TN * C::LDK) + warp * 16;
    const float* svs = sks + TN;

    // S = Q K^T over the warp's 16 keys (two n8-tiles: keys g and 8 + g)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      uint32_t a_ld[4];
      const uint32_t* a;
      if constexpr (QREG) {
        a = qf[k];
      } else {
        q_frag(k, a_ld);
        a = a_ld;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b0, b1;
        E::i8x4(*reinterpret_cast<const uint32_t*>(kw + (nt * 8 + g) * C::LDK + 16 * k + 4 * i),
                b0, b1);
        E::mma(s[nt], a, b0, b1);
      }
    }

    // online softmax over the warp's 16 keys for rows g and g + 8; the K
    // scale of key column c multiplies its score before the mask
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 ksc = *reinterpret_cast<const float2*>(sks + nt * 8 + 2 * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tok0 + nt * 8 + 2 * i + (e & 1);
        const float v = (t >= start && t < ctx) ? s[nt][e] * scale * (e & 1 ? ksc.y : ksc.x)
                                                : NEG_INF;
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
    for (int nt = 0; nt < 2; ++nt) {
      const float2 vsc = *reinterpret_cast<const float2*>(svs + nt * 8 + 2 * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] > NEG_INF ? __expf(s[nt][e] - m_r[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        s[nt][e] = p * (e & 1 ? vsc.y : vsc.x);
      }
    }
    const uint32_t pa[4] = {E::pack(s[0][0], s[0][1]), E::pack(s[0][2], s[0][3]),
                            E::pack(s[1][0], s[1][1]), E::pack(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V: the words of keys 2i, 2i + 1, 2i + 8, 2i + 9 at head dims
    // 32c + 4g .. + 3; byte t is B column g of n8-tile 4c + t
    const unsigned char* vw = kw + 2 * i * C::LDK + D + 4 * g;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vw + 32 * c);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vw + C::LDK + 32 * c);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(vw + 8 * C::LDK + 32 * c);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(vw + 9 * C::LDK + 32 * c);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        E::mma(o[4 * c + t], pa, E::i8pair(w0, w1, t), E::i8pair(w8, w9, t));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages become the merge buffers

  // per warp O (head dims back in order), m and l (l summed over the quad first)
  float* sO = reinterpret_cast<float*>(smem);  // [NWARPS][HR][D]
  float* sM = sO + NWARPS * HR * D;            // [NWARPS][HR]
  float* sL = sM + NWARPS * HR;                // [NWARPS][HR]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (i == 0) {
    sM[warp * HR + g] = m_r[0];
    sM[warp * HR + g + 8] = m_r[1];
    sL[warp * HR + g] = l_r[0];
    sL[warp * HR + g + 8] = l_r[1];
  }
  float* ow = sO + warp * HR * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ow[(g + 8 * (e >> 1)) * D + 32 * (j / 4) + 4 * (2 * i + (e & 1)) + j % 4] = o[j][e];
  decode_merge<D, EMIT, T>(sO, out, m_out, l_out, part_acc, part_ml, tickets, rows, parts, split,
                        (long long)b * Hq + h0, ((long long)b * gridDim.y + hg) * splits,
                        (long long)b * gridDim.y + hg, tid, &s_last);
}

// dynamic shared memory above 48 KB and the largest carveout, once per kernel
template <int D, bool EMIT, class T>
int configure() {
  static int err = -1;
  if (err < 0) {
    err = (int)cudaFuncSetAttribute(decode_hm_q_kernel<D, EMIT, T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::BYTES);
    if (!err)
      err = (int)cudaFuncSetAttribute(decode_hm_q_kernel<D, EMIT, T>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

template <int D, bool EMIT, class T>
int launch(void* out, float* m_out, float* l_out, float* part_acc, float* part_ml, int* tickets,
           const void* q, const void* pool, const void* k_scales, const void* v_scales,
           const void* page_tables, const void* context_lens, int B, int Hkv, int G, long long N,
           long long scale_stride, int maxp, int S, float scale, int window, int splits,
           cudaStream_t stream) {
  if (int err = configure<D, EMIT, T>()) return err;
  const int groups = (G + HR - 1) / HR;
  decode_hm_q_kernel<D, EMIT, T><<<dim3(splits, Hkv * groups, B), NT, Cfg<D>::BYTES, stream>>>(
      out, m_out, l_out, part_acc, part_ml, tickets, (const T*)q, (const int8_t*)pool,
      (const float*)k_scales, (const float*)v_scales, (const int32_t*)page_tables,
      (const int32_t*)context_lens, Hkv, G, groups, N, scale_stride, maxp, S, scale, window);
  return (int)cudaGetLastError();
}

template <int D>
int blocks_per_sm(int* blocks) {
  if (int err = configure<D, false, bf16>()) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_hm_q_kernel<D, false, bf16>, NT, Cfg<D>::BYTES);
}

}  // namespace

// How many blocks of the head-dim-D kernel one SM holds at once (into
// *blocks); the host sizes `splits` with it (the fp16 instantiation's shared
// memory is the same). Returns the CUDA error code.
extern "C" int zt_decode_attention_hm_q_blocks_per_sm(int D, int* blocks) {
  if (D == 64) return blocks_per_sm<64>(blocks);
  if (D == 128) return blocks_per_sm<128>(blocks);
  if (D == 192) return blocks_per_sm<192>(blocks);
  if (D == 256) return blocks_per_sm<256>(blocks);
  return (int)cudaErrorInvalidValue;
}

// Supported: bf16 q (fp16 with fp16 != 0), int8 pool, fp32 scales [Hkv,
// scale_stride >= N]; D in {64, 128, 192, 256}, any G = Hq / Hkv >= 1, 1 <= splits <= 64. With splits
// > 1: part_acc fp32 [B, Hkv * ceil(G / 16), splits, 16, D], part_ml fp32
// [..., splits, 2, 16] and tickets int32 [B, Hkv * ceil(G / 16)], zero before
// the launch and left zero after it (with splits == 1 the three may be null).
// With m_out (and l_out) non-null the partial mode runs: out is fp32 [B, Hq,
// D] and receives the unnormalized accumulator, m_out and l_out fp32 [B, Hq]
// the running max and normalizer. Returns the CUDA error code of the launch.
extern "C" int zt_decode_attention_hm_q(void* out, float* m_out, float* l_out, float* part_acc,
                                        float* part_ml, int* tickets, const void* q,
                                        const void* pool, const void* k_scales,
                                        const void* v_scales, const void* page_tables,
                                        const void* context_lens, int B, int Hkv, int G, int D,
                                        long long N, long long scale_stride, int maxp, int S,
                                        float scale, int window, int splits, int fp16,
                                        void* stream) {
  if (B == 0) return 0;
  if ((m_out == nullptr) != (l_out == nullptr) || G < 1 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ZT_D(DD)                                                                                \
  if (D == DD)                                                                                  \
    return (m_out != nullptr ? (fp16 ? launch<DD, true, __half> : launch<DD, true, bf16>)        \
                             : (fp16 ? launch<DD, false, __half> : launch<DD, false, bf16>))(   \
        out, m_out, l_out, part_acc, part_ml, tickets, q, pool, k_scales, v_scales, page_tables, \
        context_lens, B, Hkv, G, N, scale_stride, maxp, S, scale, window, splits, st);
  ZT_D(64) ZT_D(128) ZT_D(192) ZT_D(256)
#undef ZT_D
  return (int)cudaErrorInvalidValue;
}
