// Chunked-prefill flash attention over the head-major packed K|V pool.
//
// Replaces: zhilight_tpu/ops/pallas/prefill_attention.py
// paged_prefill_attention_hm_packed (:255), kernel _kernel_prefill_hm (:78);
// paged_prefill_attention_hm (:227) is its one-segment case.
//
// Computes, for each of NS packed segments s (tokens [s*TC, (s+1)*TC) of q)
// and each query head h with KV head h / G: query i of the segment sits at
// global position cache_lens[s] + i and attends to the keys j of the
// segment's pages with j <= cache_lens[s] + i and j < cache_lens[s] +
// q_lens[s] (and j >= cache_lens[s] + i + 1 - window when a sliding window is
// set). The pool already holds the chunk's own K/V. Rows i >= q_lens[s] are
// padding: they see no key and come out as zeros, which the host discards.
// fp32 scores and online softmax, NEG_INF = -2e38, max(l, 1e-20) floor. The
// probabilities are rounded to q's type (bf16 or fp16) for the P.V product, as the TPU kernel
// casts p to the pool's dtype before its second dot (_kernel_prefill_hm body,
// :212-216); l sums them unrounded.
//
// Bound on the H100: operations, 4 * Hq * D flops per (query, visible key):
// a 512-token chunk at cache 3200 with Qwen2.5-14B's 40 heads of 128 is
// 36.3 GFLOP, 36.6 us at the 989 TFLOP/s dense bf16 rate, while its K|V bytes
// (15.2 MB) take 4.5 us.
//
// Design (FlashAttention-2's shape on mma.sync):
// - One block of 4 warps per (64-query block of a segment, query head); warp w
//   owns query rows [16w, 16w + 16). The block walks BK-key tiles (64 at
//   D 64, 32 above: see Cfg) from
//   its window's first tile up to its causal bound only. A warp skips the
//   tiles that are wholly masked for its 16 rows, and masks element by element
//   only on the tiles that cross one of its rows' bounds.
// - K|V tiles are gathered through the page table with cp.async 16-byte
//   copies into a ring of stages (3 at D <= 128, 2 above) in shared memory, rows
//   padded by 16 bytes so ldmatrix is conflict-free; rows outside the block's
//   key range are zero-filled, so no stale bf16 (inf, NaN) meets a zero
//   probability. The page ids of the next tile to copy are loaded a tile
//   ahead and spread by shuffles. One __syncthreads per tile; the next tile
//   loads while this one is multiplied.
// - S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 -> fp32), Q and K
//   through ldmatrix, V through ldmatrix.trans. The scores, the row max and
//   sum (quad shuffles), P (packed to bf16 in registers as the A operand of
//   P V, csrc/attn_tile.cuh) and the running O stay in registers; no score or
//   output tile goes through shared memory. Q's fragments stay in registers
//   for the whole loop at D <= 128; at D 192 and 256 they are re-read from
//   the staged Q tile each step, to leave the registers to O.
// - The grid is (Hq, query blocks x NS) with the query blocks of each segment
//   in reverse, so the blocks with the most keys start first and the causal
//   imbalance does not leave SMs idle at the end; the G heads of one KV group
//   are neighbours in launch order and read the same K|V tiles, which the
//   50 MB L2 holds (Qwen2.5-14B's K|V for a chunk at cache 3200 is 15 MB):
//   heads share tiles through L2 rather than one block, which keeps a block's
//   registers to one head's O.

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
  // keys per tile and stages: at D 128, 32-key tiles in 3 stages (68 KB, so
  // two blocks share an SM) ran 1.5x faster on the H100 than 64-key tiles in
  // 2 stages; at D 192 and 256 the registers of O leave room for 32 keys only
  static constexpr int BK = D == 64 ? 64 : 32;
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr int UNROLL = D == 64 ? BK * (2 * D / 8) / NT : 2;  // gather_tile: all at D 64
  static constexpr bool QREG = D <= 128;         // Q fragments held in registers
  static constexpr int LDQ = D + 8;              // bf16 per staged q row
  static constexpr int LDK = 2 * D + 8;          // bf16 per staged K|V row
  static constexpr int STAGE = BK * LDK;
  static constexpr int Q_BYTES = BQ * LDQ * 2;
  static constexpr int BYTES = Q_BYTES + STAGES * STAGE * 2;
  static_assert(D % 64 == 0, "head dim");
};

// three blocks an SM up to D 128 (at most 170 registers a thread): MiniCPM-2B's
// 288 blocks and Qwen2.5-14B's 320 for a 512-token chunk then run in one wave
template <int D, class T>
__global__ void __launch_bounds__(NT, D <= 128 ? 3 : 2) prefill_hm_kernel(
    T* __restrict__ out,                      // [NS*TC, Hq, D]
    const T* __restrict__ q,                  // [NS*TC, Hq, D]
    const T* __restrict__ pool,               // [Hkv, N, 2D]
    const int32_t* __restrict__ page_tables,  // [NS, maxp]
    const int32_t* __restrict__ cache_lens,   // [NS]
    const int32_t* __restrict__ q_lens,       // [NS]
    int Hq, int Hkv, long long N, int maxp, int S, int TC, int NS, int qblocks_per_seg,
    float scale, int window) {
  using C = Cfg<D>;
  using E = Elem<T>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = reinterpret_cast<T*>(smem + C::Q_BYTES);

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
  const T* head = pool + (long long)hkv * N * 2 * D;

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

  // the ring: tile `issued` goes next, its page ids already in `ids`
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
      gather_tile<BK, 2 * D, C::LDK, NT, C::UNROLL, T>(sKV + (issued % C::STAGES) * C::STAGE, head, pt, ids,
                                         j0, kv_lo, kv_hi, S, s_shift, num_pages, tid);
      if (++issued < n) ids = fetch_pages(pt, maxp, page_of(j0 + BK), lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) issue();

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

  for (int it = 0; it < n; ++it) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile it is in (and, on the first pass, the Q tile)
    issue();          // tile it + STAGES - 1, into tile it - 1's stage
    if constexpr (C::QREG) {
      if (it == 0) {
#pragma unroll
        for (int k = 0; k < D / 16; ++k) ldsm_x4(qf[k], qw + a_offset(lane, C::LDQ, k * 16));
      }
    }
    const int j0 = jt0 + it * BK;
    if (j0 >= hi_max || j0 + BK <= lo_min) continue;  // warp-uniform: all masked
    const bool full = j0 + BK <= hi_min && j0 >= lo_max;
    const T* kv = sKV + (it % C::STAGES) * C::STAGE;

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

    // online softmax over the tile for rows g and g + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * scale;
        if (!full) {
          const int j = j0 + nt * 8 + 2 * (lane % 4) + (e & 1);
          if (j >= hi[e >> 1] || j < lo[e >> 1]) v = NEG_INF;
        }
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
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
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] > NEG_INF ? __expf(s[nt][e] - m_r[e >> 1]) : 0.f;
        s[nt][e] = p;
        l_r[e >> 1] += p;
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
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + warp * 16 + g + 8 * r;
    if (i >= TC) continue;
    T* orow = out + (((long long)seg * TC + i) * Hq + hq) * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          E::pack(o[j][2 * r] * l_r[r], o[j][2 * r + 1] * l_r[r]);
  }
}

template <int D, class T>
int launch(void* out, const void* q, const void* pool, const void* page_tables,
           const void* cache_lens, const void* q_lens, int NS, int TC, int Hq, int Hkv,
           long long N, int maxp, int S, float scale, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_hm_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int qbps = (TC + BQ - 1) / BQ;
  prefill_hm_kernel<D, T><<<dim3(Hq, NS * qbps), NT, C::BYTES, stream>>>(
      (T*)out, (const T*)q, (const T*)pool, (const int32_t*)page_tables,
      (const int32_t*)cache_lens, (const int32_t*)q_lens, Hq, Hkv, N, maxp, S, TC, NS, qbps,
      scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported: bf16 q and pool (fp16 with fp16 != 0), D in {64, 128, 192, 256},
// Hq a multiple of Hkv.
// Returns the CUDA error code of the launch.
extern "C" int zt_prefill_attention_hm(void* out, const void* q, const void* pool,
                                       const void* page_tables,
                                       const void* cache_lens, const void* q_lens,
                                       int NS, int TC, int Hq, int Hkv, int D,
                                       long long N, int maxp, int S, float scale,
                                       int window, int fp16, void* stream) {
  if (NS == 0 || TC == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define ZT_D(DD)                                                                          \
  if (D == DD)                                                                            \
    return (fp16 ? launch<DD, __half> : launch<DD, bf16>)(                               \
        out, q, pool, page_tables, cache_lens, q_lens, NS, TC, Hq, Hkv, N,               \
        maxp, S, scale, window, st);
  ZT_D(64) ZT_D(128) ZT_D(192) ZT_D(256)
#undef ZT_D
  return (int)cudaErrorInvalidValue;
}
