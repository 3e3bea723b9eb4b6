// MLA latent decode: absorbed-weight attention over the paged latent pool.
//
// Replaces: zhilight_tpu/ops/pallas/attn_headmajor.py
// paged_decode_attention_hm (:151), kernel _kernel_hm (:54), in its MLA latent
// mode (v_dim > 0), as zhilight_tpu/ops/pallas/paged_attention.py
// paged_mla_decode (:791) reaches it; paged_mla_decode's emit_partial mode,
// which the reference serves from _kernel_bs (paged_attention.py:179, emit at
// :272-287); and the fused latent write + attend, paged_mla_decode_fused
// (paged_attention.py:844, the latent mode of _kernel_bs_fused :445). One
// template, three modes (EMIT, FUSED).
//
// Computes, for each sequence b and head h, over the tokens t < end (end =
// ctx = context_lens[b]; ctx - 1 in the fused mode), token t at pool row
// page_tables[b, t / S] * S + t % S (the page clamped into the pool):
//   s[t]      = scale * q[b, h, :KD] . latent[row(t), :KD]
//   out[b, h] = sum_t p[t] * latent[row(t), :VD] / max(l, 1e-20)
// with p = exp(s - m), l = sum p, from an fp32 online softmax (NEG_INF =
// -2e38: an empty slot gives zeros). All heads share the one latent row per
// token ("one KV head"): K is its first KD = 576 elements, V its first VD =
// 512. Q . K^T is exact in fp32 from the bf16 operands. How p meets P . V, by
// mode, is the reference's:
// - unfused (row 2b): p is rounded to bf16 unnormalized, before P . V, and l
//   sums the fp32 p, as _kernel_hm rounds `p.astype(kv.dtype)` and divides
//   by l last (attn_headmajor.py:110-121, :141-145). Its twin in
//   ops/cuda/attn_headmajor.py (paged_mla_decode_twin) rounds the same way.
// - EMIT (row 2bp) and FUSED: the reference keeps p fp32 (_kernel_bs and
//   _kernel_bs_fused cast the latent rows to fp32). p is split into two bf16
//   halves, hi = bf16(p) and lo = bf16(p - hi), and both go through P . V:
//   hi + lo holds p to 2^-16 of itself, against bf16's 2^-8.
//
// Bound on the H100: bytes. A step reads B * ctx latent rows of KD bf16
// once: 25.9 MB at DeepSeek-V2-Lite's batch 8, context 2816 (7.7 us at 3.35
// TB/s); the 16 heads do 2 * 16 * (KD + VD) flops a row (a third product in
// the split modes), under 50 flops a byte against the card's 295.
//
// Design: split-context flash decoding on mma.sync, one launch a layer.
// - Grid (splits, head tiles of 16, B), 256 threads, one block an SM (229 KB
//   of shared memory, 246 registers). A block owns the 16 query rows of one
//   head tile (rows past H are zeros) and one run of the sequence's tokens,
//   and reads each latent row once for all of them. Split s takes tokens
//   [lo, hi): [0, end) cut into runs of one length, a multiple of 16, so no
//   block has a tile more than another; its 64-token tiles count from lo.
// - The splits of a (sequence, head tile) are one thread block cluster (1, 2,
//   4, 8 or 16 blocks; 16 is above the portable size) and merge on chip:
//   each block puts its O [16][512] fp32 and (m, l) in its own shared memory,
//   and block k merges columns [k * 512 / splits, +512 / splits) of every
//   block of the cluster, in split order, through distributed shared memory,
//   and writes them. No partial goes through device memory, no ticket is
//   drawn, and the output does not depend on which block ran last. An empty
//   run inside the cluster takes part with m = -2e38, l = 0, acc = 0; when
//   only split 0 has tokens it writes the output alone. The host
//   (ops/cuda/attn_headmajor.py mla_splits) takes as many splits as let every
//   block fit on the card at once, down to a power of two for which the card
//   holds a cluster per (sequence, head tile) at once
//   (zt_mla_decode_max_clusters; a cluster's blocks share a GPC: the H100
//   holds 7 clusters of 16, 15 of 8, 30 of 4): one wave.
//   Measured on the H100 at DeepSeek-V2-Lite's batch 8, context 2816 (PERF.md),
//   the earlier merges lost: a last-ticket merge of 16 splits' fp32 partials
//   by one block (the partials' 4 MB of stores, then 512 KB through one SM,
//   waiting a round of loads at a time), and clusters of 4 merged on chip
//   with a last-ticket merge of the clusters' partials.
// - Copies: a latent row is 1,152 contiguous bytes. Threads 0-63 each own a
//   row of every 64-token tile and copy it with one cp.async.bulk onto the
//   stage's mbarrier (arrive.expect_tx, 64 arrivals a phase), into a ring of
//   three stages whose rows are padded to 1,168 bytes, so ldmatrix reads
//   them without bank conflicts (a page-sized copy would land rows 1,152
//   bytes apart, every row on the same banks). A row past hi is zero-filled
//   by its thread before it arrives (the release orders the stores), so no
//   stale value meets a zero probability, and a row outside [lo, hi) is
//   never read: the fused mode's row ctx - 1 may be under write by another
//   block. Each thread's page id is read one tile ahead of its copy.
// - q: its 16 rows are loaded at the block's start beside the context and
//   page-table loads, staged once in the last stage's buffer, and each warp
//   keeps their A fragments (16 x 576) in registers for the block's life.
// - Two block barriers a tile. Q . K^T: warp w takes tokens [8w, 8w + 8) of
//   the tile over the whole KD, with two accumulators. The warps' row maxima
//   meet in shared memory (barrier 1), every warp forms the same running max
//   and writes its p tile (bf16, or the hi and lo halves) to shared memory
//   (barrier 2). P . V: warp w owns V columns [64w, 64w + 64), its 16 x 64
//   fp32 O in registers across tiles, rescaled by the row's exp(m_old - m_new).
// - The shared-memory attribute is set once per device.
//
// Fused latent write + attend (FUSED): context_lens count this step's token,
// whose latent row (latent_new [B, stored], in the pool's dtype) is not in
// the pool yet. The tiles cover rows t < ctx - 1 only, and row ctx - 1 is
// never read. Split 0 of head tile 0 stores the new row at slot_mapping[b]
// when that is >= 0 and ctx >= 1 (as the TPU kernel writes only inside a
// context); no other block reads that slot in the launch. The new row is
// folded in once per (b, h), where the output is written (the only split,
// or each block's columns of the cluster's merge), as one more partial: m =
// s_new = scale * q[b, h, :KD] . latent_new[b, :KD] (fp32), l = 1, acc =
// latent_new[b, :VD]. An empty context gives the new row's V.
//
// What holds it back (PERF.md): with the latent rows in L2, a 64-token tile
// takes about 2 us a block (its copies, ldmatrix reads and products pass
// through shared memory, 228 KB a tile, beside two block barriers), and a
// block's start about 3.5 us (the context and page-table loads, q's
// fragments); at batch 8 the card's 7 clusters of 16 leave the launch at 8
// splits, 64 blocks; a head tile of 16 rows re-reads the latent rows for
// every 16 heads (DeepSeek-V2/V3's 128 heads read them 8 times); the split
// modes' third product. wgmma on the staged tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attn_tile.cuh"

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;
using namespace zt_mma;

constexpr float NEG_INF = -2.0e38f;
constexpr int KD = 576, VD = 512;  // latent widths: K the whole row, V its first 512
constexpr int HR = 16;             // query rows (heads) a block
constexpr int TN = 64;             // tokens a tile
constexpr int NWARPS = 8, NT = NWARPS * 32;
constexpr int STAGES = 3;
constexpr int MAX_SPLITS = 16;     // splits: one cluster (16 takes the non-portable size)
constexpr int LDK = KD + 8;        // bf16 a staged row: 1,168 bytes, ldmatrix conflict-free
constexpr int LDP = TN + 8;        // bf16 a row of the p tiles
constexpr int ROW_BYTES = KD * 2;  // bytes a copy
constexpr int KSTEPS = KD / 16;    // 16-deep steps of Q . K^T
constexpr int VCOLS = VD / NWARPS; // V columns a warp
static_assert(VCOLS == 64 && TN == 8 * NWARPS, "warp split of the tile");

// shared memory, bytes: the ring (which the merge reuses at the end), the p
// tiles (hi, lo), the warps' row maxima and sums, s_new
constexpr int STAGE_BYTES = TN * LDK * 2;
constexpr int RING = STAGES * STAGE_BYTES;
constexpr int P_OFF = RING;
constexpr int RED_OFF = P_OFF + 2 * HR * LDP * 2;
constexpr int NEW_OFF = RED_OFF + 2 * NWARPS * HR * 4;
constexpr int SMEM = NEW_OFF + HR * 4;
// the merge's buffers, in the ring (free once every copy is consumed): small
// tables, then the block's O [16][512] fp32, which its peers read
constexpr int TAB_BYTES = 2048;
constexpr int O_OFF = TAB_BYTES;
static_assert((2 + MAX_SPLITS + 2) * HR * 4 <= TAB_BYTES, "merge tables");
static_assert(O_OFF + HR * VD * 4 <= RING, "the block's O in the ring");

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival, and the bytes of this thread's copy that the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The fused mode's extra inputs (null pointers otherwise), of the pool's type.
struct LatentRows {
  const void* latent_new;  // [B, stored] this step's rows, in the pool's dtype
  const int32_t* slots;    // [B] pool row of each; < 0 => not written
  void* pool;              // [N, stored], written at slots[b] only
};

// T: the type of q, the pool and out, bf16 or fp16 (the comments say bf16).
// out: T [B, H, VD]; with EMIT fp32 [B, H, VD] (the unnormalized
// accumulator) and m_out, l_out [B, H]
template <bool EMIT, bool FUSED, class T>
__global__ void __launch_bounds__(NT, 1) mla_decode_kernel(
    void* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
    const T* __restrict__ q,                  // [B, H, KD]
    const T* pool,                            // [N, stored]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    LatentRows fz, int H, long long N, int stored, int maxp, int S, float scale) {
  static_assert(!(EMIT && FUSED), "the fused mode returns the output");
  constexpr bool SPLIT_P = EMIT || FUSED;  // p unrounded: hi and lo halves
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  T* ring = reinterpret_cast<T*>(smem);
  T* sPh = reinterpret_cast<T*>(smem + P_OFF);
  T* sPl = sPh + HR * LDP;
  const T* latent_new = static_cast<const T*>(fz.latent_new);
  float* red_m = reinterpret_cast<float*>(smem + RED_OFF);  // [NWARPS][HR]
  float* red_l = red_m + NWARPS * HR;
  float* sNew = reinterpret_cast<float*>(smem + NEW_OFF);  // [HR]

  const int split = blockIdx.x, splits = gridDim.x;
  const int ht = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i4 = lane % 4;
  const int h0 = ht * HR;
  const int rows = min(HR, H - h0);

  // the q rows of the head tile (rows past H zero), 16 bytes a load, in
  // flight beside the context and page-table loads: nothing here waits on them
  constexpr int QCH = (HR * KD / 8 + NT - 1) / NT;
  uint4 qv[QCH];
#pragma unroll
  for (int j = 0; j < QCH; ++j) {
    const int c = tid + j * NT, r = c / (KD / 8);
    qv[j] = make_uint4(0, 0, 0, 0);
    if (c < HR * (KD / 8) && r < rows)
      qv[j] = *reinterpret_cast<const uint4*>(q + ((long long)b * H + h0) * KD + c * 8);
  }

  // the fused mode's new row, its words 2 * lane + 64 i (the K columns a
  // lane takes in its warp's new scores, below)
  constexpr int NW = KD / 64;
  uint32_t nv[FUSED ? NW : 1];
  if constexpr (FUSED) {
#pragma unroll
    for (int i = 0; i < NW; ++i)
      nv[i] = *reinterpret_cast<const uint32_t*>(latent_new + (long long)b * stored +
                                                 2 * lane + 64 * i);
  }

  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S));
  // the fused mode's row ctx - 1 comes from latent_new, never the pool
  const int end = FUSED ? max(ctx - 1, 0) : ctx;
  // split s takes tokens [lo, hi): [0, end) cut into `splits` runs of one
  // length, a multiple of 16 tokens
  const int per = (max((end + splits - 1) / splits, 1) + 15) / 16 * 16;
  const int parts = max((end + per - 1) / per, 1);
  // one split with tokens: its block writes the output, the others leave;
  // else every block of the cluster (the splits) takes part in the merge, an
  // empty split with m = -2e38, l = 0, acc = 0
  if (parts == 1 && split > 0) return;
  const int lo = split * per, hi = max(min(lo + per, end), lo);
  const int n = (max(hi - lo, 0) + TN - 1) / TN;

  if constexpr (FUSED) {
    const long long slot = fz.slots[b];
    if (split == 0 && ht == 0 && slot >= 0 && slot < N && ctx >= 1) {
      const uint4* src = reinterpret_cast<const uint4*>(latent_new + (long long)b * stored);
      uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(fz.pool) + slot * stored);
      for (int c = tid; c < stored / 8; c += NT) dst[c] = src[c];
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], TN);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any arrival

  // thread r < 64 owns row r of every tile: its page id one tile ahead
  const int32_t* pt = page_tables + (long long)b * maxp;
  const long long num_pages = N / S;
  const int s_shift = log2_if_pow2(S);
  auto page_of = [&](int j) -> int {
    const int t = lo + j * TN + tid;
    return (j < n && t < hi) ? pt[s_shift >= 0 ? t >> s_shift : t / S] : 0;
  };
  // tile j into stage j % STAGES: the row's bytes, or zeros past hi
  auto issue = [&](int j, int page) {
    if (j >= n) return;
    uint64_t* bar = &full[j % STAGES];
    T* dst = ring + (j % STAGES) * (TN * LDK) + tid * LDK;
    const int t = lo + j * TN + tid;
    if (t < hi) {
      const int pidx = s_shift >= 0 ? t >> s_shift : t / S;
      const long long pg = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
      // this thread's earlier zero stores into the row, ordered before the copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, ROW_BYTES);
      bulk_copy(dst, pool + (pg * S + (t - pidx * S)) * stored, ROW_BYTES, bar);
    } else {
      uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll 8
      for (int c = 0; c < KD / 8; ++c) d[c] = make_uint4(0, 0, 0, 0);
      mbar_arrive(bar);  // releases the stores
    }
  };
  int pg_next = 0;
  if (tid < TN) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s, page_of(s));
    pg_next = page_of(STAGES - 1);
  }

  // the q fragments, while the first tiles are in flight: the rows staged
  // once in the last stage's buffer (its first tile is issued in the loop,
  // after every warp has passed barrier 1), then each warp's A fragments by
  // ldmatrix
  uint32_t qf[KSTEPS][4];
  {
    T* sQ = ring + (STAGES - 1) * (TN * LDK);
#pragma unroll
    for (int j = 0; j < QCH; ++j) {
      const int c = tid + j * NT;
      if (c < HR * (KD / 8))
        *reinterpret_cast<uint4*>(sQ + (c / (KD / 8)) * LDK + (c % (KD / 8)) * 8) = qv[j];
    }
    // the stores, ordered before the stage's later bulk copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) ldsm_x4(qf[k], sQ + a_offset(lane, LDK, 16 * k));
    if constexpr (FUSED) {
      // the new row's scores, s_new = scale * q . latent_new[:KD] in fp32
      // (warp w rows 2w, 2w + 1), read where the output is written
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * warp + rr;
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const float2 a =
              E::unpack(*reinterpret_cast<const uint32_t*>(sQ + r * LDK + 2 * lane + 64 * i));
          const float2 c = E::unpack(nv[i]);
          x += a.x * c.x + a.y * c.y;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) sNew[r] = x * scale;
      }
    }
  }

  float m_run[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[VCOLS / 8][4];
#pragma unroll
  for (int j = 0; j < VCOLS / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < n; ++it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    const T* st = ring + (it % STAGES) * (TN * LDK);
    const int t0 = lo + it * TN;

    // S = Q K^T over the warp's 8 keys (rows 8w .. 8w + 7 of the tile)
    float s[4];
    {
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      const T* kw = st + (warp * 8 + lane % 8) * LDK + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int k = 0; k < KSTEPS; k += 2) {
        uint32_t b0[2], b1[2];
        ldsm_x2(b0, kw + 16 * k);
        ldsm_x2(b1, kw + 16 * (k + 1));
        E::mma(sa, qf[k], b0[0], b0[1]);
        E::mma(sb, qf[k + 1], b1[0], b1[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = sa[e] + sb[e];
    }
    // scale, mask and the warp's row maxima (rows g and g + 8)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + warp * 8 + 2 * i4 + (e & 1);
      s[e] = t < hi ? s[e] * scale : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (i4 == 0) {
      red_m[warp * HR + g] = mx[0];
      red_m[warp * HR + g + 8] = mx[1];
    }
    __syncthreads();  // 1: every warp's maxima; every warp is done with tile it - 1

    // tile it + STAGES - 1 into tile it - 1's stage; the next page ids
    if (tid < TN) {
      issue(it + STAGES - 1, pg_next);
      pg_next = page_of(it + STAGES);
    }

    // the running max (the same in every warp), p, and its tile in shared memory
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = NEG_INF;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) tmax = fmaxf(tmax, red_m[w * HR + g + 8 * r]);
      const float m_new = fmaxf(m_run[r], tmax);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_r[r] *= alpha[r];
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = s[e] > NEG_INF ? __expf(s[e] - m_run[e >> 1]) : 0.f;
      l_r[e >> 1] += p[e];
    }
    {
      const int c = warp * 8 + 2 * i4;
      if constexpr (SPLIT_P) {
        uint32_t h0v, l0v, h1v, l1v;
        split_pair<T>(p[0], p[1], h0v, l0v);
        split_pair<T>(p[2], p[3], h1v, l1v);
        *reinterpret_cast<uint32_t*>(sPh + g * LDP + c) = h0v;
        *reinterpret_cast<uint32_t*>(sPh + (g + 8) * LDP + c) = h1v;
        *reinterpret_cast<uint32_t*>(sPl + g * LDP + c) = l0v;
        *reinterpret_cast<uint32_t*>(sPl + (g + 8) * LDP + c) = l1v;
      } else {
        *reinterpret_cast<uint32_t*>(sPh + g * LDP + c) = E::pack(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sPh + (g + 8) * LDP + c) = E::pack(p[2], p[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < VCOLS / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    __syncthreads();  // 2: the p tile

    // O += P V over the warp's 64 V columns
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, sPh + a_offset(lane, LDP, 16 * kk));
      if constexpr (SPLIT_P) ldsm_x4(al, sPl + a_offset(lane, LDP, 16 * kk));
#pragma unroll
      for (int np = 0; np < VCOLS / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, st + bt_offset(lane, LDK, 16 * kk, warp * VCOLS + 16 * np));
        E::mma(o[2 * np], ah, bv[0], bv[1]);
        E::mma(o[2 * np + 1], ah, bv[2], bv[3]);
        if constexpr (SPLIT_P) {
          E::mma(o[2 * np], al, bv[0], bv[1]);
          E::mma(o[2 * np + 1], al, bv[2], bv[3]);
        }
      }
    }
  }

  // the rows' sums over the warps (every warp holds the same m_run)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __syncthreads();  // every warp is done with red_m
  if (i4 == 0) {
    red_l[warp * HR + g] = l_r[0];
    red_l[warp * HR + g + 8] = l_r[1];
  }
  __syncthreads();
  float L[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    L[r] = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) L[r] += red_l[w * HR + g + 8 * r];
  }

  const long long row0 = (long long)b * H + h0;  // the block's first output row
  // row r's output at columns d, d + 1 from (M, L, A): FUSED folds the new
  // row in as one more partial (m = s_new, l = 1, acc = its V)
  auto write2 = [&](int r, int d, float M, float Lr, float a0, float a1) {
    const long long row = row0 + r;
    if constexpr (EMIT) {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + row * VD + d) = make_float2(a0, a1);
      return;
    } else {
      if constexpr (FUSED) {
        const float sn = sNew[r];
        const float M2 = fmaxf(M, sn);
        const float fa = __expf(M - M2), fb = __expf(sn - M2);
        const float2 v =
            E::unpack(*reinterpret_cast<const uint32_t*>(latent_new + (long long)b * stored + d));
        Lr = Lr * fa + fb;
        a0 = a0 * fa + v.x * fb;
        a1 = a1 * fa + v.y * fb;
      }
      const float inv = 1.f / fmaxf(Lr, 1e-20f);
      *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + row * VD + d) =
          E::pack(a0 * inv, a1 * inv);
    }
  };

  if (parts == 1) {
#pragma unroll
    for (int j = 0; j < VCOLS / 8; ++j) {
      const int d = warp * VCOLS + 8 * j + 2 * i4;
      if (g < rows) write2(g, d, m_run[0], L[0], o[j][0], o[j][1]);
      if (g + 8 < rows) write2(g + 8, d, m_run[1], L[1], o[j][2], o[j][3]);
    }
    if (EMIT && warp == 0 && i4 == 0) {
      if (g < rows) m_out[row0 + g] = m_run[0], l_out[row0 + g] = L[0];
      if (g + 8 < rows) m_out[row0 + g + 8] = m_run[1], l_out[row0 + g + 8] = L[1];
    }
    return;
  }

  // several splits, merged on chip: every block of the cluster puts its O
  // [16][512] and (m, l) in its own shared memory (the ring is free: every
  // copy has been consumed); block k merges columns [k * 512 / C, +512 / C)
  // of the C blocks, in split order, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const int C = splits, rank = split;  // the cluster is the sequence's splits
  float* sMLo = reinterpret_cast<float*>(smem);        // this block's m [HR], L [HR]
  float* sW = sMLo + 2 * HR;                            // the splits' weights [C][HR]
  float* sRow = sW + MAX_SPLITS * HR;                   // the rows' M [HR], L [HR]
  float* sO = reinterpret_cast<float*>(smem + O_OFF);  // [HR][VD]
#pragma unroll
  for (int j = 0; j < VCOLS / 8; ++j) {
    const int d = warp * VCOLS + 8 * j + 2 * i4;
    *reinterpret_cast<float2*>(sO + g * VD + d) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(sO + (g + 8) * VD + d) = make_float2(o[j][2], o[j][3]);
  }
  if (warp == 0 && i4 == 0) {
    sMLo[g] = m_run[0], sMLo[HR + g] = L[0];
    sMLo[g + 8] = m_run[1], sMLo[HR + g + 8] = L[1];
  }
  cluster.sync();  // every block's O and (m, l)
  if (tid < rows) {
    float M = NEG_INF, Ls = 0.f, m_p[MAX_SPLITS], l_p[MAX_SPLITS];
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < C) {
        const float* ml = cluster.map_shared_rank(sMLo, p);
        m_p[p] = ml[tid], l_p[p] = ml[HR + tid];
        M = fmaxf(M, m_p[p]);
      }
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < C) {
        const float f = __expf(m_p[p] - M);
        sW[p * HR + tid] = f;
        Ls += l_p[p] * f;
      }
    sRow[tid] = M, sRow[HR + tid] = Ls;
    if (EMIT && rank == 0) m_out[row0 + tid] = M, l_out[row0 + tid] = Ls;
  }
  __syncthreads();  // sW, sRow
  const int cols = VD / C, c0 = rank * cols;
  for (int c = tid; c < rows * (cols / 4); c += NT) {
    const int r = c / (cols / 4), d = c0 + (c % (cols / 4)) * 4;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)  // every peer's load in flight at once
      if (p < C) v[p] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sO, p) + r * VD + d);
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < C) {
        const float f = sW[p * HR + r];
        A.x += v[p].x * f, A.y += v[p].y * f, A.z += v[p].z * f, A.w += v[p].w * f;
      }
    write2(r, d, sRow[r], sRow[HR + r], A.x, A.y);
    write2(r, d + 2, sRow[r], sRow[HR + r], A.z, A.w);
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

// Sets the dynamic shared-memory attribute of an instantiation, and its
// leave to launch clusters of 16 (above the portable 8), once per device.
template <bool EMIT, bool FUSED, class T>
int configure() {
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  static bool done[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    cudaError_t e = cudaFuncSetAttribute(mla_decode_kernel<EMIT, FUSED, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mla_decode_kernel<EMIT, FUSED, T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

// a launch of the grid in clusters of cl blocks along the splits
inline cudaLaunchConfig_t config(dim3 grid, int cl, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool EMIT, bool FUSED, class T>
int launch(void* out, float* m_out, float* l_out, const void* q, const void* pool,
           const void* page_tables, const void* context_lens, const LatentRows& fz, int B, int H,
           long long N, int stored, int maxp, int S, float scale, int splits,
           cudaStream_t stream) {
  if (int e = configure<EMIT, FUSED, T>()) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(splits, (H + HR - 1) / HR, B), splits, stream, &attr);
  return (int)cudaLaunchKernelEx(&cfg, mla_decode_kernel<EMIT, FUSED, T>, out, m_out, l_out,
                                 (const T*)q, (const T*)pool,
                                 (const int32_t*)page_tables, (const int32_t*)context_lens, fz,
                                 H, N, stored, maxp, S, scale);
}

// the checks both entry points share: splits a power of two up to 16 (its
// columns of the merge, 512 / splits, a whole number of float4)
int check(int KD_, int VD_, int stored, int S, int splits, const void* pool) {
  if (KD_ != KD || VD_ != VD || stored < KD || stored % 8 || S < 1 || splits < 1 ||
      splits > MAX_SPLITS || (splits & (splits - 1)) || (uintptr_t)pool % 16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Supported (the wrapper checks): bf16 q [B, H, 576] and pool [N, stored]
// (both fp16, and out too, with fp16 != 0)
// (16-byte aligned) with stored >= 576 and a multiple of 8, any page size S,
// any H; splits 1, 2, 4, 8 or 16 (launched as one cluster of that many
// blocks a sequence and head tile: at most zt_mla_decode_max_clusters of
// them fit the card at once); out bf16 [B, H, 512], or with m_out and l_out
// (fp32 [B, H]) non-null the partial mode: out fp32 [B, H, 512] receives the
// unnormalized accumulator. Returns the CUDA error code.
extern "C" int zt_mla_decode(void* out, float* m_out, float* l_out, const void* q,
                             const void* pool, const void* page_tables, const void* context_lens,
                             int B, int H, int KD_, int VD_, long long N, int stored, int maxp,
                             int S, float scale, int splits, int fp16, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (int e = check(KD_, VD_, stored, S, splits, pool)) return e;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m_out != nullptr)
    return (fp16 ? launch<true, false, __half> : launch<true, false, bf16>)(
        out, m_out, l_out, q, pool, page_tables, context_lens, LatentRows{}, B, H, N, stored,
        maxp, S, scale, splits, st);
  return (fp16 ? launch<false, false, __half> : launch<false, false, bf16>)(
      out, nullptr, nullptr, q, pool, page_tables, context_lens, LatentRows{}, B, H, N, stored,
      maxp, S, scale, splits, st);
}

// The fused mode (header): as zt_mla_decode without the partial outputs, plus
// latent_new [B, stored] of the pool's type (16-byte aligned) and int32 slot_mapping [B];
// pool is written at slot_mapping[b] (>= 0) with row b of latent_new.
extern "C" int zt_mla_decode_fused(void* out, const void* q, void* pool, const void* latent_new,
                                   const void* slot_mapping, const void* page_tables,
                                   const void* context_lens, int B, int H, int KD_, int VD_,
                                   long long N, int stored, int maxp, int S, float scale,
                                   int splits, int fp16, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (int e = check(KD_, VD_, stored, S, splits, pool)) return e;
  if ((uintptr_t)latent_new % 16) return (int)cudaErrorInvalidValue;
  const LatentRows fz{latent_new, (const int32_t*)slot_mapping, pool};
  return (fp16 ? launch<false, true, __half> : launch<false, true, bf16>)(
      out, nullptr, nullptr, q, pool, page_tables, context_lens, fz, B, H, N, stored, maxp, S,
      scale, splits, (cudaStream_t)stream);
}

// How many blocks of the latent decode kernel one SM holds at once (the three
// modes and both types share one shared-memory size); D is the output's width (512).
extern "C" int zt_mla_decode_blocks_per_sm(int D, int* blocks) {
  if (D != VD) return (int)cudaErrorInvalidValue;
  if (int e = configure<false, false, bf16>()) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mla_decode_kernel<false, false, bf16>, NT, SMEM);
}

// How many clusters of cl blocks (1, 2, 4, 8 or 16) the card holds at once:
// a cluster's blocks share a GPC, so SMs left over in a GPC hold none, and a
// GPC with fewer free SMs than cl holds no cluster of cl.
extern "C" int zt_mla_decode_max_clusters(int cl, int* clusters) {
  if (cl < 1 || cl > MAX_SPLITS || (cl & (cl - 1))) return (int)cudaErrorInvalidValue;
  if (int e = configure<false, false, bf16>()) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(cl), cl, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, mla_decode_kernel<false, false, bf16>, &cfg);
}
