// Paged decode attention over slot-major K and V pools, shared by
// paged_attention.cu (bf16 or fp16 pools), paged_attention_q.cu (int8 pools
// with fp32 scales) and paged_attention_fused.cu (bf16 or fp16 pools, this
// step's rows written and attended in the same launch). q and the output are
// bf16 or fp16 (Q below; a model-dtype pool is of the same type), and Q is the
// tensor cores' operand type: "bf16" in the notes below reads Q.
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py
// paged_decode_attention (:364; kernels _kernel :48 and _kernel_bs :179),
// paged_decode_attention_q (:971; kernel _kernel_bs_q :884) and
// paged_decode_attention_fused (:644; kernel _kernel_bs_fused :445) in its
// two-pool and packed single-pool modes.
//
// Computes, for each sequence b and query head h = hkv * G + g, over the
// tokens t in [start, end), ctx = context_lens[b], end = ctx (end = ctx - 1
// in the fused mode), start = max(0, ctx - window) when a sliding window is
// set, token t living at slot = page_tables[b, t / S] * S + t % S (the page
// clamped into the pool) of pools K, V [N, Hkv, rs] (a row of D elements at
// the start of each rs-element row):
//   s[t]      = (q[b, h] . K[slot, hkv]) * scale                  (bf16 pools)
//   s[t]      = (q[b, h] . K_i8[slot, hkv]) * scale * k_scales[hkv, slot]
//   out[b, h] = sum_t p[t] * V[slot, hkv] / l                     (bf16 pools)
//   out[b, h] = sum_t (p[t] * v_scales[hkv, slot]) * V_i8[slot, hkv] / l
// with p, l from an fp32 online softmax of s (NEG_INF = -2e38 and the
// max(l, 1e-20) floor of the TPU kernels, so an empty slot gives zeros). The
// reference's arithmetic is fp32 with nothing rounded (paged_attention.py
// :224-271, :921-962), and so is this kernel's:
// - Q . K^T runs on mma.sync with bf16 operands: q and a bf16 K row are the
//   stored values, an int8 K element converts to bf16 exactly, and each
//   product is exact in the fp32 accumulator. The scale (and the int8 row's K
//   scale) multiplies the finished score, as in the reference.
// - P . V: p is never rounded to bf16 alone. The A operand is split into two
//   bf16 halves, hi = bf16(p) and lo = bf16(p - hi) (int8: of p * v_scale),
//   and both go through the product: hi + lo holds p to 2^-16 of itself,
//   against bf16's 2^-8. l sums the unsplit fp32 p.
// The scales are head-major [Hkv, scale_stride >= N] (the reference keeps
// them [N, Hkv]).
//
// Bound on the H100: bytes. Each (b, KV head) streams (end - start) * D
// elements of K and of V once, a row of D elements per token at (slot * Hkv +
// hkv) * rs: at B = 8, ctx 3712, 8 KV heads of 80 that is 76.0 MB a layer in
// bf16 (22.7 us at 3.35 TB/s) and 38.0 MB + 1.9 MB of scales in int8 (11.9
// us). The arithmetic is 4 * G flops per element (the split P . V adds a
// third product), far under the card's 295 flops a byte.
//
// Design: split-context flash decoding on mma.sync, the head-major decode's
// (attn_headmajor.cu) over slot-major rows, one launch a layer.
// - Grid (splits, Hkv * groups, B). A block owns up to 16 query rows of one
//   KV head (G rows zero-padded to one m16 tile; G > 16 is cut into groups of
//   16) and one run of the sequence's tokens, and reads each K and V row once
//   for all its rows. The host picks `splits` so that every block fits on the
//   card at once (ops/cuda/attn_headmajor.py decode_splits, from this
//   kernel's own zt_*_blocks_per_sm): one wave. Split s takes tokens [lo,
//   hi): [start, end) cut into runs of one length, a multiple of 16, so that
//   no block has a tile more than another (whole 64-token tiles left one
//   split of H2O-Danube-1.8B's 3712 tokens with 2 tiles beside 8); its
//   64-token tiles count from lo. A run without tokens returns at once.
// - One launch: the splits' partials merge in the same launch. Each block
//   writes its (m, l, acc), fences and draws a ticket from a zeroed counter;
//   the block that draws the last merges every partial online in fixed split
//   order (fp32, so the result does not depend on which block ran last), its
//   loads of eight partials in flight at once, and resets the counter. The
//   head-major decodes share the counters: one stream at a time runs decode.
// - Tiles of 64 tokens are gathered through the page table with cp.async by
//   all 128 threads into a ring of stages (4 at a head dim of at most 64;
//   above that 2 in bf16, 3 in int8, so that four and three blocks share an
//   SM). The copy is the widest the rows' alignment allows: 16 bytes when a
//   row is (D % 8 == 0 in bf16, D % 16 == 0 in int8, as at D 80), 8 or 4
//   bytes below that (D 100: 8 bytes in bf16, 4 in int8); rows with no
//   4-byte alignment (odd bf16 D) take plain loads into shared memory. Chosen
//   on the host side of the launch from D, rs and the pointers, never by
//   giving way to a plain version. The page ids are read two tiles ahead of
//   their copy (a thread a row) and the tile's slots staged a tile ahead, so
//   no copy waits on the page table at any page size. The first tiles' copies
//   go out before the q rows are staged.
// - Every K and V row is padded from D to a multiple of 16 columns (int8 V:
//   32) with zeros, written once when the block starts and never by a copy,
//   so D 16, 80, 96, 100 and odd D all run the same m16n8k16 loop; rows of
//   a tile outside [lo, hi) get zeros instead of a copy and are masked, so
//   no stale value meets a zero probability. Instantiations: three column
//   buckets (64, 128, 256) per pool type; the loops run D's own tile count.
// - Warp w takes tokens [16w, 16w + 16) of each tile and keeps its own
//   (m, l, O); one __syncthreads a tile. bf16 tiles go through ldmatrix (V
//   through ldmatrix.trans); int8 tiles are read as 32-bit words and
//   converted in registers (attn_headmajor_q.cu's layout: the words a lane's
//   fragments need, the output columns permuted and put back at the end).
// - Copies by the copy engine did not pay (timed on the H100 against this
//   design at H2O-Danube-1.8B's shape): one cp.async.bulk a row, issued by one
//   warp on a stage mbarrier, and a copy warp issuing every tile's cp.async
//   beside four product warps were both slower: issuing the copies needs the
//   threads of the whole block. TMA boxes of a page ([S, 1, D] over the pool
//   seen as [N, Hkv, rs]) would copy every row of the page, where rows outside
//   [lo, hi) must not be read at all (the fused mode's row ctx - 1 is being
//   written by another block, and a stale row may hold inf or NaN), and need
//   16-byte rows (not D 100 or odd D).
//
// Fused write + attend (FUSED, bf16 pools; paged_attention_fused.cu):
// context_lens include this step's token, whose K and V rows (k_new, v_new
// [B, Hkv, D], already in the pool's dtype) are not in the pool yet. Row ctx
// - 1 is never read: end = ctx - 1, so its tile row gets zeros and a mask
// like any row past the context, while another block writes it during the
// launch. Split 0, head group 0 of each (b, KV head) stores that head's rows
// at slot_mapping[b] when it is >= 0 (and ctx >= 1, as the TPU kernel writes
// only inside a context). The new token's column (s = scale * q . k_new, l =
// 1, acc = v_new) is folded into the fp32 softmax once per (b, query head),
// by the block that writes the output: the only split's block, or the one
// that draws the last ticket. An empty context therefore gives v_new. A
// stored row is rs elements long; K sits at its start, V at v_pool - k_pool
// elements into it: separate pools (rs = D, v_pool its own array) or the
// packed single pool [N, Hkv, 2D] (rs = 2D, v_pool = k_pool + D).
//
// What holds it back (timestamps and cycle counts of instrumented copies of
// this kernel, H100, Danube's shape): the tile loop takes most of the time;
// in a tile, issuing the cp.async copies stalls every thread longest (the
// memory system pushing back), and each warp's products and softmax follow
// it; the split P . V doubles the second product's mma count; the block's
// start and the last block's merge lie outside the stream.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "decode_split.cuh"

// Internal linkage throughout: each library that includes this header (and an
// earlier tree's build of it, loaded beside it for a comparison) keeps its
// own kernels and its own once-per-process attribute flags.
namespace zt_paged {
namespace {

using bf16 = __nv_bfloat16;
using namespace zt_mma;
using zt_decode::HR;
using zt_decode::MAX_SPLITS;
using zt_decode::NEG_INF;
using zt_decode::NT;
using zt_decode::NWARPS;
using zt_decode::TN;

constexpr int DMAX = 256;

// The fused mode's extra inputs (null pointers otherwise), of the pool's type.
struct FusedRows {
  const void* k_new;      // [B, Hkv, D] this step's rows, in the pool's dtype
  const void* v_new;      // [B, Hkv, D]
  const int32_t* slots;   // [B] pool slot of each row; < 0 => not written
  void* k_dst;            // the pools again, written at slots[b] only
  void* v_dst;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the column bucket of head dim D: the registers a lane keeps
__host__ __device__ constexpr int bucket(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }

// ring stages of a bucket: bf16 tiles take twice the bytes of int8 ones
template <bool QUANT, int DPM>
__host__ __device__ constexpr int stages() {
  return QUANT ? (DPM == 64 ? 4 : 3) : (DPM == 64 ? 4 : 2);
}

// The block's shared memory at head dim D, in bytes: the ring (each stage K
// rows, V rows, and for int8 the tile's K and V scales), which the merge
// buffers reuse at the end; the q rows; the ring of the tiles' slots.
struct Layout {
  int dk, dv;     // K and V columns staged (D zero-padded to 16; int8 V to 32)
  int ldk, ldv;   // elements per staged K and V row
  int ldq;        // bf16 per staged q row
  int stage, buf, q_off, slot_off, new_off, bytes;

  __host__ __device__ Layout(int D, bool quant, int nstages) {
    dk = round_up(D, 16);
    ldq = dk + 8;
    if (quant) {
      // word-read rows: (ldk / 16) odd and ldv = 32m + 16 make the fragment
      // reads conflict-free
      dv = round_up(D, 32);
      ldk = (dk / 16) % 2 ? dk + 32 : dk + 16;
      ldv = dv + 16;
      stage = TN * (ldk + ldv) + 2 * TN * 4;
    } else {
      dv = dk;
      ldk = ldv = dk + 8;  // ldmatrix rows conflict-free
      stage = TN * (ldk + ldv) * 2;
    }
    const int merge = (NWARPS * HR * D + 3 * NWARPS * HR + 2 * HR) * 4;
    buf = round_up(nstages * stage > merge ? nstages * stage : merge, 16);
    q_off = buf;
    slot_off = q_off + HR * ldq * 2;
    new_off = slot_off + nstages * TN * 4;  // the fused mode's s_new [HR] and v_new row
    bytes = new_off + HR * 4 + DMAX * 2;
  }
};

// How a thread walks a tile's row chunks: chunk i = tid + k * NT of the
// row-major (row, chunk) grid, stepped without a division.
struct CopyPlan {
  int epc, cpr;  // elements per chunk, chunks per row
  int r0, c0, dr, dc;
};

__device__ __forceinline__ CopyPlan copy_plan(int D, int esize, int vb, int tid) {
  CopyPlan p;
  p.epc = vb ? vb / esize : 1;
  p.cpr = D / p.epc;
  p.r0 = tid / p.cpr;
  p.c0 = tid % p.cpr;
  p.dr = NT / p.cpr;
  p.dc = NT % p.cpr;
  return p;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ __half zero<__half>() { return __float2half(0.f); }
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

// Rows of one tile from one pool: row r of the tile is the hkv row of slot
// slots[r] (zeros where slots[r] < 0), D elements of T into dst + r * ld, in
// vb-byte copies (vb 16, 8, 4; 0: plain element loads).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* pool, const int* slots,
                                          long long Hkv, int hkv, long long rs, int vb,
                                          const CopyPlan& p) {
  int r = p.r0, c = p.c0;
  while (r < TN) {
    const int slot = slots[r];
    T* d = dst + r * ld + c * p.epc;
    if (slot >= 0) {
      const T* s = pool + ((long long)slot * Hkv + hkv) * rs + c * p.epc;
      if (vb == 16) cp_async16(d, s);
      else if (vb == 8) cp_async8(d, s);
      else if (vb == 4) cp_async4(d, s);
      else *d = *s;
    } else {
      if (vb == 16) *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      else if (vb == 8) *reinterpret_cast<uint2*>(d) = make_uint2(0, 0);
      else if (vb == 4) *reinterpret_cast<uint32_t*>(d) = 0u;
      else *d = zero<T>();
    }
    c += p.dc;
    r += p.dr;
    if (c >= p.cpr) {
      c -= p.cpr;
      ++r;
    }
  }
}

// The end of a block, every thread. sO [NWARPS][HR][D] holds each warp's
// unnormalized O in head-dim order, then sM, sL [NWARPS][HR] its running max
// and sum, then room for the warps' weights [NWARPS][HR] and the rows' (M, L)
// [2][HR]. Merges the warps, then writes the output (one split) or this
// split's partial and, in the block that draws the last ticket, merges the
// splits in fixed order. FUSED folds the new token's column (s_new [HR] and
// the v_new row, in shared memory) in, in the block that writes the output.
template <bool FUSED, class Q>
__device__ __forceinline__ void finish(float* sO, int D, Q* out, float* part_acc,
                                       float* part_ml, int* tickets, int rows, int parts,
                                       int split, long long row0, long long slot,
                                       long long ticket, int tid, int* s_last,
                                       const float* s_new, const Q* v_new) {
  float* sM = sO + NWARPS * HR * D;
  float* sL = sM + NWARPS * HR;
  float* sW = sL + NWARPS * HR;        // the warps' weights [NWARPS][HR]
  float* sRow = sW + NWARPS * HR;      // M [HR], L [HR]
  __syncthreads();
  if (tid < HR) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sM[w * HR + tid]);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = __expf(sM[w * HR + tid] - M);
      sW[w * HR + tid] = f;
      L += sL[w * HR + tid] * f;
    }
    sRow[tid] = M;
    sRow[HR + tid] = L;
  }
  auto write = [&](int r, int d, float M, float L, float A) {
    if constexpr (FUSED) {  // one more partial: m = s_new, l = 1, acc = v_new
      const float s = s_new[r];
      const float M2 = fmaxf(M, s);
      const float fa = __expf(M - M2), fb = __expf(s - M2);
      L = L * fa + fb;
      A = A * fa + Elem<Q>::to_f(v_new[d]) * fb;
    }
    out[(row0 + r) * D + d] = Elem<Q>::from_f(A / fmaxf(L, 1e-20f));
  };

  if (parts == 1) {
    __syncthreads();
    for (int i = tid; i < rows * D; i += NT) {
      const int r = i / D, d = i - r * D;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) A += sO[(w * HR + r) * D + d] * sW[w * HR + r];
      write(r, d, sRow[r], sRow[HR + r], A);
    }
    return;
  }

  // several splits: write this split's partial, then the last block merges
  __syncthreads();
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) A += sO[(w * HR + r) * D + d] * sW[w * HR + r];
    part_acc[((slot + split) * HR + r) * D + d] = A;
  }
  if (tid < rows) {
    part_ml[(slot + split) * 2 * HR + tid] = sRow[tid];
    part_ml[(slot + split) * 2 * HR + HR + tid] = sRow[HR + tid];
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(tickets + ticket, 1) == parts - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  if (tid == 0) tickets[ticket] = 0;  // ready for the next launch
  // each output element merges the splits' partials online, in fixed split
  // order; the loads of eight splits are in flight at once
#pragma unroll 2
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {
      const float* ml = part_ml + (slot + p) * 2 * HR;
      const float m = __ldcg(ml + r), l = __ldcg(ml + HR + r);
      const float a = __ldcg(part_acc + ((slot + p) * HR + r) * D + d);
      const float M2 = fmaxf(M, m);
      const float fa = __expf(M - M2), fb = __expf(m - M2);
      L = L * fa + l * fb;
      A = A * fa + a * fb;
      M = M2;
    }
    write(r, d, M, L, A);
  }
}

// T: bf16 or fp16 (model-dtype pools, T == Q) or int8 (quantized pools, read
// with scales); Q: the type of q and out (bf16 or fp16); DPM: the column
// bucket (registers for DPM / 8 accumulator tiles); FUSED: write this step's
// rows and fold their column in (header). vb: the copy width in bytes (0:
// plain loads).
template <typename T, typename Q, int DPM, bool FUSED>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    Q* __restrict__ out,                      // [B, Hq, D]
    float* __restrict__ part_acc,             // [B, Hkv * groups, splits, HR, D]
    float* __restrict__ part_ml,              // [B, Hkv * groups, splits, 2, HR]
    int* __restrict__ tickets,                // [B, Hkv * groups], zero between launches
    const Q* __restrict__ q,                  // [B, Hq, D]
    const T* k_pool,                          // [N, Hkv, rs]: K at the row's start
    const T* v_pool,                          // V at the same stride
    const float* __restrict__ k_scales,       // [Hkv, scale_stride] (int8 pools)
    const float* __restrict__ v_scales,       // [Hkv, scale_stride] (int8 pools)
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    FusedRows fz, int Hkv, int G, int groups, int D, long long rs, long long N,
    long long scale_stride, int maxp, int S, float scale, int window, int vb) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int STAGES = stages<QUANT, DPM>();
  static_assert(!(FUSED && QUANT), "the fused mode takes model-dtype pools");
  using E = Elem<Q>;
  const Layout L(D, QUANT, STAGES);
  extern __shared__ __align__(128) unsigned char smem[];
  Q* sQ = reinterpret_cast<Q*>(smem + L.q_off);
  int* sSlot = reinterpret_cast<int*>(smem + L.slot_off);  // [STAGES][TN]
  __shared__ int s_last;

  const int split = blockIdx.x, splits = gridDim.x;
  const int hg = blockIdx.y;  // hkv * groups + group
  const int hkv = hg / groups, grp = hg % groups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i4 = lane % 4;
  const int Hq = Hkv * G;
  const int h0 = hkv * G + grp * HR;  // the block's first query head
  const int rows = min(HR, G - grp * HR);

  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S));
  // the fused mode's row ctx - 1 comes from k_new / v_new, never the pool
  const int end = FUSED ? max(ctx - 1, 0) : ctx;
  const int start = window > 0 ? max(0, ctx - window) : 0;
  // split s takes tokens [lo, hi): [start, end) cut into `splits` runs of
  // one length, a multiple of 16 tokens, so that no block has a tile more
  // than another; its 64-token tiles count from lo
  const int len = max(end - start, 0);
  const int per = round_up(max((len + splits - 1) / splits, 1), 16);
  const int parts = max((len + per - 1) / per, 1);
  if (split >= parts) return;  // an empty split: the merge counts `parts` tickets only
  const int lo = start + split * per, hi = min(lo + per, end);

  if constexpr (FUSED) {
    const long long slot = fz.slots[b];
    if (split == 0 && grp == 0 && slot >= 0 && slot < N && ctx >= 1) {
      const long long src = ((long long)b * Hkv + hkv) * D;
      const long long dst = (slot * Hkv + hkv) * rs;
      for (int d = tid; d < D; d += NT) {
        static_cast<T*>(fz.k_dst)[dst + d] = static_cast<const T*>(fz.k_new)[src + d];
        static_cast<T*>(fz.v_dst)[dst + d] = static_cast<const T*>(fz.v_new)[src + d];
      }
    }
  }

  const int32_t* pt = page_tables + (long long)b * maxp;
  const long long num_pages = N / S;
  const int s_shift = log2_if_pow2(S);
  const int n = (max(hi - lo, 0) + TN - 1) / TN;
  // the slot of token t, -1 outside [start, end); in two halves so that the
  // page-table load is in flight while the warps multiply
  auto page_load = [&](int t) -> int {
    return (t >= lo && t < hi) ? pt[s_shift >= 0 ? t >> s_shift : t / S] : 0;
  };
  auto slot_of = [&](int t, int page) -> int {
    if (t < lo || t >= hi) return -1;
    const int pidx = s_shift >= 0 ? t >> s_shift : t / S;
    const long long pg = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    return (int)(pg * S + (t - pidx * S));
  };

  // the q rows (zero rows past `rows`, zero columns past D): the group's
  // rows are rows * D consecutive elements of q, all loaded before any is
  // stored; the pad columns of every stage (never written by a copy); the
  // first tiles' slots
  constexpr int QPT = HR * DPM / NT;  // q elements a thread loads at most
  const Q* qg = q + ((long long)b * Hq + h0) * D;
  Q qv[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int e = tid + j * NT;
    qv[j] = e < rows * D ? qg[e] : zero<Q>();
  }
  // the ring (every pad column with it) and the q rows: zeros, 16 bytes a store
  for (int e = tid; e < (L.q_off + HR * L.ldq * 2) / 16; e += NT)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  // page ids two tiles ahead of their store: tile it + STAGES is read into
  // pg_ahead during iteration it - 1 and stored at the end of iteration it,
  // so a page-table load never stalls the tile loop
  int pg_ahead = 0;
  if (tid < TN) {
    int pg[STAGES + 1];
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) pg[s] = s < n ? page_load(lo + s * TN + tid) : 0;
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      if (s < n) sSlot[s * TN + tid] = slot_of(lo + s * TN + tid, pg[s]);
    pg_ahead = pg[STAGES];
  }
  __syncthreads();  // the ring and sQ are zero, the first slots staged

  const CopyPlan plan = copy_plan(D, (int)sizeof(T), vb, tid);
  const float* ks_head = QUANT ? k_scales + (long long)hkv * scale_stride : nullptr;
  const float* vs_head = QUANT ? v_scales + (long long)hkv * scale_stride : nullptr;
  // tile j of the split into stage j % STAGES (its slots already staged)
  auto issue = [&](int j) {
    if (j < n) {
      unsigned char* st = smem + (j % STAGES) * L.stage;
      const int* slots = sSlot + (j % STAGES) * TN;
      T* sk = reinterpret_cast<T*>(st);
      T* sv = sk + TN * L.ldk;
      copy_rows<T>(sk, L.ldk, k_pool, slots, Hkv, hkv, rs, vb, plan);
      copy_rows<T>(sv, L.ldv, v_pool, slots, Hkv, hkv, rs, vb, plan);
      if constexpr (QUANT) {
        // thread tid: the K scale of row tid (tid < 64), else the V scale of row tid - 64
        float* dst = reinterpret_cast<float*>(sv + TN * L.ldv) + tid;
        const int slot = slots[tid % TN];
        if (slot >= 0) cp_async4(dst, (tid < TN ? ks_head : vs_head) + slot);
        else *dst = 0.f;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  // the q rows, while the first tiles are in flight
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int e = tid + j * NT;
    if (e < rows * D) {
      const int r = e / D;
      sQ[r * L.ldq + e - r * D] = qv[j];
    }
  }
  __syncthreads();

  // the fused mode's new column, while the first tiles are in flight: each
  // row's fp32 score against k_new (warp w takes rows w, w + 4, ...) and the
  // v_new row, kept in shared memory for the block that writes the output
  float* sNew = reinterpret_cast<float*>(smem + L.new_off);
  Q* sVn = reinterpret_cast<Q*>(sNew + HR);
  if constexpr (FUSED) {
    const long long kv_row = ((long long)b * Hkv + hkv) * D;
    const Q* k_new = static_cast<const Q*>(fz.k_new);
    for (int r = warp; r < rows; r += NWARPS) {
      float x = 0.f;
      for (int d = lane; d < D; d += 32)
        x += E::to_f(sQ[r * L.ldq + d]) * E::to_f(k_new[kv_row + d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) sNew[r] = x * scale;
    }
    for (int d = tid; d < D; d += NT) sVn[d] = static_cast<const Q*>(fz.v_new)[kv_row + d];
  }

  const int nk = L.dk / 16;  // 16-deep steps of Q K^T
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[DPM / 8][4];
#pragma unroll
  for (int j = 0; j < DPM / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < n; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    issue(it + STAGES - 1);  // into tile it - 1's stage
    // the page ids of tile it + STAGES + 1, stored in the next iteration
    const int pg_after = tid < TN && it + STAGES + 1 < n
                             ? page_load(lo + (it + STAGES + 1) * TN + tid) : 0;

    const int tok0 = lo + it * TN + warp * 16;  // this warp's 16 tokens
    if (tok0 < hi) {                            // warp-uniform
      const unsigned char* st = smem + (it % STAGES) * L.stage;
      const T* kw = reinterpret_cast<const T*>(st) + warp * 16 * L.ldk;
      const T* vw = reinterpret_cast<const T*>(st) + TN * L.ldk + warp * 16 * L.ldv;

      // S = Q K^T over the warp's 16 keys (two n8 tiles: keys g and 8 + g)
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k = 0; k < DPM / 16; ++k) {
        if (k < nk) {
          if constexpr (QUANT) {
            // dims 16k + 4i .. + 3 of rows g and g + 8 as k slots (2i, 2i +
            // 1, 2i + 8, 2i + 9), the same dims of key g in one word
            const uint2 lo = *reinterpret_cast<const uint2*>(sQ + g * L.ldq + 16 * k + 4 * i4);
            const uint2 hi =
                *reinterpret_cast<const uint2*>(sQ + (g + 8) * L.ldq + 16 * k + 4 * i4);
            const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              uint32_t b0, b1;
              E::i8x4(*reinterpret_cast<const uint32_t*>(
                          reinterpret_cast<const unsigned char*>(kw) +
                          (nt * 8 + g) * L.ldk + 16 * k + 4 * i4),
                      b0, b1);
              E::mma(s[nt], a, b0, b1);
            }
          } else {
            uint32_t a[4], bk[4];
            ldsm_x4(a, sQ + a_offset(lane, L.ldq, k * 16));
            ldsm_x4(bk, kw + b_offset(lane, L.ldk, 0, k * 16));
            E::mma(s[0], a, bk[0], bk[1]);
            E::mma(s[1], a, bk[2], bk[3]);
          }
        }
      }

      // online softmax over the warp's 16 keys for rows g and g + 8; the
      // scale (and an int8 row's K scale) multiplies the score before the mask
      const float* sks = QUANT ? reinterpret_cast<const float*>(
                                     reinterpret_cast<const T*>(st) + TN * (L.ldk + L.ldv)) +
                                     warp * 16
                               : nullptr;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float2 ksc = make_float2(1.f, 1.f);
        if constexpr (QUANT) ksc = *reinterpret_cast<const float2*>(sks + nt * 8 + 2 * i4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tok0 + nt * 8 + 2 * i4 + (e & 1);
          float v = s[nt][e] * scale;
          if constexpr (QUANT) v *= e & 1 ? ksc.y : ksc.x;
          v = (t >= lo && t < hi) ? v : NEG_INF;
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
      // p into l unscaled; the A operand (p, int8: p times the key's V
      // scale) split into hi and lo halves of Q
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float2 vsc = make_float2(1.f, 1.f);
        if constexpr (QUANT) vsc = *reinterpret_cast<const float2*>(sks + TN + nt * 8 + 2 * i4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[nt][e] > NEG_INF ? __expf(s[nt][e] - m_r[e >> 1]) : 0.f;
          l_r[e >> 1] += p;
          s[nt][e] = QUANT ? p * (e & 1 ? vsc.y : vsc.x) : p;
        }
      }
      uint32_t ph[4], pl[4];
      split_pair<Q>(s[0][0], s[0][1], ph[0], pl[0]);
      split_pair<Q>(s[0][2], s[0][3], ph[1], pl[1]);
      split_pair<Q>(s[1][0], s[1][1], ph[2], pl[2]);
      split_pair<Q>(s[1][2], s[1][3], ph[3], pl[3]);
      const int nj = L.dv / 8;  // n8 tiles of the output
#pragma unroll
      for (int j = 0; j < DPM / 8; ++j) {
        if (j < nj) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
      }
      if constexpr (QUANT) {
        // O += P V: the words of keys 2i, 2i + 1, 2i + 8, 2i + 9 at head dims
        // 32c + 4g .. + 3; byte t is B column g of n8 tile 4c + t
        const unsigned char* vb8 =
            reinterpret_cast<const unsigned char*>(vw) + 2 * i4 * L.ldv + 4 * g;
#pragma unroll
        for (int c = 0; c < DPM / 32; ++c) {
          if (c < L.dv / 32) {
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vb8 + 32 * c);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vb8 + L.ldv + 32 * c);
            const uint32_t w8 = *reinterpret_cast<const uint32_t*>(vb8 + 8 * L.ldv + 32 * c);
            const uint32_t w9 = *reinterpret_cast<const uint32_t*>(vb8 + 9 * L.ldv + 32 * c);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const uint32_t b0 = E::i8pair(w0, w1, t), b1 = E::i8pair(w8, w9, t);
              E::mma(o[4 * c + t], ph, b0, b1);
              E::mma(o[4 * c + t], pl, b0, b1);
            }
          }
        }
      } else {
#pragma unroll
        for (int dp = 0; dp < DPM / 16; ++dp) {
          if (dp < nk) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, vw + bt_offset(lane, L.ldv, 0, dp * 16));
            E::mma(o[2 * dp], ph, bv[0], bv[1]);
            E::mma(o[2 * dp], pl, bv[0], bv[1]);
            E::mma(o[2 * dp + 1], ph, bv[2], bv[3]);
            E::mma(o[2 * dp + 1], pl, bv[2], bv[3]);
          }
        }
      }
    }
    if (tid < TN && it + STAGES < n)
      sSlot[(it % STAGES) * TN + tid] = slot_of(lo + (it + STAGES) * TN + tid, pg_ahead);
    pg_ahead = pg_after;
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages become the merge buffers

  // per warp O (head dims in order, those past D dropped), m and l (l summed
  // over the quad first)
  float* sO = reinterpret_cast<float*>(smem);  // [NWARPS][HR][D]
  float* sM = sO + NWARPS * HR * D;            // [NWARPS][HR]
  float* sL = sM + NWARPS * HR;                // [NWARPS][HR]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (i4 == 0) {
    sM[warp * HR + g] = m_r[0];
    sM[warp * HR + g + 8] = m_r[1];
    sL[warp * HR + g] = l_r[0];
    sL[warp * HR + g + 8] = l_r[1];
  }
  float* ow = sO + warp * HR * D;
#pragma unroll
  for (int j = 0; j < DPM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // column 2 i + e of n8 tile j: bf16 head dim 8j + 2i + e; int8 (tile
      // 4c + t) head dim 32c + 4(2i + e) + t
      const int d = QUANT ? 32 * (j / 4) + 4 * (2 * i4 + e) + j % 4 : 8 * j + 2 * i4 + e;
      if (d < D) {
        ow[g * D + d] = o[j][e];
        ow[(g + 8) * D + d] = o[j][2 + e];
      }
    }
  }
  finish<FUSED, Q>(sO, D, out, part_acc, part_ml, tickets, rows, parts, split,
                (long long)b * Hq + h0, ((long long)b * gridDim.y + hg) * splits,
                (long long)b * gridDim.y + hg, tid, &s_last, sNew, sVn);
}

template <typename T, typename Q, int DPM, bool FUSED>
int set_smem() {
  static int done = -1;  // the attribute is set once per instantiation
  if (done < 0) {
    const Layout L(DPM, sizeof(T) == 1, stages<sizeof(T) == 1, DPM>());
    done = (int)cudaFuncSetAttribute(paged_decode_kernel<T, Q, DPM, FUSED>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  }
  return done;
}

template <typename T, typename Q, int DPM, bool FUSED>
int launch(void* out, void* part_acc, void* part_ml, void* tickets, const void* q,
           const void* k_pool, const void* v_pool, const void* k_scales, const void* v_scales,
           const void* page_tables, const void* context_lens, const FusedRows& fz, int B,
           int Hkv, int G, int D, long long rs, long long N, long long scale_stride, int maxp,
           int S, float scale, int window, int vb, int splits, cudaStream_t stream) {
  const int e = set_smem<T, Q, DPM, FUSED>();
  if (e != 0) return e;
  const Layout L(D, sizeof(T) == 1, stages<sizeof(T) == 1, DPM>());
  const int groups = (G + HR - 1) / HR;
  paged_decode_kernel<T, Q, DPM, FUSED><<<dim3(splits, Hkv * groups, B), NT, L.bytes, stream>>>(
      (Q*)out, (float*)part_acc, (float*)part_ml, (int*)tickets, (const Q*)q,
      (const T*)k_pool, (const T*)v_pool, (const float*)k_scales, (const float*)v_scales,
      (const int32_t*)page_tables, (const int32_t*)context_lens, fz, Hkv, G, groups, D, rs, N,
      scale_stride, maxp, S, scale, window, vb);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// The widest copy (16, 8 or 4 bytes; 0: plain loads) that every K and V row
// allows: its bytes, the row stride and both pools' addresses.
template <typename T>
int copy_bytes(int D, long long rs, const void* k_pool, const void* v_pool) {
  const long long es = (long long)sizeof(T);
  const int widths[3] = {16, 8, 4};
  for (int vb : widths)
    if ((D * es) % vb == 0 && (rs * es) % vb == 0 && aligned(k_pool, vb) && aligned(v_pool, vb))
      return vb;
  return 0;
}

// Checks the arguments, picks the column bucket and the copy width, and
// launches. splits in [1, MAX_SPLITS]; with splits > 1 the partials and the
// tickets must be given.
template <typename T, typename Q, bool FUSED>
int dispatch(void* out, void* part_acc, void* part_ml, void* tickets, const void* q,
             const void* k_pool, const void* v_pool, const void* k_scales, const void* v_scales,
             const void* page_tables, const void* context_lens, const FusedRows& fz, int B,
             int Hkv, int G, int D, long long rs, long long N, long long scale_stride, int maxp,
             int S, float scale, int window, int splits, cudaStream_t stream) {
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  if (D < 1 || D > DMAX || rs < D || S < 1 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vb = copy_bytes<T>(D, rs, k_pool, v_pool);
#define ZT_CASE(DPM)                                                                         \
  if (bucket(D) == DPM)                                                                      \
    return launch<T, Q, DPM, FUSED>(out, part_acc, part_ml, tickets, q, k_pool, v_pool,         \
                                 k_scales, v_scales, page_tables, context_lens, fz, B, Hkv,  \
                                 G, D, rs, N, scale_stride, maxp, S, scale, window, vb,      \
                                 splits, stream);
  ZT_CASE(64) ZT_CASE(128) ZT_CASE(256)
#undef ZT_CASE
  return (int)cudaErrorInvalidValue;
}

// How many blocks of the head-dim-D kernel one SM holds at once (the fp16
// instantiations take the bf16 ones' shared memory).
template <typename T, bool FUSED>
int blocks_per_sm(int D, int* blocks) {
  if (D < 1 || D > DMAX) return (int)cudaErrorInvalidValue;
#define ZT_CASE(DPM)                                                                          \
  if (bucket(D) == DPM) {                                                                     \
    const int e = set_smem<T, bf16, DPM, FUSED>();                                            \
    if (e != 0) return e;                                                                     \
    const Layout L(D, sizeof(T) == 1, stages<sizeof(T) == 1, DPM>());                         \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                \
        blocks, paged_decode_kernel<T, bf16, DPM, FUSED>, NT, L.bytes);                       \
  }
  ZT_CASE(64) ZT_CASE(128) ZT_CASE(256)
#undef ZT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace zt_paged
