// Paged decode attention over the head-major packed K|V pool.
//
// Replaces: zhilight_tpu/ops/pallas/attn_headmajor.py
// paged_decode_attention_hm (:151), kernel _kernel_hm (:54), in its default
// mode (normalized output) and its emit_partial mode (:126-139, the flash
// partials of the decode-window side buffer); not its MLA v_dim mode
// (csrc/mla_decode.cu).
//
// Computes, for each sequence b and query head h = hkv * G + g:
//   out[b, h] = softmax(scale * q[b, h] . K[t]) . V[t] over the tokens
//   t in [start, ctx), ctx = context_lens[b], start = max(0, ctx - window)
//   when a sliding window is set; token t lives at pool[hkv, page*S + t%S]
//   with page = page_tables[b, t / S] (clamped into the pool); K is lanes
//   [:D], V lanes [D:].
// q, the pool and the output are bf16 or fp16 (one type, T). fp32 scores and
// online softmax with NEG_INF = -2e38 and the max(l, 1e-20)
// floor of the TPU kernel, so an empty slot (ctx == 0) yields zeros. The
// probabilities are rounded to T for the P.V product, as the TPU kernel
// casts p.astype(kv.dtype) before its second dot_general (_kernel_hm body,
// :118-122); l sums them unrounded. With EMIT (the partial mode) the kernel
// writes fp32 m = max score, l = sum of exp(score - m) and the unnormalized
// acc = sum exp(score - m) * V instead of acc / max(l, 1e-20): m = -2e38,
// l = 0, acc = 0 for an empty slot.
//
// Bound on the H100: bytes, B * ctx * Hkv * 2D * 2 of pool plus q, the output,
// the page tables and the lengths: at Qwen2.5-14B's batch 8, context 3712,
// 8 KV heads of 128 that is 121.6 MB a layer, 36.4 us at 3.35 TB/s. The
// arithmetic is 4 * G flops per pool element (5 flops per byte at G 5), far
// under the card's 295, so the tensor cores here take the serial
// per-token shuffle reductions out of the loop, not the rate.
//
// Design (split-context flash decoding on mma.sync):
// - Grid (splits, Hkv * groups, B). A block owns up to 16 query rows of one
//   KV head (G rows, zero-padded to 16: one m16 tile; G > 16 is cut into
//   groups of 16) and a run of 64-token tiles of one sequence, so each K|V
//   row is read once for all the group's query heads. The host picks `splits`
//   so that all the blocks fit on the card at once, in one wave
//   (ops/cuda/attn_headmajor.py `decode_splits`, from B, Hkv, G, the page
//   tables' width and zt_decode_attention_hm_blocks_per_sm): a block that
//   starts late, after the first wave, would double the time. A batch of 8
//   on 8 KV heads then takes 4 splits at D 128 (256 blocks, two an SM),
//   while MiniCPM-2B's 576 (sequence, head) pairs take one and skip the
//   merge.
// - The tiles of a sequence are [start / 64, ceil(ctx / 64)) on the absolute
//   64-token grid; split s takes tiles [s * per, (s + 1) * per) of them with
//   per = ceil(tiles / splits), so every split is a whole number of tiles,
//   the splits cover [start, ctx) exactly and a short sequence leaves the
//   later splits empty (those blocks return at once; `parts` counts the
//   others). Rows of a tile outside [start, ctx) are zero-filled in shared
//   memory and masked, so no stale bf16 (inf, NaN) meets a zero probability.
// - K|V tiles (64 rows of 2D bf16, rows padded by 16 bytes so ldmatrix is
//   conflict-free) are gathered through the page table with cp.async 16-byte
//   copies into a ring of stages (3 at D 128, 2 otherwise): the next tiles' bytes are
//   in flight while this one is multiplied. The page ids of the next tile to
//   copy are loaded a tile ahead, two a lane, and spread by shuffles, so no
//   copy waits on a page-table read. One __syncthreads per tile.
// - Warp w takes tokens [16w, 16w + 16) of each tile: S = Q K^T is 16 x 16 x D
//   and O += P V is 16 x D x 16 on mma.sync m16n8k16 (bf16 -> fp32), Q and K
//   through ldmatrix, V through ldmatrix.trans; P goes from the score
//   accumulators to the A operand in registers (csrc/attn_tile.cuh). Each warp
//   keeps its own (m, l, O) over its tokens: no barrier between the two
//   products; the four warps merge through shared memory at the end.
// - The split merge happens in the last block of a (sequence, head group) to
//   finish, not in a second kernel: each block writes its (m, l, acc) partial,
//   fences, and takes a ticket from a zeroed int32 counter that the wrapper
//   owns; the block that draws the last ticket merges all the partials in
//   fixed split order (fp32, so the result does not depend on which block
//   ran last) and resets the counter to zero. One launch a layer keeps the
//   host-bound paths' launch count as it was; a merge kernel would add one.
// - Any D in {64, 128, 192, 256} and any G.

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
  static constexpr int LDK = 2 * D + 8;  // bf16 per staged K|V row
  static constexpr int LDQ = D + 8;      // bf16 per staged q row
  // 3 stages at D 128 (two blocks an SM), 2 elsewhere: at D 64 that lets six
  // blocks share an SM, so MiniCPM-2B's 576 blocks run in one wave
  static constexpr int STAGES = D == 128 ? 3 : 2;
  static constexpr int STAGE = TN * LDK;  // bf16 per stage
  static constexpr int KV_BYTES = STAGES * STAGE * 2;
  static constexpr int BYTES = KV_BYTES + HR * LDQ * 2;
  // the end-of-block merge reuses the stages (decode_split.cuh)
  static_assert(merge_floats<D>() * 4 <= KV_BYTES, "merge buffers");
  static_assert(D % 64 == 0, "head dim");
};

template <int D, bool EMIT, class T>
__global__ void __launch_bounds__(NT) decode_hm_kernel(
    void* __restrict__ out,                   // [B, Hq, D]: T, or fp32 acc with EMIT
    float* __restrict__ m_out,                // [B, Hq] with EMIT, else unused
    float* __restrict__ l_out,                // [B, Hq] with EMIT, else unused
    float* __restrict__ part_acc,             // [B, Hkv * groups, splits, HR, D]
    float* __restrict__ part_ml,              // [B, Hkv * groups, splits, 2, HR]
    int* __restrict__ tickets,                // [B, Hkv * groups], zero between launches
    const T* __restrict__ q,                  // [B, Hq, D]
    const T* __restrict__ pool,               // [Hkv, N, 2D]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    int Hkv, int G, int groups, long long N, int maxp, int S, float scale, int window) {
  using C = Cfg<D>;
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sKV = reinterpret_cast<T*>(smem);
  T* sQ = reinterpret_cast<T*>(smem + C::KV_BYTES);
  __shared__ int s_last;

  const int split = blockIdx.x, splits = gridDim.x;
  const int hg = blockIdx.y;  // hkv * groups + group
  const int hkv = hg / groups, grp = hg % groups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
  for (int i = tid; i < HR * QV; i += NT) {
    const int r = i / QV, c = i % QV;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(q + ((long long)b * Hq + h0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * C::LDQ + c * 8) = v;
  }

  const T* head = pool + (long long)hkv * N * 2 * D;
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
      const int tile = first + issued;
      gather_tile<TN, 2 * D, C::LDK, NT, 2, T>(sKV + (issued % C::STAGES) * C::STAGE, head, pt, ids,
                                         tile * TN, start, ctx, S, s_shift, num_pages, tid);
      if (++issued < n) ids = fetch_pages(pt, maxp, page_of((tile + 1) * TN), lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) issue();

  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    issue();          // tile i + STAGES - 1, into tile i - 1's stage
    const int tok0 = (first + i) * TN + warp * 16;  // this warp's 16 tokens
    if (tok0 >= ctx || tok0 + 16 <= start) continue;  // warp-uniform
    const T* kw = sKV + (i % C::STAGES) * C::STAGE + warp * 16 * C::LDK;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, sQ + a_offset(lane, C::LDQ, k * 16));
      ldsm_x4(bk, kw + b_offset(lane, C::LDK, 0, k * 16));
      E::mma(s[0], a, bk[0], bk[1]);
      E::mma(s[1], a, bk[2], bk[3]);
    }

    // online softmax over the warp's 16 tokens; rows g and g + 8 of the tile
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tok0 + nt * 8 + 2 * (lane % 4) + (e & 1);
        const float v = (t >= start && t < ctx) ? s[nt][e] * scale : NEG_INF;
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
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] > NEG_INF ? __expf(s[nt][e] - m_r[e >> 1]) : 0.f;
        s[nt][e] = p;
        l_r[e >> 1] += p;
      }
    uint32_t pa[4] = {E::pack(s[0][0], s[0][1]), E::pack(s[0][2], s[0][3]),
                      E::pack(s[1][0], s[1][1]), E::pack(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, kw + bt_offset(lane, C::LDK, 0, D + dp * 16));
      E::mma(o[2 * dp], pa, bv[0], bv[1]);
      E::mma(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages become the merge buffers

  // merge the four warps: per-warp O, m and l (l summed over the quad first)
  float* sO = reinterpret_cast<float*>(smem);        // [NWARPS][HR][D]
  float* sM = sO + NWARPS * HR * D;                  // [NWARPS][HR]
  float* sL = sM + NWARPS * HR;                      // [NWARPS][HR]
  {
    const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    if (lane % 4 == 0) {
      sM[warp * HR + g] = m_r[0];
      sM[warp * HR + g + 8] = m_r[1];
      sL[warp * HR + g] = l_r[0];
      sL[warp * HR + g + 8] = l_r[1];
    }
    float* ow = sO + warp * HR * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(ow + g * D + j * 8 + c) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(ow + (g + 8) * D + j * 8 + c) = make_float2(o[j][2], o[j][3]);
    }
  }
  decode_merge<D, EMIT, T>(sO, out, m_out, l_out, part_acc, part_ml, tickets, rows, parts, split,
                        (long long)b * Hq + h0, ((long long)b * gridDim.y + hg) * splits,
                        (long long)b * gridDim.y + hg, tid, &s_last);
}

template <int D, bool EMIT, class T>
int launch_one(void* out, float* m_out, float* l_out, float* part_acc, float* part_ml,
               int* tickets, const void* q, const void* pool, const void* page_tables,
               const void* context_lens, int B, int Hkv, int G, long long N, int maxp, int S,
               float scale, int window, int splits, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_hm_kernel<D, EMIT, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int groups = (G + HR - 1) / HR;
  decode_hm_kernel<D, EMIT, T><<<dim3(splits, Hkv * groups, B), NT, C::BYTES, stream>>>(
      out, m_out, l_out, part_acc, part_ml, tickets, (const T*)q, (const T*)pool,
      (const int32_t*)page_tables, (const int32_t*)context_lens, Hkv, G, groups, N, maxp, S,
      scale, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch(void* out, float* m_out, float* l_out, float* part_acc, float* part_ml, int* tickets,
           const void* q, const void* pool, const void* page_tables, const void* context_lens,
           int B, int Hkv, int G, long long N, int maxp, int S, float scale, int window,
           int splits, int fp16, cudaStream_t stream) {
  auto fn = m_out != nullptr ? (fp16 ? launch_one<D, true, __half> : launch_one<D, true, bf16>)
                             : (fp16 ? launch_one<D, false, __half> : launch_one<D, false, bf16>);
  return fn(out, m_out, l_out, part_acc, part_ml, tickets, q, pool, page_tables, context_lens, B,
            Hkv, G, N, maxp, S, scale, window, splits, stream);
}

template <int D>
int blocks_per_sm(int* blocks) {
  using C = Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(decode_hm_kernel<D, false, bf16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, decode_hm_kernel<D, false, bf16>, NT,
                                                      C::BYTES);
  return (int)e;
}

}  // namespace

// How many blocks of the head-dim-D kernel one SM holds at once (into
// *blocks); the host sizes `splits` with it (the fp16 instantiation's shared
// memory is the same). Returns the CUDA error code.
extern "C" int zt_decode_attention_hm_blocks_per_sm(int D, int* blocks) {
  if (D == 64) return blocks_per_sm<64>(blocks);
  if (D == 128) return blocks_per_sm<128>(blocks);
  if (D == 192) return blocks_per_sm<192>(blocks);
  if (D == 256) return blocks_per_sm<256>(blocks);
  return (int)cudaErrorInvalidValue;
}

// Supported: bf16 q and pool (fp16 with fp16 != 0), D in {64, 128, 192,
// 256}, any G = Hq / Hkv >= 1, 1 <= splits <= 64. With splits > 1: part_acc fp32
// [B, Hkv * ceil(G / 16), splits, 16, D], part_ml fp32 [..., splits, 2, 16]
// and tickets int32 [B, Hkv * ceil(G / 16)], zero before the launch and left
// zero after it (with splits == 1 the three may be null). With m_out (and
// l_out) non-null the partial mode runs: out is fp32 [B, Hq, D] and receives
// the unnormalized accumulator, m_out and l_out fp32 [B, Hq] the running max
// and normalizer. Returns the CUDA error code of the launch.
extern "C" int zt_decode_attention_hm(void* out, float* m_out, float* l_out, float* part_acc,
                                      float* part_ml, int* tickets, const void* q,
                                      const void* pool, const void* page_tables,
                                      const void* context_lens, int B, int Hkv, int G, int D,
                                      long long N, int maxp, int S, float scale, int window,
                                      int splits, int fp16, void* stream) {
  if (B == 0) return 0;
  if ((m_out == nullptr) != (l_out == nullptr) || G < 1 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ZT_D(DD)                                                                            \
  if (D == DD)                                                                              \
    return launch<DD>(out, m_out, l_out, part_acc, part_ml, tickets, q, pool, page_tables,  \
                      context_lens, B, Hkv, G, N, maxp, S, scale, window, splits, fp16, st);
  ZT_D(64) ZT_D(128) ZT_D(192) ZT_D(256)
#undef ZT_D
  return (int)cudaErrorInvalidValue;
}
