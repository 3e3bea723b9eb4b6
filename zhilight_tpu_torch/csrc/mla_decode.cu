// MLA latent decode: absorbed-weight attention over the paged latent pool.
//
// Replaces: zhilight_tpu/ops/pallas/attn_headmajor.py
// paged_decode_attention_hm (:151), kernel _kernel_hm (:54), in its MLA latent
// mode (v_dim > 0), as zhilight_tpu/ops/pallas/paged_attention.py
// paged_mla_decode (:791) reaches it; and paged_mla_decode's emit_partial mode,
// which the reference serves from _kernel_bs (paged_attention.py:179, emit at
// :272-287): the same function, with the merge kernel writing fp32 M, sum L and
// the unnormalized accumulator instead of dividing.
//
// Computes, for each sequence b and head h, over the tokens t < ctx =
// context_lens[b], token t at pool row page_tables[b, t / S] * S + t % S:
//   s[t]      = scale * q[b, h, :KD] . latent[row(t), :KD]
//   out[b, h] = sum_t softmax(s)[t] * latent[row(t), :VD]
// with fp32 scores, an fp32 online softmax (NEG_INF = -2e38, the max(l, 1e-20)
// floor of the TPU kernel, so an empty slot yields zeros) and probabilities
// rounded to bf16 for the second product. All heads share the one latent row
// per token ("one KV head"): K is its first KD elements, V its first VD.
//
// Bound on the H100: bytes. A step reads B * ctx rows of KD bf16 once: 25.9 MB
// at B 8, ctx 2816, KD 576 (7.7 us at 3.35 TB/s); the 16 heads do
// 2 * 16 * (KD + VD) flops per row, 30 flops per byte, far under the card's
// 295. Design: flash decoding. Grid (splits, head tiles of 16, B): a block
// takes a run of 64-token tiles of one sequence, so a batch of 8 spreads over
// the card (one block per sequence would use 8 of 132 SMs). Per tile the block
// stages the 64 latent rows in shared memory once (cp.async, 16 bytes a
// thread) and uses them for both products; rows past ctx are zero-filled.
// Both products have M = 16 rows (the heads), one tensor-core tile: WMMA
// 16x16x16 bf16 -> fp32. Eight warps: for q.K^T warp w takes 16 tokens (w % 4)
// and half of KD (w / 4), the halves are summed in the softmax pass; for p.V
// warp w owns VD / 8 output columns, its accumulators stay in registers
// across tiles and are rescaled by the row's exp(m_old - m_new), the row of
// each accumulator element being read once from a probe fragment (the WMMA
// element layout is not specified). Each block writes its (m, l, acc) partial;
// a second kernel merges a head's partials and writes bf16. About 106 KB of
// shared memory per block, so two blocks share an SM and one's loads overlap
// the other's arithmetic. No TMA, no wgmma yet.
//
// Fused latent write + attend (zt_mla_decode_fused): replaces
// zhilight_tpu/ops/pallas/paged_attention.py paged_mla_decode_fused (:844),
// the latent mode of kernel _kernel_bs_fused (:445). context_lens count this
// step's token, whose latent row (latent_new [B, stored], in the pool's
// dtype) is not in the pool yet: the tiles cover pool rows t < ctx - 1 only,
// and the merge kernel folds the new row in as one more partial (m = s_new =
// scale * q[b, h, :KD] . latent_new[b, :KD], l = 1, acc = latent_new[b, :VD]),
// in fp32, so an empty context gives the new row's V. Block h = 0 of the
// merge then stores the row at slot_mapping[b] when that is >= 0 and ctx >=
// 1; the merge runs after the tiles in stream order, so no read races the
// write. As in the unfused mode the tiles round p to bf16 for their WMMA p.V
// product, where the TPU kernel keeps it fp32 (its fused mode casts the
// latent rows to fp32): the kernel is held to the unrounded plain version
// within 2e-2 of the output's size. Bytes: the unfused mode's plus the
// written row (7.8 us at DeepSeek-V2-Lite's batch 8, context 2816).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "paged_decode.cuh"  // zt_paged::block_dot (128 threads)

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -2.0e38f;
constexpr int HT = 16;       // heads per block (one WMMA tile of rows)
constexpr int TN = 64;       // tokens per tile
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int LDS = TN + 8;  // leading dimension of the score and probability tiles

template <int KD, int VD>
struct Smem {
  static constexpr int LDK = KD + 8;  // bf16 elements per staged row
  static constexpr int TILE = TN * LDK * 2;
  static constexpr int Q = HT * LDK * 2;
  static constexpr int S = 2 * HT * LDS * 4;
  static constexpr int P = HT * LDS * 2;
  static constexpr int PROBE = 16 * 16 * 4;
  static constexpr int STATS = 3 * HT * 4;
  static constexpr int BYTES = TILE + Q + S + P + PROBE + STATS;
  static_assert(KD % 32 == 0 && VD % (16 * NWARPS) == 0 && VD <= KD, "MLA dims");
  static_assert(TILE % 32 == 0 && Q % 32 == 0 && S % 32 == 0 && P % 32 == 0, "alignment");
};

// tiles of sequence b handled by split `split` of `splits`: [first, last)
__device__ __forceinline__ void split_range(int ctx, int splits, int split, int* first,
                                            int* last) {
  const int tiles = (ctx + TN - 1) / TN;
  const int per = (tiles + splits - 1) / splits;
  *first = min(split * per, tiles);
  *last = min(*first + per, tiles);
}

template <int KD, int VD>
__global__ void __launch_bounds__(NT) mla_decode_kernel(
    float* __restrict__ part_acc,             // [B, tiles_h, splits, HT, VD]
    float* __restrict__ part_ml,              // [B, tiles_h, splits, 2, HT]
    const bf16* __restrict__ q,               // [B, H, KD]
    const bf16* __restrict__ pool,            // [N, stored]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    const int32_t* __restrict__ context_lens, // [B]
    int H, long long N, int stored, int maxp, int S, float scale, int drop) {
  using L = Smem<KD, VD>;
  constexpr int LDK = L::LDK;
  constexpr int CPR = KD / 8;   // 16-byte chunks per row
  constexpr int FV = VD / (16 * NWARPS);  // accumulator fragments per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::TILE);
  float* sS = reinterpret_cast<float*>(smem + L::TILE + L::Q);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::TILE + L::Q + L::S);
  float* sProbe = reinterpret_cast<float*>(smem + L::TILE + L::Q + L::S + L::P);
  float* sM = sProbe + 16 * 16;
  float* sL = sM + HT;
  float* sAlpha = sL + HT;

  const int split = blockIdx.x, splits = gridDim.x;
  const int ht = blockIdx.y, tiles_h = gridDim.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // drop = 1 (fused): row ctx - 1 is this step's, folded in by the merge
  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S) - drop);
  int first, last;
  split_range(ctx, splits, split, &first, &last);
  if (first >= last) return;  // the merge kernel skips this split as well

  const long long num_pages = N / S;
  const int32_t* pt = page_tables + (long long)b * maxp;
  const int h0 = ht * HT;

  // q rows of this head tile (zero rows past H), the probe, the running stats
  for (int c = tid; c < HT * CPR; c += NT) {
    const int r = c / CPR, j = c % CPR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (h0 + r < H)
      v = *reinterpret_cast<const uint4*>(q + ((long long)b * H + h0 + r) * KD + j * 8);
    *reinterpret_cast<uint4*>(sQ + r * LDK + j * 8) = v;
  }
  if (tid < 256) sProbe[tid] = (float)(tid / 16);
  if (tid < HT) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FV];
  int row_of[8];  // accumulator elements per thread of a 16x16 fp32 fragment
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> probe;
    wmma::load_matrix_sync(probe, sProbe, 16, wmma::mem_row_major);
    static_assert(decltype(probe)::num_elements == 8, "fragment size");
#pragma unroll
    for (int i = 0; i < 8; ++i) row_of[i] = (int)probe.x[i];
  }
#pragma unroll
  for (int f = 0; f < FV; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * TN;
    // stage the tile's latent rows: [TN, KD] bf16, zero rows past ctx
    for (int c = tid; c < TN * CPR; c += NT) {
      const int r = c / CPR, j = c % CPR;
      const int t = t0 + r;
      bf16* dst = sK + r * LDK + j * 8;
      if (t < ctx) {
        long long page = pt[t / S];
        page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
        const bf16* src = pool + (page * S + t % S) * stored + j * 8;
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // scores: warp w -> tokens [16 * (w % 4), +16), k in half (w / 4) of KD
    {
      const int nt = warp % 4, kh = warp / 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll 6
      for (int k = kh * (KD / 2); k < (kh + 1) * (KD / 2); k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + k, LDK);
        wmma::load_matrix_sync(fb, sK + nt * 16 * LDK + k, LDK);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(sS + kh * HT * LDS + nt * 16, s, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: 16 threads per head row, 4 tokens each
    {
      const int r = tid / 16, sub = tid % 16;
      float sv[4];
      float tmax = NEG_INF;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = sub * 4 + i;
        float x = (sS[r * LDS + c] + sS[HT * LDS + r * LDS + c]) * scale;
        if (t0 + c >= ctx) x = NEG_INF;
        sv[i] = x;
        tmax = fmaxf(tmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(sv[i] - m_new);
        psum += p;
        sP[r * LDS + sub * 4 + i] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();  // every lane has read sM[r] before lane 0 of the row writes it
      if (sub == 0) {
        const float alpha = __expf(m_old - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V: warp w owns columns [w * FV * 16, +FV * 16)
    {
      float al[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) al[i] = sAlpha[row_of[i]];
#pragma unroll
      for (int f = 0; f < FV; ++f)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[f].x[i] *= al[i];
#pragma unroll
      for (int kk = 0; kk < TN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::load_matrix_sync(fp, sP + kk, LDS);
#pragma unroll
        for (int f = 0; f < FV; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, sK + kk * LDK + (warp * FV + f) * 16, LDK);
          wmma::mma_sync(acc[f], fp, fv, acc[f]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sK and sP
  }

  const long long slot = ((long long)b * tiles_h + ht) * splits + split;
  float* pa = part_acc + slot * HT * VD;
#pragma unroll
  for (int f = 0; f < FV; ++f)
    wmma::store_matrix_sync(pa + (warp * FV + f) * 16, acc[f], VD, wmma::mem_row_major);
  if (tid < HT) {
    part_ml[slot * 2 * HT + tid] = sM[tid];
    part_ml[slot * 2 * HT + HT + tid] = sL[tid];
  }
}

// The fused mode's extra inputs (latent_new null otherwise).
struct LatentRows {
  const bf16* q;           // [B, H, KD]
  const bf16* latent_new;  // [B, stored] this step's rows, in the pool's dtype
  const int32_t* slots;    // [B] pool row of each; < 0 => not written
  bf16* pool;              // [N, stored], written at slots[b] only
};

// out[b, h, :] = sum_s acc_s * exp(m_s - M) / max(sum_s l_s * exp(m_s - M), 1e-20)
// with M = max_s m_s; with EMIT, out (fp32) gets the sum unnormalized and
// m_out, l_out [B, H] get M and the sum of l_s * exp(m_s - M): the flash
// partials of the whole context (M = -2e38, L = 0, acc = 0 when it is empty).
// FUSED adds the new latent row as one more partial and stores it (header).
template <int KD, int VD, bool EMIT, bool FUSED>
__global__ void __launch_bounds__(128) mla_merge_kernel(
    void* __restrict__ out,                   // [B, H, VD]: bf16, or fp32 with EMIT
    float* __restrict__ m_out, float* __restrict__ l_out,
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ context_lens, LatentRows fz, int H, int tiles_h, int splits,
    int maxp, int S, long long N, int stored, float scale) {
  static_assert(!(EMIT && FUSED), "the fused mode returns the output");
  const int b = blockIdx.y, h = blockIdx.x;
  const int ht = h / HT, r = h % HT;
  int ctx = context_lens[b];
  ctx = max(0, min(ctx, maxp * S));
  const int tiles = ((FUSED ? max(ctx - 1, 0) : ctx) + TN - 1) / TN;
  const int per = max((tiles + splits - 1) / splits, 1);
  const int used = (tiles + per - 1) / per;  // splits with a non-empty range
  const long long base = ((long long)b * tiles_h + ht) * splits;
  const long long row = (long long)b * H + h;
  const bf16* new_row = FUSED ? fz.latent_new + (long long)b * stored : nullptr;
  float M = NEG_INF, s_new = NEG_INF;
  if constexpr (FUSED) {
    s_new = zt_paged::block_dot(fz.q + row * KD, new_row, KD, scale);
    M = s_new;
    const long long slot = fz.slots[b];
    if (h == 0 && slot >= 0 && slot < N && ctx >= 1)
      for (int d = threadIdx.x; d < stored; d += blockDim.x)
        fz.pool[slot * stored + d] = new_row[d];
  }
  for (int s = 0; s < used; ++s) M = fmaxf(M, part_ml[(base + s) * 2 * HT + r]);
  float Lsum = FUSED ? __expf(s_new - M) : 0.f;
  for (int s = 0; s < used; ++s)
    Lsum += part_ml[(base + s) * 2 * HT + HT + r] * __expf(part_ml[(base + s) * 2 * HT + r] - M);
  if (EMIT && threadIdx.x == 0) {
    m_out[row] = M;
    l_out[row] = Lsum;
  }
  const float inv = 1.f / fmaxf(Lsum, 1e-20f);
  for (int d = threadIdx.x; d < VD; d += blockDim.x) {
    float a = FUSED ? __bfloat162float(new_row[d]) * __expf(s_new - M) : 0.f;
    for (int s = 0; s < used; ++s)
      a += part_acc[((base + s) * HT + r) * VD + d] * __expf(part_ml[(base + s) * 2 * HT + r] - M);
    if constexpr (EMIT)
      static_cast<float*>(out)[row * VD + d] = a;
    else
      static_cast<bf16*>(out)[row * VD + d] = __float2bfloat16(a * inv);
  }
}

template <int KD, int VD>
int launch(void* out, float* m_out, float* l_out, void* part_acc, void* part_ml,
           const void* q, const void* pool,
           const void* page_tables, const void* context_lens, const LatentRows& fz, int B,
           int H, long long N, int stored, int maxp, int S, float scale, int splits,
           cudaStream_t stream) {
  using L = Smem<KD, VD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(mla_decode_kernel<KD, VD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles_h = (H + HT - 1) / HT;
  mla_decode_kernel<KD, VD><<<dim3(splits, tiles_h, B), NT, L::BYTES, stream>>>(
      (float*)part_acc, (float*)part_ml, (const bf16*)q, (const bf16*)pool,
      (const int32_t*)page_tables, (const int32_t*)context_lens, H, N, stored, maxp, S, scale,
      fz.latent_new != nullptr ? 1 : 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto merge = fz.latent_new != nullptr ? mla_merge_kernel<KD, VD, false, true>
               : m_out != nullptr       ? mla_merge_kernel<KD, VD, true, false>
                                        : mla_merge_kernel<KD, VD, false, false>;
  merge<<<dim3(H, B), 128, 0, stream>>>(
      out, m_out, l_out, (const float*)part_acc, (const float*)part_ml,
      (const int32_t*)context_lens, fz, H, tiles_h, splits, maxp, S, N, stored, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported (the wrapper checks): bf16 q [B, H, KD] and pool [N, stored] with
// (KD, VD) = (576, 512), stored >= KD and a multiple of 8; scratch part_acc
// fp32 [B, ceil(H / 16), splits, 16, VD] and part_ml fp32
// [B, ceil(H / 16), splits, 2, 16], 32-byte aligned; out bf16 [B, H, VD], or
// with m_out and l_out (fp32 [B, H]) non-null the partial mode: out fp32
// [B, H, VD] receives the unnormalized accumulator.
extern "C" int zt_mla_decode(void* out, float* m_out, float* l_out, void* part_acc,
                             void* part_ml, const void* q,
                             const void* pool, const void* page_tables,
                             const void* context_lens, int B, int H, int KD, int VD,
                             long long N, int stored, int maxp, int S, float scale,
                             int splits, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (splits < 1 || stored < KD || stored % 8) return (int)cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (KD == 576 && VD == 512)
    return launch<576, 512>(out, m_out, l_out, part_acc, part_ml, q, pool, page_tables,
                            context_lens, LatentRows{}, B, H, N, stored, maxp, S, scale, splits,
                            st);
  return (int)cudaErrorInvalidValue;
}

// The fused mode (header): as zt_mla_decode without the partial outputs, plus
// bf16 latent_new [B, stored] and int32 slot_mapping [B]; pool is written at
// slot_mapping[b] (>= 0) with row b of latent_new. Returns the CUDA error code.
extern "C" int zt_mla_decode_fused(void* out, void* part_acc, void* part_ml, const void* q,
                                   void* pool, const void* latent_new, const void* slot_mapping,
                                   const void* page_tables, const void* context_lens, int B,
                                   int H, int KD, int VD, long long N, int stored, int maxp,
                                   int S, float scale, int splits, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (splits < 1 || stored < KD || stored % 8) return (int)cudaErrorInvalidValue;
  const LatentRows fz{(const bf16*)q, (const bf16*)latent_new, (const int32_t*)slot_mapping,
                      (bf16*)pool};
  cudaStream_t st = (cudaStream_t)stream;
  if (KD == 576 && VD == 512)
    return launch<576, 512>(out, nullptr, nullptr, part_acc, part_ml, q, pool, page_tables,
                            context_lens, fz, B, H, N, stored, maxp, S, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}
