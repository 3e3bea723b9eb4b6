// FP8 block-scaled matmul: y = x_bf16 . (W_e4m3 (.) block_scale[k/128, n/128]).
//
// Replaces: zhilight_tpu/ops/pallas/fp8_matmul.py fp8_block_matmul (:85), its
// kernel _fp8_kernel (:54) and the conversion _e4m3_to_bf16 (:31).
//
// Computes, for x bf16 [M, K], W float8_e4m3fn [K, N] and f32 scales
// [K/128, N/128] (K and N multiples of 128):
//   y[m, n] = sum_kb scale[kb, n / 128] *
//             (sum_{k in block kb} x[m, k] * bf16(W[k, n]))
// The activations stay bf16: they are not quantized (a product of two FP8
// operands on Hopper's FP8 tensor cores would be another function). Every
// e4m3 value is a bf16 value, so the conversion is exact. The inner sum runs
// in fp32 on the tensor cores; THE BLOCK'S SCALE MULTIPLIES THAT PARTIAL SUM,
// not the weights, and the scaled partials are added in fp32; y is rounded to
// bf16 once. The plain version (ops/cuda/fp8_matmul.py fp8_block_matmul_plain)
// computes the same thing. Dequantizing the weight first (w * scale rounded
// to bf16, as ops/quant.py fp8_linear does where no kernel applies) differs in
// the last bf16 bits, so this kernel does not reuse w4a16_tile.cuh's loop with
// the scale moved into the weights: it keeps two accumulator fragments per
// output tile, one for the current 128-row K block (zeroed at its start) and
// the running one, and folds `part * scale` into the running one after each
// block. An output tile is 64 or 128 columns wide and starts at a multiple of
// its width, so it never straddles a 128-column block and the scale is one
// scalar per block and K step, read straight from block_scale.
//
// The NaN encodings of e4m3fn (bytes 0x7f and 0xff) convert to NaN here (the
// TPU kernel maps them to +-480); weights never hold them, and the callers'
// tests generate none.
//
// Bound on the H100. Decode (M <= 32) is bound by bytes: the K*N weight bytes
// (4096 x 12288: 50.3 MB, 15 us at 3.35 TB/s). A 512-row prefill chunk is
// bound by operations: 2*M*K*N = 51.5 GFLOP for the same weight, 52 us at 989
// TFLOP/s in bf16. Design, simple first: a block computes one (BM x BN) output
// tile over a run of 128-row K blocks. The bf16 x tile and the raw FP8 weight
// tile of the next K blocks are in flight as 16-byte cp.async copies into a
// ring of shared-memory stages while the current one is used. Per K block the
// threads convert the staged FP8 bytes to a bf16 tile in shared memory (the
// hardware's e4m3x2 -> f16x2 conversion, then f32, then bf16, all exact), and
// WMMA 16x16x16 bf16 -> fp32 multiplies. Two shapes:
//   M <= 32: 16 x 64 tiles, 4 warps, 4 stages (68 KB: 3 blocks an SM), and
//     split-K: the K blocks are divided over gridDim.z so that about three
//     blocks per SM stream the weight (N/64 blocks alone are 16 for the
//     1024-wide k/v projections). Each split writes its fp32 partial tile to
//     a scratch buffer [splits, M, N] and a second kernel adds the splits in
//     order: no atomicAdd, the sum does not depend on scheduling, so greedy
//     decoding repeats.
//   M > 32: 64 x 128 tiles, 8 warps, 2 stages (100 KB: 2 blocks an SM, so one
//     block's conversion overlaps the other's products), no split.
// M is predicated in the kernel (rows past M are zero-filled in shared memory
// and never stored). No TMA, no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int KB = 128;      // scale block edge = the K tile
constexpr int SMALL_M = 32;  // up to here: the split-K decode shape

template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int FM = BM / WM / 16;  // 16x16 fragments per warp along M
  static constexpr int FN = BN / WN / 16;  // ... along N
  static constexpr int LDA = KB + 8;       // bf16
  static constexpr int LDB = BN + 8;       // bf16
  static constexpr int LDC = BN + 4;       // float
  static constexpr int A_STAGE = BM * LDA * 2;  // bytes: x tile [BM][LDA] bf16
  static constexpr int W_STAGE = KB * BN;       // bytes: raw e4m3 tile [KB][BN]
  static constexpr int B_OFF = STAGES * (A_STAGE + W_STAGE);
  static constexpr int B_BYTES = KB * LDB * 2;  // converted tile [KB][LDB] bf16
  static constexpr int C_BYTES = BM * LDC * 4;  // epilogue tile, overlays the stages
  static constexpr int SMEM = B_OFF + B_BYTES;
  static constexpr int ACH = KB / 8;   // 16-byte chunks per x tile row
  static constexpr int WCH = BN / 16;  // 16-byte chunks per weight tile row
  static_assert(BN <= KB && KB % BN == 0, "a tile must not straddle a scale block");
  static_assert(C_BYTES <= B_OFF, "epilogue tile overlays the stages");
  static_assert(A_STAGE % 128 == 0 && W_STAGE % 128 == 0, "stage alignment");
};

using Small = Cfg<16, 64, 1, 4, 4>;
using Large = Cfg<64, 128, 2, 4, 2>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// two e4m3 bytes -> two bf16 (low byte first), exact
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw hr =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xFFFFu), __NV_E4M3);
  const __half2 h(hr);
  const float2 f = __half22float2(h);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// eight e4m3 bytes (two words) -> eight bf16 in a uint4
__device__ __forceinline__ uint4 e4m3x8_to_bf16x8(uint32_t lo, uint32_t hi) {
  return make_uint4(e4m3x2_to_bf16x2(lo), e4m3x2_to_bf16x2(lo >> 16),
                    e4m3x2_to_bf16x2(hi), e4m3x2_to_bf16x2(hi >> 16));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// One block: rows [m_blk, m_blk + BM) x columns [n_blk, n_blk + BN) over the
// K blocks [kb0, kb1) of split blockIdx.z. With `partial` null the bf16 tile
// goes to `out`; otherwise the fp32 tile goes to partial[blockIdx.z].
template <class C>
__global__ void __launch_bounds__(C::NT) fp8_block_kernel(
    bf16* __restrict__ out,            // [M, N]
    float* __restrict__ partial,       // [splits, M, N] or null
    const bf16* __restrict__ x,        // [M, K]
    const uint8_t* __restrict__ w,     // [K, N] e4m3fn bytes
    const float* __restrict__ scale,   // [K/128, N/128]
    int M, int N, int K, int kb_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem + C::B_OFF);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n_blk = blockIdx.x * C::BN;
  const int m_blk = blockIdx.y * C::BM;
  const int kbs = K / KB;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(kb0 + kb_per_split, kbs);
  const float* srow = scale + n_blk / KB;  // + kb * (N / KB)
  const int scale_ld = N / KB;

  auto stage_a = [&](int s) { return smem + s * C::A_STAGE; };
  auto stage_w = [&](int s) { return smem + C::STAGES * C::A_STAGE + s * C::W_STAGE; };

  // start the copies of K block kb into stage s
  auto issue = [&](int s, int kb) {
    unsigned char* a = stage_a(s);
    for (int c = tid; c < C::BM * C::ACH; c += C::NT) {
      const int r = c / C::ACH, j = c % C::ACH;
      unsigned char* dst = a + (r * C::LDA + j * 8) * 2;
      if (m_blk + r < M)
        cp_async16(dst, x + (long long)(m_blk + r) * K + kb * KB + j * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    unsigned char* wt = stage_w(s);
    for (int c = tid; c < KB * C::WCH; c += C::NT) {
      const int r = c / C::WCH, j = c % C::WCH;
      cp_async16(wt + r * C::BN + j * 16, w + (long long)(kb * KB + r) * N + n_blk + j * 16);
    }
  };

  // the staged e4m3 tile of stage s -> the bf16 tile sB
  auto convert = [&](int s) {
    const unsigned char* wt = stage_w(s);
    for (int c = tid; c < KB * C::WCH; c += C::NT) {
      const int r = c / C::WCH, j = c % C::WCH;
      const uint4 raw = *reinterpret_cast<const uint4*>(wt + r * C::BN + j * 16);
      uint4* dst = reinterpret_cast<uint4*>(sB + r * C::LDB + j * 16);
      dst[0] = e4m3x8_to_bf16x8(raw.x, raw.y);
      dst[1] = e4m3x8_to_bf16x8(raw.z, raw.w);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN], part[C::FM][C::FN];
#pragma unroll
  for (int a = 0; a < C::FM; ++a)
#pragma unroll
    for (int b = 0; b < C::FN; ++b) wmma::fill_fragment(acc[a][b], 0.f);
  const int wm = (warp / C::WN) * C::FM * 16;
  const int wn = (warp % C::WN) * C::FN * 16;

  // prologue: STAGES - 1 K blocks in flight (an empty group where none is left)
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (kb0 + s < kb1) issue(s, kb0 + s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int kb = kb0; kb < kb1; ++kb) {
    const int it = kb - kb0;
    const int s = it % C::STAGES;
    // the stage of K block kb + STAGES - 1 was read in the previous iteration,
    // which ended with a barrier
    if (kb + C::STAGES - 1 < kb1) issue((it + C::STAGES - 1) % C::STAGES, kb + C::STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(C::STAGES - 1));
    __syncthreads();
    convert(s);
    __syncthreads();

#pragma unroll
    for (int a = 0; a < C::FM; ++a)
#pragma unroll
      for (int b = 0; b < C::FN; ++b) wmma::fill_fragment(part[a][b], 0.f);
    const bf16* sA = reinterpret_cast<const bf16*>(stage_a(s));
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int a = 0; a < C::FM; ++a)
        wmma::load_matrix_sync(fa[a], sA + (wm + a * 16) * C::LDA + kk, C::LDA);
#pragma unroll
      for (int b = 0; b < C::FN; ++b) {
        wmma::load_matrix_sync(fb, sB + kk * C::LDB + wn + b * 16, C::LDB);
#pragma unroll
        for (int a = 0; a < C::FM; ++a) wmma::mma_sync(part[a][b], fa[a], fb, part[a][b]);
      }
    }
    // the block's scale multiplies its fp32 partial sum
    const float sc = __ldg(srow + (long long)kb * scale_ld);
#pragma unroll
    for (int a = 0; a < C::FM; ++a)
#pragma unroll
      for (int b = 0; b < C::FN; ++b)
#pragma unroll
        for (int i = 0; i < acc[a][b].num_elements; ++i)
          acc[a][b].x[i] = fmaf(part[a][b].x[i], sc, acc[a][b].x[i]);
    __syncthreads();
  }
  // nothing is in flight any more: the groups left are empty

  // epilogue through shared memory (sC overlays the stages): masked stores
#pragma unroll
  for (int a = 0; a < C::FM; ++a)
#pragma unroll
    for (int b = 0; b < C::FN; ++b)
      wmma::store_matrix_sync(sC + (wm + a * 16) * C::LDC + wn + b * 16, acc[a][b], C::LDC,
                              wmma::mem_row_major);
  __syncthreads();
  constexpr int CPR = C::BN / 8;
  for (int c = tid; c < C::BM * CPR; c += C::NT) {
    const int m = c / CPR, j = (c % CPR) * 8;
    if (m_blk + m >= M) continue;
    const float* src = sC + m * C::LDC + j;
    if (partial == nullptr) {
      *reinterpret_cast<uint4*>(out + (long long)(m_blk + m) * N + n_blk + j) =
          make_uint4(pack_bf16x2(src[0], src[1]), pack_bf16x2(src[2], src[3]),
                     pack_bf16x2(src[4], src[5]), pack_bf16x2(src[6], src[7]));
    } else {
      float4* dst = reinterpret_cast<float4*>(
          partial + ((long long)blockIdx.z * M + m_blk + m) * N + n_blk + j);
      dst[0] = make_float4(src[0], src[1], src[2], src[3]);
      dst[1] = make_float4(src[4], src[5], src[6], src[7]);
    }
  }
}

// out = bf16(partial[0] + partial[1] + ...), the splits added in order
__global__ void fp8_reduce_kernel(bf16* __restrict__ out, const float* __restrict__ partial,
                                  int splits, long long MN) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MN) return;
  float4 s = *reinterpret_cast<const float4*>(partial + i);
  for (int z = 1; z < splits; ++z) {
    const float4 t = *reinterpret_cast<const float4*>(partial + z * MN + i);
    s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
  }
  *reinterpret_cast<uint2*>(out + i) = make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && v > 0)
      n = v;
    else
      n = 132;
  }
  return n;
}

// Split-K plan, from the shapes and the SM count alone: K blocks per split.
// About three blocks per SM (what the small shape's shared memory lets an SM
// hold) stream the weight.
int plan_kb_per_split(int M, int N, int K) {
  const int kbs = K / KB;
  if (M > SMALL_M) return kbs;
  const int tiles = (N / Small::BN) * ((M + Small::BM - 1) / Small::BM);
  int want = 3 * sm_count() / tiles;
  want = want < 1 ? 1 : (want > kbs ? kbs : want);
  return (kbs + want - 1) / want;
}

int plan_splits(int M, int N, int K) {
  const int kbs = K / KB, per = plan_kb_per_split(M, N, K);
  return (kbs + per - 1) / per;
}

template <class C>
int launch(void* out, void* partial, const void* x, const void* w, const void* scale, int M,
           int N, int K, int kb_per_split, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fp8_block_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(N / C::BN, (M + C::BM - 1) / C::BM, splits);
  fp8_block_kernel<C><<<grid, C::NT, C::SMEM, stream>>>(
      (bf16*)out, (float*)partial, (const bf16*)x, (const uint8_t*)w, (const float*)scale, M, N,
      K, kb_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of K splits zt_fp8_block_matmul uses for these shapes: with more
// than one, the caller passes an fp32 scratch buffer [splits, M, N].
extern "C" int zt_fp8_block_matmul_splits(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0 || K % KB || N % KB) return 1;
  return plan_splits(M, N, K);
}

// Supported (the wrapper checks): bf16 x [M, K] and out [M, N]; e4m3fn w
// [K, N]; f32 scale [K/128, N/128]; K % 128 == 0 and N % 128 == 0; every
// pointer 16-byte aligned; `splits` as zt_fp8_block_matmul_splits says, and
// `partial` [splits, M, N] f32 when it is more than 1 (null otherwise).
extern "C" int zt_fp8_block_matmul(void* out, void* partial, const void* x, const void* w,
                                   const void* scale, int M, int N, int K, int splits,
                                   void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % KB || N % KB) return (int)cudaErrorInvalidValue;
  const int per = plan_kb_per_split(M, N, K);
  if (splits != plan_splits(M, N, K) || (splits > 1) != (partial != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (M > SMALL_M)
    return launch<Large>(out, nullptr, x, w, scale, M, N, K, per, 1, st);
  int err = launch<Small>(out, partial, x, w, scale, M, N, K, per, splits, st);
  if (err != 0 || splits == 1) return err;
  const long long MN = (long long)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((MN / 4 + threads - 1) / threads);
  fp8_reduce_kernel<<<blocks, threads, 0, st>>>((bf16*)out, (const float*)partial, splits, MN);
  return (int)cudaGetLastError();
}
