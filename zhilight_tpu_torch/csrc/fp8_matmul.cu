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
// finite e4m3 value is a bf16 value and the conversion is exact, subnormals
// included (the hardware's e4m3x2 -> f16x2, then f32, then bf16). The inner
// sum runs in fp32 on the tensor cores; THE BLOCK'S SCALE MULTIPLIES THAT
// PARTIAL SUM, not the weights (folding it into them would round w * scale),
// and the scaled partials are added in fp32; y is rounded to bf16 once. The
// plain version (ops/cuda/fp8_matmul.py fp8_block_matmul_plain) computes the
// same thing. Both kernels keep two accumulators an output element: the
// current 128-row K block's (fresh at its start) and the running one, which
// takes `part * scale` when the block ends. An output tile never straddles a
// 128-column scale block, so the scale is one scalar per (tile, K block).
//
// The NaN encodings of e4m3fn (bytes 0x7f and 0xff) convert to NaN here (the
// TPU kernel maps them to +-480); weights never hold them.
//
// Bound on the H100. Decode (M <= 16) is bound by bytes: the K*N weight bytes
// (Qwen3-8B's gate/up, 4096 x 12288: 50.3 MB, 15 us at 3.35 TB/s). A 512-row
// prefill chunk is bound by operations: 2*M*K*N = 51.5 GFLOP for the same
// weight, 52 us at 989 TFLOP/s in bf16.
//
// Design:
// - Prefill (M > 16): wgmma fed by TMA. A block of two consumer warpgroups
//   owns a 128 x 128 output tile (each warpgroup 64 rows) and walks its K
//   range in 128-deep blocks through a ring of three stages. Thread 0 fills a
//   stage with three TMA copies on one mbarrier: the bf16 x tile as two 64-deep
//   panels whose 128-byte swizzle is the K-major layout wgmma reads (rows past
//   M arrive as zeros), and the raw e4m3 W tile as bytes. The threads convert
//   each stage's W bytes once a block into one of two bf16 B tiles, N-major
//   (no transpose: 8 bytes of a W row become the 16-byte chunk of the same row)
//   with the same swizzle, one K block ahead of the products: while the tensor
//   cores run K block kb (eight wgmma m64n128k16 into a fresh accumulator, 64
//   registers a thread, scale-d off for the first), the threads convert K block
//   kb + 1; then they wait, add `part * scale` into the running accumulator (64
//   more registers) and meet at one barrier a K block. Two accumulators a
//   thread cap a warpgroup's tile at 64 x 128, so both warpgroups read the
//   whole B tile: with the copies and the conversion, shared memory is the
//   busiest unit. Split-K over gridDim.z when the tiles alone would not fill
//   the SMs (k/v at M 512: 32 tiles, 4 splits).
//   What was tried on the H100 and dropped: all-thread cp.async copies in
//   place of TMA (the copy instructions in every warp cost about as much as
//   the products), a deeper ring of 64-deep stages, a cluster of two blocks
//   sharing the x tile by TMA multicast (its barrier a K block held the pair
//   in step) and two partial accumulators in turn (more registers, a second
//   barrier a K block): each was slower.
// - Decode (M <= 16): row 4's decode design (quant_matmul.cu). The block's x
//   slice (up to 8 K blocks of 8 or 16 rows) is staged once; 8 warps of 32
//   columns each stream their own ring of three 64-row cp.async stages of
//   weight bytes and wait only on their own copies (__syncwarp): the loop has
//   no block barrier. A lane reads the four rows (2i, 2i + 1, 2i + 8, 2i + 9)
//   of its 4 adjacent columns, one word each, pairs their bytes by column
//   (two byte permutes) and converts each pair into the bf16x2 of an mma.sync
//   m16n8k16 B fragment: column t of the lane's run is B column g of n8-tile
//   t. At most 128 registers, so two blocks share an SM; about one block an
//   SM, split-K over the rest (ops/cuda/fp8_matmul.py plan).
// - Split-K (both): each split writes its fp32 partial tile; the block that
//   draws the last ticket of its tile adds them in split order (splitk.cuh):
//   the same bits on every call, so greedy decoding repeats, and one launch a
//   call.
// M is predicated in both kernels (rows past M are zero-filled and never
// stored).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "splitk.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace zt_mma;

constexpr int KB = 128;     // scale block edge = the K step of both kernels
constexpr int DEC_KB = 8;   // most K blocks a decode split takes (its x slice is staged whole)
constexpr int DEC_M = 16;   // up to here: the decode kernel

// two e4m3 bytes (the low 16 bits, low byte first) -> two bf16, exact
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw hr =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xFFFFu), __NV_E4M3);
  const __half2 h(hr);
  const float2 f = __half22float2(h);
  return pack_bf16(f.x, f.y);
}

// eight e4m3 bytes (two words) -> eight bf16 in a uint4
__device__ __forceinline__ uint4 e4m3x8_to_bf16x8(uint32_t lo, uint32_t hi) {
  return make_uint4(e4m3x2_to_bf16x2(lo), e4m3x2_to_bf16x2(lo >> 16),
                    e4m3x2_to_bf16x2(hi), e4m3x2_to_bf16x2(hi >> 16));
}

// ---------------------------------------------------------------------------
// decode: M <= 16
// ---------------------------------------------------------------------------

template <int MR>
struct Dec {
  static constexpr int NWARP = 8, NT = NWARP * 32, BN = 256, STG = 3;
  static constexpr int SRD = 64;                  // weight rows a stage
  static constexpr int LDX = DEC_KB * KB + 8;     // bf16 per staged x row
  static constexpr int X_BYTES = MR * LDX * 2;
  static constexpr int LDW = 48;  // bytes per staged row of a warp's 32 columns (conflict-free)
  static constexpr int W_BYTES = SRD * LDW;
  static constexpr int SMEM = X_BYTES + NWARP * STG * W_BYTES;
};

template <int MR>
__global__ void __launch_bounds__(256, 2) fp8_decode_kernel(
    bf16* __restrict__ out, const bf16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ part, int* __restrict__ tickets,
    int M, int N, int K, int per) {
  using C = Dec<MR>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i = lane % 4;
  const int n_blk = blockIdx.x * C::BN, n_w = n_blk + warp * 32;
  const int kb0 = blockIdx.z * per;
  const int nkb = min(K / KB, kb0 + per) - kb0;  // >= 1 (the host's plan)
  const int nkt = nkb * (KB / C::SRD);
  const int r_beg = kb0 * KB;
  bf16* sx = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + C::X_BYTES + warp * C::STG * C::W_BYTES;

  // the block's x slice: column c is x[m, r_beg + c]; rows past M zero
  {
    const int cpr = nkb * KB / 8;
    for (int c = tid; c < MR * cpr; c += C::NT) {
      const int m = c / cpr, j = (c % cpr) * 8;
      const bool ok = m < M;
      cp16(sx + m * C::LDX + j, ok ? x + (long long)m * K + r_beg + j : x, ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // the warp's ring: stage s in slot s % STG. A lane copies rows lane / 2 +
  // 16k (k < 4) of a stage, 16 bytes at column 16 (lane % 2) of the warp's 32
  // (N % 32 == 0: a warp's columns are all in or all out)
  const int wbytes = n_w < N ? 16 : 0;
  const uint8_t* wp = w + (wbytes ? (long long)(r_beg + lane / 2) * N + n_w + 16 * (lane % 2) : 0);
  auto issue = [&](int slot) {
    unsigned char* st = ring + slot * C::W_BYTES + (lane / 2) * C::LDW + 16 * (lane % 2);
#pragma unroll
    for (int k = 0; k < C::SRD / 16; ++k)
      cp16(st + 16 * k * C::LDW, wbytes ? wp + 16LL * k * N : w, wbytes);
    if (wbytes) wp += (long long)C::SRD * N;
  };
#pragma unroll
  for (int s = 0; s < C::STG - 1; ++s) {
    if (s < nkt) issue(s);
    cp_async_commit();
  }
  cp_async_wait<C::STG - 1>();
  __syncthreads();  // the x slice

  float acc[1][4][4], prt[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][t][e] = prt[t][e] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<C::STG - 2>();
    __syncwarp();  // stage it is in; every lane is done with slot (it - 1) % STG
    if (it + C::STG - 1 < nkt) issue((it + C::STG - 1) % C::STG);
    cp_async_commit();
    const unsigned char* st = ring + (it % C::STG) * C::W_BYTES;
#pragma unroll
    for (int j = 0; j < C::SRD; j += 16) {
      uint32_t wv[4];  // rows j + 2i, 2i + 1, 2i + 8, 2i + 9; columns 4g .. 4g + 3
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const uint32_t*>(
            st + (j + 2 * i + (q & 1) + (q >> 1) * 8) * C::LDW + 4 * g);
      // byte pairs (row 2i, 2i + 1) and (2i + 8, 2i + 9) of columns 0, 1 and 2, 3
      const uint32_t lo01 = __byte_perm(wv[0], wv[1], 0x5140), lo23 = __byte_perm(wv[0], wv[1], 0x7362);
      const uint32_t hi01 = __byte_perm(wv[2], wv[3], 0x5140), hi23 = __byte_perm(wv[2], wv[3], 0x7362);
      const uint32_t b[4][2] = {{e4m3x2_to_bf16x2(lo01), e4m3x2_to_bf16x2(hi01)},
                                {e4m3x2_to_bf16x2(lo01 >> 16), e4m3x2_to_bf16x2(hi01 >> 16)},
                                {e4m3x2_to_bf16x2(lo23), e4m3x2_to_bf16x2(hi23)},
                                {e4m3x2_to_bf16x2(lo23 >> 16), e4m3x2_to_bf16x2(hi23 >> 16)}};
      uint32_t af[4];
      const bf16* xa = sx + it * C::SRD + j;
      if constexpr (MR == 16) {
        ldsm_x4(af, xa + a_offset(lane, C::LDX, 0));
      } else {
        uint32_t r2[2];
        ldsm_x2(r2, xa + (lane % 8) * C::LDX + ((lane / 8) % 2) * 8);
        af[0] = r2[0];
        af[1] = 0u;
        af[2] = r2[1];
        af[3] = 0u;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) mma_bf16(prt[t], af, b[t][0], b[t][1]);
    }
    if (it % 2 == 1) {  // the end of a K block: its scale multiplies its partial sum
      const float sc = wbytes ? __ldg(scale + (long long)(kb0 + it / 2) * (N / KB) + n_w / KB) : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][t][e] = fmaf(prt[t][e], sc, acc[0][t][e]);
          prt[t][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  finish<1, 4, true, C::NT, 16, C::BN>(acc, out, part, tickets, M, N, g, n_w, 0, n_blk, i, tid,
                                      &s_last);
}

// ---------------------------------------------------------------------------
// prefill: M > 16, wgmma
// ---------------------------------------------------------------------------

struct Pre {
  static constexpr int BM = 128, BN = 128, NT = 256, STAGES = 3;
  static constexpr int PANEL = BM * 128;        // bytes: 64 k of BM rows, 128 bytes a row
  static constexpr int A_BYTES = 2 * PANEL;     // x tile, K-major, two panels
  static constexpr int W_BYTES = KB * BN;       // raw e4m3 tile [KB][BN]
  static constexpr int HALF = KB * 128;         // bytes: 64 n of KB rows, 128 bytes a row
  static constexpr int B_BYTES = 2 * HALF;      // bf16 tile, N-major, two column halves
  // + 1 KB to align the base to the 128-byte swizzle's 1024-byte pattern
  static constexpr int SMEM = STAGES * (A_BYTES + W_BYTES) + 2 * B_BYTES + 1024;
};

// A shared-memory matrix descriptor with the 128-byte swizzle (PTX ISA,
// "Matrix Descriptor Format"): start address, leading and stride byte
// offsets, all in units of 16 bytes. K-major (x): rows of 128 bytes, 8-row
// groups (1024 bytes) apart by the stride offset; the leading offset is not
// used. N-major (B): 64 columns a 128-byte row, rows k; 8-row groups apart by
// the stride offset, 64-column halves by the leading offset.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int k = 0; k < 64; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// d (+)= A . B, 64 x 128 x 16, A K-major and B N-major in shared memory,
// bf16 -> fp32; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// one arrival, and the bytes the phase waits for
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

// a box of a 2-D tensor map into shared memory, completing its bytes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar)) : "memory");
}

__global__ void __launch_bounds__(Pre::NT, 1) fp8_prefill_kernel(
    bf16* __restrict__ out, const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ scale,
    float* __restrict__ part, int* __restrict__ tickets, int M, int N, int K, int per) {
  using C = Pre;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_last;
  __shared__ __align__(8) uint64_t full[C::STAGES];  // a stage's bytes have landed
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;                              // STAGES x x tile
  unsigned char* sW = sA + C::STAGES * C::A_BYTES;       // STAGES x raw W tile
  unsigned char* sB = sW + C::STAGES * C::W_BYTES;       // 2 x bf16 B tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int n_blk = blockIdx.x * C::BN, m_blk = blockIdx.y * C::BM;
  const int kb0 = blockIdx.z * per;
  const int nkb = min(K / KB, kb0 + per) - kb0;  // >= 1 (the host's plan)
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before a copy completes on them

  // K block kb into stage slot, by thread 0: x as two 128 x 64 boxes (the
  // tensor map's 128-byte swizzle is the layout wgmma reads; rows past M come
  // as zeros), W as one 128 x 128 box of bytes
  auto load = [&](int kb, int slot) {
    mbar_expect_tx(&full[slot], C::A_BYTES + C::W_BYTES);
    unsigned char* a = sA + slot * C::A_BYTES;
    tma_load(a, &tmx, kb * KB, m_blk, &full[slot]);
    tma_load(a + C::PANEL, &tmx, kb * KB + 64, m_blk, &full[slot]);
    tma_load(sW + slot * C::W_BYTES, &tmw, n_blk, kb * KB, &full[slot]);
  };
  // the raw W tile of stage slot -> B tile buf: row r's 8 bytes at column 8c
  // become the 16-byte chunk (c % 8) ^ (r % 8) of row r of column half c / 8
  auto convert = [&](int slot, int buf) {
    const unsigned char* wt = sW + slot * C::W_BYTES;
    unsigned char* bt = sB + buf * C::B_BYTES;
#pragma unroll
    for (int j = 0; j < KB * C::BN / 8 / C::NT; ++j) {
      const int id = tid + C::NT * j, r = id >> 4, c = id & 15;
      const uint2 raw = *reinterpret_cast<const uint2*>(wt + r * C::BN + c * 8);
      *reinterpret_cast<uint4*>(bt + (c >> 3) * C::HALF + r * 128 + (((c & 7) ^ (r & 7)) << 4)) =
          e4m3x8_to_bf16x8(raw.x, raw.y);
    }
    fence_async_smem();  // the generic-proxy stores, visible to wgmma after the barrier
  };

  float acc[64], prt[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = prt[k] = 0.f;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s)
      if (s < nkb) load(kb0 + s, s);
  }
  mbar_wait(&full[0], 0);
  convert(0, 0);
  __syncthreads();

  const int a_rows = wg * 64 * 128;  // the warpgroup's 64 rows of a panel
  for (int it = 0; it < nkb; ++it) {
    // into the slot of K block it - 1, which every warp is done with
    if (tid == 0 && it + C::STAGES - 1 < nkb)
      load(kb0 + it + C::STAGES - 1, (it + C::STAGES - 1) % C::STAGES);
    {
      const unsigned char* a = sA + (it % C::STAGES) * C::A_BYTES + a_rows;
      const unsigned char* bt = sB + (it % 2) * C::B_BYTES;
      hold(prt);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < KB / 16; ++s)
        wgmma_m64n128k16(prt, sw128_desc(a + (s >> 2) * C::PANEL + (s & 3) * 32, 16, 1024),
                         sw128_desc(bt + s * 16 * 128, C::HALF, 1024), s);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      hold(prt);
    }
    if (it + 1 < nkb) {  // K block it + 1, converted while the tensor cores run block it
      mbar_wait(&full[(it + 1) % C::STAGES], ((it + 1) / C::STAGES) & 1);
      convert((it + 1) % C::STAGES, (it + 1) % 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(prt);
    const float sc = __ldg(scale + (long long)(kb0 + it) * (N / KB) + n_blk / KB);
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = fmaf(prt[k], sc, acc[k]);
    __syncthreads();  // B tile it + 1 is whole; every warpgroup is done with K block it
  }
  // the accumulator of m64nNk16: warp w of the warpgroup holds rows 16w + g
  // and 16w + g + 8, slot 4t + e of columns 8t + 2i + e % 2 (mma.sync's C)
  finish<1, 16, false, C::NT, C::BM, C::BN>(*reinterpret_cast<float(*)[1][16][4]>(acc), out,
                                            part, tickets, M, N,
                                            m_blk + wg * 64 + (warp % 4) * 16 + lane / 4, n_blk,
                                            m_blk, n_blk, lane % 4, tid, &s_last);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D row-major tensor [rows, cols] of `type`, boxes of box_rows x box_cols
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------

// dynamic shared memory above 48 KB, once per kernel, and the largest
// shared-memory carveout (two decode blocks an SM)
int configure(const void* fn, int smem) {
  static const void* done[4];
  static int n = 0;
  for (int k = 0; k < n; ++k)
    if (done[k] == fn) return 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && n < 4) done[n++] = fn;
  return (int)err;
}

}  // namespace

// Supported (the wrapper checks): bf16 x [M, K] and out [M, N]; e4m3fn w
// [K, N]; f32 scale [K/128, N/128]; K % 128 == 0 and N % 128 == 0; every
// pointer 16-byte aligned. cfg picks the kernel (0: decode, M <= 16, at most
// 8 K blocks a split; 1: the wgmma kernel, 128 x 128 tiles); splits must cut
// the K blocks into that many non-empty runs of ceil(K/128 / splits); with
// splits > 1, part holds f32 [splits, M, N] and tickets int32 [ceil(M / BM) *
// (N / BN)] (BM x BN 16 x 256 or 128 x 128), zero before the launch and left
// zero.
extern "C" int zt_fp8_block_matmul(void* out, const void* x, const void* w, const void* scale,
                                   float* part, int* tickets, int M, int N, int K, int cfg,
                                   int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % KB || N % KB || cfg < 0 || cfg > 1 || (cfg == 0 && M > DEC_M))
    return (int)cudaErrorInvalidValue;
  const int kbs = K / KB;
  const int per = splits >= 1 ? (kbs + splits - 1) / splits : 0;
  if (splits < 1 || splits > kbs || (kbs + per - 1) / per != splits ||
      (cfg == 0 && per > DEC_KB) || (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* fn = cfg == 1 ? (const void*)fp8_prefill_kernel
                   : M <= 8 ? (const void*)fp8_decode_kernel<8>
                            : (const void*)fp8_decode_kernel<16>;
  const int smem = cfg == 1 ? Pre::SMEM : M <= 8 ? Dec<8>::SMEM : Dec<16>::SMEM;
  if (int err = configure(fn, smem)) return err;
  bf16* o = (bf16*)out;
  const float* sc = (const float*)scale;
  if (cfg == 1) {
    CUtensorMap tmx, tmw;
    if (!tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, Pre::BM, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, KB, Pre::BN,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(N / Pre::BN, (M + Pre::BM - 1) / Pre::BM, splits);
    fp8_prefill_kernel<<<grid, Pre::NT, smem, (cudaStream_t)stream>>>(o, tmx, tmw, sc, part,
                                                                       tickets, M, N, K, per);
    return (int)cudaGetLastError();
  }
  const dim3 grid(N / Dec<8>::BN + (N % Dec<8>::BN != 0), (M + 15) / 16, splits);
  const bf16* xx = (const bf16*)x;
  const uint8_t* ww = (const uint8_t*)w;
  void* args[] = {&o, &xx, &ww, &sc, &part, &tickets, &M, &N, &K, (void*)&per};
  return (int)cudaLaunchKernel(fn, grid, dim3(256), args, smem, (cudaStream_t)stream);
}
