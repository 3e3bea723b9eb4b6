// The W4A16 kernels shared by csrc/quant_matmul.cu (one weight matrix, row 4)
// and csrc/quant_ragged.cu (a stack of expert weights, one expert an m-tile,
// row 8): the exact dequantization, the decode kernel's register-built B
// fragments and the prefill kernel's dequantized B tiles, their cp.async
// stage copies, the split-K end (splitk.cuh). The design is described in
// quant_matmul.cu; RAGGED = true is the grouped product of quant_ragged.cu.
//
// Internal linkage throughout: each library that includes this header (and an
// earlier tree's build, loaded beside it for a comparison) keeps its own
// kernels and its own attribute flags.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"
#include "splitk.cuh"

namespace zt_w4a16 {
namespace {

using bf16 = __nv_bfloat16;
using namespace zt_mma;

constexpr int SR = 32;         // weight source rows per stage
constexpr int DEC_ROWS = 640;  // most weight rows a decode block takes

enum Mode { FAST, EXACT, SLOW };

__device__ __forceinline__ void cp8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// one 16-byte chunk of weight bytes (two 8-byte copies unless vec16)
__device__ __forceinline__ void copy_w(void* dst, const uint8_t* w, long long off, int bytes,
                                       bool vec16) {
  if (vec16) {
    cp16(dst, bytes ? w + off : w, bytes);
  } else {
    cp8(dst, bytes ? w + off : w, bytes ? 8 : 0);
    cp8(static_cast<char*>(dst) + 8, bytes > 8 ? w + off + 8 : w, bytes > 8 ? 8 : 0);
  }
}

// (a & B) ^ c in one LOP3, B an immediate
template <uint32_t B>
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "n"(B), "r"(c));
  return d;
}

// bit position of column t's nibble of `plane` in its (possibly >> 16) word
__device__ __forceinline__ constexpr int nib_pos(int t, int plane) {
  return 8 * ((t % 4) & 1) + 4 * plane;
}

// A lane's scale terms for NPL columns of both planes: FAST za = 2^23 + z *
// 2^p, sb = s * 2^-p; otherwise za = z, sb = s. Returns whether the warp
// takes FAST for this group.
template <int NPL, int NP>
__device__ __forceinline__ bool set_terms(const float (&s)[NP][NPL], const float (&z)[NP][NPL],
                                          float (&za)[NP][NPL], float (&sb)[NP][NPL]) {
  bool ok = true;
#pragma unroll
  for (int pl = 0; pl < NP; ++pl)
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const float up = (float)(1 << nib_pos(t, pl)), down = 1.f / up;
      const float zp = z[pl][t] * up, sp = s[pl][t] * down;
      ok = ok && zp >= 0.f && zp < 8388608.f && zp == rintf(zp) && sp * up == s[pl][t];
    }
  const bool fast = __all_sync(0xffffffffu, ok);
#pragma unroll
  for (int pl = 0; pl < NP; ++pl)
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const float up = (float)(1 << nib_pos(t, pl));
      za[pl][t] = fast ? 8388608.f + z[pl][t] * up : z[pl][t];
      sb[pl][t] = fast ? s[pl][t] * (1.f / up) : s[pl][t];
    }
  return fast;
}

// The B fragments of one plane of a 16-row step: w[q][v] is word v of the
// lane's row q (rows 2i, 2i+1, 8+2i, 9+2i), w16 the same >> 16. SLOW reads
// each weight's scale and zero through sz_at(q, t).
template <int MODE, int PLANE, int NPL, class SZ>
__device__ __forceinline__ void fragments(const uint32_t (&w)[4][(NPL + 3) / 4],
                                          const uint32_t (&w16)[4][(NPL + 3) / 4],
                                          const float (&za)[NPL], const float (&sb)[NPL],
                                          SZ sz_at, uint32_t (&b)[NPL][2]) {
#pragma unroll
  for (int t = 0; t < NPL; ++t) {
    float d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (MODE == FAST) {
        constexpr int p0 = 4 * PLANE, p1 = 8 + 4 * PLANE;  // nib_pos of even, odd t
        constexpr uint32_t flip0 = PLANE ? 8u << p0 : 0u, flip1 = PLANE ? 8u << p1 : 0u;
        const uint32_t src = (t % 4) < 2 ? w[q][t / 4] : w16[q][t / 4];
        const uint32_t bits = t & 1 ? and_xor<(0xFu << p1)>(src, 0x4B000000u | flip1)
                                    : and_xor<(0xFu << p0)>(src, 0x4B000000u | flip0);
        d[q] = __fmul_rn(__fsub_rn(__int_as_float(bits), za[t]), sb[t]);
      } else {
        const int shift = 8 * (t % 4) + 4 * PLANE;
        const uint32_t bits =
            ((w[q][t / 4] >> shift) & 0xFu) ^ ((PLANE ? 8u : 0u) | 0x4B000000u);
        float s = sb[t], z = za[t];
        if constexpr (MODE == SLOW) sz_at(q, t, s, z);
        d[q] = __fmul_rn(__fsub_rn(__int_as_float(bits) - 8388608.f, z), s);
      }
    }
    b[t][0] = pack_bf16(d[0], d[1]);
    b[t][1] = pack_bf16(d[2], d[3]);
  }
}

// Which stages enter a new group (aligned layouts): the low and high
// plane's phase within their group, advanced one stage at a time.
struct Groups {
  int spg, g_lo, ph_lo, g_hi, ph_hi;
  __device__ __forceinline__ Groups(int kt, int rows, int gs, bool aligned, bool planar, int sr) {
    spg = aligned ? gs / sr : 1;
    g_lo = kt / spg;
    ph_lo = kt % spg;
    const int kh = aligned ? (planar ? rows / sr : 0) + kt : 0;
    g_hi = kh / spg;
    ph_hi = kh % spg;
  }
  __device__ __forceinline__ bool fresh(bool first) const {
    return first || ph_lo == 0 || ph_hi == 0;
  }
  __device__ __forceinline__ void next() {
    if (++ph_lo == spg) ph_lo = 0, ++g_lo;
    if (++ph_hi == spg) ph_hi = 0, ++g_hi;
  }
};

// The grouped product's m-tiles (RAGGED): x and out are [tiles * TM, K] and
// [tiles * TM, N], m-tile blockIdx.y belongs to expert tile_expert[blockIdx.y]
// (clamped into [0, E - 1]: the caller's overflow bucket may name E), and
// only m-tiles below num_occ[0] are computed, read on the device.
struct Experts {
  const int32_t* tile_expert;  // [tiles]
  const int32_t* num_occ;      // [1]
  int E;

  // Offsets the block's operands to its m-tile (M = TM rows of x, out and
  // the fp32 partials, laid out [tiles, splits, TM, N]) and its expert's
  // weights, scales and zeros; false for a block past num_occ, which exits.
  // (templates: the kernels' pointers are __restrict__-qualified)
  template <class X, class O, class W, class S, class Z, class P>
  __device__ __forceinline__ bool select(X& x, O& out, W& w, S& scales, Z& zeros, P& part,
                                         int M, int N, int K, int G, bool planar) const {
    const int i = blockIdx.y;
    if (i >= num_occ[0]) return false;
    int e = tile_expert[i];
    e = e < 0 ? 0 : (e >= E ? E - 1 : e);
    x += (long long)i * M * K;
    out += (long long)i * M * N;
    if (part != nullptr) part += (long long)i * gridDim.z * M * N;
    w += (long long)e * (planar ? K / 2 : K) * N;
    scales += (long long)e * G * N;
    zeros += (long long)e * G * N;
    return true;
  }
};

// ---------------------------------------------------------------------------
// decode: M <= 16
// ---------------------------------------------------------------------------

template <int MR, bool PLANAR>
struct Dec {
  static constexpr int NWARP = 8, NT = NWARP * 32, BN = 256, NPL = 4, STG = 3;
  static constexpr int SRD = 2 * SR;             // weight rows a stage (the decode split unit)
  static constexpr int NP = PLANAR ? 2 : 1;     // planes
  static constexpr int LDX = NP * DEC_ROWS + 8;  // bf16 per staged x row
  static constexpr int X_BYTES = MR * LDX * 2;
  static constexpr int LDW = 48;  // bytes per staged row of a warp's 32 columns (conflict-free)
  static constexpr int W_BYTES = SRD * LDW;
  static constexpr int SLOT = W_BYTES + 2 * NP * 32 * 4;  // + s, z of each plane
  static constexpr int SMEM = X_BYTES + NWARP * STG * SLOT;
  static_assert(DEC_ROWS % SRD == 0, "x slice");
};

// two blocks an SM (at most 128 registers a thread): one block's latency-
// bound copies alone left half of each SM's issue slots idle
template <int MR, bool PLANAR, bool RAGGED>
__global__ void __launch_bounds__(256, 2) w4a16_decode_kernel(
    bf16* __restrict__ out, const bf16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scales, const float* __restrict__ zeros, float* __restrict__ part,
    int* __restrict__ tickets, int M, int N, int K, int G, int per, int vec16, int aligned,
    Experts ex) {
  using C = Dec<MR, PLANAR>;
  if constexpr (RAGGED) {
    if (!ex.select(x, out, w, scales, zeros, part, M, N, K, G, PLANAR)) return;
  }
  constexpr int NPL = C::NPL, NP = C::NP, SRD = C::SRD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i = lane % 4;
  const int n_blk = blockIdx.x * C::BN, n_w = n_blk + warp * 32;
  const int rows = PLANAR ? K / 2 : K, gs = K / G;
  const int kt0 = blockIdx.z * per;
  const int nkt = min((rows + SRD - 1) / SRD, kt0 + per) - kt0;  // >= 1 (the host's plan)
  const int r_beg = kt0 * SRD, r_end = min(rows, (kt0 + nkt) * SRD);
  bf16* sx = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + C::X_BYTES + warp * C::STG * C::SLOT;

  // the block's x slice, zero past r_end: column c of plane pl is
  // x[m, pl * K/2 + r_beg + c]
  {
    const int cpr = nkt * SRD / 8;
    for (int c = tid; c < MR * NP * cpr; c += C::NT) {
      const int m = c / (NP * cpr), rem = c % (NP * cpr), pl = rem / cpr, j = (rem % cpr) * 8;
      const bool ok = m < M && r_beg + j < r_end;  // rows % 8 == 0
      cp16(sx + m * C::LDX + pl * DEC_ROWS + j,
           ok ? x + (long long)m * K + pl * rows + r_beg + j : x, ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // the warp's ring: stage kt0 + s in slot s % STG. A lane copies rows
  // lane / 2 + 16k (k < 4) of a stage, 16 bytes at column 16 (lane % 2) of
  // the warp's 32; rows past r_end are zero-filled
  Groups gi(kt0, rows, gs, aligned, PLANAR, SRD);
  const int wn = n_w + 16 * (lane % 2);
  const int wbytes = wn < N ? min(16, N - wn) : 0;
  const uint8_t* wp = w + (long long)(r_beg + lane / 2) * N + (wbytes ? wn : 0);
  int wr = r_beg + lane / 2;  // the row of chunk 0
  auto issue = [&](int kt, int slot) {
    unsigned char* st = ring + slot * C::SLOT + (lane / 2) * C::LDW + 16 * (lane % 2);
#pragma unroll
    for (int k = 0; k < SRD / 16; ++k) {
      const int bytes = wr + 16 * k < r_end ? wbytes : 0;
      copy_w(st + 16 * k * C::LDW, wp, 16LL * k * N, bytes, vec16);
    }
    wp += (long long)SRD * N;
    wr += SRD;
    if (aligned && gi.fresh(kt == kt0) && lane < 16 * NP) {
      // fields s_lo, z_lo (, s_hi, z_hi) of the warp's 32 columns
      const int f = lane / 8, j = (lane % 8) * 4;
      const bool ok = n_w + j < N;  // N % 8 == 0: four columns are all in or all out
      const float* src =
          (f & 1 ? zeros : scales) + (long long)(f < 2 ? gi.g_lo : gi.g_hi) * N + n_w + j;
      cp16(reinterpret_cast<float*>(ring + slot * C::SLOT + C::W_BYTES) + f * 32 + j,
           ok ? src : scales, ok ? 16 : 0);
    }
    gi.next();
  };
#pragma unroll
  for (int s = 0; s < C::STG - 1; ++s) {
    if (s < nkt) issue(kt0 + s, s);
    cp_async_commit();
  }
  cp_async_wait<C::STG - 1>();
  __syncthreads();  // the x slice

  float acc[1][NPL][4];
#pragma unroll
  for (int t = 0; t < NPL; ++t) acc[0][t][0] = acc[0][t][1] = acc[0][t][2] = acc[0][t][3] = 0.f;
  float za[NP][NPL] = {}, sb[NP][NPL] = {};
  bool fast = false;
  Groups gc(kt0, rows, gs, aligned, PLANAR, SRD);

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<C::STG - 2>();
    __syncwarp();  // stage it is in; every lane is done with slot (it - 1) % STG
    if (it + C::STG - 1 < nkt) issue(kt0 + it + C::STG - 1, (it + C::STG - 1) % C::STG);
    cp_async_commit();
    const unsigned char* st = ring + (it % C::STG) * C::SLOT;
    const int kt = kt0 + it;

    auto stage = [&](auto mode_tag) {
      constexpr int MODE = decltype(mode_tag)::value;
#pragma unroll
      for (int j = 0; j < SRD; j += 16) {
        uint32_t wv[4][1], w16[4][1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wv[q][0] = *reinterpret_cast<const uint32_t*>(
              st + (j + 2 * i + (q & 1) + (q >> 1) * 8) * C::LDW + 4 * g);
          w16[q][0] = wv[q][0] >> 16;
        }
        auto plane_step = [&](auto plane_tag) {
          constexpr int PL = decltype(plane_tag)::value;
          auto sz_at = [&](int q, int t, float& s, float& z) {
            const int R = kt * SRD + j + 2 * i + (q & 1) + (q >> 1) * 8, n = n_w + 4 * g + t;
            const long long o = (long long)min(((PL ? rows : 0) + R) / gs, G - 1) * N + n;
            s = n < N ? __ldg(scales + o) : 0.f;
            z = n < N ? __ldg(zeros + o) : 0.f;
          };
          uint32_t b[NPL][2];
          fragments<MODE, PL, NPL>(wv, w16, za[PL], sb[PL], sz_at, b);
          uint32_t af[4];
          const bf16* xa = sx + PL * DEC_ROWS + it * SRD + j;
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
          for (int t = 0; t < NPL; ++t) mma_bf16(acc[0][t], af, b[t][0], b[t][1]);
        };
        plane_step(std::integral_constant<int, 0>{});
        if constexpr (PLANAR) plane_step(std::integral_constant<int, 1>{});
      }
    };

    if (aligned) {
      if (gc.fresh(it == 0)) {
        const float* ssz = reinterpret_cast<const float*>(st + C::W_BYTES);
        float s[NP][NPL], z[NP][NPL];
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          const float4 a = *reinterpret_cast<const float4*>(ssz + 2 * pl * 32 + 4 * g);
          const float4 b = *reinterpret_cast<const float4*>(ssz + (2 * pl + 1) * 32 + 4 * g);
          s[pl][0] = a.x, s[pl][1] = a.y, s[pl][2] = a.z, s[pl][3] = a.w;
          z[pl][0] = b.x, z[pl][1] = b.y, z[pl][2] = b.z, z[pl][3] = b.w;
        }
        fast = set_terms<NPL, NP>(s, z, za, sb);
      }
      gc.next();
      if (fast)
        stage(std::integral_constant<int, FAST>{});
      else
        stage(std::integral_constant<int, EXACT>{});
    } else {
      stage(std::integral_constant<int, SLOW>{});
    }
  }
  cp_async_wait<0>();
  finish<1, NPL, true, C::NT, 16, C::BN>(acc, out, part, tickets, M, N, g, n_w, 0, n_blk, i, tid,
                                   &s_last);
}

// ---------------------------------------------------------------------------
// prefill: M > 16
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WM_, int WN_, int MINB_, bool PLANAR_>
struct Pre {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, MINB = MINB_;
  static constexpr int NT = WM * WN * 32;
  static constexpr bool PLANAR = PLANAR_;
  static constexpr int STAGES = 3;
  static constexpr int MT = BM / WM / 16;      // m16 tiles of a warp (warp tile BM/WM x 64)
  static constexpr int DQ = NT / (BN / 4);     // dequantizing threads a column group
  static_assert(BN == 64 * WN && SR % DQ == 0, "warp tiles of 64 columns");
  static constexpr int NP = PLANAR ? 2 : 1;
  static constexpr int BKL = NP * SR;          // k rows of a stage (x columns, B tile rows)
  static constexpr int LDW = BN + 16;          // bytes per staged raw weight row
  static constexpr int LDX = BKL + 8;          // bf16 per staged x row
  static constexpr int LDB = BN + 8;           // bf16 per dequantized B row
  static constexpr int W_BYTES = SR * LDW;
  static constexpr int X_BYTES = BM * LDX * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES + 2 * NP * BN * 4;  // + s, z of each plane
  static constexpr int B_BYTES = BKL * LDB * 2;
  static constexpr int SMEM = STAGES * STAGE + 2 * B_BYTES;
};

// One dequantizing thread's 4 adjacent columns of one weight row (word w,
// w16 = w >> 16) as 4 bf16, the column order of y.
template <int MODE, int PLANE, class SZ>
__device__ __forceinline__ uint2 deq_row(uint32_t w, uint32_t w16, const float (&za)[4],
                                         const float (&sb)[4], SZ sz_at) {
  float d[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (MODE == FAST) {
      constexpr int p0 = 4 * PLANE, p1 = 8 + 4 * PLANE;
      constexpr uint32_t flip0 = PLANE ? 8u << p0 : 0u, flip1 = PLANE ? 8u << p1 : 0u;
      const uint32_t src = t < 2 ? w : w16;
      const uint32_t bits = t & 1 ? and_xor<(0xFu << p1)>(src, 0x4B000000u | flip1)
                                  : and_xor<(0xFu << p0)>(src, 0x4B000000u | flip0);
      d[t] = __fmul_rn(__fsub_rn(__int_as_float(bits), za[t]), sb[t]);
    } else {
      const uint32_t bits = ((w >> (8 * t + 4 * PLANE)) & 0xFu) ^ ((PLANE ? 8u : 0u) | 0x4B000000u);
      float sc = sb[t], zc = za[t];
      if constexpr (MODE == SLOW) sz_at(t, sc, zc);
      d[t] = __fmul_rn(__fsub_rn(__int_as_float(bits) - 8388608.f, zc), sc);
    }
  }
  return make_uint2(pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]));
}

// a warp holds a 64-column run of BM / WM rows (128 fp32 accumulators at 64)
template <class C, bool RAGGED>
__global__ void __launch_bounds__(C::NT, C::MINB) w4a16_prefill_kernel(
    bf16* __restrict__ out, const bf16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scales, const float* __restrict__ zeros, float* __restrict__ part,
    int* __restrict__ tickets, int M, int N, int K, int G, int per, int vec16, int aligned,
    Experts ex) {
  constexpr int NP = C::NP;
  if constexpr (RAGGED) {  // one m-tile of M = TM <= BM rows
    if (!ex.select(x, out, w, scales, zeros, part, M, N, K, G, C::PLANAR)) return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i = lane % 4;
  const int n_blk = blockIdx.x * C::BN, m_blk = RAGGED ? 0 : blockIdx.y * C::BM;
  const int rows = C::PLANAR ? K / 2 : K, gs = K / G;
  const int kt0 = blockIdx.z * per;
  const int nkt = min((rows + SR - 1) / SR, kt0 + per) - kt0;  // >= 1 (the host's plan)
  const int wm = warp / C::WN, wn = warp % C::WN;
  bf16* sB = reinterpret_cast<bf16*>(smem + C::STAGES * C::STAGE);  // 2 x [BKL][LDB]

  Groups gi(kt0, rows, gs, aligned, C::PLANAR, SR);
  auto load_stage = [&](int kt, int slot) {
    unsigned char* st = smem + slot * C::STAGE;
    bf16* sx = reinterpret_cast<bf16*>(st + C::W_BYTES);
    const int r0 = kt * SR;
#pragma unroll
    for (int k = 0; k < SR * (C::BN / 16) / C::NT; ++k) {
      const int c = tid + k * C::NT, r = c / (C::BN / 16), j = (c % (C::BN / 16)) * 16;
      const int R = r0 + r, n = n_blk + j;
      const int bytes = R < rows && n < N ? min(16, N - n) : 0;
      copy_w(st + r * C::LDW + j, w, (long long)R * N + n, bytes, vec16);
    }
    constexpr int XC = C::BKL / 8;
#pragma unroll
    for (int k = 0; k < C::BM * XC / C::NT; ++k) {
      const int c = tid + k * C::NT, m = c / XC, j = (c % XC) * 8, pl = j / SR;
      const int r = r0 + j % SR;
      const bool ok = r < rows && m_blk + m < M;
      cp16(sx + m * C::LDX + j, ok ? x + (long long)(m_blk + m) * K + pl * rows + r : x,
           ok ? 16 : 0);
    }
    if (aligned && gi.fresh(kt == kt0)) {
      float* ssz = reinterpret_cast<float*>(st + C::W_BYTES + C::X_BYTES);
      constexpr int SC = C::BN / 4;
      for (int c = tid; c < 2 * NP * SC; c += C::NT) {
        const int f = c / SC, j = (c % SC) * 4;
        const bool ok = n_blk + j < N;  // N % 8 == 0: four columns are all in or all out
        const float* src =
            (f & 1 ? zeros : scales) + (long long)(f < 2 ? gi.g_lo : gi.g_hi) * N + n_blk + j;
        cp16(ssz + f * C::BN + j, ok ? src : scales, ok ? 16 : 0);
      }
    }
    gi.next();
  };

  // dequantizing: thread tid takes columns 4 (tid % (BN / 4)) + [0, 4) of
  // rows tid / (BN / 4) + DQ j, both planes, into the bf16 B tile (k rows:
  // low plane [0, 32), high plane [32, 64), as the staged x columns)
  const int dc = 4 * (tid % (C::BN / 4)), dr = tid / (C::BN / 4);
  float za[NP][4] = {}, sb[NP][4] = {};
  bool fast = false;
  Groups gc(kt0, rows, gs, aligned, C::PLANAR, SR);
  auto dequant = [&](int it) {
    const unsigned char* st = smem + (it % C::STAGES) * C::STAGE;
    bf16* b = sB + (it % 2) * (C::B_BYTES / 2);
    const int kt = kt0 + it;
    auto rows_of = [&](auto mode_tag) {
      constexpr int MODE = decltype(mode_tag)::value;
#pragma unroll
      for (int j = 0; j < SR / C::DQ; ++j) {
        const int r = dr + C::DQ * j;
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(st + r * C::LDW + dc);
        auto plane = [&](auto plane_tag) {
          constexpr int PL = decltype(plane_tag)::value;
          auto sz_at = [&](int t, float& sc, float& zc) {
            const int n = n_blk + dc + t;
            const long long o = (long long)min(((PL ? rows : 0) + kt * SR + r) / gs, G - 1) * N + n;
            sc = n < N ? __ldg(scales + o) : 0.f;
            zc = n < N ? __ldg(zeros + o) : 0.f;
          };
          *reinterpret_cast<uint2*>(b + (PL * SR + r) * C::LDB + dc) =
              deq_row<MODE, PL>(wv, wv >> 16, za[PL], sb[PL], sz_at);
        };
        plane(std::integral_constant<int, 0>{});
        if constexpr (C::PLANAR) plane(std::integral_constant<int, 1>{});
      }
    };
    if (aligned) {
      if (gc.fresh(it == 0)) {
        const float* ssz = reinterpret_cast<const float*>(st + C::W_BYTES + C::X_BYTES);
        float sv[NP][4], zv[NP][4];
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          const float4 a = *reinterpret_cast<const float4*>(ssz + 2 * pl * C::BN + dc);
          const float4 c = *reinterpret_cast<const float4*>(ssz + (2 * pl + 1) * C::BN + dc);
          sv[pl][0] = a.x, sv[pl][1] = a.y, sv[pl][2] = a.z, sv[pl][3] = a.w;
          zv[pl][0] = c.x, zv[pl][1] = c.y, zv[pl][2] = c.z, zv[pl][3] = c.w;
        }
        fast = set_terms<4, NP>(sv, zv, za, sb);
      }
      gc.next();
      if (fast)
        rows_of(std::integral_constant<int, FAST>{});
      else
        rows_of(std::integral_constant<int, EXACT>{});
    } else {
      rows_of(std::integral_constant<int, SLOW>{});
    }
  };

  float acc[C::MT][8][4];
#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[a][t][0] = acc[a][t][1] = acc[a][t][2] = acc[a][t][3] = 0.f;

  // the ring: stage kt0 + s in slot s % STAGES, dequantized one stage ahead
  // into B buffer s % 2; one barrier a stage
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nkt) load_stage(kt0 + s, s);
    cp_async_commit();
  }
  cp_async_wait<C::STAGES - 2>();  // stage 0
  __syncthreads();
  dequant(0);
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<C::STAGES - 3>();  // stage it + 1
    __syncthreads();  // B it is whole; every warp is done with B it + 1 and stage it - 1's slot
    if (it + C::STAGES - 1 < nkt)
      load_stage(kt0 + it + C::STAGES - 1, (it + C::STAGES - 1) % C::STAGES);
    cp_async_commit();
    if (it + 1 < nkt) dequant(it + 1);
    const bf16* sx =
        reinterpret_cast<const bf16*>(smem + (it % C::STAGES) * C::STAGE + C::W_BYTES);
    const bf16* b = sB + (it % 2) * (C::B_BYTES / 2);
#pragma unroll
    for (int kk = 0; kk < C::BKL; kk += 16) {
      uint32_t af[C::MT][4];
#pragma unroll
      for (int a = 0; a < C::MT; ++a)
        ldsm_x4(af[a], sx + (wm * C::MT + a) * 16 * C::LDX + a_offset(lane, C::LDX, kk));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, b + bt_offset(lane, C::LDB, kk, wn * 64 + np * 16));
#pragma unroll
        for (int a = 0; a < C::MT; ++a) {
          mma_bf16(acc[a][2 * np], af[a], bv[0], bv[1]);
          mma_bf16(acc[a][2 * np + 1], af[a], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  finish<C::MT, 8, false, C::NT, C::BM, C::BN>(acc, out, part, tickets, M, N,
                                               m_blk + wm * C::MT * 16 + g, n_blk + wn * 64,
                                               m_blk, n_blk, i, tid, &s_last);
}

// ---------------------------------------------------------------------------

// the kernel of config cfg (the host's ops/cuda/quant_matmul.py CONFIGS):
// 0 decode (x rows 8 or 16), 1 prefill 64 x 128, 2 prefill 128 x 256
template <bool P, bool RAGGED>
struct Kernels {
  using P64 = Pre<64, 128, 2, 2, 2, P>;
  using P128 = Pre<128, 256, 2, 4, 1, P>;
  static void* fn(int cfg, int M) {
    if (cfg == 0)
      return M <= 8 ? (void*)w4a16_decode_kernel<8, P, RAGGED>
                    : (void*)w4a16_decode_kernel<16, P, RAGGED>;
    if (cfg == 1) return (void*)w4a16_prefill_kernel<P64, RAGGED>;
    return (void*)w4a16_prefill_kernel<P128, RAGGED>;
  }
  static int smem(int cfg, int M) {
    if (cfg == 0) return M <= 8 ? Dec<8, P>::SMEM : Dec<16, P>::SMEM;
    return cfg == 1 ? P64::SMEM : P128::SMEM;
  }
  static int threads(int cfg) { return cfg == 0 ? Dec<8, P>::NT : cfg == 1 ? P64::NT : P128::NT; }
  static int bn(int cfg) { return cfg == 0 ? Dec<8, P>::BN : cfg == 1 ? P64::BN : P128::BN; }
  static int bm(int cfg) { return cfg == 0 ? 16 : cfg == 1 ? 64 : 128; }
};

// dynamic shared memory above 48 KB, once per kernel and device, and the
// largest shared-memory carveout: without it CUDA may size the L1/shared
// split for one block an SM (measured: the decode kernel's blocks ran in waves
// of one an SM)
int configure(const void* fn, int smem) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  static const void* done_fn[64];
  static int done_dev[64];
  static int n = 0;
  for (int k = 0; k < n; ++k)
    if (done_fn[k] == fn && done_dev[k] == dev) return 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && n < 64) {
    done_fn[n] = fn;
    done_dev[n++] = dev;
  }
  return (int)err;
}

// Launches config cfg's kernel (RAGGED: over grid rows `tiles` m-tiles of M =
// TM rows, ex naming their experts; else over ceil(M / BM) row blocks): the
// split count must cut the stages into that many non-empty runs of ceil(stages
// / splits); with splits > 1 the fp32 partials (dense [splits, M, N], ragged
// [tiles, splits, TM, N]) and zeroed tickets (one per output tile) are given.
template <bool P, bool RAGGED>
int launch(int cfg, void* out, const void* x, const void* w, const void* scales,
           const void* zeros, float* part, int* tickets, int M, int N, int K, int G, int splits,
           int vec16, int tiles, Experts ex, cudaStream_t stream) {
  using KS = Kernels<P, RAGGED>;
  if (cfg < 0 || cfg > 2) return (int)cudaErrorInvalidValue;
  const int rows = P ? K / 2 : K;
  const int unit = cfg == 0 ? Dec<8, P>::SRD : SR;  // weight rows of a stage
  const int kts = (rows + unit - 1) / unit;
  const int per = (kts + splits - 1) / splits;
  if (splits < 1 || (kts + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if (cfg == 0 && (M > 16 || per * unit > DEC_ROWS)) return (int)cudaErrorInvalidValue;
  if (RAGGED && M > KS::bm(cfg)) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const void* fn = KS::fn(cfg, M);
  const int smem = KS::smem(cfg, M);
  if (int err = configure(fn, smem)) return err;
  const int aligned = (K / G) % unit == 0 && rows % unit == 0;
  const int bm = KS::bm(cfg);
  const int bn = KS::bn(cfg);
  const dim3 grid((N + bn - 1) / bn, RAGGED ? tiles : (M + bm - 1) / bm, splits);
  bf16* o = (bf16*)out;
  const bf16* xx = (const bf16*)x;
  const uint8_t* ww = (const uint8_t*)w;
  const float *s = (const float*)scales, *z = (const float*)zeros;
  void* args[] = {&o, &xx, &ww, &s, &z, &part, &tickets, &M, &N, &K, &G,
                  (void*)&per, &vec16, (void*)&aligned, &ex};
  return (int)cudaLaunchKernel(fn, grid, dim3(KS::threads(cfg)), args, smem, stream);
}
}  // namespace
}  // namespace zt_w4a16
