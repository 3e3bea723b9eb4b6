// The tile loop shared by the W4A16 kernels: one thread block computes one
// (BM x BN) tile of y = x . ((w - zero_g) * scale_g) for one weight matrix.
// csrc/quant_matmul.cu (one weight) and csrc/quant_ragged.cu (a stack of
// expert weights, one expert per m-tile) include it; the design notes are in
// quant_matmul.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace w4a16 {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

template <int BM_, int BN_, int BK_, int WM_, int WN_, bool PLANAR_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr bool PLANAR = PLANAR_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int FM = BM / WM / 16;  // 16x16 fragments per warp along M
  static constexpr int FN = BN / WN / 16;  // ... along N
  static constexpr int LDA = BK + 8;       // bf16
  static constexpr int LDB = BN + 8;       // bf16
  static constexpr int LDC = BN + 4;       // float
  static constexpr int A_BYTES = BM * LDA * 2;
  static constexpr int B_BYTES = BK * LDB * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
  static constexpr int SR = PLANAR ? BK / 2 : BK;  // weight source rows per tile
  static constexpr int CPR = BN / 8;               // 8-byte chunks per source row
  static constexpr int RSTEP = NT / CPR;           // rows between one thread's chunks
  static constexpr int WPT = SR / RSTEP;           // weight chunks per thread
  static constexpr int ACH = BK / 8;               // 16-byte x chunks per tile row
  static constexpr int APT = BM * ACH / NT;        // x chunks per thread
  static_assert(NT % CPR == 0 && SR % RSTEP == 0, "weight tile split");
  static_assert((BM * ACH) % NT == 0, "x tile split");
  static_assert(SMEM <= 48 * 1024, "static shared memory limit");
};

__device__ __forceinline__ void load_sz(const float* __restrict__ scales,
                                        const float* __restrict__ zeros, int g,
                                        int N, int n0, float* s, float* z) {
  const float4* sp = reinterpret_cast<const float4*>(scales + (long long)g * N + n0);
  const float4* zp = reinterpret_cast<const float4*>(zeros + (long long)g * N + n0);
  const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1), z0 = __ldg(zp), z1 = __ldg(zp + 1);
  s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
  s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
  z[0] = z0.x; z[1] = z0.y; z[2] = z0.z; z[3] = z0.w;
  z[4] = z1.x; z[5] = z1.y; z[6] = z1.z; z[7] = z1.w;
}

// 8 weights (one nibble of each of 8 bytes) -> 8 bf16 in a uint4
__device__ __forceinline__ uint4 dequant8(uint2 bytes, int shift, int flip,
                                          const float* s, const float* z) {
  uint32_t out[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t word = h < 2 ? bytes.x : bytes.y;
    const int b0 = (h % 2) * 16;
    const int q0 = ((word >> (b0 + shift)) & 0xF) ^ flip;
    const int q1 = ((word >> (b0 + 8 + shift)) & 0xF) ^ flip;
    const bf16 w0 = __float2bfloat16(((float)q0 - z[2 * h]) * s[2 * h]);
    const bf16 w1 = __float2bfloat16(((float)q1 - z[2 * h + 1]) * s[2 * h + 1]);
    out[h] = (uint32_t)__bfloat16_as_ushort(w0) | ((uint32_t)__bfloat16_as_ushort(w1) << 16);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// One output tile: rows [m_blk, min(m_blk + BM, M)) and columns
// [n_blk, min(n_blk + BN, N)) of out = x . dequant(w); every thread of the
// block calls it with the same arguments.
template <class C>
__device__ __forceinline__ void tile(
    bf16* __restrict__ out,             // [>= M, N]
    const bf16* __restrict__ x,         // [>= M, K]
    const uint8_t* __restrict__ w,      // [K/2, N] planar or [K, N] nibbles
    const float* __restrict__ scales,   // [G, N]
    const float* __restrict__ zeros,    // [G, N]
    int M, int N, int K, int gs, int m_blk, int n_blk) {
  __shared__ __align__(128) unsigned char smem[C::SMEM];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + C::A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int Kh = K / 2;
  const int src_rows = C::PLANAR ? Kh : K;
  const int tiles = (src_rows + C::SR - 1) / C::SR;

  // this thread's weight chunk: 8 columns, rows row0 + i*RSTEP of each tile
  const int col8 = tid % C::CPR;
  const int row0 = tid / C::CPR;
  const int n0 = n_blk + col8 * 8;
  const bool col_ok = n0 < N;  // N % 8 == 0: a chunk is all in or all out

  uint2 wreg[C::WPT];
  uint4 areg[C::APT];
  float s_lo[8], z_lo[8], s_hi[8], z_hi[8];
  int g_lo = -1, g_hi = -1;

  auto touch_groups = [&](int R) {
    // scales and zeros of the groups of source row R (both planes)
    const int glo = R / gs;
    if (glo != g_lo) {
      load_sz(scales, zeros, glo, N, n0, s_lo, z_lo);
      g_lo = glo;
    }
    if (C::PLANAR) {
      const int ghi = (Kh + R) / gs;
      if (ghi != g_hi) {
        load_sz(scales, zeros, ghi, N, n0, s_hi, z_hi);
        g_hi = ghi;
      }
    }
  };

  auto load_tile = [&](int t) {
    const int r0 = t * C::SR;
#pragma unroll
    for (int i = 0; i < C::WPT; ++i) {
      const int R = r0 + row0 + i * C::RSTEP;
      wreg[i] = make_uint2(0, 0);
      if (col_ok && R < src_rows)
        wreg[i] = __ldg(reinterpret_cast<const uint2*>(w + (long long)R * N + n0));
    }
#pragma unroll
    for (int i = 0; i < C::APT; ++i) {
      const int c = tid + i * C::NT;
      const int m = c / C::ACH, j = (c % C::ACH) * 8;
      int k;
      bool ok;
      if (C::PLANAR) {
        const int r = r0 + (j < C::SR ? j : j - C::SR);
        ok = r < Kh;
        k = (j < C::SR ? 0 : Kh) + r;
      } else {
        k = r0 + j;
        ok = k < K;
      }
      areg[i] = make_uint4(0, 0, 0, 0);
      if (ok && m_blk + m < M)
        areg[i] = __ldg(reinterpret_cast<const uint4*>(x + (long long)(m_blk + m) * K + k));
    }
    // start the scale/zero loads of this tile's first rows early
    if (col_ok && r0 + row0 < src_rows) touch_groups(r0 + row0);
  };

  auto store_tile = [&](int t) {
    const int r0 = t * C::SR;
#pragma unroll
    for (int i = 0; i < C::APT; ++i) {
      const int c = tid + i * C::NT;
      *reinterpret_cast<uint4*>(sA + (c / C::ACH) * C::LDA + (c % C::ACH) * 8) = areg[i];
    }
#pragma unroll
    for (int i = 0; i < C::WPT; ++i) {
      const int r = row0 + i * C::RSTEP;
      const int R = r0 + r;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (col_ok && R < src_rows) {
        touch_groups(R);
        lo = dequant8(wreg[i], 0, 0, s_lo, z_lo);
        if (C::PLANAR) hi = dequant8(wreg[i], 4, 8, s_hi, z_hi);
      }
      *reinterpret_cast<uint4*>(sB + r * C::LDB + col8 * 8) = lo;
      if (C::PLANAR)
        *reinterpret_cast<uint4*>(sB + (C::SR + r) * C::LDB + col8 * 8) = hi;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int a = 0; a < C::FM; ++a)
#pragma unroll
    for (int b = 0; b < C::FN; ++b) wmma::fill_fragment(acc[a][b], 0.f);
  const int wm = (warp / C::WN) * C::FM * 16;
  const int wn = (warp % C::WN) * C::FN * 16;

  load_tile(0);
  for (int t = 0; t < tiles; ++t) {
    store_tile(t);
    __syncthreads();
    if (t + 1 < tiles) load_tile(t + 1);
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int a = 0; a < C::FM; ++a)
        wmma::load_matrix_sync(fa[a], sA + (wm + a * 16) * C::LDA + kk, C::LDA);
#pragma unroll
      for (int b = 0; b < C::FN; ++b) {
        wmma::load_matrix_sync(fb, sB + kk * C::LDB + wn + b * 16, C::LDB);
#pragma unroll
        for (int a = 0; a < C::FM; ++a) wmma::mma_sync(acc[a][b], fa[a], fb, acc[a][b]);
      }
    }
    __syncthreads();
  }

  // epilogue through shared memory (sC overlays the tiles): masked bf16 stores
#pragma unroll
  for (int a = 0; a < C::FM; ++a)
#pragma unroll
    for (int b = 0; b < C::FN; ++b)
      wmma::store_matrix_sync(sC + (wm + a * 16) * C::LDC + wn + b * 16, acc[a][b], C::LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < C::BM * C::CPR; c += C::NT) {
    const int m = c / C::CPR, j = (c % C::CPR) * 8;
    if (m_blk + m >= M || n_blk + j >= N) continue;
    const float* src = sC + m * C::LDC + j;
    uint32_t packed[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      packed[h] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(src[2 * h])) |
                  ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(src[2 * h + 1])) << 16);
    *reinterpret_cast<uint4*>(out + (long long)(m_blk + m) * N + n_blk + j) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

}  // namespace w4a16
