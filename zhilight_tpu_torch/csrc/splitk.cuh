// The end of a split-K matmul block, shared by the int4 matmul
// (quant_matmul.cu) and the FP8 block matmul (fp8_matmul.cu): its fp32
// accumulators go to y, or, when the K range is split over gridDim.z blocks,
// to an fp32 partial tile; the block that draws the last ticket of its tile
// from a zeroed per-tile counter sums the partials in split order (the same
// bits on every call), writes y and resets the counter. One launch a call,
// where a second reduction kernel would add a launch to every projection of
// a host-bound decode step.
//
// The output type O is bf16 (y rounded once) or float (the fp32-output mode:
// the accumulators, or the split sum, stored unrounded, for a row-parallel
// rank's partial product that is all-reduced in fp32 before it is rounded).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace zt_mma {

// two or four adjacent outputs from fp32 (4: 16-byte aligned for float)
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The end of a block: its accumulators into y, or, split, into the fp32
// partials and, for the block drawing the last ticket of its tile, summed in
// split order into y. A warp holds MT m16 x NT8 n8 tiles; slot e of n8-tile t
// is row row_w + 16a + 8 (e / 2) and, PERM (the decode kernel's register-
// built B fragments), column col_w + NT8 (2i + e % 2) + t, else column col_w
// + 8t + 2i + e % 2. Every thread of the block calls it.
template <int MT, int NT8, bool PERM, int NT, int BM, int BN, class O>
__device__ __forceinline__ void finish(float (&acc)[MT][NT8][4], O* __restrict__ out,
                                       float* __restrict__ part, int* __restrict__ tickets,
                                       int M, int N, int row_w, int col_w, int m_blk, int n_blk,
                                       int i, int tid, int* s_last) {
  static_assert(!PERM || NT8 == 4, "the decode kernel's 4 columns a lane");
  const int split = blockIdx.z, splits = gridDim.z;
  // a thread writes together PERM the 4 adjacent values of slot e (t = 0..3),
  // else the 2 of slots e, e + 1 of one n8-tile
  if (splits == 1) {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int e = 0; e < 4; e += PERM ? 1 : 2) {
        const int m = row_w + a * 16 + 8 * (e >> 1);
        if (m >= M) continue;
        if constexpr (PERM) {
          const int n = col_w + NT8 * (2 * i + (e & 1));
          if (n >= N) continue;
          store4(out + (long long)m * N + n, acc[a][0][e], acc[a][1][e], acc[a][2][e],
                 acc[a][3][e]);
        } else {
#pragma unroll
          for (int t = 0; t < NT8; ++t) {
            const int n = col_w + 8 * t + 2 * i;
            if (n < N) store2(out + (long long)m * N + n, acc[a][t][e], acc[a][t][e + 1]);
          }
        }
      }
    return;
  }
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int e = 0; e < 4; e += PERM ? 1 : 2) {
      const int m = row_w + a * 16 + 8 * (e >> 1);
      if (m >= M) continue;
      float* row = part + ((long long)split * M + m) * N;
      if constexpr (PERM) {
        const int n = col_w + NT8 * (2 * i + (e & 1));
        if (n < N)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[a][0][e], acc[a][1][e], acc[a][2][e], acc[a][3][e]);
      } else {
#pragma unroll
        for (int t = 0; t < NT8; ++t) {
          const int n = col_w + 8 * t + 2 * i;
          if (n < N)
            *reinterpret_cast<float2*>(row + n) = make_float2(acc[a][t][e], acc[a][t][e + 1]);
        }
      }
    }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  int* ticket = tickets + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) *s_last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  constexpr int Q4 = BN / 4;
  const int rows = min(BM, M - m_blk);
  for (int c = tid; c < rows * Q4; c += NT) {
    const int m = m_blk + c / Q4, n = n_blk + (c % Q4) * 4;
    if (n >= N) continue;
    // eight partials in flight at a time, summed in split order (the same
    // bits on every call)
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = 0; p0 < splits; p0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (p0 + u < splits)
          v[u] = __ldcg(reinterpret_cast<const float4*>(part + ((long long)(p0 + u) * M + m) * N + n));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (p0 + u < splits) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
    }
    store4(out + (long long)m * N + n, sum.x, sum.y, sum.z, sum.w);
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

}  // namespace zt_mma
