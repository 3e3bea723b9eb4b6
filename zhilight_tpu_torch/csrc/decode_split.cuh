// The split-context plan and the end of a block shared by the two head-major
// decode kernels (attn_headmajor.cu over bf16 rows, attn_headmajor_q.cu over
// int8 rows): which 64-token tiles a split takes, and the merge of the four
// warps' flash states and of the splits' partials in fixed split order (the
// last block of a (sequence, head group) to finish draws the last ticket of a
// zeroed counter, merges, and resets the counter).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace zt_decode {

constexpr float NEG_INF = -2.0e38f;
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr int TN = 64;  // tokens per tile (16 per warp)
constexpr int HR = 16;  // query rows per block
constexpr int MAX_SPLITS = 64;

// floats of the merge buffers (which reuse the ring): per warp O [HR, D], m,
// l [HR]; the split merge's per-row weights [MAX_SPLITS, HR] and (M, L) [HR]
template <int D>
constexpr int merge_floats() {
  return NWARPS * HR * (D + 2) + MAX_SPLITS * HR + 2 * HR;
}

// tiles [*first, *last) of split `split` over the tiles of [start, ctx); the
// number of splits with a non-empty range
__device__ __forceinline__ int split_range(int start, int ctx, int splits, int split, int* first,
                                           int* last) {
  const int t0 = start / TN;
  const int tiles = ctx > start ? (ctx + TN - 1) / TN - t0 : 0;
  const int per = (tiles + splits - 1) / splits;
  *first = t0 + min(split * per, tiles);
  *last = t0 + min((split + 1) * per, tiles);
  return per > 0 ? (tiles + per - 1) / per : 0;
}

// T: the output's element type (bf16 or fp16) outside EMIT
template <int D, bool EMIT, class T>
__device__ __forceinline__ void write_final(void* out, float* m_out, float* l_out, long long row,
                                            int d, float M, float L, float A) {
  if constexpr (EMIT) {
    static_cast<float*>(out)[row * D + d] = A;
    if (d == 0) {
      m_out[row] = M;
      l_out[row] = L;
    }
  } else {
    static_cast<T*>(out)[row * D + d] = zt_mma::Elem<T>::from_f(A / fmaxf(L, 1e-20f));
  }
}

// The end of a block, every thread: sO [NWARPS][HR][D] holds each warp's
// unnormalized O and, after it, sM and sL [NWARPS][HR] each warp's running max
// and sum (followed by room for the weights and the rows' (M, L)). Merges the
// warps, then writes the rows' output (one split) or this split's partial and,
// in the block that draws the last ticket, merges the splits. row0 is the
// first output row, slot the first partial of the (sequence, head group),
// ticket its counter.
template <int D, bool EMIT, class T>
__device__ __forceinline__ void decode_merge(float* sO, void* out, float* m_out, float* l_out,
                                             float* part_acc, float* part_ml, int* tickets,
                                             int rows, int parts, int split, long long row0,
                                             long long slot, long long ticket, int tid,
                                             int* s_last) {
  float* sM = sO + NWARPS * HR * D;
  float* sL = sM + NWARPS * HR;
  float* sW = sL + NWARPS * HR;
  float* sRow = sW + MAX_SPLITS * HR;
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
  __syncthreads();

  if (parts == 1) {
    for (int i = tid; i < rows * D; i += NT) {
      const int r = i / D, d = i % D;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) A += sO[(w * HR + r) * D + d] * sW[w * HR + r];
      write_final<D, EMIT, T>(out, m_out, l_out, row0 + r, d, sRow[r], sRow[HR + r], A);
    }
    return;
  }

  // several splits: write this split's partial, then the last block merges
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
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

  if (tid < rows) {
    float M = NEG_INF, L = 0.f;
    for (int p = 0; p < parts; ++p) M = fmaxf(M, __ldcg(part_ml + (slot + p) * 2 * HR + tid));
    for (int p = 0; p < parts; ++p) {
      const float f = __expf(__ldcg(part_ml + (slot + p) * 2 * HR + tid) - M);
      sW[p * HR + tid] = f;
      L += __ldcg(part_ml + (slot + p) * 2 * HR + HR + tid) * f;
    }
    sRow[tid] = M;
    sRow[HR + tid] = L;
  }
  if (tid == 0) tickets[ticket] = 0;  // ready for the next launch
  __syncthreads();
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    float A = 0.f;
    for (int p = 0; p < parts; ++p)
      A += __ldcg(part_acc + ((slot + p) * HR + r) * D + d) * sW[p * HR + r];
    write_final<D, EMIT, T>(out, m_out, l_out, row0 + r, d, sRow[r], sRow[HR + r], A);
  }
}

}  // namespace zt_decode
