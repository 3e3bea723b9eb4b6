// One warp, one row of D <= 256 bf16 or fp16 elements (T): lane l holds elements
// [8l, 8l + 8) as fp32 (lanes l >= D / 8 hold nothing and take part only in
// the shuffles). Shared by the attention prologues of the packed pool
// (kv_write.cu) and the latent pool (kv_write_2d.cu).
//
// The rotation rounds as PyTorch's separate kernels of
// ops/rope.py apply_rope_rot round: out = x*cos + rot(x)*sin with each product
// and the sum rounded to fp32 on its own (__fmul_rn / __fadd_rn, so nvcc
// cannot contract them into an FMA), then once to T by the caller.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace zt_rope {

constexpr unsigned kFull = 0xffffffffu;

template <class T>
__device__ __forceinline__ void load8(const T* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = zt_mma::Elem<T>::unpack(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <class T>
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  using E = zt_mma::Elem<T>;
  return make_uint4(E::pack(x[0], x[1]), E::pack(x[2], x[3]), E::pack(x[4], x[5]),
                    E::pack(x[6], x[7]));
}

// x <- T(x) as fp32: the value a T tensor holds after the rotation
template <class T>
__device__ __forceinline__ void round_to(float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = zt_mma::Elem<T>::to_f(zt_mma::Elem<T>::from_f(x[i]));
}

// Rotates the lane's 8 elements in place. cos_row / sin_row: fp32 [D] of the
// row's token (RopeTable.rot_values, laid out for the style). Neox pairs
// element i with i +- D/2, held by lane l +- D/16 (D % 16 == 0); the
// interleaved style pairs neighbours inside the lane. Every lane of the warp
// must call it.
__device__ __forceinline__ void rope8(float (&x)[8], const float* __restrict__ cos_row,
                                      const float* __restrict__ sin_row, int lane, int D,
                                      bool neox) {
  const bool active = lane < D / 8;
  float c[8], s[8], r[8];
  if (active) {
    const float4* c4 = reinterpret_cast<const float4*>(cos_row) + 2 * lane;
    const float4* s4 = reinterpret_cast<const float4*>(sin_row) + 2 * lane;
    const float4 c0 = c4[0], c1 = c4[1], s0 = s4[0], s1 = s4[1];
    c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
    c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
    s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
    s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
  }
  if (neox) {
    const int half = D / 16;  // lanes a half
    const int src = lane < half ? lane + half : (lane < 2 * half ? lane - half : lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = __shfl_sync(kFull, x[i], src);
      r[i] = lane < half ? -p : p;  // (x1, x2) -> (-x2, x1)
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (x_even, x_odd) -> (-x_odd, x_even)
      r[2 * i] = -x[2 * i + 1];
      r[2 * i + 1] = x[2 * i];
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __fadd_rn(__fmul_rn(x[i], c[i]), __fmul_rn(r[i], s[i]));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

}  // namespace zt_rope
