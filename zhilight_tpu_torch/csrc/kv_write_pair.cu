// The slot-major pools' attention prologue: rope of q and k, int8
// quantization and the K and V row writes in one launch a layer; and, as the
// same kernel's mode without rope, the plain K and V row write.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py paged_write_rows (:141;
// kernels _decode_kernel :41 and _prefill_kernel :63) and write_rows_2d_pair
// (:427; kernel _rmw_decode_kernel_2d_pair :378, its prefill form calling
// write_rows_2d twice), together with the ops the reference leaves to XLA
// around them: the rotation of q and k (zhilight_tpu/ops/rope.py
// apply_rope_rot) and the int8 quantization and scale scatter of
// kvcache/paged.py write_kv. The TPU needed two row writes because Mosaic
// moves only tile-aligned row blocks; on the GPU they compute one thing.
//
// Computes, for tokens t < T, query heads h < Hq and KV heads g < Hkv, over
// the slot-major pools [N, Hkv, D] (one token's row of every head contiguous):
//   rope mode:  q_out[t, h] = rope(q[t, h]); k_pool[slot[t], g] = rope(k[t, g]);
//               v_pool[slot[t], g] = v[t, g] (q, k, v bf16 or fp16); over
//               int8 pools the rope(k) row rounded to their type and the v
//               row are quantized per (token, head), codes into
//               the pools and scales into the head-major [Hkv, N + 1] arrays,
//               a skipped row's into the spare column N;
//   copy mode:  k_pool[slot[t]] = k_rows[t], v_pool[slot[t]] = v_rows[t] on
//               the pools' 2-D views [N, Hkv * D], rows in the pools' type
//               (bf16, or int8 codes quantized by the caller): bytes of any
//               row width and alignment.
// A row with slot < 0 or slot >= N is skipped: no pool row is written, with
// no host sync. The rope results are bit-equal to the port's composition of
// PyTorch ops on the card (apply_rope_rot, quantize_rows, the pair write and
// the scale scatter): each rope product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA), the int8
// scale is absmax * fp32(1/127), floored at 1e-8, and a code is rint(x /
// scale) (half to even) clamped to +-127.
//
// Bound on the H100: the launch, then bytes. A decode step of
// H2O-Danube-1.8B (8 tokens, 32 / 8 heads of 80) moves about 130 KB (40 ns at
// 3.35 TB/s), so one launch instead of the 15 (bf16 pools) or 32 (int8 pools)
// small launches of the composition is the gain. Design: one warp per
// (token, head row), each lane holding whole rope pairs (neox (i, i + D/2),
// interleaved (2i, 2i + 1)), at most four of a row of 256: every even head_dim
// up to 256, at any alignment of a row, with no shuffle that depends on D;
// the int8 absmax is a warp reduction. q, k and v are read through their
// strides (views of the fused qkv projection need no copy). The grid is sized
// by rows, so a packed prefill of four 512-token chunks is as many warps as
// it has (token, head) rows. The copy mode gives each thread one vector of a
// token's K and V rows, the widest (16, 8, 4, 2 or 1 bytes) that divides the
// row's bytes and all four addresses.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_row.cuh"

namespace {

enum Mode { kCopy = 0, kRope = 1, kRopeInt8 = 2 };

constexpr int kMaxPairs = 4;  // rope pairs a lane holds: D <= 256

struct Params {
  void* k_pool;             // [N, Hkv, D] (copy mode: [N, vec])
  void* v_pool;
  float* k_scale;           // [Hkv, N + 1] (int8 rope mode)
  float* v_scale;
  const void* q;            // [T, Hq, D] bf16 or fp16, strides q_st, q_sh (elements)
  const void* k;            // [T, Hkv, D], strides k_st, k_sh (copy mode: [T, vec])
  const void* v;
  void* q_out;              // [T, Hq, D] contiguous
  const float* cos_f;       // [T, D] fp32
  const float* sin_f;
  const int32_t* slots;     // [T]
  long long q_st, q_sh, k_st, k_sh, v_st, v_sh;
  long long N;
  int T, Hq, Hkv, D;        // copy mode: Hq 0, Hkv the warps of a token, D its vectors a row
  int neox;
};

// Element indices of the lane's i-th rope pair, p = lane + 32 i < D / 2.
__device__ __forceinline__ void pair_at(int p, int D, bool neox, int& a, int& b) {
  a = neox ? p : 2 * p;
  b = neox ? p + D / 2 : 2 * p + 1;
}

// Loads the lane's pairs of a bf16 or fp16 row as fp32 (0 past the row).
template <class T>
__device__ __forceinline__ void load_pairs(const T* row, int lane, int D, bool neox,
                                           float (&x0)[kMaxPairs], float (&x1)[kMaxPairs]) {
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    x0[i] = x1[i] = 0.f;
    if (p < D / 2) {
      int a, b;
      pair_at(p, D, neox, a, b);
      x0[i] = zt_mma::Elem<T>::to_f(row[a]);
      x1[i] = zt_mma::Elem<T>::to_f(row[b]);
    }
  }
}

// Rotates the lane's pairs in place: (x0, x1) -> (x0 c_a - x1 s_a, x1 c_b + x0 s_b).
__device__ __forceinline__ void rope_pairs(const float* __restrict__ cs,
                                           const float* __restrict__ sn, int lane, int D,
                                           bool neox, float (&x0)[kMaxPairs],
                                           float (&x1)[kMaxPairs]) {
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    if (p < D / 2) {
      int a, b;
      pair_at(p, D, neox, a, b);
      const float y0 = __fadd_rn(__fmul_rn(x0[i], cs[a]), __fmul_rn(-x1[i], sn[a]));
      const float y1 = __fadd_rn(__fmul_rn(x1[i], cs[b]), __fmul_rn(x0[i], sn[b]));
      x0[i] = y0;
      x1[i] = y1;
    }
  }
}

template <typename T, typename F>
__device__ __forceinline__ void store_pairs(T* row, int lane, int D, bool neox,
                                            const float (&x0)[kMaxPairs],
                                            const float (&x1)[kMaxPairs], F cast) {
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    if (p < D / 2) {
      int a, b;
      pair_at(p, D, neox, a, b);
      row[a] = cast(x0[i]);
      row[b] = cast(x1[i]);
    }
  }
}

// The int8 scale of a row whose lanes hold (x0, x1); every lane of the warp
// must call it.
__device__ __forceinline__ float row_scale(const float (&x0)[kMaxPairs],
                                           const float (&x1)[kMaxPairs]) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) m = fmaxf(m, fmaxf(fabsf(x0[i]), fabsf(x1[i])));
  constexpr float kInv127 = 1.0f / 127.0f;
  return fmaxf(__fmul_rn(zt_rope::warp_max(m), kInv127), 1e-8f);
}

// V: the copy mode's vector type; the rope modes' element type of q, k, v,
// q_out and a model-dtype pool (bf16 or fp16)
template <int MODE, typename V>
__global__ void __launch_bounds__(256) pair_rows_kernel(const Params p) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int per_tok = p.Hq + p.Hkv;
  if (row >= (long long)p.T * per_tok) return;  // whole warps
  const int t = (int)(row / per_tok);
  const int j = (int)(row - (long long)t * per_tok);
  const int slot = p.slots[t];
  const bool keep = slot >= 0 && slot < p.N;

  if constexpr (MODE == kCopy) {  // warp j of a token: vectors 32 j ... of its K | V row
    const int vec = p.D, c = 32 * j + lane;
    if (!keep || c >= 2 * vec) return;
    if (c < vec)
      static_cast<V*>(p.k_pool)[(long long)slot * vec + c] =
          static_cast<const V*>(p.k)[(long long)t * vec + c];
    else
      static_cast<V*>(p.v_pool)[(long long)slot * vec + c - vec] =
          static_cast<const V*>(p.v)[(long long)t * vec + c - vec];
  } else {
    const int D = p.D;
    const bool neox = p.neox;
    const float* cs = p.cos_f + (long long)t * D;
    const float* sn = p.sin_f + (long long)t * D;
    using E = zt_mma::Elem<V>;
    const auto cast = [](float f) { return E::from_f(f); };
    float x0[kMaxPairs], x1[kMaxPairs];
    if (j < p.Hq) {  // a query row: rotated into q_out
      load_pairs(static_cast<const V*>(p.q) + t * p.q_st + j * p.q_sh, lane, D, neox, x0, x1);
      rope_pairs(cs, sn, lane, D, neox, x0, x1);
      store_pairs(static_cast<V*>(p.q_out) + ((long long)t * p.Hq + j) * D, lane, D, neox, x0,
                  x1, cast);
      return;
    }
    const int g = j - p.Hq;  // a KV row
    float y0[kMaxPairs], y1[kMaxPairs];
    load_pairs(static_cast<const V*>(p.k) + t * p.k_st + g * p.k_sh, lane, D, neox, x0, x1);
    load_pairs(static_cast<const V*>(p.v) + t * p.v_st + g * p.v_sh, lane, D, neox, y0, y1);
    rope_pairs(cs, sn, lane, D, neox, x0, x1);
    const long long base = ((long long)slot * p.Hkv + g) * D;  // element of the pool row
    if constexpr (MODE == kRope) {
      if (!keep) return;
      store_pairs(static_cast<V*>(p.k_pool) + base, lane, D, neox, x0, x1, cast);
      store_pairs(static_cast<V*>(p.v_pool) + base, lane, D, neox, y0, y1, cast);
    } else {
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {  // the cache quantizes the rotated row as V holds it
        x0[i] = E::to_f(E::from_f(x0[i]));
        x1[i] = E::to_f(E::from_f(x1[i]));
      }
      const float sk = row_scale(x0, x1), sv = row_scale(y0, y1);
      if (lane == 0) {
        const long long col = (long long)g * (p.N + 1) + (keep ? slot : p.N);
        p.k_scale[col] = sk;
        p.v_scale[col] = sv;
      }
      if (!keep) return;
      const auto code = [](float s) {
        return [s](float f) { return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f); };
      };
      store_pairs(static_cast<int8_t*>(p.k_pool) + base, lane, D, neox, x0, x1, code(sk));
      store_pairs(static_cast<int8_t*>(p.v_pool) + base, lane, D, neox, y0, y1, code(sv));
    }
  }
}

template <int MODE, typename V = uint8_t>
int launch(const Params& p, cudaStream_t stream) {
  const long long warps = (long long)p.T * (p.Hq + p.Hkv);
  if (warps == 0) return 0;
  const long long blocks = (warps + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  pair_rows_kernel<MODE, V><<<(unsigned)blocks, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The plain row write. row_bytes: bytes of one token's row, Hkv * D * element
// size; k_rows and v_rows are contiguous [T, Hkv * D]. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int zt_write_rows_pair(void* k_pool, void* v_pool, const void* k_rows,
                                  const void* v_rows, const void* slots, int T, long long N,
                                  int row_bytes, void* stream) {
  if (T == 0 || row_bytes == 0) return 0;
  Params p{};
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k = k_rows;
  p.v = v_rows;
  p.slots = static_cast<const int32_t*>(slots);
  p.N = N;
  p.T = T;
  p.Hq = 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t bits = (uintptr_t)k_pool | (uintptr_t)v_pool | (uintptr_t)k_rows |
                         (uintptr_t)v_rows | (uintptr_t)row_bytes;
  const int width = bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : bits % 2 == 0 ? 2 : 1;
  p.D = row_bytes / width;
  p.Hkv = (2 * p.D + 31) / 32;
  switch (width) {
    case 16: return launch<kCopy, uint4>(p, st);
    case 8: return launch<kCopy, uint2>(p, st);
    case 4: return launch<kCopy, uint32_t>(p, st);
    case 2: return launch<kCopy, uint16_t>(p, st);
    default: return launch<kCopy, uint8_t>(p, st);
  }
}

// The prologue. q, k, v: bf16 (fp16 with fp16 != 0) with unit last stride,
// strides in elements (row, head). q_out [T, Hq, D] of their type,
// contiguous. cos_f, sin_f: fp32 [T, D] contiguous. k_pool, v_pool [N, Hkv,
// D] of their type, or int8 with k_scale, v_scale
// fp32 [Hkv, N + 1] (int8 != 0). D even, 2 <= D <= 256. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int zt_rope_write_rows_pair(
    void* k_pool, void* v_pool, void* k_scale, void* v_scale, const void* q, const void* k,
    const void* v, void* q_out, const void* cos_f, const void* sin_f, const void* slots, int T,
    int Hq, int Hkv, int D, long long N, long long q_st, long long q_sh, long long k_st,
    long long k_sh, long long v_st, long long v_sh, int neox, int int8, int fp16,
    void* stream) {
  if (D % 2 != 0 || D > 2 * 32 * kMaxPairs || D <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<float*>(k_scale);
  p.v_scale = static_cast<float*>(v_scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_out = q_out;
  p.cos_f = static_cast<const float*>(cos_f);
  p.sin_f = static_cast<const float*>(sin_f);
  p.slots = static_cast<const int32_t*>(slots);
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.N = N;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.neox = neox;
  cudaStream_t st = (cudaStream_t)stream;
  if (fp16) return int8 ? launch<kRopeInt8, __half>(p, st) : launch<kRope, __half>(p, st);
  return int8 ? launch<kRopeInt8, __nv_bfloat16>(p, st) : launch<kRope, __nv_bfloat16>(p, st);
}
