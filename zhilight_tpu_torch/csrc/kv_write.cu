// The packed pool's attention prologue: rope of q and k, int8 quantization
// and the K|V row write in one launch a layer; and, as the same kernel's
// mode without rope, the plain K|V row write.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py write_rows_hm (:606), whose
// Pallas kernels are _rmw_decode_kernel_hm (:499, decode: read-modify-write
// of an 8-row block per token) and _page_write_kernel_hm (:537, prefill:
// page-run DMA writes that assume page-aligned runs), together with the ops
// the reference leaves to XLA around it: the rotation of q and k
// (zhilight_tpu/ops/rope.py apply_rope_rot) and the int8 quantization and
// scale scatter of kvcache/paged.py write_kv.
//
// Computes, for tokens t < T, query heads h < Hq and KV heads g < Hkv, over
// the head-major pool [Hkv, N, 2D] (K in [:D], V in [D:]):
//   rope mode:  q_out[t, h] = rope(q[t, h]); pool[g, slot[t]] = rope(k[t, g]) | v[t, g];
//               over an int8 pool the rope(k) row rounded to q's type (bf16
//               or fp16, the type of q, k, v and a model-dtype pool) and the v row are
//               quantized per (token, head), codes into the pool and scales
//               into the head-major [Hkv, N + 1] arrays, a skipped row's into
//               the spare column N;
//   copy mode:  pool[g, slot[t]] = k[t, g] | v[t, g], rows in the pool's type
//               (bf16, or int8 codes quantized by the caller).
// A row with slot < 0 or slot >= N is skipped: no pool row is written. The
// results are bit-equal to the port's composition of PyTorch ops
// (apply_rope_rot, _quantize_rows, write_rows_hm_plain and the scale scatter
// on the card): each rope product and sum is rounded on its own, the int8
// scale is absmax * fp32(1/127) (PyTorch on the card divides by a constant
// through its reciprocal), floored at 1e-8, and a code is rint(x / scale)
// (half to even) clamped to +-127.
//
// Bound on the H100: the launch, then bytes. A decode step at 8 tokens,
// 40 / 8 heads of 128 moves 123 KB (37 ns at 3.35 TB/s), so one launch
// instead of the 15 (bf16 pool) or 32 (int8 pool) small launches of the
// composition is the gain. Design: one warp per (token, head row); a lane
// holds a 16-byte vector of 8 elements, the neox partner comes through a
// shuffle and the int8 absmax through a warp reduction. q, k and v are read
// through their strides (views of the fused qkv projection need no copy).
// The grid is sized by rows, so a packed prefill of several 512-token chunks
// is as many warps as it has (token, head) rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_row.cuh"

namespace {

enum Mode { kCopy = 0, kRope = 1, kRopeInt8 = 2 };

struct Params {
  void* pool;               // [Hkv, N, 2D]
  float* k_scale;           // [Hkv, N + 1] (int8 rope mode)
  float* v_scale;
  const void* q;            // [T, Hq, D] bf16 or fp16, strides q_st, q_sh (elements)
  const void* k;            // [T, Hkv, D], strides kv_st... (copy mode: contiguous)
  const void* v;
  void* q_out;              // [T, Hq, D] contiguous
  const float* cos_f;       // [T, D] fp32
  const float* sin_f;
  const int32_t* slots;     // [T]
  long long q_st, q_sh, k_st, k_sh, v_st, v_sh;
  long long N;
  int T, Hq, Hkv, D;        // copy mode: D counts 16-byte vectors of a half row
  int neox;
};

// T: the type of q, k, v, q_out and a model-dtype pool (bf16 or fp16)
template <int MODE, class T>
__global__ void __launch_bounds__(256) hm_rows_kernel(const Params p) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int per_tok = p.Hq + p.Hkv;
  if (row >= (long long)p.T * per_tok) return;  // whole warps
  const int t = (int)(row / per_tok);
  const int j = (int)(row - (long long)t * per_tok);
  const int slot = p.slots[t];
  const bool keep = slot >= 0 && slot < p.N;

  if constexpr (MODE == kCopy) {
    if (!keep) return;
    const int vec = p.D;
    const uint4* k = static_cast<const uint4*>(p.k) + ((long long)t * p.Hkv + j) * vec;
    const uint4* v = static_cast<const uint4*>(p.v) + ((long long)t * p.Hkv + j) * vec;
    uint4* dst = static_cast<uint4*>(p.pool) + ((long long)j * p.N + slot) * 2 * vec;
    for (int c = lane; c < 2 * vec; c += 32) dst[c] = c < vec ? k[c] : v[c - vec];
  } else {
    const int D = p.D;
    const bool active = lane < D / 8;
    const float* cs = p.cos_f + (long long)t * D;
    const float* sn = p.sin_f + (long long)t * D;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < p.Hq) {  // a query row: rotated into q_out
      const T* src = static_cast<const T*>(p.q) + t * p.q_st + j * p.q_sh;
      if (active) zt_rope::load8(src + 8 * lane, x);
      zt_rope::rope8(x, cs, sn, lane, D, p.neox);
      if (active)
        *reinterpret_cast<uint4*>(static_cast<T*>(p.q_out) + ((long long)t * p.Hq + j) * D +
                                  8 * lane) = zt_rope::pack8<T>(x);
      return;
    }
    const int g = j - p.Hq;  // a KV row
    const T* ks = static_cast<const T*>(p.k) + t * p.k_st + g * p.k_sh;
    const T* vs = static_cast<const T*>(p.v) + t * p.v_st + g * p.v_sh;
    if (active) zt_rope::load8(ks + 8 * lane, x);
    zt_rope::rope8(x, cs, sn, lane, D, p.neox);
    const long long base = ((long long)g * p.N + slot) * 2 * D;  // element of the pool row
    if constexpr (MODE == kRope) {
      if (!keep || !active) return;
      T* dst = static_cast<T*>(p.pool) + base;
      *reinterpret_cast<uint4*>(dst + 8 * lane) = zt_rope::pack8<T>(x);
      *reinterpret_cast<uint4*>(dst + D + 8 * lane) = *reinterpret_cast<const uint4*>(vs + 8 * lane);
    } else {
      float y[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (active) zt_rope::load8(vs + 8 * lane, y);
      zt_rope::round_to<T>(x);  // the cache quantizes the rotated row as T holds it
      float ak = 0.f, av = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ak = fmaxf(ak, fabsf(x[i]));
        av = fmaxf(av, fabsf(y[i]));
      }
      constexpr float kInv127 = 1.0f / 127.0f;
      const float sk = fmaxf(__fmul_rn(zt_rope::warp_max(ak), kInv127), 1e-8f);
      const float sv = fmaxf(__fmul_rn(zt_rope::warp_max(av), kInv127), 1e-8f);
      if (lane == 0) {
        const long long col = (long long)g * (p.N + 1) + (keep ? slot : p.N);
        p.k_scale[col] = sk;
        p.v_scale[col] = sv;
      }
      if (!keep || !active) return;
      uint32_t kc[2] = {0u, 0u}, vc[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = fminf(fmaxf(rintf(__fdiv_rn(x[i], sk)), -127.f), 127.f);
        const float b = fminf(fmaxf(rintf(__fdiv_rn(y[i], sv)), -127.f), 127.f);
        kc[i / 4] |= (uint32_t)(uint8_t)(int8_t)a << (8 * (i % 4));
        vc[i / 4] |= (uint32_t)(uint8_t)(int8_t)b << (8 * (i % 4));
      }
      int8_t* dst = static_cast<int8_t*>(p.pool) + base;
      *reinterpret_cast<uint2*>(dst + 8 * lane) = make_uint2(kc[0], kc[1]);
      *reinterpret_cast<uint2*>(dst + D + 8 * lane) = make_uint2(vc[0], vc[1]);
    }
  }
}

template <class T>
int launch(int mode, const Params& p, cudaStream_t stream) {
  const long long warps = (long long)p.T * (p.Hq + p.Hkv);
  if (warps == 0) return 0;
  const long long blocks = (warps + 7) / 8;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (mode == kCopy) hm_rows_kernel<kCopy, T><<<(unsigned)blocks, 256, 0, stream>>>(p);
  else if (mode == kRope) hm_rows_kernel<kRope, T><<<(unsigned)blocks, 256, 0, stream>>>(p);
  else hm_rows_kernel<kRopeInt8, T><<<(unsigned)blocks, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The plain row write. row_bytes: bytes of one head's K (or V) row, D *
// element size; must be a multiple of 16. k and v are contiguous [T, H, D].
// Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_write_rows_hm(void* pool, const void* k, const void* v,
                                const void* slots, int T, int H, long long N,
                                int row_bytes, void* stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.pool = pool;
  p.k = k;
  p.v = v;
  p.slots = static_cast<const int32_t*>(slots);
  p.N = N;
  p.T = T;
  p.Hq = 0;
  p.Hkv = H;
  p.D = row_bytes / 16;
  return launch<__nv_bfloat16>(kCopy, p, (cudaStream_t)stream);  // bytes: any type
}

// The prologue. q, k, v: bf16 (fp16 with fp16 != 0) with unit last stride,
// strides in elements (row, head); every row 16-byte aligned. q_out [T, Hq,
// D] of their type, contiguous. cos_f, sin_f: fp32 [T, D] contiguous. pool:
// [Hkv, N, 2D] of their type, or int8 with
// k_scale, v_scale fp32 [Hkv, N + 1] (int8 != 0). D % 16 == 0 and D <= 256.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_rope_write_rows_hm(
    void* pool, void* k_scale, void* v_scale, const void* q, const void* k,
    const void* v, void* q_out, const void* cos_f, const void* sin_f,
    const void* slots, int T, int Hq, int Hkv, int D, long long N,
    long long q_st, long long q_sh, long long k_st, long long k_sh,
    long long v_st, long long v_sh, int neox, int int8, int fp16, void* stream) {
  if (D % 16 != 0 || D > 256 || D <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.pool = pool;
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
  const int mode = int8 ? kRopeInt8 : kRope;
  return fp16 ? launch<__half>(mode, p, (cudaStream_t)stream)
              : launch<__nv_bfloat16>(mode, p, (cudaStream_t)stream);
}
