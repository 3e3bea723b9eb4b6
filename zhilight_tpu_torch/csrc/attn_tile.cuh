// Helpers shared by the attention kernels (attn_headmajor.cu,
// attn_headmajor_q.cu, prefill_attention.cu, prefill_attention_q.cu, the
// slot-major paged_decode.cuh) and the
// int4 and FP8 matmuls (quant_matmul.cu, fp8_matmul.cu): warp-level tensor-core products, asynchronous copies
// and the paged gather of a K|V tile.
//
// The element type of a kernel's q, its output and its tensor-core operands is
// bf16 or fp16 (Elem<T> at the end: the mma.sync operand type, conversions and
// pair packing); the fragment layouts below are the same for both.
//
// mma.sync m16n8k16 bf16 -> fp32 fragment layouts (PTX ISA, "Matrix Fragments
// for mma.m16n8k16"), with g = lane / 4 and c = 2 * (lane % 4):
//   A (16 x 16, row-major): a[0] = (g, c..c+1), a[1] = (g+8, c..c+1),
//                           a[2] = (g, c+8..c+9), a[3] = (g+8, c+8..c+9)
//   B (16 x 8, "col"):      b[0] = (k c..c+1, n g), b[1] = (k c+8..c+9, n g)
//   C (16 x 8, fp32):       c[0..1] = (g, c..c+1), c[2..3] = (g+8, c..c+1)
// So the C fragments of two adjacent 8-column tiles are, packed to bf16 pairs,
// the A fragment of a 16-deep product: the softmax probabilities go from the
// scores' accumulators to the second product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace zt_mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy that bypasses L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// the same with src-size `bytes` (0 or 16): the rest of the 16 bytes zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8x8 b16 matrices: an A fragment of rows 0-7 only (rows 8-15 zero)
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b (16 x 8 x 16, bf16 operands, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b (16 x 8 x 16, fp16 operands, fp32 accumulators)
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats rounded to an fp16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four int8 (a word, low byte first) -> two bf16 pairs, exactly
__device__ __forceinline__ void i8x4_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;  // x + 128 as unsigned bytes
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// byte t of words a and b, exactly, as a bf16 pair (a's in the low half)
__device__ __forceinline__ uint32_t i8_pair(uint32_t a, uint32_t b, int t) {
  const float fa = __int_as_float(__byte_perm(a ^ 0x80808080u, 0x4B000000u, 0x7650 + t)) - 8388736.f;
  const float fb = __int_as_float(__byte_perm(b ^ 0x80808080u, 0x4B000000u, 0x7650 + t)) - 8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// the four int8 of a word (low byte first) as exact fp32 values
__device__ __forceinline__ void i8x4_to_f32(uint32_t v, float (&f)[4]) {
  const uint32_t u = v ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - 8388736.f;
}

// Address of lane `lane`'s row for ldsm_x4 of the A operand (16 rows x 16
// columns at col0) of a row-major tile with leading dimension ld: matrices
// (rows 0-7 | 8-15) x (cols 0-7 | 8-15) in a[0..3] order.
__device__ __forceinline__ int a_offset(int lane, int ld, int col0) {
  return (lane % 16) * ld + col0 + (lane / 16) * 8;
}

// ldsm_x4 of B fragments for two 8-column tiles from a tile stored n-major
// (row n holds the k values, as K rows hold the head dims): r[0..1] is the
// fragment of columns n0..n0+7, r[2..3] of n0+8..n0+15; 16 deep from k0.
__device__ __forceinline__ int b_offset(int lane, int ld, int n0, int k0) {
  return (n0 + lane % 8 + 8 * (lane / 16)) * ld + k0 + 8 * ((lane / 8) % 2);
}

// ldsm_x4_trans of B fragments from a tile stored k-major (row k holds the n
// values, as V rows of tokens hold the head dims): r[0..1] is the fragment of
// columns n0..n0+7, r[2..3] of n0+8..n0+15; 16 deep from row k0.
__device__ __forceinline__ int bt_offset(int lane, int ld, int k0, int n0) {
  return (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + n0 + 8 * (lane / 16);
}

// Page ids of the pages from p0 on, fetched by every lane of a warp ahead of
// a tile's copy, two a lane (pages p0 .. p0 + 63: enough for a 64-row tile at
// page sizes >= 2), so the copy waits on no global load; gather_tile spreads
// them by shuffles.
struct PageIds {
  int p0, a, b;
};

__device__ __forceinline__ PageIds fetch_pages(const int32_t* pt, int maxp, int p0, int lane) {
  return {p0, pt[min(p0 + lane, maxp - 1)], pt[min(p0 + 32 + lane, maxp - 1)]};
}

// Stage rows [t0, t0 + ROWS) of one head of a head-major pool (rows of D2
// elements of type T, bf16 or int8; token t at head[(page * S + t % S) * D2],
// page = pt[t / S] clamped into [0, num_pages)) into dst, LD elements a row,
// with cp.async 16-byte copies of the NT threads of the block; rows outside
// [lo, hi) are zero-filled. Thread tid handles chunks tid + k * NT (16 bytes
// each, row-major), so a thread may read back its own chunks after
// cp_async_wait with no barrier. ids holds the page ids from t0 / S on
// (fetch_pages); s_shift is log2(S) when S is a power of two, else -1. Every
// lane of every warp must call it. UNROLL copies are unrolled: fewer keep
// the registers down, more hide the index arithmetic.
template <int ROWS, int D2, int LD, int NT, int UNROLL, class T = __nv_bfloat16>
__device__ __forceinline__ void gather_tile(T* dst0, const T* head, const int32_t* pt,
                                            const PageIds& ids, int t0, int lo, int hi, int S,
                                            int s_shift, long long num_pages, int tid) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D2 / EPC;        // chunks per row
  static_assert((ROWS * CPR) % NT == 0, "tile chunks");
#pragma unroll UNROLL
  for (int k = 0; k < ROWS * CPR / NT; ++k) {
    const int i = tid + k * NT;
    const int r = i / CPR, c = i % CPR;
    const int t = t0 + r;
    const int pidx = s_shift >= 0 ? t >> s_shift : t / S;
    const int rel = pidx - ids.p0;
    const int pa = __shfl_sync(0xffffffffu, ids.a, rel & 31);
    const int pb = __shfl_sync(0xffffffffu, ids.b, rel & 31);
    T* dst = dst0 + r * LD + c * EPC;
    if (t >= lo && t < hi) {
      long long page = rel < 32 ? pa : (rel < 64 ? pb : pt[pidx]);
      page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
      cp_async16(dst, head + (page * S + (t - pidx * S)) * D2 + c * EPC);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ int log2_if_pow2(int S) {
  return (S & (S - 1)) ? -1 : __ffs(S) - 1;
}

// The element type T (bf16 or fp16) of q, the output and the tensor-core
// operands: the product, conversions and pairs. An int8 code converts to
// either exactly (|x| <= 127).
template <class T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ void i8x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
    i8x4_to_bf16(v, lo, hi);
  }
  static __device__ __forceinline__ uint32_t i8pair(uint32_t a, uint32_t b, int t) {
    return i8_pair(a, b, t);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ void i8x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
    float f[4];
    i8x4_to_f32(v, f);
    lo = pack_f16(f[0], f[1]);
    hi = pack_f16(f[2], f[3]);
  }
  static __device__ __forceinline__ uint32_t i8pair(uint32_t a, uint32_t b, int t) {
    const float fa = __int_as_float(__byte_perm(a ^ 0x80808080u, 0x4B000000u, 0x7650 + t)) - 8388736.f;
    const float fb = __int_as_float(__byte_perm(b ^ 0x80808080u, 0x4B000000u, 0x7650 + t)) - 8388736.f;
    return pack_f16(fa, fb);
  }
};

// two floats as (hi, lo) pairs of T, hi = T(x), lo = T(x - hi): hi + lo holds
// x to 2^-16 of itself in bf16 (fp16: 2^-22 above its normal range)
template <class T>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = Elem<T>::pack(x0, x1);
  const float2 hf = Elem<T>::unpack(hi);
  lo = Elem<T>::pack(x0 - hf.x, x1 - hf.y);
}

}  // namespace zt_mma
