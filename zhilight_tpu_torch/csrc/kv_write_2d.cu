// The latent pool's attention prologue: rope of q_pe and k_pe and the
// latent row write in one launch a layer; and, as the same kernel's mode
// without rope, the plain row write into a 2-D pool.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py write_rows_2d (:324), whose
// Pallas kernels are _rmw_decode_kernel_2d (decode: read-modify-write of an
// aligned row block per token) and _page_write_kernel_2d (prefill: page-run
// writes merged through a staging page), together with the ops the
// reference leaves to XLA around it in zhilight_tpu/models/mla.py: the
// rotation of q_pe and k_pe (ops/rope.py apply_rope_rot) and the concatenation
// of the latent row.
//
// Computes, over the latent pool [N, X] with X = L + R (L = kv_lora_rank,
// R = qk_rope_head_dim), for tokens t < T and query heads h < H:
//   rope mode:  q_out[t, h] = rope(q_pe[t, h]);
//               pool[slot[t]] = c_kv[t] | rope(k_pe[t])   (bf16 or fp16);
//   copy mode:  pool[slot[t]] = rows[t], any element type (X * size bytes).
// A row with slot < 0 or slot >= N is skipped. The rope mode is bit-equal to
// apply_rope_rot twice, torch.cat and the row write: each rope product and
// sum rounded on its own (__fmul_rn / __fadd_rn), then once to the pool's type.
//
// Bound on the H100: the launch, then bytes. A DeepSeek-V2-Lite decode step
// (8 tokens, 16 heads of 64 rope lanes, rows of 576) moves 54 KB (16 ns at
// 3.35 TB/s); the composition it replaces is 16 launches. Design: one warp per
// row (a query head's rope row, or a token's latent row); a lane holds a
// 16-byte vector, the neox partner comes through a shuffle (rope_row.cuh).
// c_kv and k_pe are read through their row strides (k_pe is the strided tail
// of the kv_a projection's output, with no copy). The copy mode moves vectors
// of the widest width (16, 8, 4, 2 or 1 bytes) that divides the row's bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_row.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(256) rows_2d_copy_kernel(
    V* __restrict__ pool,              // [N, vec]
    const V* __restrict__ rows,        // [T, vec]
    const int32_t* __restrict__ slots, // [T]
    int T, long long N, int vec) {
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  const int slot = slots[t];
  if (slot < 0 || slot >= N) return;  // skipped row (or out of the pool)
  const V* src = rows + t * vec;
  V* dst = pool + (long long)slot * vec;
  for (int i = lane; i < vec; i += 32) dst[i] = src[i];
}

struct RopeParams {            // the rows of one type T, bf16 or fp16
  void* pool;                   // [N, L + R]
  void* q_out;                  // [T, H, R] contiguous
  const void* q_pe;             // [T, H, R], strides q_st, q_sh
  const void* c_kv;             // [T, L], row stride c_st
  const void* k_pe;             // [T, R], row stride k_st
  const float* cos_f;           // [T, R] fp32
  const float* sin_f;
  const int32_t* slots;         // [T]
  long long q_st, q_sh, c_st, k_st, N;
  int T, H, L, R, neox;
};

template <class T>
__global__ void __launch_bounds__(256) rows_2d_rope_kernel(const RopeParams p) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int per_tok = p.H + 1;
  if (row >= (long long)p.T * per_tok) return;  // whole warps
  const int t = (int)(row / per_tok);
  const int j = (int)(row - (long long)t * per_tok);
  const int R = p.R;
  const bool active = lane < R / 8;
  const float* cs = p.cos_f + (long long)t * R;
  const float* sn = p.sin_f + (long long)t * R;
  float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const T* src = j < p.H ? static_cast<const T*>(p.q_pe) + t * p.q_st + j * p.q_sh
                        : static_cast<const T*>(p.k_pe) + t * p.k_st;
  if (active) zt_rope::load8(src + 8 * lane, x);
  zt_rope::rope8(x, cs, sn, lane, R, p.neox);
  if (j < p.H) {  // a query head's rope row
    if (active)
      *reinterpret_cast<uint4*>(static_cast<T*>(p.q_out) + ((long long)t * p.H + j) * R +
                                8 * lane) = zt_rope::pack8<T>(x);
    return;
  }
  const int slot = p.slots[t];  // the token's latent row
  if (slot < 0 || slot >= p.N) return;
  T* dst = static_cast<T*>(p.pool) + (long long)slot * (p.L + R);
  if (active) *reinterpret_cast<uint4*>(dst + p.L + 8 * lane) = zt_rope::pack8<T>(x);
  const uint4* c = reinterpret_cast<const uint4*>(static_cast<const T*>(p.c_kv) + t * p.c_st);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = lane; i < p.L / 8; i += 32) d[i] = c[i];
}

template <typename V>
int launch_copy(void* pool, const void* rows, const void* slots, int T, long long N,
                int row_bytes, cudaStream_t stream) {
  rows_2d_copy_kernel<V><<<(T + 7) / 8, 256, 0, stream>>>(
      (V*)pool, (const V*)rows, (const int32_t*)slots, T, N, row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

}  // namespace

// The plain row write. row_bytes: bytes of one row, X * element size. pool
// and rows must be aligned to the vector width chosen: the largest power of
// two up to 16 that divides row_bytes and both addresses. Returns the CUDA
// error code of the launch.
extern "C" int zt_write_rows_2d(void* pool, const void* rows, const void* slots,
                                int T, long long N, int row_bytes, void* stream) {
  if (T == 0 || row_bytes == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t bits = (uintptr_t)pool | (uintptr_t)rows | (uintptr_t)row_bytes;
  if (bits % 16 == 0) return launch_copy<uint4>(pool, rows, slots, T, N, row_bytes, st);
  if (bits % 8 == 0) return launch_copy<uint2>(pool, rows, slots, T, N, row_bytes, st);
  if (bits % 4 == 0) return launch_copy<uint32_t>(pool, rows, slots, T, N, row_bytes, st);
  if (bits % 2 == 0) return launch_copy<uint16_t>(pool, rows, slots, T, N, row_bytes, st);
  return launch_copy<uint8_t>(pool, rows, slots, T, N, row_bytes, st);
}

// The prologue, bf16 throughout (fp16 with fp16 != 0). q_pe [T, H, R] (strides q_st, q_sh), c_kv
// [T, L] (row stride c_st), k_pe [T, R] (row stride k_st), unit last
// strides, every row 16-byte aligned; q_out [T, H, R] contiguous; cos_f,
// sin_f fp32 [T, R] contiguous; pool [N, L + R]. L % 8 == 0, R % 16 == 0,
// R <= 256. Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_rope_write_rows_2d(
    void* pool, void* q_out, const void* q_pe, const void* c_kv, const void* k_pe,
    const void* cos_f, const void* sin_f, const void* slots, int T, int H, int L, int R,
    long long N, long long q_st, long long q_sh, long long c_st, long long k_st, int neox,
    int fp16, void* stream) {
  if (R % 16 != 0 || R > 256 || R <= 0 || L % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)T * (H + 1);
  if (warps == 0) return 0;
  RopeParams p{};
  p.pool = pool;
  p.q_out = q_out;
  p.q_pe = q_pe;
  p.c_kv = c_kv;
  p.k_pe = k_pe;
  p.cos_f = static_cast<const float*>(cos_f);
  p.sin_f = static_cast<const float*>(sin_f);
  p.slots = static_cast<const int32_t*>(slots);
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.c_st = c_st;
  p.k_st = k_st;
  p.N = N;
  p.T = T;
  p.H = H;
  p.L = L;
  p.R = R;
  p.neox = neox;
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  if (fp16) rows_2d_rope_kernel<__half><<<blocks, 256, 0, (cudaStream_t)stream>>>(p);
  else rows_2d_rope_kernel<__nv_bfloat16><<<blocks, 256, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
