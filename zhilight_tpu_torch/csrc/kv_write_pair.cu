// Row writes into separate slot-major K and V pools, both in one launch.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py paged_write_rows (:141;
// kernels _decode_kernel :41 and _prefill_kernel :63) and write_rows_2d_pair
// (:427; kernel _rmw_decode_kernel_2d_pair :378, its prefill form calling
// write_rows_2d twice). The TPU needed two kernels because Mosaic moves only
// tile-aligned row blocks (the second reads, merges and writes back whole
// pages); on the GPU they compute one thing, so both wrappers launch this.
//
// Computes: k_pool[slot[t], :] = k_rows[t, :] and v_pool[slot[t], :] =
// v_rows[t, :] for every t with 0 <= slot[t] < N, on the pools' 2-D views
// [N, Hkv * D] with rows [T, Hkv * D] in the pools' element type (bf16 rows,
// or the int8 rows of a quantized cache: the kernel moves bytes). A row goes
// to any slot of any page, so a chunk may start mid-page; a skipped row is
// dropped on the device, with no host sync.
//
// Bound on the H100: bytes. T rows of K and of V are read once and written
// once: a decode step of H2O-Danube-1.8B (8 rows of 8 x 80 bf16) moves 41 kB,
// a 512-token chunk 2.6 MB (0.78 us at 3.35 TB/s), so launch latency sets the
// time. Design: one block per row, each thread copies vectors of the widest
// width (16, 8, 4, 2 or 1 bytes) that divides the row's bytes and all four
// addresses; K first, then V.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(128) write_rows_pair_kernel(
    V* __restrict__ k_pool,            // [N, vec]
    V* __restrict__ v_pool,            // [N, vec]
    const V* __restrict__ k_rows,      // [T, vec]
    const V* __restrict__ v_rows,      // [T, vec]
    const int32_t* __restrict__ slots, // [T]
    long long N, int vec) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= N) return;  // skipped row (or out of the pool)
  const long long src = (long long)t * vec, dst = (long long)slot * vec;
  for (int i = threadIdx.x; i < 2 * vec; i += blockDim.x) {
    if (i < vec)
      k_pool[dst + i] = k_rows[src + i];
    else
      v_pool[dst + i - vec] = v_rows[src + i - vec];
  }
}

template <typename V>
int launch(void* k_pool, void* v_pool, const void* k_rows, const void* v_rows,
           const void* slots, int T, long long N, int row_bytes, cudaStream_t stream) {
  write_rows_pair_kernel<V><<<T, 128, 0, stream>>>(
      (V*)k_pool, (V*)v_pool, (const V*)k_rows, (const V*)v_rows, (const int32_t*)slots, N,
      row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

}  // namespace

// row_bytes: bytes of one token's row, Hkv * D * element size. Returns the
// CUDA error code of the launch (0 = success).
extern "C" int zt_write_rows_pair(void* k_pool, void* v_pool, const void* k_rows,
                                  const void* v_rows, const void* slots, int T, long long N,
                                  int row_bytes, void* stream) {
  if (T == 0 || row_bytes == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t bits = (uintptr_t)k_pool | (uintptr_t)v_pool | (uintptr_t)k_rows |
                         (uintptr_t)v_rows | (uintptr_t)row_bytes;
  if (bits % 16 == 0) return launch<uint4>(k_pool, v_pool, k_rows, v_rows, slots, T, N, row_bytes, st);
  if (bits % 8 == 0) return launch<uint2>(k_pool, v_pool, k_rows, v_rows, slots, T, N, row_bytes, st);
  if (bits % 4 == 0) return launch<uint32_t>(k_pool, v_pool, k_rows, v_rows, slots, T, N, row_bytes, st);
  if (bits % 2 == 0) return launch<uint16_t>(k_pool, v_pool, k_rows, v_rows, slots, T, N, row_bytes, st);
  return launch<uint8_t>(k_pool, v_pool, k_rows, v_rows, slots, T, N, row_bytes, st);
}
