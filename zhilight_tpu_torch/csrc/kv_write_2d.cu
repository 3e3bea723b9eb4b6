// Row writes into a 2-D pool (the MLA latent pool).
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py write_rows_2d (:324), whose
// Pallas kernels are _rmw_decode_kernel_2d (decode: read-modify-write of an
// aligned row block per token) and _page_write_kernel_2d (prefill: page-run
// writes merged through a staging page).
//
// Computes: pool[slot[t], :] = rows[t, :] for every t with 0 <= slot[t] < N;
// the pool is [N, X], rows are [T, X] in the pool's element type. A row goes to
// any slot of any page, so a chunk may start mid-page.
//
// Bound on the H100: bytes. T rows of X elements are read once and written
// once; a DeepSeek-V2-Lite decode step (8 rows of 576 bf16) moves 18 KB and a
// 512-token chunk 1.2 MB (0.35 us at 3.35 TB/s), so launch latency sets the
// time. Design: one block per row, each thread copies vectors of the widest
// width (16, 8, 4, 2 or 1 bytes) that divides the row's bytes; the GPU writes
// single rows in place, where the TPU had to move tile-aligned blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(128) write_rows_2d_kernel(
    V* __restrict__ pool,              // [N, vec]
    const V* __restrict__ rows,        // [T, vec]
    const int32_t* __restrict__ slots, // [T]
    long long N, int vec) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= N) return;  // skipped row (or out of the pool)
  const V* src = rows + (long long)t * vec;
  V* dst = pool + (long long)slot * vec;
  for (int i = threadIdx.x; i < vec; i += blockDim.x) dst[i] = src[i];
}

template <typename V>
int launch(void* pool, const void* rows, const void* slots, int T, long long N,
           int row_bytes, cudaStream_t stream) {
  write_rows_2d_kernel<V><<<T, 128, 0, stream>>>(
      (V*)pool, (const V*)rows, (const int32_t*)slots, N, row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

}  // namespace

// row_bytes: bytes of one row, X * element size. pool and rows must be aligned
// to the vector width chosen: the largest power of two up to 16 that divides
// row_bytes and both addresses. Returns the CUDA error code of the launch.
extern "C" int zt_write_rows_2d(void* pool, const void* rows, const void* slots,
                                int T, long long N, int row_bytes, void* stream) {
  if (T == 0 || row_bytes == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t bits = (uintptr_t)pool | (uintptr_t)rows | (uintptr_t)row_bytes;
  if (bits % 16 == 0) return launch<uint4>(pool, rows, slots, T, N, row_bytes, st);
  if (bits % 8 == 0) return launch<uint2>(pool, rows, slots, T, N, row_bytes, st);
  if (bits % 4 == 0) return launch<uint32_t>(pool, rows, slots, T, N, row_bytes, st);
  if (bits % 2 == 0) return launch<uint16_t>(pool, rows, slots, T, N, row_bytes, st);
  return launch<uint8_t>(pool, rows, slots, T, N, row_bytes, st);
}
