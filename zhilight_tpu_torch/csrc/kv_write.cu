// Paged KV-pool row writes into the head-major packed pool.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py write_rows_hm (:606), whose
// Pallas kernels are _rmw_decode_kernel_hm (:499, decode: read-modify-write
// of an 8-row block per token) and _page_write_kernel_hm (:537, prefill:
// page-run DMA writes that assume page-aligned runs).
//
// Computes: pool[h, slot[t], :D] = k[t, h, :] and pool[h, slot[t], D:] =
// v[t, h, :] for every token t with 0 <= slot[t] < N. The pool is
// [Hkv, N, 2D]; k and v are token-major [T, Hkv, D]. This is the general
// per-row scatter of the XLA path (kvcache/paged.py:305-308), so a chunk that
// starts mid-page needs no page-aligned contract.
//
// Bound on the H100: bytes. The function reads 2*T*Hkv*D elements and writes
// as many; a decode step at B=16 with 36 heads and D=64 moves 295 KB, well
// under a microsecond at 3.35 TB/s, so launch latency sets its time. Design:
// one block per token, each thread copies 16-byte vectors straight from k and
// v into the pool row (no XLA-side concat or transpose, no read-modify-write:
// the GPU writes single rows, where the TPU had to move tile-aligned blocks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) write_rows_hm_kernel(
    uint4* __restrict__ pool,          // [H, N, 2 * vec] in 16-byte vectors
    const uint4* __restrict__ k,       // [T, H, vec]
    const uint4* __restrict__ v,       // [T, H, vec]
    const int32_t* __restrict__ slots, // [T]
    int H, long long N, int vec) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= N) return;  // skipped row (or out of the pool)
  const int per_head = 2 * vec;
  for (int i = threadIdx.x; i < H * per_head; i += blockDim.x) {
    const int h = i / per_head;
    const int c = i - h * per_head;
    const long long src = ((long long)t * H + h) * vec;
    const uint4 val = c < vec ? k[src + c] : v[src + c - vec];
    pool[((long long)h * N + slot) * per_head + c] = val;
  }
}

}  // namespace

// row_bytes: bytes of one head's K (or V) row, D * element size; must be a
// multiple of 16. Returns the CUDA error code of the launch (0 = success).
extern "C" int zt_write_rows_hm(void* pool, const void* k, const void* v,
                                const void* slots, int T, int H, long long N,
                                int row_bytes, void* stream) {
  if (T == 0) return 0;
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  write_rows_hm_kernel<<<T, 256, 0, (cudaStream_t)stream>>>(
      (uint4*)pool, (const uint4*)k, (const uint4*)v, (const int32_t*)slots, H,
      N, row_bytes / 16);
  return (int)cudaGetLastError();
}
