// End-of-window flush of the decode side buffer into the paged KV pool.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py flush_side_rows_hm (:796,
// kernel _flush_side_kernel_hm :686) and flush_side_rows_2d (:929, kernel
// _flush_side_kernel_2d :848), with the page-run split of _side_page_runs
// (:668) computed per row on the device.
//
// Computes, for each slot b and window row j < n_rows[b] (rows past n_rows,
// and every row of a slot whose n_rows is 0, are skipped):
//   pos  = entry_pos[b] + j
//   slot = max(page_tables[b, clamp(pos / S, 0, maxp - 1)], 0) * S + pos % S
//   pool[h, slot, :] = side[b, h, j, :]   for every h in [0, H)
// The head-major packed pool is [H = Hkv, N, 2D] with side rows
// [B, Hkv, Kw, 2D] (bf16, or int8 already requantized); the latent pool is
// the same with H = 1: [1, N, X] and side rows [B, Kw, X]. Kw <= S, so a
// slot's rows fall in at most two pages, as the TPU kernel assumes; here the
// slot comes from the page table per row, so no page run is formed at all.
// Rows whose slot lies past the pool are skipped.
//
// Bound on the H100: bytes. B * Kw * H rows are read once and written once:
// MiniCPM-2B's window (B 16, Kw 8, 36 heads, rows of 256 bytes) moves 2.4 MB
// (0.7 us at 3.35 TB/s), so launch latency sets the time. Design: one block
// per (window row, slot), each thread copying the widest vector (16, 8, 4, 2
// or 1 bytes) that divides the row's bytes and both base addresses, from the
// side buffer straight into the pool row. The slot is computed on the device
// from the page table, so the host neither builds a slot array nor waits for
// the device, and one launch writes a whole layer. The TPU kernel read and
// rewrote whole pages through VMEM (a selection-matrix dot shifted the rows
// into place); the GPU writes single rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(128) flush_side_kernel(
    V* __restrict__ pool,                     // [H, N, vec]
    const V* __restrict__ side,               // [B, H, Kw, vec]
    const int32_t* __restrict__ entry_pos,    // [B]
    const int32_t* __restrict__ n_rows,       // [B]
    const int32_t* __restrict__ page_tables,  // [B, maxp]
    int H, int Kw, long long N, int maxp, int S, int vec) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  if (j >= n_rows[b]) return;  // a dead row of the window (or an idle slot)
  const int pos = entry_pos[b] + j;
  const int pidx = min(max(pos / S, 0), maxp - 1);
  const long long page = max(page_tables[(long long)b * maxp + pidx], 0);
  const long long slot = page * S + pos % S;
  if (slot >= N) return;
  for (int i = threadIdx.x; i < H * vec; i += blockDim.x) {
    const int h = i / vec;
    const int c = i - h * vec;
    pool[((long long)h * N + slot) * vec + c] = side[(((long long)b * H + h) * Kw + j) * vec + c];
  }
}

template <typename V>
int launch(void* pool, const void* side, const void* entry_pos, const void* n_rows,
           const void* page_tables, int B, int H, int Kw, long long N, int maxp, int S,
           int row_bytes, cudaStream_t stream) {
  flush_side_kernel<V><<<dim3(Kw, B), 128, 0, stream>>>(
      (V*)pool, (const V*)side, (const int32_t*)entry_pos, (const int32_t*)n_rows,
      (const int32_t*)page_tables, H, Kw, N, maxp, S, row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

}  // namespace

// pool [H, N, row_bytes] and side [B, H, Kw, row_bytes] of one element type;
// entry_pos, n_rows int32 [B], page_tables int32 [B, maxp]. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int zt_flush_side_rows(void* pool, const void* side, const void* entry_pos,
                                  const void* n_rows, const void* page_tables, int B,
                                  int H, int Kw, long long N, int maxp, int S,
                                  int row_bytes, void* stream) {
  if (B == 0 || Kw == 0 || row_bytes == 0) return 0;
  if (Kw > S || maxp < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t bits = (uintptr_t)pool | (uintptr_t)side | (uintptr_t)row_bytes;
#define ZT_FLUSH(V) \
  launch<V>(pool, side, entry_pos, n_rows, page_tables, B, H, Kw, N, maxp, S, row_bytes, st)
  if (bits % 16 == 0) return ZT_FLUSH(uint4);
  if (bits % 8 == 0) return ZT_FLUSH(uint2);
  if (bits % 4 == 0) return ZT_FLUSH(uint32_t);
  if (bits % 2 == 0) return ZT_FLUSH(uint16_t);
  return ZT_FLUSH(uint8_t);
#undef ZT_FLUSH
}
