// End-of-window flush of the decode side buffers into the paged KV pools:
// every layer of a window in one launch, the int8 pool's requantization and
// scale scatter in the same kernel.
//
// Replaces: zhilight_tpu/ops/pallas/kv_write.py flush_side_rows_hm (:796,
// kernel _flush_side_kernel_hm :686) and flush_side_rows_2d (:929, kernel
// _flush_side_kernel_2d :848), with the page-run split of _side_page_runs
// (:668) computed per row on the device; together with what the reference
// leaves to XLA around them (zhilight_tpu/models/llama.py flush_window_rows
// :815-840): the loop over the layers and, over an int8 pool, the
// requantization of the side rows and the scatter of their scales.
//
// Computes, for each layer l < L, slot b and window row j < n_rows[b] (rows
// past n_rows, and every row of a slot whose n_rows is 0, are skipped):
//   pos  = entry_pos[b] + j
//   slot = max(page_tables[b, clamp(pos / S, 0, maxp - 1)], 0) * S + pos % S
//   copy mode:   pool_l[h, slot, :] = side[l, b, h, j, :]   for every h < H
//   int8 mode:   for each h and each half (K = [:D], V = [D:]) of the fp32
//                side row x: scale = max(absmax(x) * fp32(1/127), 1e-8),
//                codes = clamp(rint(x / scale), -127, 127) into the pool's
//                half, scale into that layer's head-major [H, N + 1] K or V
//                scale array at column slot
// The head-major packed pool is [H = Hkv, N, 2D] with side rows
// [L, B, Hkv, Kw, 2D] (bf16, fp16, or int8 codes already requantized in the
// copy mode; fp32 in the int8 mode); the latent pool is the same with H = 1:
// [1, N, X] and side rows [L, B, Kw, X]. The scale rule and rounding are those
// of the prologues (kv_write.cu) and of PyTorch on the card (kv_write.py
// quantize_rows): the absmax times the fp32 reciprocal of 127, each code a
// correctly rounded division, ties to even. Kw <= S, so a slot's rows fall in
// at most two pages, as the TPU kernel assumes; here the slot comes from the
// page table per row, so no page run is formed at all. Rows whose slot lies
// past the pool are skipped; a skipped row writes no scale (the reference
// drops them: .at[slots].set(mode="drop")).
//
// Layer l's pool (and its scale arrays) is at pools[l] (k_scales[l],
// v_scales[l]), a device table of addresses, or, with no table, at pool
// (k_scale, v_scale) for L = 1: the per-layer flush. Layer l's side rows
// start layer_stride bytes after layer l - 1's.
//
// Bound on the H100: bytes. B * Kw * H rows are read once and written once,
// in every layer: MiniCPM-2B's window (40 layers, B 16, Kw 8, 36 heads, rows
// of 256 bytes) moves 94.4 MB, 28 us at 3.35 TB/s; Qwen2.5-14B's int8 window
// (48 layers, B 8, Kw 8, 8 heads) reads 1 KB of fp32 and writes 264 bytes a
// row, 32 MB. A flush a layer moved at most 2.4 MB a launch (0.7 us), so the
// launch's fixed cost set its time, 40 or 48 times a window, and over an int8
// pool some 15 plain PyTorch launches a layer quantized the rows and scattered
// the scales. Design: one launch a window. Grid (window row, slot, layer),
// 128 threads a block; a block whose row is dead returns at once. The copy
// mode moves the widest vector (16, 8, 4, 2 or 1 bytes) that divides the
// row's bytes, every pool's and the side buffer's address and the layer
// stride. The int8 mode gives a warp each (head, half) row of D <= 256 fp32,
// four a lane in two float4 loads at most, the absmax from a warp reduction,
// and writes four codes a lane as one word. The slot is computed on the device
// from the page table, so the host neither builds a slot array nor waits for
// the device. The TPU kernel read and rewrote whole pages through VMEM (a
// selection-matrix dot shifted the rows into place); the GPU writes single
// rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Flush {
  void* pool;                    // layer 0's pool when pools is null
  const long long* pools;        // [L] pool addresses, or null
  float* k_scale;                // int8 mode: layer 0's [H, N + 1] scales when the tables are null
  float* v_scale;
  const long long* k_scales;     // [L] addresses, or null
  const long long* v_scales;
  const unsigned char* side;     // layer 0's side rows
  long long layer_stride;        // bytes between two layers' side rows
  const int32_t* entry_pos;      // [B]
  const int32_t* n_rows;         // [B]
  const int32_t* page_tables;    // [B, maxp]
  int H, Kw;
  long long N;
  int maxp, S;
  int vec;                       // copy mode: vectors a row; int8 mode: D
};

// the pool slot of window row j of slot b, or -1 for a dead or skipped row
__device__ __forceinline__ long long row_slot(const Flush& f, int b, int j) {
  if (j >= f.n_rows[b]) return -1;  // a dead row of the window (or an idle slot)
  const int pos = f.entry_pos[b] + j;
  const int pidx = min(max(pos / f.S, 0), f.maxp - 1);
  const long long page = max(f.page_tables[(long long)b * f.maxp + pidx], 0);
  const long long slot = page * f.S + pos % f.S;
  return slot < f.N ? slot : -1;
}

template <typename T>
__device__ __forceinline__ T* layer_ptr(void* one, const long long* table, int l) {
  return static_cast<T*>(table != nullptr ? reinterpret_cast<void*>(table[l]) : one);
}

template <typename V>
__global__ void __launch_bounds__(128) flush_copy_kernel(const Flush f) {
  const int j = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const long long slot = row_slot(f, b, j);
  if (slot < 0) return;
  V* pool = layer_ptr<V>(f.pool, f.pools, l);
  const V* side = reinterpret_cast<const V*>(f.side + l * f.layer_stride);
  const int vec = f.vec;
  for (int i = threadIdx.x; i < f.H * vec; i += blockDim.x) {
    const int h = i / vec;
    const int c = i - h * vec;
    pool[((long long)h * f.N + slot) * vec + c] =
        side[(((long long)b * f.H + h) * f.Kw + j) * vec + c];
  }
}

__global__ void __launch_bounds__(128) flush_int8_kernel(const Flush f) {
  const int j = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const long long slot = row_slot(f, b, j);
  if (slot < 0) return;
  int8_t* pool = layer_ptr<int8_t>(f.pool, f.pools, l);
  float* ks = layer_ptr<float>(f.k_scale, f.k_scales, l);
  float* vs = layer_ptr<float>(f.v_scale, f.v_scales, l);
  const float* side = reinterpret_cast<const float*>(f.side + l * f.layer_stride);
  const int D = f.vec, V4 = D / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 2 * f.H; r += blockDim.x / 32) {  // (head, half) rows, warp-uniform
    const int h = r >> 1, half = r & 1;
    const float4* src = reinterpret_cast<const float4*>(
        side + (((long long)b * f.H + h) * f.Kw + j) * 2 * D + half * D);
    float4 x[2];
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = lane + 32 * k;
      x[k] = c < V4 ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(x[k].x), fabsf(x[k].y)), fmaxf(fabsf(x[k].z), fabsf(x[k].w))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    constexpr float kInv127 = 1.0f / 127.0f;
    const float s = fmaxf(__fmul_rn(m, kInv127), 1e-8f);
    const auto code = [s](float v) {
      return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
    };
    uint32_t* dst = reinterpret_cast<uint32_t*>(pool + ((long long)h * f.N + slot) * 2 * D +
                                                half * D);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = lane + 32 * k;
      if (c < V4)
        dst[c] = code(x[k].x) | code(x[k].y) << 8 | code(x[k].z) << 16 | code(x[k].w) << 24;
    }
    if (lane == 0) (half ? vs : ks)[(long long)h * (f.N + 1) + slot] = s;
  }
}

template <typename V>
int launch_copy(const Flush& f, int L, int B, int row_bytes, cudaStream_t stream) {
  Flush g = f;
  g.vec = row_bytes / (int)sizeof(V);
  flush_copy_kernel<V><<<dim3(f.Kw, B, L), 128, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Flushes L layers' window rows in one launch. pool / pools: layer 0's pool
// [H, N, row_bytes], or a device table int64 [L] of the L pools' addresses
// (then pool is unused); side: layer 0's rows [B, H, Kw, .] and each next
// layer's layer_stride bytes on; entry_pos, n_rows int32 [B], page_tables
// int32 [B, maxp]. Copy mode (int8 == 0): side rows of the pool's type,
// row_bytes a row. Int8 mode: int8 pools [H, N, 2D] (row_bytes = 2D, D a
// multiple of 4 up to 256, pool rows 4-byte aligned), fp32 side rows of 2D,
// 16-byte aligned, and the fp32 [H, N + 1] K and V scale arrays: k_scale,
// v_scale, or the device tables k_scales, v_scales int64 [L] with pools.
// ptr_bits: every pool address ORed together (the host holds them), for the
// copy mode's vector width. Returns the CUDA error code of the launch.
extern "C" int zt_flush_side_rows(void* pool, const void* pools, float* k_scale, float* v_scale,
                                  const void* k_scales, const void* v_scales, const void* side,
                                  long long layer_stride, const void* entry_pos,
                                  const void* n_rows, const void* page_tables, int L, int B,
                                  int H, int Kw, long long N, int maxp, int S, int row_bytes,
                                  long long ptr_bits, int int8, void* stream) {
  if (L == 0 || B == 0 || Kw == 0 || row_bytes == 0 || H == 0) return 0;
  if (Kw > S || maxp < 1 || L > 65535 || B > 65535 || (pools == nullptr && L != 1))
    return (int)cudaErrorInvalidValue;
  Flush f{};
  f.pool = pool;
  f.pools = static_cast<const long long*>(pools);
  f.k_scale = k_scale;
  f.v_scale = v_scale;
  f.k_scales = static_cast<const long long*>(k_scales);
  f.v_scales = static_cast<const long long*>(v_scales);
  f.side = static_cast<const unsigned char*>(side);
  f.layer_stride = layer_stride;
  f.entry_pos = static_cast<const int32_t*>(entry_pos);
  f.n_rows = static_cast<const int32_t*>(n_rows);
  f.page_tables = static_cast<const int32_t*>(page_tables);
  f.H = H;
  f.Kw = Kw;
  f.N = N;
  f.maxp = maxp;
  f.S = S;
  cudaStream_t st = (cudaStream_t)stream;
  if (int8) {
    const int D = row_bytes / 2;
    const bool tables = pools != nullptr;
    if (row_bytes % 8 || D > 256 || (uintptr_t)side % 16 || layer_stride % 16 || ptr_bits % 4 ||
        (tables ? (k_scales == nullptr || v_scales == nullptr)
                : (k_scale == nullptr || v_scale == nullptr)))
      return (int)cudaErrorInvalidValue;
    f.vec = D;
    flush_int8_kernel<<<dim3(Kw, B, L), 128, 0, st>>>(f);
    return (int)cudaGetLastError();
  }
  const unsigned long long bits = (unsigned long long)ptr_bits | (uintptr_t)side |
                                  (unsigned long long)row_bytes |
                                  (unsigned long long)layer_stride;
  if (bits % 16 == 0) return launch_copy<uint4>(f, L, B, row_bytes, st);
  if (bits % 8 == 0) return launch_copy<uint2>(f, L, B, row_bytes, st);
  if (bits % 4 == 0) return launch_copy<uint32_t>(f, L, B, row_bytes, st);
  if (bits % 2 == 0) return launch_copy<uint16_t>(f, L, B, row_bytes, st);
  return launch_copy<uint8_t>(f, L, B, row_bytes, st);
}
