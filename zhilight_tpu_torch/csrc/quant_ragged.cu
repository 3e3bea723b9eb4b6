// W4A16 grouped (ragged) matmul over a stack of expert weights.
//
// Replaces: zhilight_tpu/ops/pallas/quant_ragged.py w4a16_ragged_matmul
// (:142), kernel _kernel_ragged_w4 (:91).
//
// Computes, for group-aligned rows x bf16 [Mp, K] cut into m-tiles of TM rows
// (ops/quant.ragged_layout: every m-tile belongs to one expert), for each
// m-tile i < num_occ[0] with e = tile_expert[i]:
//   y[i*TM + r, n] = sum_k x[i*TM + r, k] *
//                    bf16((q_e[k, n] - zeros[e, k / gs, n]) * scales[e, k / gs, n])
// with fp32 accumulation, y rounded to bf16; q_e is expert e's [K/2, N] block
// of the planar uint8 stack (low nibbles rows [0, K/2), high nibbles rows
// [K/2, K) stored XOR 8). Rows of tiles >= num_occ[0] are not written. The
// dequantized tile is rounded to bf16 once, as in w4a16_matmul, so a zero-scale
// pad group contributes exact zeros.
//
// Bound on the H100. Decode (48 rows over up to 48 experts, TM 8) is bound by
// bytes: each routed expert's K*N/2 packed bytes are read once, 69 MB for 48
// experts of 2048 x 1408 (21 us at 3.35 TB/s). A 512-token chunk (3072 rows,
// TM 64, all 64 experts) is bound by operations, 2*Mp*K*N. Design: the grid is
// the static worst case (N / BN, Mp / TM); num_occ and tile_expert are read on
// the device, blocks of unoccupied tiles exit at once, and no count comes back
// to the host. A block computes one (TM x BN) output tile with the tile loop of
// w4a16_tile.cuh (the one w4a16_matmul runs), offset to its expert's weights,
// scales and zeros. TM <= 16 takes the 16 x 64 tile over 256-deep K tiles,
// TM <= 64 the 64 x 128 tile; consecutive m-tiles of one expert find its
// weights in the L2 cache.

#include "w4a16_tile.cuh"

namespace {

using namespace w4a16;

template <class C>
__global__ void __launch_bounds__(C::NT) w4a16_ragged_kernel(
    bf16* __restrict__ out,                  // [Mp, N]
    const bf16* __restrict__ x,              // [Mp, K]
    const uint8_t* __restrict__ w,           // [E, K/2, N] planar
    const float* __restrict__ scales,        // [E, G, N]
    const float* __restrict__ zeros,         // [E, G, N]
    const int32_t* __restrict__ tile_expert, // [Mp / TM]
    const int32_t* __restrict__ num_occ,     // [1]
    int E, int TM, int N, int K, int G) {
  const int i = blockIdx.y;
  if (i >= num_occ[0]) return;
  int e = tile_expert[i];
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  const long long wo = (long long)e * (K / 2) * N;
  const long long so = (long long)e * G * N;
  tile<C>(out, x, w + wo, scales + so, zeros + so, (i + 1) * TM, N, K, K / G, i * TM,
          blockIdx.x * C::BN);
}

template <class C>
int launch(void* out, const void* x, const void* w, const void* scales, const void* zeros,
           const void* tile_expert, const void* num_occ, int tiles, int E, int TM, int N,
           int K, int G, cudaStream_t stream) {
  const dim3 grid((N + C::BN - 1) / C::BN, tiles);
  w4a16_ragged_kernel<C><<<grid, C::NT, 0, stream>>>(
      (bf16*)out, (const bf16*)x, (const uint8_t*)w, (const float*)scales,
      (const float*)zeros, (const int32_t*)tile_expert, (const int32_t*)num_occ, E, TM, N, K,
      G);
  return (int)cudaGetLastError();
}

}  // namespace

// Supported (the wrapper checks): bf16 x [tiles * TM, K] and out
// [tiles * TM, N]; uint8 w [E, K/2, N]; f32 scales and zeros [E, G, N] with
// K % G == 0 and every group inside one nibble plane; N % 8 == 0,
// (K/2) % 8 == 0; TM in [1, 64]; tiles <= 65535; x, out, scales and zeros
// 16-byte aligned, w 8.
extern "C" int zt_w4a16_ragged_matmul(void* out, const void* x, const void* w,
                                      const void* scales, const void* zeros,
                                      const void* tile_expert, const void* num_occ,
                                      int tiles, int TM, int E, int N, int K, int G,
                                      void* stream) {
  if (tiles == 0 || N == 0) return 0;
  if (G <= 0 || K % G || E <= 0 || TM < 1 || TM > 64 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (TM <= 16)
    return launch<Cfg<16, 64, 256, 1, 4, true>>(out, x, w, scales, zeros, tile_expert, num_occ,
                                                tiles, E, TM, N, K, G, st);
  return launch<Cfg<64, 128, 64, 2, 4, true>>(out, x, w, scales, zeros, tile_expert, num_occ,
                                              tiles, E, TM, N, K, G, st);
}
