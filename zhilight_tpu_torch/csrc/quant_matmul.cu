// W4A16 matmul: y = x . ((w - zero_g) * scale_g), groupwise int4 weights.
//
// Replaces: zhilight_tpu/ops/pallas/quant_matmul.py w4a16_matmul (:242), its
// kernels _w4a16_packed_kernel (:73) via _w4a16_packed (:137) and
// _w4a16_kernel (:27).
//
// Computes, for x bf16 [M, K] and groups of gs = K / G consecutive rows:
//   y[m, n] = sum_k x[m, k] * bf16((q[k, n] - zeros[k / gs, n]) * scales[k / gs, n])
// with fp32 accumulation, y rounded to bf16. Two weight formats:
//   planar  uint8 [K/2, N]: byte (r, n) holds q[r, n] in its low nibble and
//           q[r + K/2, n] XOR 8 in its high nibble (ops/quant.pack_int4);
//   nibbles int8 [K, N], one value 0..15 per byte.
// The dequantized tile is rounded to bf16 exactly as the plain version's
// dequant_int4 (fp32 (q - z) * s, then one round to nearest even).
//
// Bound on the H100. Decode (M <= 16) is bound by bytes: the K*N/2 packed
// bytes plus 8 bytes of f32 scale and zero per group column (about 12% more
// at gs 128); 5120 x 13824 takes 12 us at 3.35 TB/s. A 512-row prefill chunk
// is bound by operations: 2*M*K*N = 72.5 GFLOP for the same weight, 73 us at
// 989 TFLOP/s. Design, simple first: one block per (BM x BN) output tile
// walks K in tiles. Each thread loads 8 packed bytes (8 columns) of a few
// weight rows and 16-byte chunks of x for the next tile into registers while
// the tensor cores work on the current one (a register double buffer). At
// store time the bytes are dequantized into a bf16 tile in shared memory;
// each thread keeps the f32 scales and zeros of its 8 columns in registers
// and reloads them only when its rows enter a new group. WMMA 16x16x16
// bf16 -> fp32 multiplies the x tile by the weight tile. Ragged M, N and K
// are masked in the kernel. Two shapes: M <= 16 takes 16 x 64 output tiles
// over 256-deep K tiles (more blocks and more bytes in flight per block for
// the bandwidth-bound case); larger M takes 64 x 128 tiles over 64-deep K
// tiles. No split-K, no TMA, no wgmma yet: at decode, N/64 blocks (16 for
// the 1024-wide k/v projections) cannot fill 132 SMs. The tile loop itself is
// in w4a16_tile.cuh, which csrc/quant_ragged.cu shares.

#include "w4a16_tile.cuh"

namespace {

using namespace w4a16;

template <class C>
__global__ void __launch_bounds__(C::NT) w4a16_kernel(
    bf16* __restrict__ out,             // [M, N]
    const bf16* __restrict__ x,         // [M, K]
    const uint8_t* __restrict__ w,      // [K/2, N] planar or [K, N] nibbles
    const float* __restrict__ scales,   // [G, N]
    const float* __restrict__ zeros,    // [G, N]
    int M, int N, int K, int gs) {
  tile<C>(out, x, w, scales, zeros, M, N, K, gs, blockIdx.y * C::BM, blockIdx.x * C::BN);
}

template <class C>
int launch(void* out, const void* x, const void* w, const void* scales, const void* zeros,
           int M, int N, int K, int gs, cudaStream_t stream) {
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  w4a16_kernel<C><<<grid, C::NT, 0, stream>>>(
      (bf16*)out, (const bf16*)x, (const uint8_t*)w, (const float*)scales,
      (const float*)zeros, M, N, K, gs);
  return (int)cudaGetLastError();
}

template <bool PLANAR>
int dispatch(void* out, const void* x, const void* w, const void* scales, const void* zeros,
             int M, int N, int K, int gs, cudaStream_t stream) {
  if (M <= 16)
    return launch<Cfg<16, 64, 256, 1, 4, PLANAR>>(out, x, w, scales, zeros, M, N, K, gs, stream);
  return launch<Cfg<64, 128, 64, 2, 4, PLANAR>>(out, x, w, scales, zeros, M, N, K, gs, stream);
}

}  // namespace

// Supported (the wrapper checks): bf16 x [M, K] and out [M, N]; f32 scales
// and zeros [G, N] with K % G == 0; N % 8 == 0; K % 8 == 0 (nibbles) or
// (K/2) % 8 == 0 (planar); x, out, scales and zeros 16-byte aligned, w 8.
extern "C" int zt_w4a16_matmul(void* out, const void* x, const void* w, const void* scales,
                               const void* zeros, int M, int N, int K, int G, int planar,
                               void* stream) {
  if (M == 0 || N == 0) return 0;
  if (G <= 0 || K % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int gs = K / G;
  if (planar) return dispatch<true>(out, x, w, scales, zeros, M, N, K, gs, st);
  return dispatch<false>(out, x, w, scales, zeros, M, N, K, gs, st);
}
