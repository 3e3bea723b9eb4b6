// W4A16 matmul: y = x . ((w - zero_g) * scale_g), groupwise int4 weights.
//
// Replaces: zhilight_tpu/ops/pallas/quant_matmul.py w4a16_matmul (:242), its
// kernels _w4a16_packed_kernel (:73) via _w4a16_packed (:137) and
// _w4a16_kernel (:27).
//
// Computes, for x bf16 [M, K] and groups of gs = K / G consecutive rows:
//   y[m, n] = sum_k x[m, k] * bf16((q[k, n] - zeros[k / gs, n]) * scales[k / gs, n])
// with fp32 accumulation, y rounded to bf16, or in the fp32-output mode
// (out_f32 = 1) stored unrounded as fp32: a tensor-parallel rank's partial
// product of a row-parallel projection, which the model all-reduces in fp32
// and rounds once (models/llama.py _reduce_linear). Only the epilogue's store
// type differs (splitk.cuh). Two weight formats:
//   planar  uint8 [K/2, N]: byte (r, n) holds q[r, n] in its low nibble and
//           q[r + K/2, n] XOR 8 in its high nibble (ops/quant.pack_int4);
//   nibbles int8 [K, N], one value 0..15 per byte.
// Each weight is dequantized to the bits of the plain version's dequant_int4:
// fp32 (q - z) * s, then one round to nearest even bf16.
//
// Bound on the H100 (bytes K*N/2 + 8*G*N + 2*M*K + 2*M*N against operations
// 2*M*K*N). Decode (M <= 16) is bound by bytes: Qwen2.5-14B's gate/up
// projection (K 5120, N 13824, gs 128) moves 39.8 MB, 12 us at 3.35 TB/s. A
// 512-row prefill chunk is bound by operations: 72.5 GFLOP, 73 us at the 989
// TFLOP/s dense bf16 rate (mma.sync peaks at about 575 TFLOP/s on the card).
//
// Design:
// - Exact and cheap dequantization: a nibble at bit p <= 12 of its 32-bit
//   word (the word itself, or >> 16 for its upper two bytes) is masked in
//   place into a float's mantissa, 2^23 + q * 2^p (one LOP3, the high
//   plane's XOR 8 included), minus C = 2^23 + z * 2^p, times s * 2^-p. When
//   z * 2^p is an integer in [0, 2^23) and s * 2^-p * 2^p == s (every
//   GPTQ/AWQ checkpoint), C is exact, the difference is exactly (q - z) * 2^p
//   and the product is fl((q - z) * s): three instructions a weight and half
//   a bf16 pack, against 5.5 for the direct form. A warp whose columns' group
//   fails that test takes the direct form (fp32 q - z, then * s); where a
//   stage can cross a group boundary (a group size, or K/2, that is not a
//   multiple of the stage's rows) each weight reads its own scale and zero
//   from memory.
// - Decode kernel (M <= 16): dequantized in registers straight into
//   mma.sync B fragments. A lane of group g = lane / 4, i = lane % 4 loads
//   the bytes of its 4 adjacent columns from weight rows j+2i, j+2i+1, j+8+2i,
//   j+9+2i of a 16-row step: exactly the k slots (2i, 2i+1, 2i+8, 2i+9) its B
//   fragment holds. Low nibbles make the fragment of x columns [r0 + j, +16),
//   high nibbles (planar) that of [K/2 + r0 + j, +16), so one byte feeds two
//   products; column t of the lane's run is B column g of n8-tile t, and the
//   epilogue writes the permuted columns back in place. 8 warps of 32 columns
//   each stream their own ring of three 64-row cp.async stages (the scales
//   and zeros ride along when a stage enters a new group) and wait only on
//   their own copies (__syncwarp): the loop has no block barrier. The block's
//   x slice (at most 640 weight rows, both planes, 8 or 16 rows of x) is
//   staged once. At most 128 registers, so two blocks share an SM.
// - Prefill kernel (M > 16): a classic mma.sync GEMM. A block of 2 x WN warps,
//   each with a 64-column run of BM / 2 rows (128 x 256 tiles over 8 warps
//   above M 64, 64 x 128 over 4 below), walks 32-row stages in a ring of 3;
//   each stage's raw bytes are dequantized once a block, by all threads, into
//   one of two bf16 B tiles in shared memory, one stage ahead of the products,
//   which read x and B through ldmatrix (.trans for B). One __syncthreads a
//   stage.
// - Split-K (both kernels): blockIdx.z takes whole stages [z * per, (z + 1) *
//   per), chosen on the host (ops/cuda/quant_matmul.py plan). Each block of a
//   split tile writes its fp32 partial tile, fences and takes a ticket from a
//   zeroed per-tile counter; the block drawing the last ticket sums the
//   partials in split order (the same bits on every call), writes y and
//   resets the counter (splitk.cuh): one launch a call, where a second
//   reduction kernel would add a launch to every projection of the
//   host-bound decode step.
//
// What holds them back (measured on the H100, PERF.md): decode is
// instruction-bound (the exact dequantization alone is about 4.5
// instructions a weight), with a few microseconds of fixed cost a block
// (staging x, the split merge); prefill runs its copies, its dequantization
// and its products one after another rather than overlapped (the products
// alone take 0.20 ms at M 512, 63% of the mma.sync peak): wgmma fed by TMA
// with a producer warp is the next step.

#include "w4a16.cuh"  // the kernels, shared with quant_ragged.cu

// Supported (the wrapper checks): bf16 x [M, K] and out [M, N]; f32 scales
// and zeros [G, N] with K % G == 0; N % 8 == 0; K % 8 == 0 (nibbles) or
// (K/2) % 8 == 0 (planar); x, out, scales and zeros 16-byte aligned, w 8
// (vec16 = 1 only when w is 16-byte aligned and N % 16 == 0). cfg picks the
// kernel (0: decode, M <= 16, 64-row stages, at most 640 weight rows a split;
// 1: prefill 64 x 128 tiles; 2: prefill 128 x 256; both 32-row stages);
// splits must cut the stages into that many non-empty runs of ceil(stages /
// splits); with splits > 1, part holds f32 [splits, M, N] and tickets int32
// [ceil(M / BM) * ceil(N / BN)] (BM x BN 16 x 256, 64 x 128, 128 x 256),
// zero before the launch and left zero. out_f32: out is f32 [M, N] (the
// fp32-output mode), else bf16.
template <class O>
static int matmul(void* out, const void* x, const void* w, const void* scales, const void* zeros,
                  float* part, int* tickets, int M, int N, int K, int G, int planar, int cfg,
                  int splits, int vec16, void* stream) {
  using zt_w4a16::Experts;
  cudaStream_t st = (cudaStream_t)stream;
  if (planar)
    return zt_w4a16::launch<true, false, O>(cfg, out, x, w, scales, zeros, part, tickets, M, N, K,
                                            G, splits, vec16, 0, Experts{}, st);
  return zt_w4a16::launch<false, false, O>(cfg, out, x, w, scales, zeros, part, tickets, M, N, K,
                                           G, splits, vec16, 0, Experts{}, st);
}

extern "C" int zt_w4a16_matmul(void* out, const void* x, const void* w, const void* scales,
                               const void* zeros, float* part, int* tickets, int M, int N, int K,
                               int G, int planar, int cfg, int splits, int vec16, int out_f32,
                               void* stream) {
  if (M == 0 || N == 0) return 0;
  if (G <= 0 || K % G) return (int)cudaErrorInvalidValue;
  return out_f32 ? matmul<float>(out, x, w, scales, zeros, part, tickets, M, N, K, G, planar, cfg,
                                 splits, vec16, stream)
                 : matmul<__nv_bfloat16>(out, x, w, scales, zeros, part, tickets, M, N, K, G,
                                         planar, cfg, splits, vec16, stream);
}
