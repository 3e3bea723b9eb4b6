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
// [K/2, K) stored XOR 8). Rows of tiles >= num_occ[0] are not written. Each
// weight is dequantized to the bits of the plain version (fp32 (q - z) * s,
// one round to bf16), so a zero-scale pad group (the loader's K 1408 -> 1536)
// contributes exact zeros.
//
// Bound on the H100: bytes. Decode (DeepSeek-V2-Lite: 8 tokens x top 6 = 48
// rows over about 39 of 64 experts, TM 8) reads each routed expert's K*N/2
// packed bytes and 8*G*N bytes of scales and zeros once: 63.7 MB for the
// gate/up stack (2048 x 1408), 19 us at 3.35 TB/s. A 512-token chunk (3072
// rows, TM 64, every expert) reads the whole stack and the rows: 37 us.
//
// Design: row 4's kernels (w4a16.cuh, described in quant_matmul.cu) with
// RAGGED set: each block first offsets its operands to its m-tile's rows and
// its expert's weights, scales and zeros (Experts::select). The grid is the
// static worst case (N / BN column blocks, Mp / TM m-tiles, splits); num_occ
// and tile_expert are read on the device, blocks past num_occ[0] exit at
// once, and nothing is read back to the host.
// - TM <= 16 (decode) takes the decode kernel: 8 warps of 32 columns, each
//   dequantizing its weights in registers straight into mma.sync B
//   fragments with the exact 3-instruction form, its own ring of three
//   64-row cp.async stages (scales and zeros ride along when a stage enters a
//   new group), the m-tile's x slice staged once. K is split into runs of at
//   most 640 weight rows (the staged x slice): the gate/up stack's 1024
//   planar rows and the down stack's 768 take 2 splits; the partial tiles
//   and tickets are per (m-tile, column block), and the block drawing a
//   tile's last ticket sums the partials in split order (splitk.cuh).
// - TM in (16, 64] (prefill) takes the 64 x 128 prefill kernel: 32-row
//   stages in a ring of 3, each stage dequantized once a block into a bf16 B
//   tile one stage ahead of the ldmatrix + mma.sync products; one split.
// - An m-tile of 8 rows at decode often holds 1-2 routed rows (the caller
//   zero-fills the rest, and their outputs are never read): the m16 products
//   multiply zero rows, which costs arithmetic only, in a kernel bound by
//   bytes and instruction issue.
//
// What holds it back: as row 4's decode kernel, instruction issue (about 4.5
// instructions a weight) and a few microseconds of fixed cost a block
// (staging the x slice, the split merge), on top of which a decode step's
// ~39 experts x 6 column blocks x 2 splits run in about two waves of the two
// blocks an SM holds; the prefill kernel runs its copies, dequantization and
// products one after another (wgmma fed by TMA is the next step).

#include "w4a16.cuh"

// Supported (the wrapper checks): bf16 x [tiles * TM, K] and out
// [tiles * TM, N]; uint8 w [E, K/2, N] planar; f32 scales and zeros [E, G, N]
// with K % G == 0 and every group inside one nibble plane; N % 8 == 0,
// (K/2) % 8 == 0; TM in [1, 64]; tiles <= 65535; x, out, scales and zeros
// 16-byte aligned, w 8 (vec16 = 1 only when w is 16-byte aligned and N % 16
// == 0). cfg: 0 (the decode kernel, TM <= 16) or 1 (the 64 x 128 prefill
// kernel); splits cut the stages (64 weight rows in cfg 0, 32 in cfg 1) into
// that many non-empty runs of ceil(stages / splits), at most 640 rows a run
// in cfg 0; with splits > 1, part holds f32 [tiles, splits, TM, N] and tickets
// int32 [tiles * ceil(N / BN)] (BN 256 in cfg 0, 128 in cfg 1), zero before
// the launch and left zero.
extern "C" int zt_w4a16_ragged_matmul(void* out, const void* x, const void* w,
                                      const void* scales, const void* zeros,
                                      const void* tile_expert, const void* num_occ,
                                      float* part, int* tickets, int tiles, int TM, int E,
                                      int N, int K, int G, int cfg, int splits, int vec16,
                                      void* stream) {
  if (tiles == 0 || N == 0) return 0;
  if (G <= 0 || K % G || E <= 0 || TM < 1 || TM > 64 || tiles > 65535 || cfg < 0 || cfg > 1 ||
      (cfg == 0 && TM > 16))
    return (int)cudaErrorInvalidValue;
  const zt_w4a16::Experts ex{(const int32_t*)tile_expert, (const int32_t*)num_occ, E};
  return zt_w4a16::launch<true, true>(cfg, out, x, w, scales, zeros, part, tickets, TM, N, K, G,
                                      splits, vec16, tiles, ex, (cudaStream_t)stream);
}
