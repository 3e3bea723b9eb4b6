// Fused decode: write this step's K and V rows into the slot-major bf16 (or
// fp16) pool and attend over the whole context, in one launch per layer.
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_fused (:644), kernel _kernel_bs_fused (:445), in its
// two-pool mode (K and V pools [N, Hkv, D]) and its packed single-pool mode
// ([N, Hkv, 2D], K lanes [:D], V lanes [D:]). The latent mode of the same TPU
// kernel (paged_mla_decode_fused :844) is in mla_decode.cu.
//
// Computes, with context_lens[b] = ctx counting this step's token:
//   out[b, h] = softmax over {pool tokens t < ctx - 1 (and t >= ctx - window
//               under a window)} and the new token of scale * q . K, times V,
// the new token's K and V coming from k_new / v_new; then, when
// slot_mapping[b] >= 0 and ctx >= 1, k_new and v_new are stored at row
// slot_mapping[b]. A frozen slot (slot < 0) still attends to its new row; an
// empty one (ctx == 0) gives v_new. fp32 scores, probabilities and sums;
// nothing is rounded before the output.
//
// Bound on the H100: bytes, those of the unfused decode (paged_attention.cu)
// plus the rows written: 76.0 MB per layer at H2O-Danube-1.8B's batch 8,
// context 3712, 8 KV heads of 80 (22.7 us at 3.35 TB/s). The TPU kernel's
// page fetches, its read-modify-write of the new row's page and its flat
// write-back view are how a TPU moves rows; here the block that owns (b, KV
// head, split 0, head group 0) stores the row directly. Design: the decode
// template of paged_decode.cuh with its FUSED flag (header there): row ctx - 1
// is never read (the tile's row there gets zeros and a mask), so no block
// reads the row another block writes, and the new token's column is folded
// in once per query head by the block that writes the output, the splits'
// ticket merge included.

#include "paged_decode.cuh"

// Supported: bf16 q [B, Hkv * G, D] (all of q, the pools and the new rows
// fp16 with fp16 != 0); bf16 pools whose (slot, KV head) rows are
// rs elements apart (rs = D: separate K and V pools; rs = 2 * D: the packed
// pool, v_pool = k_pool + D), 1 <= D <= 256, any G; bf16 k_new, v_new
// [B, Hkv, D]; int32 slot_mapping [B] (< 0: no write). Splits, partials and
// tickets as in paged_attention.cu. Returns the CUDA error code of the launch.
extern "C" int zt_paged_decode_attention_fused(
    void* out, void* part_acc, void* part_ml, void* tickets, const void* q, void* k_pool,
    void* v_pool, const void* k_new, const void* v_new, const void* slot_mapping,
    const void* page_tables, const void* context_lens, int B, int Hkv, int G, int D, long long rs,
    long long N, int maxp, int S, float scale, int window, int splits, int fp16,
    void* stream) {
  using zt_paged::bf16;
  const zt_paged::FusedRows fz{k_new, v_new, (const int32_t*)slot_mapping, k_pool, v_pool};
  return (fp16 ? zt_paged::dispatch<__half, __half, true>
               : zt_paged::dispatch<bf16, bf16, true>)(
      out, part_acc, part_ml, tickets, q, k_pool, v_pool, nullptr, nullptr, page_tables,
      context_lens, fz, B, Hkv, G, D, rs, N, 0, maxp, S, scale, window, splits,
      (cudaStream_t)stream);
}

// Blocks of the head-dim-D kernel one SM holds at once. Returns the CUDA error code.
extern "C" int zt_paged_decode_attention_fused_blocks_per_sm(int D, int* blocks) {
  return zt_paged::blocks_per_sm<zt_paged::bf16, true>(D, blocks);
}
