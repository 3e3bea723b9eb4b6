// Paged decode attention over separate slot-major int8 K and V pools with
// fp32 scales per (token, KV head).
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_q (:971), kernel _kernel_bs_q (:884). The TPU kernel
// dequantizes each fetched page in fp32; here no element of K or V is
// multiplied by its scale: an int8 element converts to bf16 exactly, the K
// scale multiplies the fp32 score and the V scale the fp32 probability, whose
// product goes into P . V split into two bf16 halves, so nothing is rounded
// (as csrc/attn_headmajor_q.cu does for the packed pool, which rounds that
// product once, as its TPU kernel does). What it computes, its bound (bytes),
// its design and what holds it back are in paged_decode.cuh, which it shares
// with paged_attention.cu and paged_attention_fused.cu.

#include "paged_decode.cuh"

// Supported: bf16 q [B, Hkv * G, D] (fp16 with fp16 != 0), int8 pools
// [N, Hkv, D] with 1 <= D <= 256, any G, any page size; fp32 scales
// [Hkv, scale_stride >= N], one row stride for both. Splits, partials and tickets as in paged_attention.cu.
// Returns the CUDA error code of the launch.
extern "C" int zt_paged_decode_attention_q(void* out, void* part_acc, void* part_ml,
                                           void* tickets, const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scales,
                                           const void* v_scales, const void* page_tables,
                                           const void* context_lens, int B, int Hkv, int G,
                                           int D, long long N, long long scale_stride, int maxp,
                                           int S, float scale, int window, int splits,
                                           int fp16, void* stream) {
  return (fp16 ? zt_paged::dispatch<int8_t, __half, false>
               : zt_paged::dispatch<int8_t, zt_paged::bf16, false>)(
      out, part_acc, part_ml, tickets, q, k_pool, v_pool, k_scales, v_scales, page_tables,
      context_lens, zt_paged::FusedRows{}, B, Hkv, G, D, D, N, scale_stride, maxp, S, scale,
      window, splits, (cudaStream_t)stream);
}

// Blocks of the head-dim-D kernel one SM holds at once. Returns the CUDA error code.
extern "C" int zt_paged_decode_attention_q_blocks_per_sm(int D, int* blocks) {
  return zt_paged::blocks_per_sm<int8_t, false>(D, blocks);
}
