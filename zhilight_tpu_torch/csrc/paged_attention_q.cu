// Paged decode attention over separate slot-major int8 K and V pools with
// fp32 scales per (token, KV head).
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_q (:971), kernel _kernel_bs_q (:884). The TPU kernel
// dequantizes each fetched page in fp32; here the K scale multiplies the fp32
// score and the V scale the fp32 probability, and no element of K or V is
// multiplied by its scale (as csrc/attn_headmajor_q.cu does for the packed
// pool). What it computes, its bound and its design are in paged_decode.cuh,
// which it shares with paged_attention.cu.

#include "paged_decode.cuh"

// Supported: bf16 q [B, Hkv * G, D], int8 pools [N, Hkv, D] with D <= 256, any
// G; fp32 scales [Hkv, scale_stride >= N], one row stride for both. Scratch
// as in paged_attention.cu. Returns the CUDA error code of the launches.
extern "C" int zt_paged_decode_attention_q(void* out, void* part_acc, void* part_ml,
                                           const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scales,
                                           const void* v_scales, const void* page_tables,
                                           const void* context_lens, int B, int Hkv, int G,
                                           int D, long long N, long long scale_stride,
                                           int maxp, int S, float scale, int window,
                                           int target_blocks, int max_splits, void* stream) {
  return zt_paged::dispatch<int8_t, false>(
      out, part_acc, part_ml, q, k_pool, v_pool, k_scales, v_scales, page_tables,
      context_lens, zt_paged::FusedRows{}, B, Hkv, G, D, D, N, scale_stride, maxp, S, scale,
      window, target_blocks, max_splits, (cudaStream_t)stream);
}
