// Paged decode attention over separate slot-major bf16 K and V pools.
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py paged_decode_attention
// (:364), kernels _kernel (:48) and _kernel_bs (:179, through
// _paged_decode_blockspec :293). The two TPU kernels differ only in how they
// fetch pages; this is one kernel. What it computes, its bound and its design
// are in paged_decode.cuh, which it shares with paged_attention_q.cu.

#include "paged_decode.cuh"

// Supported: bf16 q [B, Hkv * G, D] and pools [N, Hkv, D] with D <= 256, any
// G. part_acc fp32 [B, Hkv * G, max_splits, D] and part_ml fp32
// [B, Hkv * G, max_splits, 2] are scratch for the context ranges, whose count
// (at most max_splits) the kernel picks to reach target_blocks blocks. Returns
// the CUDA error code of the launches (0 = success).
extern "C" int zt_paged_decode_attention(void* out, void* part_acc, void* part_ml,
                                         const void* q, const void* k_pool,
                                         const void* v_pool, const void* page_tables,
                                         const void* context_lens, int B, int Hkv, int G,
                                         int D, long long N, int maxp, int S, float scale,
                                         int window, int target_blocks, int max_splits,
                                         void* stream) {
  return zt_paged::dispatch<zt_paged::bf16, false>(
      out, part_acc, part_ml, q, k_pool, v_pool, nullptr, nullptr, page_tables, context_lens,
      zt_paged::FusedRows{}, B, Hkv, G, D, D, N, 0, maxp, S, scale, window, target_blocks,
      max_splits, (cudaStream_t)stream);
}
