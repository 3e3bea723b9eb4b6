// Paged decode attention over separate slot-major bf16 (or fp16) K and V pools.
//
// Replaces: zhilight_tpu/ops/pallas/paged_attention.py paged_decode_attention
// (:364), kernels _kernel (:48) and _kernel_bs (:179, through
// _paged_decode_blockspec :293). The two TPU kernels differ only in how they
// fetch pages; this is one kernel. What it computes, its bound (bytes), its
// design (split-context flash decoding on mma.sync, one launch), how p stays
// unrounded and what holds it back are in paged_decode.cuh, which it shares
// with paged_attention_q.cu and paged_attention_fused.cu.

#include "paged_decode.cuh"

// Supported: bf16 q [B, Hkv * G, D] and pools [N, Hkv, D] (fp16 with fp16 !=
// 0) with 1 <= D <= 256,
// any G, any page size S; 1 <= splits <= 64. With splits > 1: part_acc fp32
// [B, Hkv * ceil(G / 16), splits, 16, D], part_ml fp32 [..., splits, 2, 16]
// and tickets int32 [B, Hkv * ceil(G / 16)], zero before the launch and left
// zero after it (with splits == 1 the three may be null). Returns the CUDA
// error code of the launch (0 = success).
extern "C" int zt_paged_decode_attention(void* out, void* part_acc, void* part_ml, void* tickets,
                                         const void* q, const void* k_pool, const void* v_pool,
                                         const void* page_tables, const void* context_lens,
                                         int B, int Hkv, int G, int D, long long N, int maxp,
                                         int S, float scale, int window, int splits,
                                         int fp16, void* stream) {
  return (fp16 ? zt_paged::dispatch<__half, __half, false>
               : zt_paged::dispatch<zt_paged::bf16, zt_paged::bf16, false>)(
      out, part_acc, part_ml, tickets, q, k_pool, v_pool, nullptr, nullptr, page_tables,
      context_lens, zt_paged::FusedRows{}, B, Hkv, G, D, D, N, 0, maxp, S, scale, window, splits,
      (cudaStream_t)stream);
}

// How many blocks of the head-dim-D kernel one SM holds at once (into
// *blocks); the host sizes `splits` with it. Returns the CUDA error code.
extern "C" int zt_paged_decode_attention_blocks_per_sm(int D, int* blocks) {
  return zt_paged::blocks_per_sm<zt_paged::bf16, false>(D, blocks);
}
