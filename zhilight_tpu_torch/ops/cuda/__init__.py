"""Hand-written CUDA kernels of the port, one module per Pallas module they
replace (``zhilight_tpu/ops/pallas/``): ``kv_write`` (the head-major pool, the
2-D latent pool and the separate slot-major K and V pools),
``attn_headmajor`` and ``prefill_attention`` (each over a bf16 pool and, in
its ``_q`` functions, over an int8 pool with scales; ``attn_headmajor`` also
holds the MLA latent decode), ``paged_attention`` (decode over slot-major
pools, bf16 or int8, and the fused write + attend decode,
``paged_decode_attention_fused`` over slot-major or packed bf16 pools and
``paged_mla_decode_fused`` over the latent pool), ``quant_matmul``,
``quant_ragged`` and ``fp8_matmul``. Each module holds its kernels' wrappers,
their plain PyTorch versions and a launch counter on each wrapper; ``_build``
compiles the sources in ``zhilight_tpu_torch/csrc`` on first use."""
