"""Hand-written CUDA kernels of the port, one module per Pallas module they
replace (``zhilight_tpu/ops/pallas/``): ``kv_write``, ``attn_headmajor``,
``prefill_attention`` and ``quant_matmul``. Each module holds the kernel's
wrapper, its plain PyTorch version and a launch counter on the wrapper;
``_build`` compiles the sources in ``zhilight_tpu_torch/csrc`` on first use."""
