#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``zhilight_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py                         # every phase but timing
    python3 chip_smoke.py --phases kernels,serve  # a subset
    python3 chip_smoke.py --phases serve,timing   # the serve paths, then their rates
    python3 chip_smoke.py --phases multimodal     # DeepSeek-VL2-small's language path alone
    python3 chip_smoke.py --phases http           # the OpenAI server alone
    python3 chip_smoke.py --phases tp             # Qwen2.5-14B bf16 and GPTQ, ..., scoring and SmoothQuant, TP=1 then TP=2 (gloo)
    python3 chip_smoke.py --phases tp --tp-gptq-layers 48  # the GPTQ TP path at full depth
    python3 chip_smoke.py --phases tp --tp-backend nccl  # the same, NCCL, a GPU a rank
    python3 chip_smoke.py --phases pp4            # Qwen2.5-14B bf16, TP=2 x PP=2, 4 ranks
    python3 chip_smoke.py --phases pp4 --tp-backend nccl  # the same, a GPU a rank (four)
    python3 chip_smoke.py --phases hosts          # MiniCPM-2B as 2 TCP-joined hosts; Qwen2.5-14B, TP=2 x DP=2 over 2 hosts
    python3 chip_smoke.py --phases hosts --tp-backend nccl  # the same, a GPU a rank (four)
    python3 chip_smoke.py --phases kernels --parent-csrc DIR  # + an earlier tree's kernels

It builds the port's CUDA kernels from ``zhilight_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and runs these phases:

  kernels  each CUDA kernel against its plain PyTorch version (bf16 queries;
           bf16 and int8 pools) at the shapes the main paths give it, and
           timed beside its bound, the plain version and one PyTorch library
           call (device time: CUDA events around each call, queued behind a
           sleep kernel so no host time falls between them, median; the bf16
           head-major decode and prefill also without that backlog, the
           per-call cost a host-bound path pays), at MiniCPM-2B's, Qwen2.5-14B's and
           DeepSeek-V2-Lite's shapes (latent row write, MLA latent decode,
           grouped int4 matmul over the expert stacks), and the FP8 block
           matmul at Qwen3-8B's seven projection shapes, M = 8 and 512;
           and the kernels of the slot-major pools (separate K and V
           pools, head_dim 16 to 128): decode attention over bf16 and int8
           pools at H2O-Danube-1.8B's shape (32 / 8 heads of 80) and the
           row write's copy mode (rows 11 and 12, one wrapper) at its rows
           and at Qwen2.5-14B's; and the window
           side-KV kernels: the partial modes of the three decode kernels
           (MiniCPM-2B's and Qwen2.5-14B's shapes with an empty pool,
           DeepSeek-V2-Lite's) and the two end-of-window flushes, bit-exact
           (batch 8 and 16, 8 window rows, bf16 and int8 rows, latent rows);
           and the fused write + attend kernels (ZT_FUSED_KV=1) over
           slot-major pools (H2O-Danube-1.8B's and Qwen2.5-14B's heads),
           the packed single pool and the latent pool (DeepSeek-V2-Lite's),
           pools bit-exact, timed beside the unfused pair of port kernels
           they replace and a library pair. The bf16 head-major decode and
           prefill are also held at their split edges (contexts 1, 64, 65, a
           split boundary, a window across splits, an empty slot) and at
           head_dim 192 and 256 with up to 40 query heads a KV head, and timed
           at head_dim 256 (16 / 8 heads), as are the int8 head-major decode
           (the same cases, a repeated call to the same bits) and prefill;
           the four head-major attention kernels (bf16 and int8, decode and
           prefill) are held to their twins too, the plain versions that
           round where the kernels round; the int4 matmul is held at M 1 to
           512, at split counts whose runs end inside a group, at N % 16 == 8,
           at a group size that is not a multiple of 32 rows, and two calls of
           a split-K plan to the same bits, and timed at M 8, 128 and 512
           (also at every kernel and split count it takes); the FP8 block
           matmul is held on every finite e4m3 code, bit for bit; the
           slot-major decode (bf16, int8, fused) is held at its split edges,
           at head_dim 192, 256 and odd ones, with V rows near 6 (outputs in
           [4, 8), where rounded probabilities would show) and over pools
           holding NaN in every row no sequence attends to; the grouped int4
           matmul is held with every expert occupied, one row an expert,
           num_occ 0, m-tiles naming experts E and -1 and the down stack's
           pad group, timed beside one torch._grouped_mm and one
           torch.matmul per expert, and at its decode split counts; the
           latent decode (rows 2b, 2bp and the fused latent mode) is held
           at contexts 0 to 65, at its split edges, at 16 and 128 heads,
           over latents holding NaN in every row no sequence attends to and
           with V columns near 6 (2b against its twin, 2bp and the fused
           mode against the fp32 plain output), and timed at other split
           counts; the attention prologues (rows 1, 7 and 11-12
           redesigned: the rope of q and k, an int8 pool's quantization and
           scale scatter and the row write in one launch) bit-exact against
           their plain versions at MiniCPM-2B's, Qwen2.5-14B's (bf16 and int8
           pools), Qwen3-8B's, head_dim 256's and DeepSeek-V2-Lite's shapes
           and, over slot-major pools, at H2O-Danube-1.8B's (32 / 8 heads of
           80), 40 / 8 heads of 128 and head_dim 100 and 16 (bf16 and int8),
           decode batches in both rope styles, 512 and 2048 tokens, every int8
           code, and timed (device and host-inclusive) beside the sequence of
           launches each replaces; with ``--parent-csrc DIR`` the
           kv_write.cu, kv_write_2d.cu and kv_write_pair.cu in DIR (an
           earlier tree's csrc) are built apart with nvcc and that sequence,
           with the earlier tree's row write, is timed beside the prologue in
           turns, device and host-inclusive, at the same shapes; and the
           layered flush (rows 14 and 15 redesigned: every layer of a decode
           window in one launch, an int8 pool's requantization and scale
           scatter in it) bit-exact against its plain version over bf16, fp16,
           int8 and latent pools (dead slots, windows across a page, a window
           of a whole page), timed at MiniCPM-2B's, Qwen2.5-14B's int8 and
           DeepSeek-V2-Lite's windows (40, 48 and 27 layers) beside the
           per-layer sequence it replaces, and with ``--parent-csrc`` beside
           that sequence through DIR's kv_flush.cu, in turns; and every
           kernel with fp16 inputs (q, rows and model-dtype pools; fp16 q over
           int8 pools) against its plain version in fp16, rows 2, 3 and 10
           timed in fp16 beside bf16; and rows 1-3, 5, 6, 10, 12 and 16 on
           pools of more than 2^31 elements (``kernels_large_pools``), their
           rows at the pools' highest pages;
  multimodal  DeepSeek-VL2-small's language model (``VL2_SMALL``, a
           ``deepseek_vl_v2`` config.json whose nested ``language_config`` is
           parsed by ``adapt_hf_config``: 27 layers, full width, MLA over a
           latent pool, 64 + 2 experts of 1408, top 6; bf16 with bf16 expert
           stacks, about 15.7 B parameters drawn on the card from the seed)
           fed embedding rows through ``LLM`` + ``DynamicBatchGenerator`` with
           prefix caching on, launch counters zeroed just before and read
           just after: a 1500-token prompt as token ids and as its own rows
           (the same greedy tokens; teacher-forced, the same logits), two
           image prompts over the same placeholder ids (no prefix hit,
           nothing cached, different first-token logits), position ids
           0..n-1 against none (the same tokens), the ``DeepseekVL2``
           language shim over a stand-in module (the card table's rows);
           then an image prompt's first-token logits against the plain path,
           one and two requests decoded teacher-forced against the plain path
           in the engine's batch of 8 over its page tables (each row 2b call
           against its split-count twin and plain version, MoE routing parting
           only at near ties), its TTFT and batch-1 decode tok/s; the weights
           are then freed;
  tp       tensor parallelism, five paths (``TP_PATHS``): Qwen2.5-14B in bf16
           (``QWEN14B_BF16`` at 4 of its 48 layers, full width), Qwen2.5-14B
           GPTQ-Int4 (``QWEN14B_GPTQ`` at ``--tp-gptq-layers``, 2 by default,
           of its 48, full width; GPTQ tensors through the port's loader, each
           rank keeping its int4 shard: columns of q/k/v and gate/up, rows of
           o and down with their group scales), two 2-layer checks at full
           width, teacher-forced only (Qwen3-8B-FP8 kept in FP8; Qwen2.5-14B
           quantized to W8A8 at load, AUTO_INT8), and DeepSeek-V2-Lite in bf16
           (``DEEPSEEK_V2_LITE_BF16``, all 27 layers: MLA, 64 + 2 experts of
           1408, top 6, full width), random weights drawn on the card from
           the seed, each through ``LLM`` + ``DynamicBatchGenerator`` at TP=1
           in this process, then all at TP=2, one after the other, by one
           launch of two rank processes of this script on the one GPU over an
           explicit gloo group (``--tp-backend nccl``: NCCL, a GPU a rank), each
           drawing the same full tensors and keeping its shard (Qwen: 20
           query / 4 KV heads of 128 a rank; DeepSeek: 8 of 16 MLA heads over
           a whole latent pool, 32 of the 64 experts): the same requests (TTFT
           and batch-1 decode of a 1500-token prompt, two greedy prompts of 500
           and 1500 tokens, a seeded sampled request, one cancelled
           mid-decode), launch counters zeroed just before and read just after
           on each rank, every kernel of the path launched once a layer a
           forward; the TP=2 greedy tokens against TP=1's, and teacher-forced
           logits along them against TP=1's and against TP=1's own noise (one
           prompt at a time against the batch); both ranks finish every
           request alike, route every token to the same experts and score the
           same logits bit for bit; a forward's collectives counted on each
           rank against the expected (an fp32 all-reduce a row-parallel
           linear, W8A8 a MAX and an int32 one, an all-gather for one kept
           whole) with the linears kept whole; the W8A8 path's ranks also hold
           ``int8_linear``'s row-parallel product at their shapes bit-equal to
           the unsharded one, and show that a rank-local absmax or a missing
           int32 sum would not be; the Qwen bf16 and DeepSeek paths also
           score the 1500-token prompt through the loop (``calc_hidden_states``
           while the greedy batch decodes, then ``calc_logits``,
           ``calc_log_prob``, ``calc_greedy_match``: every rank runs each as a
           scheduler event, launching rows 1 and 3, or 7, once a layer; held
           to TP=1's, DeepSeek's routing shared as teacher-forced), and the
           AUTO_INT8 path's bf16 weights are SmoothQuant-calibrated on both
           ranks (``calc_act_scales``, whole vectors), each shard quantized
           with TP=1's scales equal to TP=1's shard and the calibrated model
           teacher-forced against TP=1's; the TP=2 times are labelled as
           a gloo run whose collectives go through host memory. The kernels
           phase holds rows 2 and 3 (and the prologue, row 1) at a Qwen rank's
           shapes, rows 2b, 7 and 8 at a DeepSeek rank's, and rows 4 and 9 at
           a rank's projections in both output modes (bf16, and fp32: a
           row-parallel partial); and pipeline parallelism, two paths run
           by the same launch of two rank processes, a stage a rank:
           Qwen2.5-14B in bf16 at full width and all 48 layers
           (``Qwen2.5-14B-bf16-pp``: 24 layers a rank, each rank drawing the
           full stream from the seed and keeping its stage, a pool of its 24
           layers; scored through the loop too) and the GPTQ-Int4 path at
           ``--tp-gptq-layers`` (``Qwen2.5-14B-GPTQ-Int4-pp``, each rank
           converting only its stage's layers), each against its PP=1 run in
           this process: the teacher-forced logits, the scoring calls and the
           greedy tokens bit for bit (or the teacher-forced rule), every rank
           finishing every request with rank 0's tokens, each rank's
           teacher-forced launches its stage's share (a column's sum the PP=1
           run's), one hand-off and one broadcast of the hidden state a
           forward, and decode tok/s, TTFT and the time of a move beside PP=1's;
  pp4      (not in the default order) Qwen2.5-14B in bf16 at TP=2 x PP=2
           (``Qwen2.5-14B-bf16-tp-pp``, TP_QWEN_LAYERS of 48, full width):
           its one-process run, then four rank processes (stage ``r // 2``, TP
           rank ``r % 2``; gloo on the one GPU, ``--tp-backend nccl`` a GPU a
           rank), held as the pipelined paths above, the logits by the
           teacher-forced rule (TP changes the arithmetic);
  hosts    (not in the default order) multi-host serving and data-parallel
           replicas, two paths (``HOSTS_PATHS``), each run in this process
           first, then as its rank processes, 8 requests (SERVE_LENS, 32
           greedy tokens each, queued before the loop starts so that every
           run batches them alike) and a 1500-token prompt's TTFT and batch-1
           decode, launch counters zeroed just before and read just after on
           every rank, then the teacher-forced logits along the one-process
           run's tokens: ``MiniCPM-2B-bf16-hosts``, MiniCPM-2B in bf16 at full
           width and depth as two hosts joined by the TCP control plane alone
           (``ZT_CONTROL_ADDR``, no process group), each a whole replica on
           the one GPU (``--tp-backend nccl``: a GPU a host), their tokens and
           logits held bit-equal to each other's and the one-process run's;
           ``Qwen2.5-14B-bf16-tp-dp``, Qwen2.5-14B in bf16 at full width and
           TP_QWEN_LAYERS of 48 at TP=2 x DP=2, four ranks of two emulated
           hosts sharing one world (gloo on the one GPU, made by the script;
           ``--tp-backend nccl``: each host sees two of four GPUs and ``LLM``
           joins the world from the coordinator), every rank finishing every
           request with rank 0's tokens, replica 1's logits and shards
           bit-equal to replica 0's, the logits against TP=1 by the
           teacher-forced rule; each rank's launches equal to the one-process
           run's; decode tok/s and TTFT beside the one-process run's, the
           plane's ms a broadcast on rank 0 and an ``all_min`` round trip;
  serve    the main paths, each through ``LLM`` + ``DynamicBatchGenerator``
           answering 8 concurrent requests, with every kernel's launch
           counter set to 0 just before and read just after, and the
           first-token logits and one batch-8 decode step's logits (contexts
           up to 3713) held against a plain-path forward:
           MiniCPM-2B (bf16, bench.py's configuration, random weights from a
           seed), Qwen2.5-14B GPTQ-Int4 (48 layers, full width; HF-format
           GPTQ tensors made from a seed as tools/make_bench_model.py makes
           them, converted by the port's ``map_hf_params``), and the same
           Qwen weights served with an int8 KV cache (``kv_dtype="int8"``),
           on whose executor the pool-row operations (``copy_slots``,
           ``swap_out_rows`` -> ``swap_in_rows``), a beam request and
           ``calc_logits`` are also driven; and DeepSeek-V2-Lite GPTQ-Int4 (27
           layers as it ships, 8 here: ``SERVE_DEEPSEEK_LAYERS``, the dense
           first layer and seven MoE layers, the tp phase serving all 27 in
           bf16; full width: MLA over a latent pool, 64 routed + 2 shared
           experts, top 6; HF-format tensors named and quantized as
           tools/make_bench_model.py's ``deepseek-v2-lite-w4``; prompts up to
           2816 tokens), with ``copy_slots`` and a swap round trip on the
           latent pool; then the same configuration with bf16 expert stacks
           at 4 layers (the dense grouped-expert path) against the plain path;
           and Qwen3-8B-FP8 (36 layers, full width; HF-format e4m3 ``.weight``
           [out, in] tensors with fp32 ``weight_scale_inv`` [out/128, in/128]
           made from a seed on the GPU, converted layer by layer by the port's
           ``map_hf_params(quant_method="fp8")`` with ``ZT_FP8_KEEP=1``, so
           the weights stay FP8 and every projection runs the FP8 kernel),
           then the same tensors at 4 layers dequantized at load (the
           loader's default) against the kept ones; and Qwen2.5-14B
           GPTQ-Int4 as an fp16 checkpoint (``"torch_dtype": "float16"``,
           the same GPTQ leaves, its dense leaves in fp16, a packed fp16
           pool), with 8 decode steps of 4 prompts teacher-forced against
           the plain path. Beside them, W8A8:
           MiniCPM-2B calibrated on four seeded 512-token sequences
           (``calc_act_scales``), quantized by ``quantize_int8_params`` and
           served from the int8 tree, with ``int8_linear`` on the card held
           against the same call on the CPU. Then H2O-Danube-1.8B
           (``mistral``, 24 layers, full width, 32 / 8 heads of 80, random
           weights from the seed) over a bf16 slot-major pool, and the same
           weights over an int8 one (``kv_dtype="int8"``; with the pool-row
           operations, a beam request and ``calc_logits``); and a 4-layer
           model at Qwen2.5-14B's attention geometry (40 / 8 heads of 128)
           whose pool is slot-major because ``ZT_NO_PACKED_KV=1`` is set while
           its executor builds it (rows the reference writes through
           ``paged_write_rows``; here the slot-major prologue at head_dim
           128), with logits against the packed pool's; and a
           4-layer model at Gemma-2-9B's attention geometry (16 / 8 heads of
           256) over an int8 head-major pool, four requests, its logits
           against the plain path; and
           three decode-window side-KV paths (``ZT_WINDOW_KV=1`` set while a
           second executor over already loaded weights is built): MiniCPM-2B
           (bf16 pool), Qwen2.5-14B GPTQ-Int4 over the int8 pool, and
           DeepSeek-V2-Lite GPTQ-Int4 (latent pool), each serving the 8
           requests through the partial kernels and the flush, then one
           8-step window with side buffers against the per-step path on the
           same prefilled cache (logits, launches, pools after the flush);
           and two fused write + attend paths (``ZT_FUSED_KV=1`` set while a
           second executor over loaded weights is built): H2O-Danube-1.8B
           (slot-major bf16 pool) and DeepSeek-V2-Lite GPTQ-Int4 (latent
           pool), each serving the 8 requests through the fused kernel with
           no unfused decode and row writes in prefill only, then one batch-8
           decode step fused against unfused on the same prefilled cache
           (logits, launches, every layer's written rows);
  http     the OpenAI server (``zhilight_tpu_torch.server.openai``) over
           MiniCPM-2B (full width and depth; the serve phase's weights where
           it ran) with prefix caching on the native allocator and a
           character-level tokenizer written here: first a line saying which
           of aiohttp, pydantic, transformers, tokenizers, safetensors and
           prometheus_client import and where the native library was built;
           then, where aiohttp and pydantic import, ``build_app`` in-process
           on the loopback (aiohttp's TestServer): /health, /v1/models, one
           greedy completion held equal to ``generate`` alone on the same
           ``LLM``, 8 concurrent completions (finish_reason length, usage),
           8 concurrent streamed chats ending in ``[DONE]`` (client-side
           TTFT), a request sharing two pages of prefix with another (a
           prefix hit on the native allocator) and /metrics (generated
           tokens = tokens served); where either does not import, the layer
           under the server on the same path, saying so (string prompts, a
           stop string, streaming through ``IncrementalDetokenizer``, the
           prefix hit);
  timing   (not in the default order: it needs the serve phase's
           engines and added 250-300 s to a run held to 1200 s; run it with
           ``--phases serve,timing``) per path, decode tokens/s (MiniCPM batch 16 at context 512, greedy
           and sampled at temperature 0.8, top_p 0.9; Qwen batch 8 at context
           3712, greedy, over the bf16 and the int8 pool; DeepSeek-V2-Lite
           batch 8 at context 2816; Qwen3-8B-FP8 batch 8 at context 3712;
           MiniCPM-2B W8A8 batch 16 at context 512, decode only;
           H2O-Danube-1.8B batch 8 at context 3712, over the bf16 pool and,
           decode only, the int8 pool; decode only, the three window paths
           and the two fused paths at their twins' batch and context, and
           the fp16 Qwen path's decode) and the
           time to first token of a
           3712-token prompt (DeepSeek: 2816) in 512-token chunks, by
           bench.py's method, then a torch.profiler breakdown of one decode
           window and one prefill.

The last lines are the kernels' JSON record, the GPU's name and power limit,
and ``{"ok": true, "device": {...}}``. Any failed phase makes the script exit
non-zero without the ``ok`` line; so does a machine without a CUDA GPU.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import operator
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
ATTN_TOL = 2e-2             # max |kernel - plain| on unit-variance bf16 inputs
# max |kernel - plain| / max |plain| of the int4 matmul: the dequantized
# tiles are the same bf16 values; the output is rounded to bf16 and the fp32
# sums run in another order
W4A16_TOL = 1e-2
# max |kernel - plain| / max |plain| of the FP8 block matmul: the same bf16
# weights and fp32 block sums; the output is rounded to bf16 once and the fp32
# sums (split-K included) run in another order
FP8_TOL = 1e-2
# max |card - CPU| / max |CPU| of int8_linear: the int32 product is exact; the
# card may divide through a reciprocal, so an activation code may differ by one
INT8_TOL = 1e-2
LOGIT_TOL = 5e-2            # max |kernel - plain| logits / max |plain logits|

# the reference's two slot-major row writes, paged_write_rows and
# write_rows_2d_pair: one function on the GPU
PAIR_REPLACES = "zhilight_tpu/ops/pallas/kv_write.py:141, zhilight_tpu/ops/pallas/kv_write.py:427"
KERNELS = {
    # row 1 and row 7 in their copy modes (write_kv, write_latent): the main
    # paths write their rows through the prologues below
    "write_rows_hm": dict(
        source="zhilight_tpu_torch/csrc/kv_write.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:606",
        mode="copy: write_kv's row write; the per-step path takes rope_write_rows_hm",
    ),
    "paged_decode_attention_hm": dict(
        source="zhilight_tpu_torch/csrc/attn_headmajor.cu",
        replaces="zhilight_tpu/ops/pallas/attn_headmajor.py:151",
    ),
    "paged_prefill_attention_hm_packed": dict(
        source="zhilight_tpu_torch/csrc/prefill_attention.cu",
        replaces="zhilight_tpu/ops/pallas/prefill_attention.py:255",
    ),
    "w4a16_matmul": dict(
        source="zhilight_tpu_torch/csrc/quant_matmul.cu",
        replaces="zhilight_tpu/ops/pallas/quant_matmul.py:242",
    ),
    "paged_decode_attention_hm_q": dict(
        source="zhilight_tpu_torch/csrc/attn_headmajor_q.cu",
        replaces="zhilight_tpu/ops/pallas/attn_headmajor.py:341",
    ),
    "paged_prefill_attention_hm_packed_q": dict(
        source="zhilight_tpu_torch/csrc/prefill_attention_q.cu",
        replaces="zhilight_tpu/ops/pallas/prefill_attention.py:503",
    ),
    "write_rows_2d": dict(
        source="zhilight_tpu_torch/csrc/kv_write_2d.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:324",
        mode="copy: write_latent's row write; the per-step path takes rope_write_rows_2d",
    ),
    # the MLA latent mode (v_dim > 0) of the TPU decode kernel, reached through
    # zhilight_tpu/ops/pallas/paged_attention.py:791 (paged_mla_decode)
    "paged_mla_decode": dict(
        source="zhilight_tpu_torch/csrc/mla_decode.cu",
        replaces="zhilight_tpu/ops/pallas/attn_headmajor.py:151",
    ),
    "w4a16_ragged_matmul": dict(
        source="zhilight_tpu_torch/csrc/quant_ragged.cu",
        replaces="zhilight_tpu/ops/pallas/quant_ragged.py:142",
    ),
    "fp8_block_matmul": dict(
        source="zhilight_tpu_torch/csrc/fp8_matmul.cu",
        replaces="zhilight_tpu/ops/pallas/fp8_matmul.py:85",
    ),
    "paged_decode_attention": dict(
        source="zhilight_tpu_torch/csrc/paged_attention.cu",
        replaces="zhilight_tpu/ops/pallas/paged_attention.py:364",
    ),
    # rows 11 and 12 in their copy mode (write_kv over slot-major pools): the
    # main paths write their rows through rope_write_rows_pair below
    "write_rows_pair": dict(
        source="zhilight_tpu_torch/csrc/kv_write_pair.cu",
        replaces=PAIR_REPLACES,
        mode="copy: write_kv's slot-major row write; the per-step path takes rope_write_rows_pair",
    ),
    "paged_decode_attention_q": dict(
        source="zhilight_tpu_torch/csrc/paged_attention_q.cu",
        replaces="zhilight_tpu/ops/pallas/paged_attention.py:971",
    ),
    # window side-KV (ZT_WINDOW_KV=1): the end-of-window flushes and the
    # emit_partial modes of the three decode kernels
    "flush_side_rows_hm": dict(
        source="zhilight_tpu_torch/csrc/kv_flush.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:796",
    ),
    "flush_side_rows_2d": dict(
        source="zhilight_tpu_torch/csrc/kv_flush.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:929",
    ),
    # the same kernel over every layer of a window in one launch (an int8
    # pool's requantization and scale scatter in it): what the window paths
    # launch; the per-layer entries above flush one layer (flush_side_kv,
    # flush_side_latent)
    "flush_side_layers_hm": dict(
        source="zhilight_tpu_torch/csrc/kv_flush.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:796",
    ),
    "flush_side_layers_2d": dict(
        source="zhilight_tpu_torch/csrc/kv_flush.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:929",
    ),
    "paged_decode_attention_hm_partial": dict(
        source="zhilight_tpu_torch/csrc/attn_headmajor.cu",
        replaces="zhilight_tpu/ops/pallas/attn_headmajor.py:151",
    ),
    "paged_decode_attention_hm_q_partial": dict(
        source="zhilight_tpu_torch/csrc/attn_headmajor_q.cu",
        replaces="zhilight_tpu/ops/pallas/attn_headmajor.py:341",
    ),
    # the reference serves the MLA partials from _kernel_bs (:179) through
    # paged_mla_decode(emit_partial=True)
    "paged_mla_decode_partial": dict(
        source="zhilight_tpu_torch/csrc/mla_decode.cu",
        replaces="zhilight_tpu/ops/pallas/paged_attention.py:791",
    ),
    # fused write + attend (ZT_FUSED_KV=1): one TPU kernel, _kernel_bs_fused
    # (:445), in its slot-major and packed modes and its latent mode
    "paged_decode_attention_fused": dict(
        source="zhilight_tpu_torch/csrc/paged_attention_fused.cu",
        replaces="zhilight_tpu/ops/pallas/paged_attention.py:644",
    ),
    "paged_mla_decode_fused": dict(
        source="zhilight_tpu_torch/csrc/mla_decode.cu",
        replaces="zhilight_tpu/ops/pallas/paged_attention.py:844",
    ),
    # the attention prologues: rows 1 and 7 with the rope of q and k, the int8
    # quantization and the scale scatter folded in, one launch a layer
    "rope_write_rows_hm": dict(
        source="zhilight_tpu_torch/csrc/kv_write.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:606",
    ),
    "rope_write_rows_2d": dict(
        source="zhilight_tpu_torch/csrc/kv_write_2d.cu",
        replaces="zhilight_tpu/ops/pallas/kv_write.py:324",
    ),
    # the slot-major pools' prologue: rows 11 and 12 with the rope of q and k,
    # the int8 quantization and the scale scatter folded in
    "rope_write_rows_pair": dict(
        source="zhilight_tpu_torch/csrc/kv_write_pair.cu",
        replaces=PAIR_REPLACES,
    ),
}
ATTENTION_KERNELS = ("rope_write_rows_hm", "paged_decode_attention_hm",
                     "paged_prefill_attention_hm_packed")
INT8_KERNELS = ("paged_decode_attention_hm_q", "paged_prefill_attention_hm_packed_q")
# what each main path must launch, and what it must not
PATHS = {
    "MiniCPM-2B": ATTENTION_KERNELS,
    "Qwen2.5-14B-GPTQ-Int4": ATTENTION_KERNELS + ("w4a16_matmul",),
    # the same geometry as an fp16 checkpoint ("torch_dtype": "float16", as the
    # published GPTQ config gives it): the same kernels, fp16 instantiations
    "Qwen2.5-14B-GPTQ-Int4-fp16": ATTENTION_KERNELS + ("w4a16_matmul",),
    "Qwen2.5-14B-GPTQ-Int4-int8kv": ("rope_write_rows_hm", "w4a16_matmul") + INT8_KERNELS,
    # MLA prefill is plain torch, as the reference leaves it to XLA
    "DeepSeek-V2-Lite-GPTQ-Int4": ("rope_write_rows_2d", "paged_mla_decode",
                                   "w4a16_ragged_matmul", "w4a16_matmul"),
    "Qwen3-8B-FP8": ATTENTION_KERNELS + ("fp8_block_matmul",),
    # W8A8 adds no hand-written kernel: the int8 product is the library's
    "MiniCPM-2B-W8A8": ATTENTION_KERNELS,
    # slot-major pools: prefill attends over the gathered context in plain
    # torch, as the reference leaves it to XLA
    "H2O-Danube-1.8B": ("rope_write_rows_pair", "paged_decode_attention"),
    "H2O-Danube-1.8B-int8kv": ("rope_write_rows_pair", "paged_decode_attention_q"),
    # decode windows with side-buffered KV writes (ZT_WINDOW_KV=1): the decode
    # kernels in their partial mode and one flush a window for every layer,
    # never the normal decode; the row writes are prefill's
    "MiniCPM-2B-window": ("rope_write_rows_hm", "paged_prefill_attention_hm_packed",
                          "paged_decode_attention_hm_partial", "flush_side_layers_hm"),
    "Qwen2.5-14B-GPTQ-Int4-int8kv-window": ("rope_write_rows_hm", "w4a16_matmul",
                                            "paged_prefill_attention_hm_packed_q",
                                            "paged_decode_attention_hm_q_partial",
                                            "flush_side_layers_hm"),
    "DeepSeek-V2-Lite-GPTQ-Int4-window": ("rope_write_rows_2d", "w4a16_ragged_matmul",
                                          "w4a16_matmul", "paged_mla_decode_partial",
                                          "flush_side_layers_2d"),
    # fused write + attend (ZT_FUSED_KV=1): the fused kernel in decode, never
    # the unfused decode; the row writes are prefill's (FUSED_PREFILL_WRITES)
    "H2O-Danube-1.8B-fused": ("rope_write_rows_pair", "paged_decode_attention_fused"),
    "DeepSeek-V2-Lite-GPTQ-Int4-fused": ("rope_write_rows_2d", "w4a16_ragged_matmul",
                                         "w4a16_matmul", "paged_mla_decode_fused"),
    # an int8 head-major pool at head_dim 256 (4 layers at Gemma-2-9B's heads)
    "Gemma-2-9B-geometry-4-layers-int8kv": ("rope_write_rows_hm",) + INT8_KERNELS,
    # the OpenAI server (or the layer under it) over MiniCPM-2B with prefix
    # caching on the native allocator
    "MiniCPM-2B-http": ATTENTION_KERNELS,
    # DeepSeek-VL2-small's language model fed image rows (input_embeddings):
    # bf16 experts go through the library's grouped GEMM, MLA prefill is
    # plain torch
    "DeepSeek-VL2-small-multimodal": ("rope_write_rows_2d", "paged_mla_decode"),
}
# a fused path's row write: layers x prefill forwards launches, none in decode
FUSED_PREFILL_WRITES = {"H2O-Danube-1.8B-fused": "rope_write_rows_pair",
                        "DeepSeek-V2-Lite-GPTQ-Int4-fused": "rope_write_rows_2d"}
# every kernel that writes pool rows outside a window's flush (a window
# writes none of them until its end)
ROW_WRITES = ("write_rows_hm", "write_rows_2d", "write_rows_pair", "rope_write_rows_hm",
              "rope_write_rows_2d", "rope_write_rows_pair")
# prompt lengths of a path's 8 requests (32 new tokens each)
SERVE_LENS = [7, 100, 513, 1500, 3712, 16, 250, 40]
DEEPSEEK_LENS = [7, 100, 513, 1500, 2816, 16, 250, 40]  # max_model_len 3072
MINICPM_HEADS = dict(Hq=36, Hkv=36, D=64)
QWEN_HEADS = dict(Hq=40, Hkv=8, D=128)
# Qwen2.5-14B's projections, (K, N)
QWEN_W4_SHAPES = {"q/o_proj": (5120, 5120), "k/v_proj": (5120, 1024),
                  "gate/up_proj": (5120, 13824), "down_proj": (13824, 5120)}
# Qwen3-8B's projections, (K, N): q/o, k/v, gate/up, down
QWEN3_SHAPES = {"q/o_proj": (4096, 4096), "k/v_proj": (4096, 1024),
                "gate/up_proj": (4096, 12288), "down_proj": (12288, 4096)}
DANUBE_HEADS = dict(Hq=32, Hkv=8, D=80)

# Qwen/Qwen2.5-14B-Instruct-GPTQ-Int4's config.json fields, as
# tools/make_bench_model.py:30-44 writes them
QWEN14B_GPTQ = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "hidden_size": 5120,
    "intermediate_size": 13824, "num_hidden_layers": 48, "num_attention_heads": 40,
    "num_key_value_heads": 8, "vocab_size": 152064, "max_position_embeddings": 32768,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "eos_token_id": 2, "bos_token_id": 1,
    "quantization_config": {"quant_method": "gptq", "bits": 4, "group_size": 128,
                            "desc_act": False, "sym": True},
}

# deepseek-ai/DeepSeek-V2-Lite's geometry with GPTQ-Int4 expert stacks: the
# config.json fields that tools/make_bench_model.py:88-125 ("deepseek-v2-lite-w4")
# writes
DEEPSEEK_V2_LITE_GPTQ = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2", "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16, "n_routed_experts": 64,
    "n_shared_experts": 2, "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "scoring_func": "softmax", "topk_method": "greedy",
    "norm_topk_prob": False, "routed_scaling_factor": 1.0, "vocab_size": 102400,
    "max_position_embeddings": 163840, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "eos_token_id": 2, "bos_token_id": 1,
    "rope_scaling": {"rope_type": "yarn", "factor": 40.0, "beta_fast": 32, "beta_slow": 1,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096},
    "quantization_config": {"quant_method": "gptq", "bits": 4, "group_size": 128,
                            "desc_act": False, "sym": True},
}


# Qwen/Qwen3-8B-FP8's config.json fields
QWEN3_8B_FP8 = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "hidden_size": 4096,
    "intermediate_size": 12288, "num_hidden_layers": 36, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 151936,
    "max_position_embeddings": 40960, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "attention_bias": False, "torch_dtype": "bfloat16",
    "eos_token_id": 151645, "bos_token_id": 151643,
    "quantization_config": {"quant_method": "fp8", "fmt": "e4m3", "activation_scheme": "dynamic",
                            "weight_block_size": [128, 128]},
}


# h2oai/h2o-danube-1.8b-base's config.json fields
DANUBE_1_8B = {
    "architectures": ["MistralForCausalLM"], "model_type": "mistral", "hidden_size": 2560,
    "intermediate_size": 6912, "num_hidden_layers": 24, "num_attention_heads": 32,
    "num_key_value_heads": 8, "vocab_size": 32000, "max_position_embeddings": 16384,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "sliding_window": 4096,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "bos_token_id": 1, "eos_token_id": 2,
}


# deepseek-ai/deepseek-vl2-small's config.json as far as the language model
# goes: the DeepSeek-VL2 paper's Table 1 gives DeepSeekMoE-16B with MLA (27
# layers, d 2048, kv_lora_rank 512, 64 routed + 2 shared experts, top 6); every
# other field of language_config is DeepSeek-V2-Lite's public value (the dict
# above), a stand-in. Served in bf16 with bf16 expert stacks, as it ships.
VL2_SMALL = {
    "model_type": "deepseek_vl_v2", "architectures": ["DeepseekVLV2ForCausalLM"],
    "torch_dtype": "bfloat16",
    "language_config": {k: v for k, v in DEEPSEEK_V2_LITE_GPTQ.items()
                        if k != "quantization_config"},
}


def minicpm_2b():
    """MiniCPM-2B (``cpm_dragonfly``) at bench.py:107-121's geometry, full depth."""
    from zhilight_tpu_torch.config import ModelConfig

    return ModelConfig(
        model_type="cpm_dragonfly", num_layers=40, dim_model=2304,
        num_heads=36, dim_head=64, num_kv_heads=36, dim_ff=5760,
        vocab_size=122753, dtype="bfloat16", scale_emb=12.0, scale_depth=1.4,
        dim_model_base=256, tie_lm_head=True,
    )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def lap_timer(phase: str):
    """``lap(what)`` prints the seconds since the previous lap (or since this
    call) as ``<phase> time: <what> N s``: where a phase's time goes."""
    last = [time.monotonic()]

    def lap(what: str) -> None:
        now = time.monotonic()
        print(f"{phase} time: {what} {now - last[0]:.1f} s", flush=True)
        last[0] = now
    return lap


# GPU clock cycles a second, no fewer than the H100's 1.98 GHz boost clock: a
# backlog sized with it lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2.0e9


def time_ms(fn, reps: int = 30, warmup: int = 3, flush=None, backlog: bool = True) -> float:
    """Median device time of one call, by CUDA events around each call;
    ``flush`` runs before each call, outside the events.

    With ``backlog`` (the default) the stream first runs a sleep kernel
    (``torch.cuda._sleep``) twice as long as the host took to enqueue the
    same calls in a probe run, so every event pair is enqueued before the
    device reaches it and measures device time alone: the wrapper's Python
    checks between two calls are hidden behind the backlog. Without it the
    device idles between calls and an event pair also holds the host time a
    call spends before its launch: the per-call cost a host-bound path pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if backlog:
        t0 = time.perf_counter()
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S) + 2_000_000)
    events = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _paged(rng, context_lens, S, extra_pages=3):
    """Shuffled page tables ([B, maxp], -1 padded) covering context_lens."""
    B = len(context_lens)
    need = [(int(c) + S - 1) // S for c in context_lens]
    maxp = max(max(need), 1)
    P = sum(need) + extra_pages
    perm = rng.permutation(P).astype(np.int32)
    tables = np.full((B, maxp), -1, np.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o : o + n]
        o += n
    return tables, P


def _dev(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x)).cuda()
    return t.to(dtype) if dtype is not None else t


# the model dtype of the kernels' inputs that _randn makes: bf16, or fp16
# inside ``elem_dtype(torch.float16)`` (the fp16 cases of kernels_fp16)
_ELEM = [torch.bfloat16]


@contextlib.contextmanager
def elem_dtype(dtype):
    _ELEM.append(dtype)
    try:
        yield
    finally:
        _ELEM.pop()


def _randn(rng, *shape):
    return _dev(rng.standard_normal(shape).astype(np.float32), _ELEM[-1])


def _q_note() -> str:
    """A log note on the inputs' model dtype when it is not bf16."""
    return "" if _ELEM[-1] == torch.bfloat16 else f" ({str(_ELEM[-1])[6:]} q and rows)"


def _bf16(rng, shape, scale=0.02, device=None):
    """Random bf16 (tools/make_bench_model.py's ``bf16``), as a torch tensor,
    drawn on ``device`` (default: the host)."""
    g = torch.Generator(device=device or "cpu").manual_seed(int(rng.integers(2**31)))
    return (torch.randn(int(np.prod(shape)), generator=g, device=device) * scale).to(
        torch.bfloat16).reshape(shape)


def gptq_tensors(rng, K, N, group_size):
    """Random AutoGPTQ-v1 tensors of a [K, N] linear (tools/make_bench_model.py's
    ``gptq_tensors``): sym zeros stored as 7, unpacked as 8."""
    G = K // group_size
    qweight = rng.integers(0, 2**32, size=(K // 8, N), dtype=np.uint32).astype(np.int32)
    qzeros = np.full((G, N // 8), 0x77777777, dtype=np.uint32).astype(np.int32)
    scales = (rng.random((G, N), dtype=np.float32) * 0.004 + 0.001).astype(np.float16)
    g_idx = (np.arange(K, dtype=np.int32) // group_size).astype(np.int32)
    return dict(qweight=qweight, qzeros=qzeros, scales=scales, g_idx=g_idx)


def qwen_hf_tensors(hf: dict, seed: int, keep: dict, device=None):
    """(HF name, tensor) pairs of a random GPTQ-Int4 checkpoint of ``hf``'s
    geometry, in tools/make_bench_model.py's format and order; dense leaves
    bf16 at scale 0.02 (drawn on ``device``, default the host), norms 1.
    ``keep`` receives layer 0's q_proj GPTQ tensors and the seconds spent
    making the tensors."""
    t0 = time.monotonic()
    made = 0.0
    rng = np.random.default_rng(seed)
    H, NH, KV = hf["hidden_size"], hf["num_attention_heads"], hf["num_key_value_heads"]
    HD, FF, V = H // NH, hf["intermediate_size"], hf["vocab_size"]
    gs = hf["quantization_config"]["group_size"]
    ones = torch.ones(H, dtype=torch.bfloat16)
    lin = {
        "self_attn.q_proj": (H, NH * HD), "self_attn.k_proj": (H, KV * HD),
        "self_attn.v_proj": (H, KV * HD), "self_attn.o_proj": (NH * HD, H),
        "mlp.gate_proj": (H, FF), "mlp.up_proj": (H, FF), "mlp.down_proj": (FF, H),
    }

    def emit(name, value):
        nonlocal t0, made
        made += time.monotonic() - t0
        yield name, value
        t0 = time.monotonic()

    yield from emit("model.embed_tokens.weight", _bf16(rng, (V, H), device=device))
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name, (K, N) in lin.items():
            parts = gptq_tensors(rng, K, N, gs)
            if i == 0 and name == "self_attn.q_proj":
                keep["q_proj"] = parts
            for k, v in parts.items():
                yield from emit(pre + name + "." + k, v)
            if name != "self_attn.o_proj" and name.startswith("self_attn."):
                yield from emit(pre + name + ".bias", _bf16(rng, (N,), device=device))
        yield from emit(pre + "input_layernorm.weight", ones)
        yield from emit(pre + "post_attention_layernorm.weight", ones)
    rng = np.random.default_rng(seed + 1)
    yield from emit("model.norm.weight", ones)
    yield from emit("lm_head.weight", _bf16(rng, (V, H), device=device))
    keep["make_s"] = made + time.monotonic() - t0


def deepseek_hf_tensors(hf: dict, seed: int, keep: dict, quant_experts: bool = True):
    """(HF name, tensor) pairs of a random DeepSeek-V2 checkpoint of ``hf``'s
    geometry, named and quantized as tools/make_bench_model.py's
    ``_make_deepseek_layers``: GPTQ q_proj and o_proj, bf16 kv_a and kv_b, a bf16
    dense first layer, a bf16 router, GPTQ routed and shared experts (bf16
    routed experts with ``quant_experts=False``). One layer's tensors are made
    at a time. ``keep`` receives the seconds spent making the tensors."""
    t0 = time.monotonic()
    made = 0.0
    rng = np.random.default_rng(seed)
    H, NH, V = hf["hidden_size"], hf["num_attention_heads"], hf["vocab_size"]
    FF, MFF, E = hf["intermediate_size"], hf["moe_intermediate_size"], hf["n_routed_experts"]
    SH = hf["n_shared_experts"] * MFF
    lora, rope_d = hf["kv_lora_rank"], hf["qk_rope_head_dim"]
    nope_d, v_d = hf["qk_nope_head_dim"], hf["v_head_dim"]
    gs = hf["quantization_config"]["group_size"]

    def emit(name, value):
        nonlocal t0, made
        made += time.monotonic() - t0
        yield name, value
        t0 = time.monotonic()

    def lin(name, K, N, quant=True):
        if quant:
            for k, v in gptq_tensors(rng, K, N, gs).items():
                yield from emit(name + "." + k, v)
        else:
            yield from emit(name + ".weight", _bf16(rng, (N, K)))  # HF [out, in]

    yield from emit("model.embed_tokens.weight", _bf16(rng, (V, H)))
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        yield from lin(pre + "self_attn.q_proj", H, NH * (nope_d + rope_d))
        yield from lin(pre + "self_attn.kv_a_proj_with_mqa", H, lora + rope_d, quant=False)
        yield from emit(pre + "self_attn.kv_a_layernorm.weight", torch.ones(lora, dtype=torch.bfloat16))
        yield from lin(pre + "self_attn.kv_b_proj", lora, NH * (nope_d + v_d), quant=False)
        yield from lin(pre + "self_attn.o_proj", NH * v_d, H)
        if i < hf["first_k_dense_replace"]:
            for name, (K, N) in (("gate_proj", (H, FF)), ("up_proj", (H, FF)), ("down_proj", (FF, H))):
                yield from lin(pre + "mlp." + name, K, N, quant=False)
        else:
            yield from emit(pre + "mlp.gate.weight", _bf16(rng, (E, H)))
            for e in range(E):
                epre = pre + f"mlp.experts.{e}."
                yield from lin(epre + "gate_proj", H, MFF, quant_experts)
                yield from lin(epre + "up_proj", H, MFF, quant_experts)
                yield from lin(epre + "down_proj", MFF, H, quant_experts)
            yield from lin(pre + "mlp.shared_experts.gate_proj", H, SH)
            yield from lin(pre + "mlp.shared_experts.up_proj", H, SH)
            yield from lin(pre + "mlp.shared_experts.down_proj", SH, H)
        ones = torch.ones(H, dtype=torch.bfloat16)
        yield from emit(pre + "input_layernorm.weight", ones)
        yield from emit(pre + "post_attention_layernorm.weight", ones)
    rng = np.random.default_rng(seed + 1)
    yield from emit("model.norm.weight", torch.ones(H, dtype=torch.bfloat16))
    yield from emit("lm_head.weight", _bf16(rng, (V, H)))
    keep["make_s"] = made + time.monotonic() - t0


def fp8_block_quantize(w: torch.Tensor):
    """fp32 [out, in] -> (float8_e4m3fn [out, in], f32 scales [out/128, in/128]):
    each 128 x 128 block scaled to the format's largest value, 448, and
    rounded to nearest (which never yields a NaN encoding)."""
    O, I = w.shape
    blocks = w.reshape(O // 128, 128, I // 128, 128)
    s = blocks.abs().amax(dim=(1, 3)) / 448.0 + 1e-12
    w8 = (blocks / s[:, None, :, None]).reshape(O, I).to(torch.float8_e4m3fn)
    return w8, s


def qwen3_fp8_hf_tensors(hf: dict, seed: int):
    """(HF name, tensor) pairs of a random FP8 block-scaled checkpoint of
    ``hf``'s geometry, named and laid out as the official FP8 releases: e4m3
    ``.weight`` [out, in] with f32 ``.weight_scale_inv`` [out/128, in/128] for
    the seven projections of each layer (normal values / sqrt(fan_in), as
    ``models.llama.init_params`` draws them); embeddings and lm_head bf16 at
    0.02, norms 1. Made on the GPU, one layer at a time, from generators seeded with ``seed``
    (a shallower model's layers are a prefix of a deeper one's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, NH, KV = hf["hidden_size"], hf["num_attention_heads"], hf["num_key_value_heads"]
    HD, FF, V = hf["head_dim"], hf["intermediate_size"], hf["vocab_size"]
    bf = dict(dtype=torch.bfloat16, device="cuda")

    def randn(shape, g=gen, scale=0.02):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def linear(shape):
        """[out, in] at llama.init_params' scale: normal / sqrt(fan_in)."""
        return randn(shape, scale=shape[1] ** -0.5)

    yield "model.embed_tokens.weight", randn((V, H)).to(torch.bfloat16)
    lin = {"self_attn.q_proj": (NH * HD, H), "self_attn.k_proj": (KV * HD, H),
           "self_attn.v_proj": (KV * HD, H), "self_attn.o_proj": (H, NH * HD),
           "mlp.gate_proj": (FF, H), "mlp.up_proj": (FF, H), "mlp.down_proj": (H, FF)}
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name, shape in lin.items():
            w8, s = fp8_block_quantize(linear(shape))
            yield pre + name + ".weight", w8
            yield pre + name + ".weight_scale_inv", s
        yield pre + "self_attn.q_norm.weight", torch.ones(HD, **bf)
        yield pre + "self_attn.k_norm.weight", torch.ones(HD, **bf)
        yield pre + "input_layernorm.weight", torch.ones(H, **bf)
        yield pre + "post_attention_layernorm.weight", torch.ones(H, **bf)
    tail = torch.Generator(device="cuda").manual_seed(seed + 1)
    yield "model.norm.weight", torch.ones(H, **bf)
    yield "lm_head.weight", randn((V, H), tail).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def _int8_pool(rng, Hkv, slots, D):
    """Unit-variance K|V rows quantized as the cache quantizes them: the int8
    pool [Hkv, N, 2D] and its head-major scales [Hkv, N + 1] (last column
    spare, as ``new_kv_cache`` lays them out)."""
    from zhilight_tpu_torch.kvcache.paged import _quantize_rows

    k_q, k_s = _quantize_rows(_randn(rng, slots, Hkv, D))
    v_q, v_s = _quantize_rows(_randn(rng, slots, Hkv, D))
    pool = torch.cat([k_q, v_q], -1).transpose(0, 1).contiguous()
    pad = torch.zeros(Hkv, 1, device="cuda")
    return (pool, torch.cat([k_s.t(), pad], 1).contiguous(),
            torch.cat([v_s.t(), pad], 1).contiguous())


def _pool_args(rng, Hkv, slots, D, int8):
    """(pool,) or (pool, k_scales, v_scales), and the pool as bf16 rows (the
    int8 pool dequantized beforehand) for the library call."""
    if not int8:
        pool = _randn(rng, Hkv, slots, 2 * D)
        return (pool,), pool
    pool, ks, vs = _int8_pool(rng, Hkv, slots, D)
    sc = torch.cat([ks[:, :slots, None].expand(-1, -1, D), vs[:, :slots, None].expand(-1, -1, D)], -1)
    return (pool, ks, vs), (pool.float() * sc).to(torch.bfloat16)


def check_write(rng, W) -> None:
    """write_rows_hm bit-exact against the plain scatter: MiniCPM-2B's pool (36
    heads, rows 2 x 64 wide) at its decode batch and a prefill chunk, and
    Qwen2.5-14B's (8 KV heads, rows 2 x 128 wide) likewise; bf16 rows, and
    int8 rows (64- or 128-byte halves) as an int8 cache writes them."""
    S = 16
    for int8 in (False, True):
        for T, start, H, D in ((16, None, 36, 64), (512, 3205, 36, 64),
                               (8, None, 8, 128), (512, 3200, 8, 128)):
            if int8:
                k, v = (_dev(rng.integers(-127, 128, (T, H, D)).astype(np.int8)) for _ in "kv")
            else:
                k, v = _randn(rng, T, H, D), _randn(rng, T, H, D)
            if start is None:  # decode: one row per sequence, one skipped
                npages = 64
                pages = rng.permutation(npages)[:T]
                slots = pages * S + rng.integers(0, S, T)
                slots[3] = -1
            else:  # a prefill chunk starting mid-page, through a shuffled table
                npages = (start + T) // S + 4
                table = rng.permutation(npages)
                pos = np.arange(start, start + T)
                slots = table[pos // S] * S + pos % S
            slots = _dev(slots.astype(np.int32))
            pool = _randn(rng, H, npages * S, 2 * D)
            if int8:
                pool = (pool * 40).to(torch.int8)
            got = W.write_rows_hm(pool.clone(), k, v, slots)
            want = W.write_rows_hm_plain(pool.clone(), k, v, slots)
            torch.cuda.synchronize()
            what = f"write_rows_hm {'int8' if int8 else 'bf16'} T={T} Hkv={H} D={D}"
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: not bit-exact")
            print(f"kernels: {what} bit-exact", flush=True)


def time_write(rng, W, T, H, D, int8) -> dict:
    """A decode step's (or a chunk's) rows on exclusive pages."""
    S = 16
    if int8:
        k, v = (_dev(rng.integers(-127, 128, (T, H, D)).astype(np.int8)) for _ in "kv")
    else:
        k, v = _randn(rng, T, H, D), _randn(rng, T, H, D)
    npages = max(256, 2 * T)
    slots = _dev((rng.permutation(npages)[:T] * S).astype(np.int32))
    pool = torch.zeros(H, npages * S, 2 * D, dtype=k.dtype, device="cuda")
    rows_hm = torch.cat([k, v], -1).transpose(0, 1).contiguous()
    idx = slots.long()
    t_b, by = bound(2 * T * H * 2 * D * k.element_size() + T * 4, 0)
    return dict(
        ms=time_ms(lambda: W.write_rows_hm(pool, k, v, slots)),
        plain_ms=time_ms(lambda: W.write_rows_hm_plain(pool, k, v, slots)),
        # pool[:, idx] = rows: one index_put_ on rows already laid out head-major
        library_ms=time_ms(lambda: operator.setitem(pool, (slice(None), idx), rows_hm)),
        bound_ms=t_b, bound_by=by,
    )


def check_decode(rng, A, cases, int8) -> float:
    """Decode attention (bf16 pool, or int8 pool with scales) against its
    plain version and its twin (the plain version in the kernels' rounding
    order); an empty slot is zero and a repeated call gives the same bits.
    Returns the largest error against the plain version."""
    S, err = 16, 0.0
    fn, plain, twin = ((A.paged_decode_attention_hm_q, A.paged_decode_attention_hm_q_plain,
                        A.paged_decode_attention_hm_q_twin) if int8 else
                       (A.paged_decode_attention_hm, A.paged_decode_attention_hm_plain,
                        A.paged_decode_attention_hm_twin))
    for c in cases:
        B, Hq, Hkv, D = c["B"], c["Hq"], c["Hkv"], c["D"]
        if "ctx" in c:
            ctx = np.array(c["ctx"], np.int32)
        else:
            ctx = rng.integers(1, c["ctx_max"] + 1, B).astype(np.int32)
            ctx[5] = 0  # an empty slot
        tables, npages = _paged(rng, ctx, S)
        pools, _ = _pool_args(rng, Hkv, npages * S, D, int8)
        args = (_randn(rng, B, Hq, D), *pools, _dev(tables), _dev(ctx), S, 1.0 / np.sqrt(D),
                c["window"])
        got, want = fn(*args), plain(*args)
        e = (got.float() - want.float()).abs().max().item()
        e_twin = (got.float() - twin(*args).float()).abs().max().item()
        print(f"kernels: decode {'int8' if int8 else 'bf16'}{_q_note()} {c} max_abs_err={e:.3e} "
              f"(twin {e_twin:.3e})", flush=True)
        if not (np.isfinite(e) and e <= ATTN_TOL and e_twin <= ATTN_TOL):
            raise AssertionError(f"decode attention {c}: max abs err {e} (twin {e_twin}) > {ATTN_TOL}")
        if got[torch.from_numpy(ctx == 0)].any():
            raise AssertionError(f"decode attention {c}: an empty slot is not zero")
        if not torch.equal(fn(*args), got):
            raise AssertionError(f"decode attention {c}: a repeated call differs")
        err = max(err, e)
    return err


def time_decode(rng, A, B, Hq, Hkv, D, CTX, int8) -> dict:
    """One decode step's attention of a layer: B sequences of CTX tokens."""
    from zhilight_tpu_torch.kvcache.paged import gather_hm

    F, S = torch.nn.functional, 16
    fn, plain = ((A.paged_decode_attention_hm_q, A.paged_decode_attention_hm_q_plain) if int8
                 else (A.paged_decode_attention_hm, A.paged_decode_attention_hm_plain))
    maxp = CTX // S + 2
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    pools, rows = _pool_args(rng, Hkv, B * maxp * S, D, int8)
    q = _randn(rng, B, Hq, D)
    args = (q, *pools, _dev(tables), _dev(np.full(B, CTX, np.int32)), S, 1.0 / np.sqrt(D))
    k, v = gather_hm(rows, _dev(tables), S)  # [B, KV, Hkv, D] bf16
    kg = k[:, :CTX].transpose(1, 2).contiguous()
    vg = v[:, :CTX].transpose(1, 2).contiguous()
    gqa = dict(enable_gqa=True) if Hq != Hkv else {}
    nbytes = (B * CTX * Hkv * 2 * D * pools[0].element_size() + 2 * q.numel() * 2
              + tables.size * 4 + B * 4)
    if int8:
        nbytes += B * CTX * Hkv * 2 * 4  # one K and one V scale per (token, KV head)
    t_b, by = bound(nbytes, 4 * B * Hq * CTX * D)
    return dict(
        ms=time_ms(lambda: fn(*args)),
        plain_ms=time_ms(lambda: plain(*args), reps=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg, **gqa)),
        bound_ms=t_b, bound_by=by,
        # the same call without the backlog: device time plus the wrapper's host time
        call_ms=time_ms(lambda: fn(*args), backlog=False),
    )


def check_prefill(rng, P, cases, int8) -> float:
    """Packed prefill attention against its plain version on the valid rows;
    a one-segment case also goes through the single-sequence wrapper."""
    S, err = 16, 0.0
    fn, plain, twin, single = (
        (P.paged_prefill_attention_hm_packed_q, P.paged_prefill_attention_hm_packed_q_plain,
         P.paged_prefill_attention_hm_packed_q_twin, P.paged_prefill_attention_hm_q) if int8 else
        (P.paged_prefill_attention_hm_packed, P.paged_prefill_attention_hm_packed_plain,
         P.paged_prefill_attention_hm_packed_twin, P.paged_prefill_attention_hm))
    for c in cases:
        cl = np.array(c["cache_lens"], np.int32)
        ql = np.array(c["q_lens"], np.int32)
        NS, TC, D = len(cl), c["TC"], c["D"]
        tables, npages = _paged(rng, cl + ql, S)
        pools, _ = _pool_args(rng, c["Hkv"], npages * S, D, int8)
        q = _randn(rng, NS * TC, c["Hq"], D)
        tail = (S, 1.0 / np.sqrt(D), c.get("window", 0))
        tables = _dev(tables)
        if NS == 1:
            got = single(q, *pools, tables[0], int(cl[0]), int(ql[0]), *tail)
        else:
            got = fn(q, *pools, tables, _dev(cl), _dev(ql), *tail)
        want = plain(q, *pools, tables, _dev(cl), _dev(ql), *tail)
        want_twin = twin(q, *pools, tables, _dev(cl), _dev(ql), *tail)
        if not torch.isfinite(got).all():
            raise AssertionError(f"prefill attention {c}: non-finite output")
        e = e_twin = 0.0
        for s in range(NS):
            rows = slice(s * TC, s * TC + int(ql[s]))
            if ql[s]:
                e = max(e, (got[rows].float() - want[rows].float()).abs().max().item())
                e_twin = max(e_twin, (got[rows].float() - want_twin[rows].float()).abs().max().item())
        print(f"kernels: prefill {'int8' if int8 else 'bf16'}{_q_note()} {c} max_abs_err={e:.3e} "
              f"(twin {e_twin:.3e})", flush=True)
        if e > ATTN_TOL or e_twin > ATTN_TOL:
            raise AssertionError(f"prefill attention {c}: max abs err {e} (twin {e_twin}) > {ATTN_TOL}")
        err = max(err, e)
    return err


def time_prefill(rng, P, Hq, Hkv, D, CL, QL, int8) -> dict:
    """A chunk of QL tokens at cache length CL (the last full chunk of the
    time-to-first-token prompt)."""
    from zhilight_tpu_torch.kvcache.paged import gather_hm

    F, S = torch.nn.functional, 16
    fn, plain = ((P.paged_prefill_attention_hm_packed_q,
                  P.paged_prefill_attention_hm_packed_q_plain) if int8 else
                 (P.paged_prefill_attention_hm_packed, P.paged_prefill_attention_hm_packed_plain))
    tables, npages = _paged(rng, [CL + QL], S)
    pools, rows = _pool_args(rng, Hkv, npages * S, D, int8)
    q = _randn(rng, QL, Hq, D)
    args = (q, *pools, _dev(tables), _dev(np.array([CL], np.int32)),
            _dev(np.array([QL], np.int32)), S, 1.0 / np.sqrt(D))
    k, v = gather_hm(rows, _dev(tables[0]), S)  # [KV, Hkv, D] bf16
    kg = k[: CL + QL].transpose(0, 1)[None].contiguous()
    vg = v[: CL + QL].transpose(0, 1)[None].contiguous()
    qg = q.transpose(0, 1)[None].contiguous()
    mask = (torch.arange(CL + QL, device="cuda")[None, :]
            <= CL + torch.arange(QL, device="cuda")[:, None])
    gqa = dict(enable_gqa=True) if Hq != Hkv else {}
    keys = sum(CL + i + 1 for i in range(QL))
    nbytes = (CL + QL) * Hkv * 2 * D * pools[0].element_size() + 2 * q.numel() * 2
    if int8:
        nbytes += (CL + QL) * Hkv * 2 * 4
    t_b, by = bound(nbytes, 4 * Hq * D * keys)
    return dict(
        ms=time_ms(lambda: fn(*args)),
        plain_ms=time_ms(lambda: plain(*args), reps=10),
        library_ms=time_ms(
            lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, **gqa)),
        bound_ms=t_b, bound_by=by,
        call_ms=time_ms(lambda: fn(*args), backlog=False),
    )


def parent_kernels(csrc: str):
    """The row writes of an earlier tree (``csrc`` is its zhilight_tpu_torch/csrc):
    kv_write.cu, kv_write_2d.cu and kv_write_pair.cu, built by nvcc with this
    tree's flags into a temporary directory (each ``.cu`` with the headers
    beside it) and driven through their C signatures, which are those of this
    tree's copy modes (``zt_write_rows_hm``, ``zt_write_rows_2d``,
    ``zt_write_rows_pair``). Returns {name: fn}: hm(pool, k, v, slots) over
    contiguous rows [T, Hkv, D] in the pool's type, rows_2d(pool, rows, slots)
    over a pool [1, N, X] and contiguous rows, and pair(k_pool, v_pool, k, v,
    slots) over slot-major pools [1, N, Hkv, D] and contiguous rows [T, Hkv, D]
    in the pools' type."""
    import ctypes
    import tempfile

    from zhilight_tpu_torch.ops.cuda import _build

    out_dir = tempfile.mkdtemp(prefix="zt_parent_")
    names = ("kv_write", "kv_write_2d", "kv_write_pair")
    libs = {}
    t0 = time.monotonic()
    procs = [(name, subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-o", f"{out_dir}/{name}.so", f"{csrc}/{name}.cu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name in names]
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(f"{out_dir}/{name}.so")
    print(f"kernels: parent's {', '.join(names)} built in {time.monotonic() - t0:.1f} s",
          flush=True)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    w_hm = libs["kv_write"].zt_write_rows_hm
    w_hm.argtypes = [p, p, p, p, i, i, ll, i, p]
    w_2d = libs["kv_write_2d"].zt_write_rows_2d
    w_2d.argtypes = [p, p, p, i, ll, i, p]
    w_pair = libs["kv_write_pair"].zt_write_rows_pair
    w_pair.argtypes = [p, p, p, p, p, i, ll, i, p]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def hm(pool, k, v, slots):
        H, N, X = pool.shape
        _build.check(w_hm(pool.data_ptr(), k.data_ptr(), v.data_ptr(), slots.data_ptr(),
                          k.shape[0], H, N, X // 2 * pool.element_size(), stream()),
                     "parent write_rows_hm")
        return pool

    def rows_2d(pool, rows, slots):
        N, X = pool.shape[1:]
        _build.check(w_2d(pool.data_ptr(), rows.data_ptr(), slots.data_ptr(), rows.shape[0], N,
                          X * pool.element_size(), stream()), "parent write_rows_2d")
        return pool

    def pair(k_pool, v_pool, k, v, slots):
        N, Hkv, D = k_pool.shape[1:]
        _build.check(w_pair(k_pool.data_ptr(), v_pool.data_ptr(), k.data_ptr(), v.data_ptr(),
                            slots.data_ptr(), k.shape[0], N, Hkv * D * k_pool.element_size(),
                            stream()), "parent write_rows_pair")
        return k_pool, v_pool

    return dict(hm=hm, rows_2d=rows_2d, pair=pair)


def sequence_hm(write, pool, q, k, v, cos, sin, neox, slots, k_scale=None, v_scale=None):
    """The per-layer sequence the packed pool's prologue replaces (the parent
    tree's ``attention_layer`` and ``write_kv``): rope of q and of k, then the
    row write through ``write`` (rows contiguous in the pool's type), an int8
    pool's quantization and scale scatter around it. Returns q rotated."""
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.rope import apply_rope_rot

    q_rot = apply_rope_rot(q, cos, sin, neox)
    k_rot = apply_rope_rot(k, cos, sin, neox)
    if k_scale is None:
        write(pool, k_rot.to(pool.dtype).contiguous(), v.to(pool.dtype).contiguous(), slots)
        return q_rot
    rows, scales = W.quantize_rows(torch.stack((k_rot, v)))
    write(pool, rows[0], rows[1], slots)
    W.scatter_scales(k_scale, v_scale, scales, slots)
    return q_rot


def sequence_2d(write, pool, q_pe, c_kv, k_pe, cos, sin, neox, slots):
    """The per-layer sequence the latent pool's prologue replaces (the parent
    tree's ``mla_attention_layer`` and ``write_latent``): rope of q_pe and of
    k_pe, the latent row's concatenation, the row write. Returns q_pe rotated."""
    from zhilight_tpu_torch.ops.rope import apply_rope_rot

    q_rot = apply_rope_rot(q_pe, cos, sin, neox)
    k_rot = apply_rope_rot(k_pe[:, None, :], cos, sin, neox)[:, 0]
    write(pool, torch.cat([c_kv, k_rot], dim=-1), slots)
    return q_rot


def sequence_pair(write, k_pool, v_pool, q, k, v, cos, sin, neox, slots, k_scale=None,
                  v_scale=None):
    """The per-layer sequence the slot-major pools' prologue replaces (the
    parent tree's ``attention_layer`` and ``write_kv``): rope of q and of k,
    then the K and V row write through ``write`` (rows contiguous in the
    pools' type), an int8 pool's quantization and scale scatter around it.
    Returns q rotated."""
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.rope import apply_rope_rot

    q_rot = apply_rope_rot(q, cos, sin, neox)
    k_rot = apply_rope_rot(k, cos, sin, neox)
    if k_scale is None:
        write(k_pool, v_pool, k_rot.to(k_pool.dtype).contiguous(),
              v.to(k_pool.dtype).contiguous(), slots)
        return q_rot
    rows, scales = W.quantize_rows(torch.stack((k_rot, v)))
    write(k_pool, v_pool, rows[0], rows[1], slots)
    W.scatter_scales(k_scale, v_scale, scales, slots)
    return q_rot


def _turns(res: dict, flush=None, backlog: bool = True):
    """Time an earlier tree's call and this tree's in turns (parent, this
    tree, this tree, parent), into res[label]; ``backlog=False`` times the
    per-call cost with the host's time (``time_ms``)."""
    def turns(label, old, new):
        t = [time_ms(f, flush=flush, backlog=backlog) for f in (old, new, new, old)]
        res[label] = dict(parent_ms=[t[0], t[3]], new_ms=[t[1], t[2]])
        print(f"kernels: parent vs this tree, {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, "
              f"this tree {t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    return turns


def _record(rec: dict, name: str, err: float, main: str, shapes: dict) -> None:
    """The kernel's JSON numbers are those of its ``main`` shape; every timed
    shape is kept under ``shapes``."""
    rec[name].update(shapes[main], max_abs_err=err, shape=main, shapes=shapes)
    _record_print(name, shapes)


def _record_print(name: str, shapes: dict) -> None:
    for label, r in shapes.items():
        pair = f" unfused_pair_ms={r['unfused_pair_ms']:.4f}" if "unfused_pair_ms" in r else ""
        if "call_ms" in r:
            pair += f" call_ms={r['call_ms']:.4f} (host-inclusive, no backlog)"
        if "sequence_ms" in r:
            pair += (f" ({r['device_kernels']} device kernel(s)) replaced sequence "
                     f"ms={r['sequence_ms']:.4f} call_ms={r['sequence_call_ms']:.4f} "
                     f"({r['sequence_launches']} device kernels)")
        print(f"kernels: {name} at {label}: ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={_ms(r['library_ms'])}{pair}", flush=True)


def _ms(t) -> str:
    """A time for the log; None where no one PyTorch call computes the function."""
    return "null" if t is None else f"{t:.4f}"


# the bf16 decode kernel's split edges at Qwen2.5-14B's heads and batch (9
# splits of whole 64-token tiles of each sequence): contexts 1, 64, 65, 1152
# (every split full), 1153 (a last split of one token), an empty slot
SPLIT_CTX = [3712, 1, 0, 64, 65, 1152, 1153, 2000]
# head_dim 256 at Gemma-2-9B's attention geometry (16 / 8 heads of 256)
GEMMA2_HEADS = dict(Hq=16, Hkv=8, D=256)


def phase_kernels(rec: dict, args) -> None:
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P

    rng = np.random.default_rng(0)
    mini, qwen = MINICPM_HEADS, QWEN_HEADS
    lap = lap_timer("kernels")

    def record(name, err, main, shapes):
        _record(rec, name, err, main, shapes)

    # -- write_rows_hm: bf16 and int8 rows, bit-exact --------------------------
    check_write(rng, W)
    record("write_rows_hm", 0.0, "MiniCPM-2B decode step, 16 rows bf16", {
        "MiniCPM-2B decode step, 16 rows bf16": time_write(rng, W, 16, 36, 64, False),
        "Qwen2.5-14B decode step, 8 rows bf16": time_write(rng, W, 8, 8, 128, False),
        "Qwen2.5-14B decode step, 8 rows int8": time_write(rng, W, 8, 8, 128, True),
        "Qwen2.5-14B chunk, 512 rows bf16": time_write(rng, W, 512, 8, 128, False),
        "Qwen2.5-14B chunk, 512 rows int8": time_write(rng, W, 512, 8, 128, True),
    })

    # -- decode attention: bf16 pool, then int8 pool ---------------------------
    decode_cases = [
        dict(B=16, **mini, ctx_max=4096, window=0),
        dict(B=16, Hq=32, Hkv=8, D=128, ctx_max=4096, window=0),
        dict(B=16, **mini, ctx_max=1024, window=100),
        # Qwen2.5-14B at its serving batch: 40 query heads on 8 KV heads
        dict(B=8, **qwen, ctx=[3712, 7, 513, 1500, 100, 16, 250, 3201], window=0),
        dict(B=8, **qwen, ctx=[3712, 7, 0, 1500, 100, 16, 250, 3201], window=300),
    ]
    # the split edges, and the head dims and groups both kernels take: G 16
    # at 128 and 256, G 4 and 8 at 192, G 20 (two row groups) at 64 and 256,
    # a window across splits at 128 and 256
    wide_decode_cases = [
        dict(B=8, **qwen, ctx=SPLIT_CTX, window=0),
        dict(B=8, **qwen, ctx=SPLIT_CTX, window=700),  # a window across splits
        dict(B=8, Hq=16, Hkv=4, D=192, ctx_max=3000, window=0),
        dict(B=8, Hq=32, Hkv=2, D=256, ctx_max=3000, window=0),
        dict(B=8, Hq=32, Hkv=2, D=128, ctx_max=3000, window=0),
        dict(B=8, Hq=40, Hkv=2, D=64, ctx_max=700, window=0),
        dict(B=8, **GEMMA2_HEADS, ctx=SPLIT_CTX, window=300),
        dict(B=8, Hq=32, Hkv=4, D=192, ctx=SPLIT_CTX, window=0),
        dict(B=8, Hq=40, Hkv=2, D=256, ctx=SPLIT_CTX, window=300),
    ]
    for int8, name in ((False, "paged_decode_attention_hm"), (True, "paged_decode_attention_hm_q")):
        err = check_decode(rng, A, decode_cases, int8)
        # inputs of their own, so the earlier cases keep theirs
        err = max(err, check_decode(np.random.default_rng(9 if int8 else 1), A, wide_decode_cases,
                                    int8))
        kind = "int8" if int8 else "bf16"
        shapes = {
            # bench.py's decode shape, and the Qwen serving stage's
            f"MiniCPM-2B batch 16, context 512, {kind} pool":
                time_decode(rng, A, 16, **mini, CTX=512, int8=int8),
            f"Qwen2.5-14B batch 8, context 3712, {kind} pool":
                time_decode(rng, A, 8, **qwen, CTX=3712, int8=int8),
            f"head_dim 256 (16 / 8 heads) batch 8, context 3712, {kind} pool": time_decode(
                np.random.default_rng(10 if int8 else 4), A, 8, **GEMMA2_HEADS, CTX=3712,
                int8=int8),
        }
        record(name, err, list(shapes)[1 if int8 else 0], shapes)

    # -- prefill attention: bf16 pool, then int8 pool --------------------------
    prefill_cases = [
        dict(cache_lens=[0], q_lens=[512], TC=512, **mini),
        dict(cache_lens=[3205], q_lens=[512], TC=512, **mini),
        dict(cache_lens=[0, 16, 5, 300], q_lens=[128, 37, 0, 100], TC=128, **mini),
        dict(cache_lens=[0], q_lens=[512], TC=512, **qwen),
        dict(cache_lens=[3200], q_lens=[512], TC=512, **qwen),
        dict(cache_lens=[0, 16, 5, 300], q_lens=[128, 37, 0, 100], TC=128, **qwen),
        dict(cache_lens=[700, 40], q_lens=[128, 90], TC=128, window=200, **qwen),
    ]
    # head dims 192 and 256: a windowed chunk that starts and ends mid-page
    wide_prefill_cases = [
        dict(cache_lens=[0, 16, 5, 300], q_lens=[128, 37, 0, 100], TC=128, Hq=8, Hkv=4, D=192),
        dict(cache_lens=[3205], q_lens=[300], TC=320, window=1000, **GEMMA2_HEADS),
        dict(cache_lens=[0, 45], q_lens=[96, 50], TC=96, Hq=32, Hkv=2, D=256),
        dict(cache_lens=[3205, 20], q_lens=[300, 77], TC=320, window=700, **qwen),
    ]
    for int8, name in ((False, "paged_prefill_attention_hm_packed"),
                       (True, "paged_prefill_attention_hm_packed_q")):
        err = check_prefill(rng, P, prefill_cases, int8)
        # inputs of their own, so the earlier cases keep theirs
        err = max(err, check_prefill(np.random.default_rng(3 if int8 else 2), P,
                                     wide_prefill_cases, int8))
        kind = "int8" if int8 else "bf16"
        shapes = {
            f"MiniCPM-2B 512-token chunk at cache 3200, {kind} pool":
                time_prefill(rng, P, **mini, CL=3200, QL=512, int8=int8),
            f"Qwen2.5-14B 512-token chunk at cache 3200, {kind} pool":
                time_prefill(rng, P, **qwen, CL=3200, QL=512, int8=int8),
            f"head_dim 256 (16 / 8 heads) 512-token chunk at cache 3200, {kind} pool":
                time_prefill(np.random.default_rng(7 if int8 else 5), P, **GEMMA2_HEADS,
                             CL=3200, QL=512, int8=int8),
        }
        record(name, err, list(shapes)[1 if int8 else 0], shapes)
    lap("head-major attention")
    kernels_tp_rank(rec, A, P)
    lap("kernels_tp_rank")
    kernels_prologue(rec, np.random.default_rng(6), args.parent_csrc)
    lap("kernels_prologue")
    kernels_w4a16(rec, rng)
    lap("kernels_w4a16")
    kernels_deepseek(rec, rng)
    lap("kernels_deepseek")
    kernels_fp8(rec, rng)
    lap("kernels_fp8")
    kernels_slot_major(rec, rng)
    lap("kernels_slot_major")
    kernels_window(rec, rng)
    lap("kernels_window")
    kernels_layered_flush(rec, np.random.default_rng(11), args.parent_csrc)
    lap("kernels_layered_flush")
    kernels_fused(rec, rng)
    lap("kernels_fused")
    kernels_fp16(rec, np.random.default_rng(13))
    lap("kernels_fp16")
    kernels_tp_rank_mla(rec, np.random.default_rng(17))
    lap("kernels_tp_rank_mla")
    kernels_tp_rank_quant(rec, np.random.default_rng(19))
    lap("kernels_tp_rank_quant")
    kernels_large_pools(rec, np.random.default_rng(23))
    lap("kernels_large_pools")
    for name in KERNELS:
        r = rec[name]
        print(f"kernels: {name} ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={_ms(r['library_ms'])}", flush=True)


# pools of more than 2^31 elements, so that an offset into them formed in 32
# bits would land elsewhere: a packed pool [Hkv, N, 2D] at Qwen2.5-14B's heads
# of 8,650,752 slots (48 x 11264 pages of 16: each head plane 2,214,592,512
# elements, 35.4 GB of bf16), and slot-major pools [1, N, Hkv, D] at
# H2O-Danube-1.8B's heads of 3,407,872 slots (2,181,038,080 elements each).
# A model of few layers reaches such pools on an 80 GB card.
LARGE_HM_SLOTS = 48 * 11264 * 16
LARGE_PAIR_SLOTS = 208 * 1024 * 16
LARGE_CTX = [3712, 7, 513, 1500, 100, 16, 250, 3201]  # a decode batch; a chunk of sequence 0


def kernels_large_pools(rec: dict, rng) -> None:
    """Rows 1-3 and 5-6 on a packed pool (bf16, then int8 with its scales)
    and rows 10, 12 and 16 on slot-major pools, each of more than 2^31
    elements, every page the inputs touch among the pools' highest: the
    prologue writing the 512 rows of a chunk at positions 3200-3711 into a
    zeroed pool, bit-exact against its plain version, and no element outside
    those rows written; decode attention over LARGE_CTX and the chunk's
    prefill attention against their plain versions (ATTN_TOL); the fused
    write + attend's output (ATTN_TOL) and written rows (bit-exact). Each
    kernel's max_abs_err takes these errors too."""
    from zhilight_tpu_torch.kvcache.paged import _quantize_rows, slot_indices
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P

    S, CL, QL = 16, 3200, 512
    torch.cuda.empty_cache()  # what the earlier checks left cached

    def tables(n_slots):
        """LARGE_CTX's shuffled tables moved to the pool's highest pages,
        the chunk's slots and every slot the tables reach."""
        t, npages = _paged(rng, LARGE_CTX, S)
        t = np.where(t >= 0, t + n_slots // S - npages, -1).astype(np.int32)
        pos = np.arange(CL, CL + QL)
        chunk = (t[0, pos // S] * S + pos % S).astype(np.int32)
        t = _dev(t)
        reach = slot_indices(t[t >= 0][None], S)[0]
        return t, _dev(chunk), reach

    def hold(name, what, err, limit):
        if not (np.isfinite(err) and err <= limit):
            raise AssertionError(f"{name} {what}: max abs err {err} > {limit}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        print(f"kernels: {name} {what}: max abs err {err:.3e}", flush=True)

    def written_only(name, what, arrays, rows):
        """Bit-exact rows (got, want pairs) and no other element written."""
        if not all(torch.equal(g, w) for g, w in rows):
            raise AssertionError(f"{name} {what}: rows differ from the plain version's")
        inside = sum(int(g.count_nonzero()) for g, _ in rows)
        outside = sum(int(a.select(0, i).count_nonzero()) for a in arrays
                      for i in range(a.shape[0])) - inside
        if outside:
            raise AssertionError(f"{name} {what}: {outside} elements written outside its rows")
        print(f"kernels: {name} {what}: bit-exact, nothing written outside its rows", flush=True)

    # -- rows 1-3 (bf16) and 1, 5, 6 (int8) on one packed pool ---------------------
    Hq, Hkv, D = QWEN_HEADS["Hq"], QWEN_HEADS["Hkv"], QWEN_HEADS["D"]
    N, scale = LARGE_HM_SLOTS, 1.0 / np.sqrt(D)
    for int8 in (False, True):
        kind = f"{'int8' if int8 else 'bf16'} pool [{Hkv}, {N}, {2 * D}]"
        pool = torch.zeros(Hkv, N, 2 * D, dtype=torch.int8 if int8 else torch.bfloat16,
                           device="cuda")
        scales = [torch.zeros(Hkv, N + 1, device="cuda") for _ in "kv"] if int8 else []
        t, chunk, reach = tables(N)
        idx = chunk.long()
        (q, k, v, cos, sin, neox, _), _, _ = prologue_hm_case(rng, QL, Hq, Hkv, D, int8, True, False)
        got_q = W.rope_write_rows_hm(pool, q, k, v, cos, sin, neox, chunk, *scales)
        got = [pool[:, idx].clone()] + [s[:, idx].clone() for s in scales]
        pool[:, idx] = 0
        for s in scales:
            s[:, idx] = 0
        want_q = W.rope_write_rows_hm_plain(pool, q, k, v, cos, sin, neox, chunk, *scales)
        want = [pool[:, idx]] + [s[:, idx] for s in scales]
        if not torch.equal(got_q, want_q):
            raise AssertionError(f"rope_write_rows_hm {kind}: q differs from the plain version's")
        written_only("rope_write_rows_hm", kind, [pool, *scales], list(zip(got, want)))
        del got, want
        # every slot the tables reach, filled as the cache fills it
        if int8:
            filled, ks, vs = _int8_pool(rng, Hkv, len(reach), D)
            pool[:, reach], scales[0][:, reach], scales[1][:, reach] = filled, ks[:, :-1], vs[:, :-1]
        else:
            pool[:, reach] = _randn(rng, Hkv, len(reach), 2 * D)
        pools = (pool, *scales)
        dec, dec_plain, pre, pre_plain = (
            (A.paged_decode_attention_hm_q, A.paged_decode_attention_hm_q_plain,
             P.paged_prefill_attention_hm_q, P.paged_prefill_attention_hm_packed_q_plain) if int8
            else (A.paged_decode_attention_hm, A.paged_decode_attention_hm_plain,
                  P.paged_prefill_attention_hm, P.paged_prefill_attention_hm_packed_plain))
        qd, ctx = _randn(rng, len(LARGE_CTX), Hq, D), _dev(np.array(LARGE_CTX, np.int32))
        err = (dec(qd, *pools, t, ctx, S, scale).float()
               - dec_plain(qd, *pools, t, ctx, S, scale).float()).abs().max().item()
        hold("paged_decode_attention_hm_q" if int8 else "paged_decode_attention_hm",
             f"{kind}, contexts {LARGE_CTX}", err, ATTN_TOL)
        qp = _randn(rng, QL, Hq, D)
        lens = [_dev(np.array([x], np.int32)) for x in (CL, QL)]
        err = (pre(qp, *pools, t[0], CL, QL, S, scale).float()
               - pre_plain(qp, *pools, t[:1], *lens, S, scale).float()).abs().max().item()
        hold("paged_prefill_attention_hm_packed_q" if int8 else "paged_prefill_attention_hm_packed",
             f"{kind}, a {QL}-token chunk at cache {CL} (single-sequence form)", err, ATTN_TOL)
        del pool, pools, scales
        torch.cuda.empty_cache()

    # -- rows 12, 10 and 16 on slot-major pools ---------------------------------------
    Hq, Hkv, D = DANUBE_HEADS["Hq"], DANUBE_HEADS["Hkv"], DANUBE_HEADS["D"]
    N, scale = LARGE_PAIR_SLOTS, 1.0 / np.sqrt(D)
    kind = f"bf16 pools [1, {N}, {Hkv}, {D}]"
    kv = [torch.zeros(1, N, Hkv, D, dtype=torch.bfloat16, device="cuda") for _ in "kv"]
    t, chunk, reach = tables(N)
    idx = chunk.long()
    (q, k, v, cos, sin, neox, _), _ = prologue_pair_case(rng, QL, Hq, Hkv, D, False, True, False)
    got_q = W.rope_write_rows_pair(*kv, q, k, v, cos, sin, neox, chunk)
    got = [x[:, idx].clone() for x in kv]
    for x in kv:
        x[:, idx] = 0
    want_q = W.rope_write_rows_pair_plain(*kv, q, k, v, cos, sin, neox, chunk)
    if not torch.equal(got_q, want_q):
        raise AssertionError(f"rope_write_rows_pair {kind}: q differs from the plain version's")
    written_only("rope_write_rows_pair", kind, kv, [(g, x[:, idx]) for g, x in zip(got, kv)])
    del got
    for x in kv:
        x[0, reach] = _randn(rng, len(reach), Hkv, D)
    qd, ctx = _randn(rng, len(LARGE_CTX), Hq, D), _dev(np.array(LARGE_CTX, np.int32))
    err = (PA.paged_decode_attention(qd, *kv, t, ctx, S, scale).float()
           - PA.paged_decode_attention_plain(qd, *kv, t, ctx, S, scale).float()).abs().max().item()
    hold("paged_decode_attention", f"{kind}, contexts {LARGE_CTX}", err, ATTN_TOL)
    # the fused write + attend: this step's rows at each context's last position
    last = np.array(LARGE_CTX) - 1
    slots = _dev((t.cpu().numpy()[np.arange(len(last)), last // S] * S + last % S).astype(np.int32))
    k_new, v_new = _randn(rng, len(last), Hkv, D), _randn(rng, len(last), Hkv, D)
    sidx = slots.long()
    old = [x[0, sidx].clone() for x in kv]
    tail = (k_new, v_new, slots, t, ctx, S, scale)
    out = PA.paged_decode_attention_fused(qd, *kv, *tail)
    got = [x[0, sidx].clone() for x in kv]
    for x, o in zip(kv, old):
        x[0, sidx] = o
    err = (out.float() - PA.paged_decode_attention_fused_plain(qd, *kv, *tail).float()
           ).abs().max().item()
    if not all(torch.equal(g, x[0, sidx]) for g, x in zip(got, kv)):
        raise AssertionError(f"paged_decode_attention_fused {kind}: written rows differ from the "
                             f"plain version's")
    hold("paged_decode_attention_fused", f"{kind}, contexts {LARGE_CTX}, rows bit-exact", err,
         ATTN_TOL)
    del kv, got, old
    torch.cuda.empty_cache()


# a TP=2 rank of Qwen2.5-14B (the tp phase): 20 query heads over 4 KV heads of
# 128, G 5, which no single-process path runs
TP_RANK_HEADS = dict(Hq=20, Hkv=4, D=128)


def kernels_tp_rank(rec: dict, A, P) -> None:
    """Rows 2 and 3 (bf16) at a TP=2 rank's heads (TP_RANK_HEADS) against
    their plain versions and twins, at the tp phase's engine batch (4 slots:
    its two greedy prompts decoding at 532 and 1532 tokens, one slot at
    context 1, one idle) and at the decode kernel's split edges, and the
    prefill at its chunks (a first 512-token chunk, the 1500-token prompt's
    last at cache 1024, four packed segments); the split plans those shapes
    pick are printed. Timed at the tp phase's decode step and last chunk,
    kept under ``shapes`` of each kernel's record (its main numbers stay the
    single-process Qwen2.5-14B shape's)."""
    rng, S = np.random.default_rng(15), 16
    decode = [dict(B=4, **TP_RANK_HEADS, ctx=[1532, 532, 1, 0], window=0),
              dict(B=8, **TP_RANK_HEADS, ctx=SPLIT_CTX, window=0)]
    for c in decode:
        G, maxp = c["Hq"] // c["Hkv"], max(c["ctx"]) // S + 1
        splits = A.decode_splits(c["B"], c["Hkv"], G, maxp * S,
                                 A._capacity(torch.device("cuda"), c["D"], "attn_headmajor"))
        print(f"kernels: TP=2 rank shape, decode B {c['B']}, {c['Hq']} / {c['Hkv']} heads of "
              f"{c['D']}, contexts {c['ctx']}: {splits} context splits", flush=True)
    err = check_decode(rng, A, decode, False)
    shapes = {"Qwen2.5-14B TP=2 rank (20 / 4 heads) batch 4, context 1532, bf16 pool":
              time_decode(rng, A, 4, **TP_RANK_HEADS, CTX=1532, int8=False)}
    rec["paged_decode_attention_hm"]["shapes"].update(shapes)
    rec["paged_decode_attention_hm"]["max_abs_err"] = max(
        rec["paged_decode_attention_hm"]["max_abs_err"], err)
    _record_print("paged_decode_attention_hm", shapes)
    prefill = [dict(cache_lens=[0], q_lens=[512], TC=512, **TP_RANK_HEADS),
               dict(cache_lens=[1024], q_lens=[476], TC=512, **TP_RANK_HEADS),
               dict(cache_lens=[0, 16, 5, 300], q_lens=[128, 37, 0, 100], TC=128,
                    **TP_RANK_HEADS)]
    err = check_prefill(rng, P, prefill, False)
    shapes = {"Qwen2.5-14B TP=2 rank (20 / 4 heads) 476-token chunk at cache 1024, bf16 pool":
              time_prefill(rng, P, **TP_RANK_HEADS, CL=1024, QL=476, int8=False)}
    rec["paged_prefill_attention_hm_packed"]["shapes"].update(shapes)
    rec["paged_prefill_attention_hm_packed"]["max_abs_err"] = max(
        rec["paged_prefill_attention_hm_packed"]["max_abs_err"], err)
    _record_print("paged_prefill_attention_hm_packed", shapes)


# a TP=2 rank's projections (K, N): its columns of q, k/v and gate/up (the
# bf16 output mode) and its rows of o and down (the fp32 output mode: a
# partial product, all-reduced in fp32 and rounded once)
TP_RANK_W4_SHAPES = {"q_proj": (5120, 2560), "k/v_proj": (5120, 512), "o_proj": (2560, 5120),
                     "gate/up_proj": (5120, 6912), "down_proj": (6912, 5120)}
TP_RANK_FP8_SHAPES = {"q_proj": (4096, 2048), "k/v_proj": (4096, 512), "o_proj": (2048, 4096),
                      "gate/up_proj": (4096, 6144), "down_proj": (6144, 4096)}
ROW_PARALLEL = ("o_proj", "down_proj")


def kernels_tp_rank_quant(rec: dict, rng) -> None:
    """Rows 4 and 9 at a TP=2 rank's projections (Qwen2.5-14B's int4,
    Qwen3-8B-FP8's), at a decode step of the tp phase's 4 slots and a
    512-token chunk, in both output modes (bf16, and fp32: a row-parallel
    partial), each against its plain version in the same mode (1e-2 of the
    largest output), then at the split-K edges of a row-parallel shape in the
    fp32 mode (each kernel at split counts from one to one stage a split,
    runs ending inside a group or scale block). Timed with a
    cold L2 in both modes beside the plain version and ``torch.mm`` on the
    bf16 weight dequantized beforehand (fp32 output in the fp32 mode); kept
    under ``shapes`` of each kernel's record, the mode the rank's path uses
    (fp32 for o and down) as ``ms``."""
    from zhilight_tpu_torch.ops.cuda import fp8_matmul as F8
    from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
    from zhilight_tpu_torch.ops.quant import dequant_int4, pack_int4

    gs, f32 = 128, torch.float32
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    worst = {"w4a16_matmul": [0.0, 0.0], "fp8_block_matmul": [0.0, 0.0]}  # rel, abs

    def held(kernel, what, got, want, dtype):
        if got.dtype != dtype:
            raise AssertionError(f"{kernel} {what}: output {got.dtype}, not {dtype}")
        diff = (got.float() - want.float()).abs().max().item()
        e = diff / want.float().abs().max().item()
        if not (torch.isfinite(got).all() and e <= W4A16_TOL):
            raise AssertionError(f"{kernel} {what}: max rel err {e} > {W4A16_TOL}")
        w = worst[kernel]
        w[0], w[1] = max(w[0], e), max(w[1], diff)

    def int4_weights(K, N):
        q = _dev(rng.integers(0, 16, (K, N)).astype(np.int8))
        s = _dev((rng.random((K // gs, N)) * 0.004 + 0.001).astype(np.float32))
        z = _dev(rng.integers(1, 16, (K // gs, N)).astype(np.float32))
        w = pack_int4(q)
        return ((w, s, z), dequant_int4(w, s, z, torch.bfloat16),
                K * N // 2 + 8 * (K // gs) * N)

    def fp8_weights(K, N):
        wt = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).cuda() * 0.02
        w8, bs = fp8_block_quantize(wt)
        w8 = w8.view(torch.uint8).t().contiguous().view(torch.float8_e4m3fn)
        bs = bs.t().contiguous()
        wd = (w8.float().reshape(K // 128, 128, N // 128, 128) * bs[:, None, :, None]
              ).reshape(K, N).to(torch.bfloat16)
        return (w8, bs), wd, K * N + 4 * (K // 128) * (N // 128)

    cases = (("w4a16_matmul", "Qwen2.5-14B", TP_RANK_W4_SHAPES, int4_weights, Q.w4a16_matmul,
              Q.w4a16_matmul_plain),
             ("fp8_block_matmul", "Qwen3-8B-FP8", TP_RANK_FP8_SHAPES, fp8_weights,
              F8.fp8_block_matmul, F8.fp8_block_matmul_plain))
    for kernel, model, shapes, make, fn, plain in cases:
        rows = {}
        for pname, (K, N) in shapes.items():
            w, wd, wbytes = make(K, N)
            for M in (4, 512):
                x = _randn(rng, M, K)
                for out in (None, f32):
                    held(kernel, f"{pname} M={M} out {out}", fn(x, *w, out_dtype=out),
                         plain(x, *w, out_dtype=out), out or torch.bfloat16)
                t = {}
                for mode, out in (("bf16", None), ("fp32", f32)):
                    t[mode] = time_ms(lambda: fn(x, *w, out_dtype=out), flush=flush)
                    t[mode + "_bound"] = bound(wbytes + 2 * M * K + (4 if out else 2) * M * N,
                                               2 * M * K * N)
                mode = "fp32" if pname in ROW_PARALLEL else "bf16"
                out = f32 if mode == "fp32" else None
                lib = (lambda: torch.mm(x, wd, out_dtype=f32)) if out else (lambda: torch.mm(x, wd))
                t_b, by = t[mode + "_bound"]
                rows[f"{model} TP=2 rank {pname} (K {K}, N {N}), M {M}, {mode} out"] = dict(
                    ms=t[mode], bf16_out_ms=t["bf16"], fp32_out_ms=t["fp32"],
                    plain_ms=time_ms(lambda: plain(x, *w, out_dtype=out), flush=flush,
                                     reps=5 if M == 512 else 30),
                    library_ms=time_ms(lib, flush=flush), bound_ms=t_b, bound_by=by)
                print(f"kernels: {kernel} TP=2 rank {pname} K={K} N={N} M={M}: bf16 out "
                      f"ms={t['bf16']:.4f} (bound {t['bf16_bound'][0]:.4f}), fp32 out "
                      f"ms={t['fp32']:.4f} (bound {t['fp32_bound'][0]:.4f})", flush=True)
            del w, wd
        rec[kernel].setdefault("shapes", {}).update(rows)
        _record_print(kernel, rows)

    # split-K edges in the fp32 mode at a row-parallel shape: row 4 at
    # Qwen2.5-14B's o_proj rows (K 2560: 20 decode stages of 64 weight rows,
    # 40 prefill stages of 32, a group every 128 rows), row 9 at Qwen3-8B's
    # (K 2048: 16 K blocks)
    K, N = TP_RANK_W4_SHAPES["o_proj"]
    (w, s, z), _, _ = int4_weights(K, N)
    for M, cfgs, counts in ((4, (0,), (2, 3, 7, 10, 20)), (37, (1, 2), (1, 3, 7, 20, 40)),
                            (130, (1, 2), (1, 6, 8, 40))):
        x = _randn(rng, M, K)
        want = Q.w4a16_matmul_plain(x, w, s, z, out_dtype=f32)
        for cfg in cfgs:
            for splits in counts:
                out = torch.empty(M, N, dtype=f32, device="cuda")
                Q._run(x, w, s, z, out, True, (cfg, splits))
                held("w4a16_matmul", f"o_proj M={M} config {cfg} splits {splits} fp32", out,
                     want, f32)
    K, N = TP_RANK_FP8_SHAPES["o_proj"]
    (w8, bs), _, _ = fp8_weights(K, N)
    dev = F8._DEVICES[torch.device("cuda", torch.cuda.current_device())]
    for M, cfg, counts in ((4, 0, (2, 3, 6, 8, 16)), (37, 1, (1, 2, 4, 16)), (300, 1, (1, 3, 8))):
        x = _randn(rng, M, K)
        want = F8.fp8_block_matmul_plain(x, w8, bs, out_dtype=f32)
        kept = dev.plans.get((M, N, K))
        for splits in counts:
            dev.plans[M, N, K] = (cfg, splits)
            held("fp8_block_matmul", f"o_proj M={M} config {cfg} splits {splits} fp32",
                 F8.fp8_block_matmul(x, w8, bs, out_dtype=f32), want, f32)
        dev.plans.pop((M, N, K))
        if kept is not None:
            dev.plans[M, N, K] = kept
    for kernel, (e, diff) in worst.items():
        rec[kernel]["max_abs_err"] = max(rec[kernel]["max_abs_err"], diff)
        print(f"kernels: {kernel} at TP=2 rank shapes, both output modes and the fp32 mode's "
              f"split-K edges: max rel err {e:.3e} (tolerance {W4A16_TOL}), max abs err "
              f"{diff:.3e}", flush=True)
    del scratch


# a TP=2 rank of DeepSeek-V2-Lite (the tp phase): 8 of the 16 heads over the
# whole latent pool, 32 of the 64 experts
TP_RANK_MLA_HEADS = 8


def kernels_tp_rank_mla(rec: dict, rng) -> None:
    """Rows 2b, 7 and 8 at a TP=2 rank's shapes of the DeepSeek-V2-Lite tp
    path, each against its plain version, kept under ``shapes`` of each
    kernel's record (its main numbers stay the single-process shape's):

    - row 2b at 8 heads of the 576 / 512 latent, batch 4, at the tp phase's
      contexts (its two greedy prompts decoding at 532 and 1532 tokens, one
      slot at context 1, one idle) and at the split edges of the plan those
      shapes pick, against the plain version and the twin at the kernel's
      split count; timed at the path's decode step;
    - row 7, the latent prologue, at 8 heads: a decode step's 4 rows and a
      512-token chunk, bit-exact, timed at the decode step;
    - row 8, gate/up and down, over rank 1's 32 local experts of a 64-expert
      top-6 routing, 48 and 3072 pairs, the remote pairs (about half) in the
      overflow bucket: the local pairs' rows against the plain version;
      timed with a cold L2, its bound counting the occupied local experts'
      bytes only, beside ``torch._grouped_mm`` over the local rows."""
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import quant_ragged as R
    from zhilight_tpu_torch.ops.quant import dequant_expert_int4

    F, S, X, VD, H, B = torch.nn.functional, 16, 576, 512, TP_RANK_MLA_HEADS, 4
    scale = 1.0 / np.sqrt(192)
    dev = torch.device("cuda", torch.cuda.current_device())

    # -- row 2b -----------------------------------------------------------------
    maxp = 2048 // S  # the path's max_model_len
    sp = A.mla_plan(dev, B, H, maxp * S)
    err = 0.0
    for ctx in ([1532, 532, 1, 0], [0, 1, 16 * sp, 16 * sp + 1],
                [min(64 * sp, 2046), min(64 * sp + 1, 2047), 65, 2047]):
        ctx = np.array(ctx, np.int32)
        tables, npages = _paged(rng, ctx, S)
        td, cd = _dev(tables), _dev(ctx)
        args = (_randn(rng, B, H, X), _randn(rng, npages * S, X), td, cd, S, scale)
        got = A.paged_mla_decode(*args, v_dim=VD)
        n_split = A.mla_plan(dev, B, H, tables.shape[1] * S)
        e = (got.float() - A.paged_mla_decode_plain(*args, v_dim=VD).float()).abs().max().item()
        e_twin = (got.float() - A.paged_mla_decode_twin(*args, VD, n_split).float()
                  ).abs().max().item()
        print(f"kernels: TP=2 rank shape, mla decode B={B} H={H} ctx={ctx.tolist()} "
              f"({n_split} splits) max_abs_err={e:.3e} (twin {e_twin:.3e})", flush=True)
        if not (torch.isfinite(got).all() and e <= ATTN_TOL and e_twin <= ATTN_TOL):
            raise AssertionError(f"TP=2 rank MLA decode ctx {ctx}: max abs err {e} "
                                 f"(twin {e_twin}) > {ATTN_TOL}")
        if got[torch.from_numpy(ctx == 0)].any():
            raise AssertionError("TP=2 rank MLA decode: an empty slot is not zero")
        err = max(err, e)
    ctx = np.array([1532, 532, 1, 0], np.int32)
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    pool, q = _randn(rng, B * maxp * S, X), _randn(rng, B, H, X)
    args = (q, pool, _dev(tables), _dev(ctx), S, scale)
    CTX = int(ctx.max())
    lat = pool.reshape(B, maxp * S, X)[:, None, :CTX]
    kg = lat.contiguous().expand(-1, H, -1, -1)
    vg = lat[..., :VD].contiguous().expand(-1, H, -1, -1)
    mask = (torch.arange(CTX, device="cuda")[None, :] < _dev(ctx)[:, None].long())[:, None, None]
    used = int(ctx.sum())
    t_b, by = bound(used * X * 2 + q.numel() * 2 + B * H * VD * 2 + tables.size * 4 + B * 4,
                    2 * H * used * (X + VD))
    label = (f"DeepSeek-V2-Lite TP=2 rank ({H} heads) batch {B}, contexts {ctx.tolist()} "
             f"({sp} splits)")
    shapes = {label: dict(
        ms=time_ms(lambda: A.paged_mla_decode(*args, v_dim=VD)),
        call_ms=time_ms(lambda: A.paged_mla_decode(*args, v_dim=VD), backlog=False),
        plain_ms=time_ms(lambda: A.paged_mla_decode_plain(*args, v_dim=VD), reps=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask, scale=scale)),
        bound_ms=t_b, bound_by=by)}
    rec["paged_mla_decode"]["shapes"].update(shapes)
    rec["paged_mla_decode"]["max_abs_err"] = max(rec["paged_mla_decode"]["max_abs_err"], err)
    _record_print("paged_mla_decode", shapes)

    # -- row 7 ------------------------------------------------------------------
    c = LATENT_PROLOGUE
    for T in (B, 512):
        args, pool = prologue_2d_case(rng, T, True, True, H=H)
        got, want = pool.clone(), pool.clone()
        q_got = W.rope_write_rows_2d(got, *args)
        q_want = W.rope_write_rows_2d_plain(want, *args)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(q_got, q_want)):
            raise AssertionError(f"TP=2 rank latent prologue T={T}: not bit-exact")
        print(f"kernels: TP=2 rank shape, rope_write_rows_2d {H} heads T={T} bit-exact",
              flush=True)
    args, pool = prologue_2d_case(rng, B, True, False, H=H)
    R_, L_ = c["R"], c["L"]
    nbytes = B * (2 * H * R_ * 2 + L_ * 2 + R_ * 2 + 2 * R_ * 4 + (L_ + R_) * 2 + 4)
    t_b, by = _prologue_bound(nbytes, 3 * B * (H + 1) * R_)
    run = lambda: W.rope_write_rows_2d(pool, *args)
    shapes = {f"DeepSeek-V2-Lite TP=2 rank ({H} heads), decode step, {B} tokens": dict(
        ms=time_ms(run), call_ms=time_ms(run, backlog=False),
        plain_ms=time_ms(lambda: W.rope_write_rows_2d_plain(pool, *args)),
        library_ms=None, bound_ms=t_b, bound_by=by)}
    rec["rope_write_rows_2d"]["shapes"].update(shapes)
    _record_print("rope_write_rows_2d", shapes)

    # -- row 8 ------------------------------------------------------------------
    El = e0 = EXPERTS // 2  # rank 1's experts [32, 64)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    shapes, rel = {}, 0.0
    for wname, (K, N, pad) in DEEPSEEK_STACKS.items():
        w_p, s_, z = _expert_stack(rng, K, N, pad, E=El)
        wd = dequant_expert_int4(w_p, s_, z, torch.bfloat16)
        for R_pairs, TM, seed in ((48, 8, 5), (3072, 64, 6)):
            flat = _routed(R_pairs, seed) - e0
            valid = (flat >= 0) & (flat < El)
            bucket = np.where(valid, flat, El)
            x, dest, tile_expert, num_occ = _ragged_rows(rng, bucket, TM, K, pad, E=El)
            args = (x, w_p, s_, z, tile_expert, num_occ)
            # dest follows the rows sorted by expert: the local pairs first, then the bucket
            mine = dest[: int(valid.sum())]
            got = R.w4a16_ragged_matmul(*args)[mine]
            want = R.w4a16_ragged_matmul_plain(*args)[mine]
            diff = (got.float() - want.float()).abs().max().item()
            e = diff / want.float().abs().max().item()
            rec["w4a16_ragged_matmul"]["max_abs_err"] = max(
                rec["w4a16_ragged_matmul"]["max_abs_err"], diff)
            print(f"kernels: TP=2 rank shape, w4a16_ragged {wname} {R_pairs} pairs, "
                  f"{int(valid.sum())} local over {El} experts, TM={TM}: max rel err {e:.3e}",
                  flush=True)
            if not (torch.isfinite(got).all() and e <= W4A16_TOL):
                raise AssertionError(f"TP=2 rank w4a16_ragged {wname} {R_pairs}: {e}")
            rel = max(rel, e)
            local = flat[valid]
            experts, counts = np.unique(local, return_counts=True)
            Rl = len(local)
            t_b, by = bound(len(experts) * (K * N // 2 + 8 * (K // EXPERT_GS) * N)
                            + 2 * Rl * (K + N), 2 * Rl * K * N)
            xs = x[mine]  # the local rows, sorted by expert
            ends = _dev(np.cumsum(np.bincount(local, minlength=El)).astype(np.int32))
            grouped = lambda: torch._grouped_mm(xs, wd, offs=ends)
            label = (f"DeepSeek-V2-Lite TP=2 rank {wname}, {R_pairs} pairs ({Rl} local over "
                     f"{len(experts)} of {El} experts)")
            shapes[label] = dict(
                ms=time_ms(lambda: R.w4a16_ragged_matmul(*args), flush=scratch.zero_),
                plain_ms=time_ms(lambda: R.w4a16_ragged_matmul_plain(*args), reps=5,
                                 flush=scratch.zero_),
                library_ms=time_ms(grouped, flush=scratch.zero_),
                bound_ms=t_b, bound_by=by)
        del w_p, s_, z, wd
    del scratch
    rec["w4a16_ragged_matmul"]["shapes"].update(shapes)
    _record_print("w4a16_ragged_matmul", shapes)
    print(f"kernels: TP=2 rank shapes, w4a16_ragged max rel err {rel:.3e}", flush=True)


# the packed pool's prologue at the main paths' attention shapes: label ->
# (query heads, KV heads, head_dim, int8 pool, decode batch)
PROLOGUE_SHAPES = {
    "MiniCPM-2B, 36 / 36 heads of 64, bf16 pool": (36, 36, 64, False, 16),
    "Qwen2.5-14B, 40 / 8 heads of 128, bf16 pool": (40, 8, 128, False, 8),
    "Qwen2.5-14B, 40 / 8 heads of 128, int8 pool": (40, 8, 128, True, 8),
    "Qwen2.5-14B TP=2 rank, 20 / 4 heads of 128, bf16 pool": (20, 4, 128, False, 4),
    "Qwen3-8B, 32 / 8 heads of 128, bf16 pool": (32, 8, 128, False, 8),
    "head_dim 256 (16 / 8 heads), int8 pool": (16, 8, 256, True, 8),
}
# the latent pool's: DeepSeek-V2-Lite (16 heads, q_pe of 64 in rows of 128 + 64,
# latent rows of 512 + 64), decode batch 8
LATENT_PROLOGUE = dict(H=16, nope=128, R=64, L=512, B=8)
# the slot-major pools' prologue: label -> (query heads, KV heads, head_dim,
# int8 pools, checked (tokens, neox) cases); timed at H2O-Danube-1.8B's
# (PAIR_PROLOGUE_TIMED)
_DECODE_CHUNK = ((8, True), (8, False), (512, True))
PAIR_PROLOGUE_SHAPES = {
    f"H2O-Danube-1.8B, 32 / 8 heads of 80, {kind} pools": (
        32, 8, 80, kind == "int8", ((8, True), (8, False), (512, True), (512, False), (2048, True)))
    for kind in ("bf16", "int8")
} | {
    f"{Hq} / {Hkv} heads of {D}{note}, {kind} pools": (Hq, Hkv, D, kind == "int8", _DECODE_CHUNK)
    for note, Hq, Hkv, D in ((" (ZT_NO_PACKED_KV=1)", 40, 8, 128), ("", 16, 4, 100),
                             (" (the verify recipe's checkpoint)", 4, 2, 16))
    for kind in ("bf16", "int8")
}
PAIR_PROLOGUE_TIMED = ("H2O-Danube-1.8B, 32 / 8 heads of 80, bf16 pools",
                       "H2O-Danube-1.8B, 32 / 8 heads of 80, int8 pools")
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores


def device_kernels(fn) -> int:
    """Kernels (and copies) the device runs for one call of ``fn``, counted
    in a torch.profiler trace, as ``profile`` counts a decode step's."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _prologue_bound(nbytes: float, ops: float):
    """The larger of the bytes' time and the fp32 operations' time, ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rope_rows(rng, T, D, neox):
    from zhilight_tpu_torch.config.model_config import RopeConfig
    from zhilight_tpu_torch.ops.rope import build_rope_table

    table = build_rope_table(D, 1e6, RopeConfig(neox_style=neox), 32768, 32768)
    return table.rot_values(_dev(rng.integers(0, 32000, T).astype(np.int32)))


def _prologue_slots(rng, T, N, skip):
    """T distinct slots; with ``skip`` one -1 and one past the pool (neither
    writes a row; both scales go to the spare column)."""
    slots = rng.permutation(N)[:T].astype(np.int32)
    if skip and T > 1:
        slots[T // 3], slots[T - 1] = -1, N + 3
    return _dev(slots)


def prologue_hm_case(rng, T, Hq, Hkv, D, int8, neox, skip):
    """Inputs of the packed pool's prologue as the model hands them over: q,
    k, v views of one fused qkv output [T, (Hq + 2 Hkv) D] (token 0's V rows
    hold 1 and c / 127 for every code c, so an int8 pool receives every code),
    cos/sin [T, D], slots. Returns (args, pool tensors, N)."""
    N = max(T // 16 + 4, 64) * 16
    qkv = _randn(rng, T, (Hq + 2 * Hkv) * D)
    codes = (torch.arange(-127, 128, device="cuda") / 127).repeat(Hkv * D // 255 + 1)
    row0 = torch.cat([torch.ones(Hkv, 1, device="cuda"),
                      codes[: Hkv * (D - 1)].reshape(Hkv, -1)], 1)
    qkv[0, (Hq + Hkv) * D:] = row0.reshape(-1).to(qkv.dtype)
    q, k, v = (x.reshape(T, -1, D) for x in torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], -1))
    cos, sin = _rope_rows(rng, T, D, neox)
    slots = _prologue_slots(rng, T, N, skip)
    if int8:
        pool = [torch.zeros(Hkv, N, 2 * D, dtype=torch.int8, device="cuda"),
                torch.full((Hkv, N + 1), -1.0, device="cuda"),
                torch.full((Hkv, N + 1), -1.0, device="cuda")]
    else:
        pool = [_randn(rng, Hkv, N, 2 * D)]
    return (q, k, v, cos, sin, neox, slots), pool, N


def prologue_pair_case(rng, T, Hq, Hkv, D, int8, neox, skip):
    """Inputs of the slot-major pools' prologue as the model hands them
    over: q, k, v views of one fused qkv output [T, (Hq + 2 Hkv) D]; over int8
    pools each V row holds 1 and then c / 127 for c = -127 ... 127 in turn,
    across the rows, so the pools receive every code once enough rows are
    written. Returns (args, [k_pool, v_pool(, k_scale, v_scale)])."""
    N = max(T // 16 + 4, 64) * 16
    qkv = _randn(rng, T, (Hq + 2 * Hkv) * D)
    if int8:
        codes = (torch.arange(T * Hkv * (D - 1), device="cuda") % 255 - 127) / 127
        rows = torch.cat([torch.ones(T, Hkv, 1, device="cuda"), codes.reshape(T, Hkv, D - 1)], -1)
        qkv[:, (Hq + Hkv) * D:] = rows.reshape(T, -1).to(qkv.dtype)
    q, k, v = (x.reshape(T, -1, D) for x in torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], -1))
    cos, sin = _rope_rows(rng, T, D, neox)
    slots = _prologue_slots(rng, T, N, skip)
    if int8:
        pools = [torch.zeros(1, N, Hkv, D, dtype=torch.int8, device="cuda") for _ in "kv"]
        pools += [torch.full((Hkv, N + 1), -1.0, device="cuda") for _ in "kv"]
    else:
        pools = [_randn(rng, 1, N, Hkv, D) for _ in "kv"]
    return (q, k, v, cos, sin, neox, slots), pools


def _skipped_scales(col, fresh, Hkv) -> bool:
    """Every KV head's spare-column scale is one of the skipped rows' (they
    land there in no set order)."""
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.rope import apply_rope_rot

    q, k, v, cos, sin, neox, slots, pools = fresh()
    N = pools[0].shape[1]
    _, sc = W.quantize_rows(torch.stack((apply_rope_rot(k, cos, sin, neox), v)))
    cands = sc[:, (slots < 0) | (slots >= N)]  # [2, n, Hkv]
    return bool(((col[:, None] == cands.permute(2, 0, 1).reshape(Hkv, -1)).any(1)).all())


def _prologue_bytes(T, Hq, Hkv, D, pool_elem, int8) -> int:
    """Bytes a packed or slot-major prologue must move: q, k, v and cos/sin
    read, q rotated and the K and V rows (and their scales) written."""
    return (T * (Hq + 2 * Hkv) * D * 2 + 2 * T * D * 4 + T * Hq * D * 2
            + T * Hkv * 2 * D * pool_elem + T * 4 + (2 * T * Hkv * 4 if int8 else 0))


def _prologue_ops(T, Hq, Hkv, D, int8) -> int:
    """fp32 operations of the rope (three a rotated element) and of the int8
    quantization (six a quantized element)."""
    return 3 * T * (Hq + Hkv) * D + (6 * T * Hkv * 2 * D if int8 else 0)


def prologue_2d_case(rng, T, neox, skip, H=LATENT_PROLOGUE["H"]):
    """Inputs of the latent pool's prologue as the model hands them over:
    q_pe a view of the q projection [T, H, nope + R], c_kv [T, L], k_pe the
    strided tail of kv_a [T, L + R]. Returns (args, pool)."""
    c = LATENT_PROLOGUE
    N = max(T // 16 + 4, 64) * 16
    q = _randn(rng, T, H, c["nope"] + c["R"])
    kv_a = _randn(rng, T, c["L"] + c["R"])
    cos, sin = _rope_rows(rng, T, c["R"], neox)
    args = (q[..., c["nope"]:], _randn(rng, T, c["L"]), kv_a[:, c["L"]:], cos, sin, neox,
            _prologue_slots(rng, T, N, skip))
    return args, _randn(rng, 1, N, c["L"] + c["R"])


def kernels_prologue(rec: dict, rng, parent_csrc: str = "") -> None:
    """The attention prologues (rows 1, 7 and 11-12 redesigned: rope of q
    and k, the int8 quantization and scale scatter, the row write, one
    launch) bit-exact against their plain versions (the same PyTorch
    composition on the card) at PROLOGUE_SHAPES, DeepSeek-V2-Lite's latent
    rows and PAIR_PROLOGUE_SHAPES (slot-major pools: H2O-Danube-1.8B's 32 / 8
    heads of 80, 40 / 8 of 128, head_dim 100 and 16; bf16 and int8): decode
    batches in both rope styles, a 512-token chunk and four packed chunks
    (2048 tokens), with a skipped row and one past the pool, q, k and v views
    of one fused qkv output; every int8 code written; q rotated, pools and
    scales equal, the spare column holding a skipped row's scales. Then timed
    at each packed and latent shape and at Danube's slot-major shapes,
    decode and a 512-token chunk: device time, host-inclusive time (no
    backlog), the plain version, and the sequence of launches it replaces
    with this tree's copy-mode kernel (rope of q and k, the write and, over an
    int8 pool, the quantization and scatter; device and host-inclusive). No
    one PyTorch call computes the function (library_ms null). With
    ``parent_csrc`` the same sequence with the earlier tree's write kernel,
    in turns against the prologue, device and host-inclusive; one JSON
    line."""
    from zhilight_tpu_torch.ops.cuda import kv_write as W

    def check(name, what, run, plain, fresh, npools=1, int8=False, every=True, spare=None):
        """run and plain on two copies of fresh()'s inputs, whose last item is
        the list of pools (npools of them) then scales: q rotated and the pools
        equal; over int8 pools the scales of the written rows equal, the spare
        column holding one skipped row's (``spare``), and with ``every`` each
        of the 255 codes written."""
        a, b = fresh(), fresh()
        got, want = run(*a), plain(*b)
        torch.cuda.synchronize()
        ok = torch.equal(got, want) and all(
            torch.equal(x, y) for x, y in zip(a[-1][:npools], b[-1][:npools]))
        if int8:
            N = a[-1][0].shape[1]
            if every:
                codes = torch.unique(torch.cat([x.flatten() for x in a[-1][:npools]]))
                ok = ok and torch.equal(codes, torch.arange(-127, 128, device="cuda",
                                                            dtype=torch.int8))
            for g, w in zip(a[-1][npools:], b[-1][npools:]):
                ok = ok and torch.equal(g[:, :N], w[:, :N]) and spare(g[:, N])
        if not ok:
            raise AssertionError(f"{name} {what}: not bit-exact")
        print(f"kernels: {name} {what} bit-exact", flush=True)

    # -- the packed pool's prologue ---------------------------------------------
    for label, (Hq, Hkv, D, int8, B) in PROLOGUE_SHAPES.items():
        cases = [(B, True), (B, False), (512, True)]
        if label.startswith("Qwen2.5"):
            cases.append((2048, True))
        for T, neox in cases:
            seed = int(rng.integers(2**31))

            def fresh():
                args, pool, _ = prologue_hm_case(np.random.default_rng(seed), T, Hq, Hkv, D, int8,
                                                 neox, True)
                return (*args, pool)

            check("rope_write_rows_hm", f"{label}, T={T}, {'neox' if neox else 'interleaved'}",
                  lambda *x: W.rope_write_rows_hm(x[-1][0], *x[:-1], *x[-1][1:]),
                  lambda *x: W.rope_write_rows_hm_plain(x[-1][0], *x[:-1], *x[-1][1:]),
                  fresh, int8=int8, spare=lambda col, fresh=fresh, Hkv=Hkv:
                  _skipped_scales(col, fresh, Hkv))

    parent = parent_kernels(parent_csrc) if parent_csrc else None
    compare = {}
    shapes = {}
    for label, (Hq, Hkv, D, int8, B) in PROLOGUE_SHAPES.items():
        for T, what in ((B, f"decode step, {B} tokens"), (512, "512-token chunk")):
            args, pool, N = prologue_hm_case(rng, T, Hq, Hkv, D, int8, True, False)
            run = lambda: W.rope_write_rows_hm(pool[0], *args, *pool[1:])
            seq = lambda: sequence_hm(W.write_rows_hm, pool[0], *args, *pool[1:])
            t_b, by = _prologue_bound(_prologue_bytes(T, Hq, Hkv, D, pool[0].element_size(), int8),
                                      _prologue_ops(T, Hq, Hkv, D, int8))
            shapes[f"{label}, {what}"] = dict(
                ms=time_ms(run), call_ms=time_ms(run, backlog=False),
                plain_ms=time_ms(lambda: W.rope_write_rows_hm_plain(pool[0], *args, *pool[1:])),
                library_ms=None, bound_ms=t_b, bound_by=by,
                sequence_ms=time_ms(seq), sequence_call_ms=time_ms(seq, backlog=False),
                sequence_launches=device_kernels(seq), device_kernels=device_kernels(run),
            )
            if parent is not None:
                old = lambda: sequence_hm(parent["hm"], pool[0], *args, *pool[1:])
                pa = [x.clone() for x in pool]
                pb = [x.clone() for x in pool]
                qa = sequence_hm(parent["hm"], pa[0], *args, *pa[1:])
                qb = W.rope_write_rows_hm(pb[0], *args, *pb[1:])
                if not (torch.equal(qa, qb) and all(torch.equal(x, y) for x, y in zip(pa, pb))):
                    raise AssertionError(f"parent vs this tree, row 1 {label} {what}: differ")
                for backlog in (True, False):
                    _turns(compare, backlog=backlog)(
                        f"row 1, {label}, {what}, {'device' if backlog else 'host-inclusive'}",
                        old, run)
    _record(rec, "rope_write_rows_hm", 0.0,
            "Qwen2.5-14B, 40 / 8 heads of 128, bf16 pool, decode step, 8 tokens", shapes)

    # -- the latent pool's prologue --------------------------------------------
    c = LATENT_PROLOGUE
    for T, neox in ((c["B"], True), (c["B"], False), (512, True), (2048, True)):
        seed = int(rng.integers(2**31))

        def fresh():
            args, pool = prologue_2d_case(np.random.default_rng(seed), T, neox, True)
            return (*args, [pool])

        check("rope_write_rows_2d", f"DeepSeek-V2-Lite, T={T}, {'neox' if neox else 'interleaved'}",
              lambda *x: W.rope_write_rows_2d(x[-1][0], *x[:-1]),
              lambda *x: W.rope_write_rows_2d_plain(x[-1][0], *x[:-1]), fresh)
    shapes = {}
    for T, what in ((c["B"], f"decode step, {c['B']} tokens"), (512, "512-token chunk")):
        args, pool = prologue_2d_case(rng, T, True, False)
        run = lambda: W.rope_write_rows_2d(pool, *args)
        seq = lambda: sequence_2d(W.write_rows_2d, pool, *args)
        H, R, L = c["H"], c["R"], c["L"]
        nbytes = T * (2 * H * R * 2 + L * 2 + R * 2 + 2 * R * 4 + (L + R) * 2 + 4)
        t_b, by = _prologue_bound(nbytes, 3 * T * (H + 1) * R)
        label = f"DeepSeek-V2-Lite, 16 heads, rows of 512 + 64, {what}"
        shapes[label] = dict(
            ms=time_ms(run), call_ms=time_ms(run, backlog=False),
            plain_ms=time_ms(lambda: W.rope_write_rows_2d_plain(pool, *args)),
            library_ms=None, bound_ms=t_b, bound_by=by,
            sequence_ms=time_ms(seq), sequence_call_ms=time_ms(seq, backlog=False),
            sequence_launches=device_kernels(seq), device_kernels=device_kernels(run),
        )
        if parent is not None:
            old = lambda: sequence_2d(parent["rows_2d"], pool, *args)
            pa, pb = pool.clone(), pool.clone()
            if not (torch.equal(sequence_2d(parent["rows_2d"], pa, *args),
                                W.rope_write_rows_2d(pb, *args)) and torch.equal(pa, pb)):
                raise AssertionError(f"parent vs this tree, row 7 {what}: differ")
            for backlog in (True, False):
                _turns(compare, backlog=backlog)(
                    f"row 7, {label}, {'device' if backlog else 'host-inclusive'}", old, run)
    _record(rec, "rope_write_rows_2d", 0.0, list(shapes)[0], shapes)

    # -- the slot-major pools' prologue ------------------------------------------
    def pair_fn(fn):  # fn(k_pool, v_pool, q, k, v, cos, sin, neox, slots(, scales))
        return lambda *x: fn(*x[-1][:2], *x[:-1], *x[-1][2:])

    for label, (Hq, Hkv, D, int8, cases) in PAIR_PROLOGUE_SHAPES.items():
        for T, neox in cases:
            seed = int(rng.integers(2**31))

            def fresh():
                args, pools = prologue_pair_case(np.random.default_rng(seed), T, Hq, Hkv, D, int8,
                                                 neox, True)
                return (*args, pools)

            # token 0 alone holds every code, or enough rows are written to
            check("rope_write_rows_pair", f"{label}, T={T}, {'neox' if neox else 'interleaved'}",
                  pair_fn(W.rope_write_rows_pair), pair_fn(W.rope_write_rows_pair_plain), fresh,
                  npools=2, int8=int8, every=Hkv * (D - 1) >= 255 or T >= 512,
                  spare=lambda col, fresh=fresh, Hkv=Hkv: _skipped_scales(col, fresh, Hkv))
    shapes = {}
    for label in PAIR_PROLOGUE_TIMED:
        Hq, Hkv, D, int8, _ = PAIR_PROLOGUE_SHAPES[label]
        for T, what in ((8, "decode step, 8 tokens"), (512, "512-token chunk")):
            args, pools = prologue_pair_case(rng, T, Hq, Hkv, D, int8, True, False)
            run = lambda: W.rope_write_rows_pair(*pools[:2], *args, *pools[2:])
            seq = lambda: sequence_pair(W.write_rows_pair, *pools[:2], *args, *pools[2:])
            t_b, by = _prologue_bound(_prologue_bytes(T, Hq, Hkv, D, pools[0].element_size(), int8),
                                      _prologue_ops(T, Hq, Hkv, D, int8))
            shapes[f"{label}, {what}"] = dict(
                ms=time_ms(run), call_ms=time_ms(run, backlog=False),
                plain_ms=time_ms(
                    lambda: W.rope_write_rows_pair_plain(*pools[:2], *args, *pools[2:])),
                library_ms=None, bound_ms=t_b, bound_by=by,
                sequence_ms=time_ms(seq), sequence_call_ms=time_ms(seq, backlog=False),
                sequence_launches=device_kernels(seq), device_kernels=device_kernels(run),
            )
            if parent is not None:
                old = lambda: sequence_pair(parent["pair"], *pools[:2], *args, *pools[2:])
                pa = [x.clone() for x in pools]
                pb = [x.clone() for x in pools]
                qa = sequence_pair(parent["pair"], *pa[:2], *args, *pa[2:])
                qb = W.rope_write_rows_pair(*pb[:2], *args, *pb[2:])
                if not (torch.equal(qa, qb) and all(torch.equal(x, y) for x, y in zip(pa, pb))):
                    raise AssertionError(f"parent vs this tree, rows 11-12 {label} {what}: differ")
                for backlog in (True, False):
                    _turns(compare, backlog=backlog)(
                        f"rows 11-12, {label}, {what}, {'device' if backlog else 'host-inclusive'}",
                        old, run)
                if not int8:  # the copy mode (write_kv's row write) against the parent's kernel
                    rows = [_randn(rng, T, Hkv, D) for _ in "kv"]
                    pa = [x.clone() for x in pools]
                    pb = [x.clone() for x in pools]
                    parent["pair"](*pa, *rows, args[6])
                    W.write_rows_pair(*pb, *rows, args[6])
                    if not all(torch.equal(x, y) for x, y in zip(pa, pb)):
                        raise AssertionError(f"parent vs this tree, rows 11-12 copy mode {what}: "
                                             "differ")
                    _turns(compare)(f"rows 11-12 copy mode, {label}, {what}, device",
                                    lambda: parent["pair"](*pools, *rows, args[6]),
                                    lambda: W.write_rows_pair(*pools, *rows, args[6]))
    _record(rec, "rope_write_rows_pair", 0.0, f"{PAIR_PROLOGUE_TIMED[0]}, decode step, 8 tokens",
            shapes)
    if parent is not None:
        print(json.dumps({"parent_compare": compare}), flush=True)


def kernels_w4a16(rec: dict, rng) -> None:
    """w4a16_matmul against its plain version at the Qwen2.5-14B projections'
    (K, N), both weight formats, decode to prefill M, and at its split-K and
    layout edges; then timed with a cold L2 (a decode step streams every
    layer's weights once) at M 8, 128 and 512, each shape also at every
    kernel and split count the kernel takes (the "sweep:" lines behind the
    host's plan)."""
    from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
    from zhilight_tpu_torch.ops.quant import (dequant_int4, int4_linear, pack_int4,
                                              pad_int4_groups)

    gs = 128

    def weights(K, N):
        q = _dev(rng.integers(0, 16, (K, N)).astype(np.int8))
        s = _dev((rng.random((K // gs, N)) * 0.004 + 0.001).astype(np.float32))
        z = _dev(rng.integers(1, 16, (K // gs, N)).astype(np.float32))
        return q, s, z

    abs_err = 0.0

    def check(what, got, want):
        """max |got - want| / max |want|, held to W4A16_TOL."""
        nonlocal abs_err
        diff = (got.float() - want.float()).abs().max().item()
        e = diff / want.float().abs().max().item()
        if not (torch.isfinite(got).all() and e <= W4A16_TOL):
            raise AssertionError(f"w4a16 {what}: max rel err {e} > {W4A16_TOL}")
        abs_err = max(abs_err, diff)
        return e

    err = 0.0
    planar = {}
    for K, N in QWEN_W4_SHAPES.values():
        q, s, z = weights(K, N)
        planar[K, N] = (pack_int4(q), s, z)
        for fmt, w in (("planar", planar[K, N][0]), ("nibbles", q)):
            es = []
            for M in (1, 8, 16, 37, 128, 512):
                x = _randn(rng, M, K)
                es.append(check(f"{fmt} M={M} K={K} N={N}", Q.w4a16_matmul(x, w, s, z),
                                Q.w4a16_matmul_plain(x, w, s, z)))
            print(f"kernels: w4a16 {fmt} K={K} N={N} M=1,8,16,37,128,512 max rel err "
                  f"{max(es):.3e}", flush=True)
            err = max(err, *es)
    # act-order: the perm gather in int4_linear, then the kernel
    K, N = 5120, 1024
    q, s, z = weights(K, N)
    perm = _dev(rng.permutation(K).astype(np.int32))
    x = _randn(rng, 8, K)
    p = {"w_p": pack_int4(q), "scales": s, "zeros": z, "perm": perm}
    e = check("perm", int4_linear(p, x), Q.w4a16_matmul_plain(x[:, perm.long()], p["w_p"], s, z))
    # a K the loader pads (DeepSeek-V2-Lite's expert down_proj, 1408 at gs 128)
    K, N = 1408, 2048
    q, s, z = weights(K, N)
    canon = pad_int4_groups({"w_p": q, "scales": s, "zeros": z})
    p = dict(canon, w_p=pack_int4(canon["w_p"]))
    x = _randn(rng, 8, K)
    e2 = check("padded K", int4_linear(p, x), Q.w4a16_matmul_plain(x, q, s, z))
    err = max(err, e, e2)
    print(f"kernels: w4a16 perm max rel err {e:.3e}; K 1408 padded to "
          f"{p['w_p'].shape[0] * 2} max rel err {e2:.3e}", flush=True)

    # split-K edges. Qwen2.5-14B's k/v shape has 2560 weight rows, a group
    # every 128: the prefill kernels' stages of 32 rows at split counts whose
    # runs end inside a group (3, 6, 7, 9), the decode kernel's stages of 64
    # (at most 8 a split) at 6, 7 and one stage a split (40)
    w, s, z = planar[5120, 1024]
    for M, cfgs, counts in ((8, (0,), (5, 6, 7, 10, 20, 40)),
                            (37, (1, 2), (1, 3, 6, 7, 9, 16)), (130, (1, 2), (1, 3, 6, 7, 9, 16))):
        x = _randn(rng, M, 5120)
        want = Q.w4a16_matmul_plain(x, w, s, z)
        for cfg in cfgs:
            for splits in counts:
                out = torch.empty(M, 1024, dtype=torch.bfloat16, device="cuda")
                Q._run(x, w, s, z, out, True, (cfg, splits))
                err = max(err, check(f"M={M} config {cfg} splits {splits}", out, want))
    # N a multiple of 8 but not of 16 (8-byte weight copies), a group size
    # that is not a multiple of 32 rows (scales per weight), both formats
    for K, N, G in ((5120, 1032, 40), (768, 200, 16)):
        q, s, z = weights(K, N) if G == K // gs else (
            _dev(rng.integers(0, 16, (K, N)).astype(np.int8)),
            _dev((rng.random((G, N)) * 0.004 + 0.001).astype(np.float32)),
            _dev(rng.integers(1, 16, (G, N)).astype(np.float32)))
        for w in (pack_int4(q), q):
            for M in (5, 16, 130):
                x = _randn(rng, M, K)
                err = max(err, check(f"K={K} N={N} G={G} {w.dtype} M={M}",
                                     Q.w4a16_matmul(x, w, s, z), Q.w4a16_matmul_plain(x, w, s, z)))
    # a plan with several splits at Qwen's down_proj K: two calls, the same bits
    K, N = 13824, 1024
    q, s, z = weights(K, N)
    w = pack_int4(q)
    x = _randn(rng, 8, K)
    first = Q.w4a16_matmul(x, w, s, z)
    err = max(err, check("K=13824 N=1024 M=8", first, Q.w4a16_matmul_plain(x, w, s, z)))
    if not torch.equal(first, Q.w4a16_matmul(x, w, s, z)):
        raise AssertionError("w4a16: a second call at a split-K plan gave other bits")
    print(f"kernels: w4a16 split-K plan at K=13824 N=1024 M=8: "
          f"{Q._DEVICES[x.device].plans[8, N, K, True]} (config, splits), a second call "
          f"bit-identical; over every case max rel err {err:.3e}, max abs err {abs_err:.3e}",
          flush=True)

    # timed: each call finds the L2 cold, as in a decode step
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    dev = Q._DEVICES[torch.device("cuda", torch.cuda.current_device())]
    for M in (8, 128, 512):
        for name, (K, N) in QWEN_W4_SHAPES.items():
            w, s, z = planar[K, N]
            x = _randn(rng, M, K)
            wd = dequant_int4(w, s, z, torch.bfloat16)
            t_b, by = bound(K * N // 2 + 8 * (K // gs) * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
            row = dict(
                ms=time_ms(lambda: Q.w4a16_matmul(x, w, s, z), flush=flush),
                plain_ms=time_ms(lambda: Q.w4a16_matmul_plain(x, w, s, z), flush=flush),
                library_ms=time_ms(lambda: torch.matmul(x, wd), flush=flush),
                bound_ms=t_b, bound_by=by,
            )
            print(f"kernels: w4a16 {name} M={M} K={K} N={N} plan={dev.plans[M, N, K, True]} "
                  f"ms={row['ms']:.4f} bound_ms={t_b:.4f} ({by}) plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} (torch.matmul on the dequantized "
                  f"bf16 weight)", flush=True)
            if (M, K, N) == (8, 5120, 13824):  # gate/up_proj at the serving batch
                rec["w4a16_matmul"].update(row, max_abs_err=abs_err)
            times = []
            for cfg in range(len(Q.CONFIGS)):
                stages = K // 2 // Q.STAGE_ROWS[cfg]
                for splits in (1, 2, 3, 4, 5, 6, 8, 10, 14, 16, 20, 27, 32):
                    per = -(-stages // splits)
                    if -(-stages // per) != splits or (
                            cfg == 0 and (M > 16 or per * Q.STAGE_ROWS[0] > Q.DECODE_ROWS)):
                        continue
                    out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
                    t = time_ms(lambda: Q._run(x, w, s, z, out, True, (cfg, splits)), flush=flush)
                    times.append(f"{cfg}/{splits}:{t:.4f}")
            print(f"sweep: w4a16 M={M} K={K} N={N} config/splits:ms {' '.join(times)}",
                  flush=True)
    del scratch


def check_fp8_codes(F8, M: int) -> float:
    """Every finite e4m3 code through fp8_block_matmul: weight rows 0 and 1
    of a [128, 256] weight hold the 254 codes that are not NaN (each twice),
    unit block scales, and x rows 0 and 1 are one-hot on them, so those output
    rows are the codes' values, bit for bit; the other rows (random x over
    random finite codes) are held to the plain version at FP8_TOL. Returns
    their max abs error."""
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    bits = np.zeros((128, 256), np.uint8)
    bits[:2, :254] = np.stack([codes, codes[::-1]])
    bits[2:] = np.random.default_rng(M).integers(0, 0x7F, (126, 256))
    w = _dev(bits).view(torch.float8_e4m3fn)
    bs = torch.ones(1, 2, device="cuda")
    x = torch.zeros(M, 128, dtype=torch.bfloat16, device="cuda")
    x[0, 0] = x[1, 1] = 1.0
    x[2:, 2:] = _randn(np.random.default_rng(M + 1), M - 2, 126)
    got, want = F8.fp8_block_matmul(x, w, bs), F8.fp8_block_matmul_plain(x, w, bs)
    exact = w[:2].float().to(torch.bfloat16)
    if not (torch.equal(got[:2], exact) and exact.isfinite().all()):
        bad = (got[:2].float() != exact.float()).nonzero()[:8].tolist()
        raise AssertionError(f"fp8_block_matmul M={M}: e4m3 codes not exact at {bad}")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= FP8_TOL * want.float().abs().max().item():
        raise AssertionError(f"fp8_block_matmul M={M} over the codes: max abs err {err}")
    print(f"kernels: fp8_block_matmul M={M}: every finite e4m3 code exact", flush=True)
    return err


def kernels_fp8(rec: dict, rng) -> None:
    """fp8_block_matmul against its plain version at Qwen3-8B's seven projection
    shapes (four distinct K x N) at a decode batch (M = 8) and a prefill chunk
    (M = 512); then timed with a cold L2 (a decode step streams every layer's
    weights once) beside the plain version and ``torch.matmul`` on a bf16
    weight dequantized beforehand."""
    from zhilight_tpu_torch.ops.cuda import fp8_matmul as F8

    def weights(K, N):
        """e4m3 weights quantized from normal values, block by block."""
        w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).cuda() * 0.02
        w8, s = fp8_block_quantize(w)  # HF layout [out, in], scales [out/128, in/128]
        w8 = w8.view(torch.uint8).t().contiguous().view(torch.float8_e4m3fn)
        nan = ((w8.view(torch.uint8) & 0x7F) == 0x7F).sum().item()
        if nan:
            raise AssertionError(f"fp8 weights K={K} N={N}: {nan} NaN encodings")
        return w8, s.t().contiguous()

    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rel_err, abs_err, shapes = 0.0, 0.0, {}
    for pname, (K, N) in QWEN3_SHAPES.items():
        w8, bs = weights(K, N)
        wd = (w8.float().reshape(K // 128, 128, N // 128, 128) * bs[:, None, :, None]
              ).reshape(K, N).to(torch.bfloat16)  # for the library call
        for M in (8, 512):
            x = _randn(rng, M, K)
            got, want = F8.fp8_block_matmul(x, w8, bs), F8.fp8_block_matmul_plain(x, w8, bs)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            e = diff / want.float().abs().max().item()
            if not (torch.isfinite(got).all() and e <= FP8_TOL):
                raise AssertionError(f"fp8_block_matmul {pname} M={M}: max rel err {e} > {FP8_TOL}")
            if not torch.equal(got, F8.fp8_block_matmul(x, w8, bs)):
                raise AssertionError(f"fp8_block_matmul {pname} M={M}: a repeated call differs")
            rel_err, abs_err = max(rel_err, e), max(abs_err, diff)
            t_b, by = bound(K * N + 4 * (K // 128) * (N // 128) + 2 * M * K + 2 * M * N,
                            2 * M * K * N)
            shapes[f"Qwen3-8B {pname} (K {K}, N {N}), M {M}"] = dict(
                ms=time_ms(lambda: F8.fp8_block_matmul(x, w8, bs), flush=scratch.zero_),
                plain_ms=time_ms(lambda: F8.fp8_block_matmul_plain(x, w8, bs), reps=5,
                                 flush=scratch.zero_),
                library_ms=time_ms(lambda: torch.matmul(x, wd), flush=scratch.zero_),
                bound_ms=t_b, bound_by=by, max_rel_err=e,
            )
            print(f"kernels: fp8_block_matmul {pname} K={K} N={N} M={M}: max rel err {e:.3e}",
                  flush=True)
        del w8, bs, wd
    del scratch
    for M in (8, 512):  # both kernels
        abs_err = max(abs_err, check_fp8_codes(F8, M))
    print(f"kernels: fp8_block_matmul over every case max rel err {rel_err:.3e}, max abs err "
          f"{abs_err:.3e} (library: torch.matmul on the bf16 weight dequantized beforehand)",
          flush=True)
    _record(rec, "fp8_block_matmul", abs_err, "Qwen3-8B gate/up_proj (K 4096, N 12288), M 8", shapes)


# DeepSeek-V2-Lite's routed expert stacks: (K, N, zero-scale pad groups at
# the end of K); the loader pads the down projection's K 1408 to 1536
DEEPSEEK_STACKS = {"gate/up (K 2048, N 1408)": (2048, 1408, 0), "down (K 1536, N 2048)": (1536, 2048, 1)}
EXPERTS, EXPERT_GS = 64, 128


def _expert_stack(rng, K, N, pad_groups=0, E=EXPERTS):
    """A planar int4 stack of ``E`` experts, group EXPERT_GS, its last
    ``pad_groups`` groups with zero scales (the loader's padding)."""
    from zhilight_tpu_torch.ops.quant import pack_expert_int4

    gs = EXPERT_GS
    q4 = _dev(rng.integers(0, 16, (E, K, N)).astype(np.int8))
    s = _dev((rng.random((E, K // gs, N)) * 0.004 + 0.001).astype(np.float32))
    z = _dev(rng.integers(1, 16, (E, K // gs, N)).astype(np.float32))
    if pad_groups:
        s[:, -pad_groups:] = 0
    return pack_expert_int4(q4), s, z


def _routed(R_, seed):
    """R_ / 6 tokens' top-6 experts, drawn without replacement per token;
    expert 1 gets no rows."""
    g = np.random.default_rng(seed)
    flat = np.concatenate([g.permutation(EXPERTS - 1)[:6] for _ in range(R_ // 6)])
    return np.where(flat >= 1, flat + 1, flat)


def _ragged_rows(rng, flat, TM, K, pad=0, E=EXPERTS):
    """Rows routed to the experts ``flat`` in ``ragged_layout``'s order (E + 1
    groups, the last an overflow bucket, as models/moe.py lays them out; an
    expert shard's remote pairs name bucket E): x [Mp, K] bf16, zero in the
    alignment padding and the pad groups' columns; and dest, tile_expert,
    num_occ."""
    from zhilight_tpu_torch.ops.quant import ragged_layout

    _, dest, tile_expert, num_occ, mp = ragged_layout(_dev(np.asarray(flat).astype(np.int32)),
                                                      E + 1, TM, occ_experts=E)
    x = torch.zeros(mp, K, dtype=_ELEM[-1], device="cuda")
    x[dest] = _randn(rng, len(flat), K)
    if pad:
        x[:, K - pad * EXPERT_GS:] = 0
    return x, dest, tile_expert, num_occ


def kernels_deepseek(rec: dict, rng) -> None:
    """The three kernels of the DeepSeek-V2-Lite path at its shapes (16 heads,
    latent rows of 576 = 512 + 64 bf16, 64 experts of 2048 x 1408, top 6, group
    128): each against its plain version (the latent decode also against its
    twin, and at its edges: check_latent_edges), then timed (the latent
    decode also at other split counts; the grouped matmul: kernels_ragged)."""
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W

    F, S, X, VD, H = torch.nn.functional, 16, 576, 512, 16
    scale = 1.0 / np.sqrt(192)

    # -- write_rows_2d: a decode step's 8 rows, a 512-token chunk; bit-exact ---
    def write_case(T, start):
        if start is None:  # decode: one row per sequence, one skipped
            npages = 64
            slots = rng.permutation(npages)[:T] * S + rng.integers(0, S, T)
            slots[3] = -1
        else:  # a chunk starting mid-page through a shuffled table, its tail padded
            npages = (start + T) // S + 4
            table = rng.permutation(npages)
            pos = np.arange(start, start + T)
            slots = table[pos // S] * S + pos % S
            slots[-37:] = -1
        return _randn(rng, T, X), _dev(slots.astype(np.int32)), _randn(rng, 1, npages * S, X)

    shapes = {}
    for T, start, label in ((8, None, "DeepSeek-V2-Lite decode step, 8 rows of 576"),
                            (512, 2309, "DeepSeek-V2-Lite chunk, 512 rows of 576")):
        rows, slots, pool = write_case(T, start)
        got = W.write_rows_2d(pool.clone(), rows, slots)
        want = W.write_rows_2d_plain(pool.clone(), rows, slots)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"write_rows_2d T={T}: not bit-exact")
        print(f"kernels: write_rows_2d T={T} X={X} bit-exact", flush=True)
        # timed on T distinct rows spread over the pool (the library call takes no skipped rows)
        idx = torch.arange(T, device="cuda") * (pool.shape[1] // T)
        slots = idx.to(torch.int32)
        t_b, by = bound(2 * T * X * 2 + T * 4, 0)
        shapes[label] = dict(
            ms=time_ms(lambda: W.write_rows_2d(pool, rows, slots)),
            plain_ms=time_ms(lambda: W.write_rows_2d_plain(pool, rows, slots)),
            library_ms=time_ms(lambda: pool[0].index_copy_(0, idx, rows)),
            bound_ms=t_b, bound_by=by,
        )
    _record(rec, "write_rows_2d", 0.0, list(shapes)[0], shapes)

    # -- paged_mla_decode: ragged contexts with an empty slot, then ctx 2816 ----
    err = 0.0
    for ctx in ([2816, 7, 0, 1500, 100, 16, 1, 2305], [64, 65, 63, 128, 2816, 2815, 0, 640]):
        ctx = np.array(ctx, np.int32)
        tables, npages = _paged(rng, ctx, S)
        args = (_randn(rng, len(ctx), H, X), _randn(rng, npages * S, X), _dev(tables), _dev(ctx),
                S, scale)
        got = A.paged_mla_decode(*args, v_dim=VD)
        want = A.paged_mla_decode_plain(*args, v_dim=VD)
        e = (got.float() - want.float()).abs().max().item()
        e_twin = (got.float() - A.paged_mla_decode_twin(*args, VD).float()).abs().max().item()
        print(f"kernels: mla decode B={len(ctx)} H={H} ctx={ctx.tolist()} max_abs_err={e:.3e} "
              f"(twin {e_twin:.3e})", flush=True)
        if not (np.isfinite(e) and e <= ATTN_TOL and e_twin <= ATTN_TOL):
            raise AssertionError(f"MLA decode ctx {ctx}: max abs err {e} (twin {e_twin}) > {ATTN_TOL}")
        if got[torch.from_numpy(ctx == 0)].any():
            raise AssertionError("MLA decode: an empty slot is not zero")
        err = max(err, e)
    B, CTX = 8, 2816
    maxp = 3072 // S
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    pool, q = _randn(rng, B * maxp * S, X), _randn(rng, B, H, X)
    args = (q, pool, _dev(tables), _dev(np.full(B, CTX, np.int32)), S, scale)
    # latents gathered beforehand, [B, 1, CTX, 576], shared by the 16 heads as views
    lat = pool.reshape(B, maxp * S, X)[:, None, :CTX]
    kg = lat.contiguous().expand(-1, H, -1, -1)
    vg = lat[..., :VD].contiguous().expand(-1, H, -1, -1)
    t_b, by = bound(B * CTX * X * 2 + q.numel() * 2 + B * H * VD * 2 + tables.size * 4 + B * 4,
                    2 * B * H * CTX * (X + VD))
    label = f"DeepSeek-V2-Lite batch {B}, context {CTX}, 16 heads"
    _record(rec, "paged_mla_decode", err, label, {label: dict(
        ms=time_ms(lambda: A.paged_mla_decode(*args, v_dim=VD)),
        plain_ms=time_ms(lambda: A.paged_mla_decode_plain(*args, v_dim=VD), reps=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg, vg, scale=scale)),
        bound_ms=t_b, bound_by=by,
    )})

    check_latent_edges(rng)
    # the split count of the normal mode at the timed shape, against others
    # (the host's plan: one wave; "sweep:" lines)
    times = []
    for n in (1, 2, 4, 8, 16):
        times.append(f"{n}:{time_ms(lambda: A._launch_mla('sweep', *args, VD, False, n)):.4f}")
    print(f"sweep: paged_mla_decode {label} splits:ms {' '.join(times)} (plan: "
          f"{A.mla_plan(q.device, B, H, maxp * S)}; clusters the card holds at once, by size: "
          f"{A._MLA_CLUSTERS[q.device]})", flush=True)

    # -- w4a16_ragged_matmul ----------------------------------------------------
    kernels_ragged(rec, rng)


def kernels_ragged(rec: dict, rng) -> None:
    """The grouped int4 matmul at DeepSeek-V2-Lite's stacks against its plain
    version: a decode step's 48 rows (TM 8), a chunk's 3072 (TM 64), 5 rows
    over 64 experts, every expert occupied at TM 8 (128 rows), one row per
    expert over all 64, num_occ 0 (nothing written), an m-tile naming expert
    E (the overflow bucket's id: the kernel clamps it to E - 1) and -1, the
    down stack's zero-scale pad group, and a repeated split-K call to the
    same bits; then timed with a cold L2 beside one torch.matmul per routed
    expert and one torch._grouped_mm over the expert-sorted rows (weights
    dequantized beforehand), and at the decode split counts it takes."""
    from zhilight_tpu_torch.ops.cuda import quant_ragged as R
    from zhilight_tpu_torch.ops.quant import dequant_expert_int4

    E = EXPERTS
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rel_err, abs_err, shapes = 0.0, 0.0, {}

    def check(what, got, want):
        nonlocal rel_err, abs_err
        diff = (got.float() - want.float()).abs().max().item()
        e = diff / want.float().abs().max().item()
        print(f"kernels: w4a16_ragged {what}: max rel err {e:.3e}", flush=True)
        if not (torch.isfinite(got).all() and e <= W4A16_TOL):
            raise AssertionError(f"w4a16_ragged {what}: max rel err {e} > {W4A16_TOL}")
        rel_err, abs_err = max(rel_err, e), max(abs_err, diff)

    for wname, (K, N, pad) in DEEPSEEK_STACKS.items():
        w_p, s, z = _expert_stack(rng, K, N, pad)
        wd = dequant_expert_int4(w_p, s, z, torch.bfloat16)  # for the library calls
        every = np.concatenate([np.random.default_rng(3).permutation(E) for _ in range(2)])
        cases = (("decode, 48 rows", _routed(48, 1), 8), ("chunk, 3072 rows", _routed(3072, 2), 64),
                 ("5 rows over 64 experts", np.array([63, 0, 17, 63, 40]), 8),
                 ("every expert, 128 rows", every, 8), ("one row an expert", np.arange(E), 8))
        for cname, flat, TM in cases:
            x, dest, tile_expert, num_occ = _ragged_rows(rng, flat, TM, K, pad)
            args = (x, w_p, s, z, tile_expert, num_occ)
            got = R.w4a16_ragged_matmul(*args)
            check(f"{wname} {cname} TM={TM}", got[dest], R.w4a16_ragged_matmul_plain(*args)[dest])
            live = slice(0, int(num_occ[0]) * TM)  # rows past num_occ are not written
            if TM == 8 and not torch.equal(got[live], R.w4a16_ragged_matmul(*args)[live]):
                raise AssertionError(f"w4a16_ragged {wname} {cname}: a repeated call differs")
            if len(flat) not in (48, 3072):
                continue
            # timed with a cold L2, as a decode step finds the experts' weights
            experts, counts = np.unique(flat, return_counts=True)
            R_ = len(flat)
            t_b, by = bound(len(experts) * (K * N // 2 + 8 * (K // EXPERT_GS) * N)
                            + 2 * R_ * (K + N), 2 * R_ * K * N)
            xs = x[dest]  # the rows, sorted by expert
            groups = list(zip(experts.tolist(), np.cumsum(counts) - counts, np.cumsum(counts)))
            ends = _dev(np.cumsum(np.bincount(flat, minlength=E)).astype(np.int32))
            out = torch.empty(R_, N, dtype=torch.bfloat16, device="cuda")

            def loop():  # one torch.matmul per routed expert
                for ex, a, b in groups:
                    torch.matmul(xs[a:b], wd[ex], out=out[a:b])

            grouped = lambda: torch._grouped_mm(xs, wd, offs=ends)
            e = ((grouped().float() - got[dest].float()).abs().max()
                 / got[dest].float().abs().max()).item()
            if not e <= W4A16_TOL:  # the library call computes the same function
                raise AssertionError(f"torch._grouped_mm {wname} {cname}: {e} from the kernel")
            label = f"DeepSeek-V2-Lite {wname}, {cname} over {len(experts)} experts"
            shapes[label] = dict(
                ms=time_ms(lambda: R.w4a16_ragged_matmul(*args), flush=scratch.zero_),
                plain_ms=time_ms(lambda: R.w4a16_ragged_matmul_plain(*args), reps=5,
                                 flush=scratch.zero_),
                library_ms=time_ms(grouped, flush=scratch.zero_),
                library_loop_ms=time_ms(loop, flush=scratch.zero_),
                bound_ms=t_b, bound_by=by,
            )
            print(f"kernels: w4a16_ragged {label}: torch._grouped_mm "
                  f"{shapes[label]['library_ms']:.4f} ms, one torch.matmul per expert "
                  f"{shapes[label]['library_loop_ms']:.4f} ms", flush=True)
            if TM == 8:
                key = (tile_expert.shape[0], TM, N, K, E)
                times = []
                for n in (1, 2, 3, 4, 6, 8, 12, 16):
                    stages = K // 2 // R.STAGE_ROWS[0]
                    per = -(-stages // n)
                    if -(-stages // per) != n or per * R.STAGE_ROWS[0] > R.DECODE_ROWS:
                        continue
                    o = torch.empty_like(got)
                    t = time_ms(lambda: R._run(*args, o, (0, n)), flush=scratch.zero_)
                    times.append(f"{n}:{t:.4f}")
                dev = R._DEVICES[x.device]
                print(f"sweep: w4a16_ragged {label} splits:ms {' '.join(times)} "
                      f"(plan {dev.plans[key]})", flush=True)
        # num_occ 0: nothing is written; an m-tile naming expert E or -1 takes
        # expert E - 1 or 0
        x, dest, tile_expert, num_occ = _ragged_rows(rng, _routed(48, 4), 8, K, pad)
        out = torch.full((x.shape[0], N), float("nan"), dtype=torch.bfloat16, device="cuda")
        R._run(x, w_p, s, z, tile_expert, torch.zeros_like(num_occ), out)
        torch.cuda.synchronize()
        if not out.isnan().all():
            raise AssertionError(f"w4a16_ragged {wname}: num_occ 0 wrote rows")
        named = tile_expert.clone()
        named[0], named[1] = E, -1
        clamped = named.clamp(0, E - 1)
        live = slice(0, 2 * 8)
        check(f"{wname} m-tiles naming experts {E} and -1",
              R.w4a16_ragged_matmul(x, w_p, s, z, named, num_occ)[live],
              R.w4a16_ragged_matmul_plain(x, w_p, s, z, clamped, num_occ)[live])
        del w_p, s, z, wd
    del scratch
    print(f"kernels: w4a16_ragged over every case max rel err {rel_err:.3e}, max abs err "
          f"{abs_err:.3e}", flush=True)
    _record(rec, "w4a16_ragged_matmul", abs_err, list(shapes)[0], shapes)


def check_latent_edges(rng) -> None:
    """The latent decode's three modes (rows 2b, 2bp and the fused latent
    mode) at batch 8 over contexts 0, 1, 15, 16, 64, 65, at the split edges
    of this card's split count (runs of 16 and 64 tokens a split, one token
    past) and up to 2816, at 16 heads (DeepSeek-V2-Lite's) and 128
    (DeepSeek-V2's), each over unit-variance latents ("plain": against the
    plain version, and 2b also against its twin), latents holding NaN in
    every row no sequence attends to (and, fused, at the written slot) and
    latents whose V columns are near 6 ("v6": outputs in [4, 8), where one
    bf16 ulp is above ATTN_TOL; 2b against its twin's fp32 output, 2bp and
    the fused mode against the plain version's); the fused mode's written
    rows bit-exact. The twin here rounds p against the running max the kernel
    keeps at its split count (``splits``). On V near 6 the kernel is also held
    against the one-max twin (the one the CPU tests hold to the Pallas kernel):
    each twin rounds every p within 2^-9 of itself, and with V positive that
    moves an output by at most 2^-9 of it, so the two twins are held within
    2^-8 of the output's size (as tests/test_torch_mla.py holds them on the
    CPU) and the kernel within ATTN_TOL plus that of the one-max twin (on the
    other latents within ATTN_TOL)."""
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA

    S, X, VD, B = 16, 576, 512, 8
    scale = 1.0 / np.sqrt(192)
    dev = torch.device("cuda", torch.cuda.current_device())
    sp = A.mla_plan(dev, B, 16, 2816)
    edges = ([0, 1, 15, 16, 64, 65, 16 * sp, 16 * sp + 1],
             [2816, min(64 * sp, 2815), min(64 * sp + 1, 2816), 17, 63, 128, 0, 2815])
    err = {"2b": 0.0, "2b one-max": 0.0, "twins": 0.0, "2bp": 0.0, "fused": 0.0}
    size = 0.0  # the largest V-near-6 output

    def hold(mode, what, e, limit=ATTN_TOL):
        if not e <= limit:
            raise AssertionError(f"latent {mode} {what}: error {e} > {limit}")
        err[mode] = max(err[mode], e)

    for H in (16, 128):
        for ctx in edges:
            ctx = np.array(ctx, np.int32)
            tables, npages = _paged(rng, ctx, S)
            td, cd = _dev(tables), _dev(ctx)
            live = torch.from_numpy(ctx > 0).cuda()
            n_split = A.mla_plan(dev, B, H, tables.shape[1] * S)  # the kernel's plan
            for kind in ("plain", "nan", "v6"):
                what = f"H={H} ctx={ctx.tolist()} ({kind})"
                pool, q, new = _randn(rng, npages * S, X), _randn(rng, B, H, X), _randn(rng, B, X)
                if kind == "v6":
                    pool[:, :VD] = _v6(rng, npages * S, VD)
                    new[:, :VD] = _v6(rng, B, VD)
                qp = q.float() if kind == "v6" else q  # fp32 outputs from the plain versions
                used = pool
                if kind == "nan":
                    used = torch.full_like(pool, float("nan"))
                    keep = _read_slots(tables, ctx, 0)
                    used[keep] = pool[keep]
                # row 2b
                got = A.paged_mla_decode(q, used, td, cd, S, scale, v_dim=VD)
                # the twin at the kernel's split count: p rounded against the same running max
                twin = A.paged_mla_decode_twin(qp, pool, td, cd, S, scale, VD, n_split)
                if not torch.isfinite(got).all() or got[~live].any():
                    raise AssertionError(f"latent 2b {what}: non-finite, or an empty slot not zero")
                e = (got.float() - twin.float()).abs().max().item()
                one_max = A.paged_mla_decode_twin(qp, pool, td, cd, S, scale, VD)
                rounding = 0.0
                if kind == "v6":
                    if not (twin[live].abs().min() >= 4 and twin.abs().max() < 8):
                        raise AssertionError(f"latent 2b {what}: outputs outside [4, 8)")
                    rounding = 2.0 ** -8 * one_max.abs().max().item()
                    size = max(size, one_max.abs().max().item())
                    hold("twins", what, (twin.float() - one_max.float()).abs().max().item(),
                         rounding)
                hold("2b one-max", what, (got.float() - one_max.float()).abs().max().item(),
                     ATTN_TOL + rounding)
                if kind != "v6":
                    e = max(e, (got.float() - A.paged_mla_decode_plain(q, pool, td, cd, S, scale, VD)
                                .float()).abs().max().item())
                hold("2b", what, e)
                # row 2bp
                got = A.paged_mla_decode_partial(q, used, td, cd, S, scale, VD)
                want = A.paged_mla_decode_partial_plain(q, pool, td, cd, S, scale, VD)
                e = _partial_err(got, want, ctx)
                if kind == "v6":
                    e = max(e, (got[2] / got[1].clamp_min(1e-20)[..., None]
                                - want[2] / want[1].clamp_min(1e-20)[..., None])[live].abs().max().item())
                hold("2bp", what, e)
                # the fused mode: ctx counts the new token, written at row ctx - 1
                # (slot 3 frozen), never read
                c1 = np.maximum(ctx - 1, 0)
                slots = np.where(ctx >= 1, tables[np.arange(B), c1 // S] * S + c1 % S, -1)
                slots[3] = -1
                slots = _dev(slots.astype(np.int32))
                fk, fp = used.clone(), pool.clone()
                if kind == "nan":
                    fk = torch.full_like(pool, float("nan"))
                    keep = _read_slots(tables, ctx, 0, fused=True)
                    fk[keep] = pool[keep]
                tail = (new, slots, td, cd, S, scale, VD)
                got = PA.paged_mla_decode_fused(q, fk, *tail)
                want = PA.paged_mla_decode_fused_plain(qp, fp, *tail)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"latent fused {what}: non-finite output")
                wrote = (slots >= 0) & (cd >= 1)
                if not (torch.equal(fk[slots[wrote].long()], new[wrote])
                        and (kind == "nan" or torch.equal(fk, fp))):
                    raise AssertionError(f"latent fused {what}: written rows differ")
                hold("fused", what, (got.float() - want.float()).abs().max().item())
            print(f"kernels: latent decode H={H} ctx={ctx.tolist()} ({sp} splits at 16 heads): "
                  f"plain, NaN and V near 6 latents; max err 2b {err['2b']:.3e}, 2bp "
                  f"{err['2bp']:.3e}, fused {err['fused']:.3e}; 2b against the one-max twin "
                  f"{err['2b one-max']:.3e} (limit {ATTN_TOL}, on V near 6 plus 2^-8 of the "
                  f"output's size, up to {size:.4f}); on V near 6 the twin at the kernel's "
                  f"splits against the one-max twin {err['twins']:.3e} (limit 2^-8 of the size)",
                  flush=True)


def _v6(rng, *shape):
    """V rows near 6 (uniform in [4.5, 7.5)), bf16: attention outputs in [4,
    8), where one bf16 ulp (2^-5) is above ATTN_TOL, so a kernel that rounded
    its probabilities to bf16 before P.V would show."""
    return _dev((6 + 1.5 * (2 * rng.random(shape) - 1)).astype(np.float32), torch.bfloat16)


def _read_slots(tables, ctx, window, fused=False) -> torch.Tensor:
    """Pool slots some sequence attends to: tokens [start, end) of each (end
    = ctx - 1 in the fused mode, whose row ctx - 1 is written, not read)."""
    tables, ctx = np.asarray(tables), np.asarray(ctx)
    keep = [np.zeros(0, np.int64)]
    for b, c in enumerate(ctx):
        t = np.arange(max(0, c - window) if window else 0, max(c - 1, 0) if fused else c)
        keep.append(tables[b, t // 16].astype(np.int64) * 16 + t % 16)
    return _dev(np.concatenate(keep))


def _poisoned(pools, keep, int8):
    """Copies of the pools [1, N, Hkv, X] with NaN in every row but ``keep``;
    int8 pools keep their rows and get NaN in every other column of their
    scales [Hkv, >= N]."""
    out = list(pools)
    for i in ((2, 3) if int8 else range(len(pools))):
        bad = torch.full_like(pools[i], float("nan"))
        if int8:
            bad[:, keep] = pools[i][:, keep]
        else:
            bad[0, keep] = pools[i][0, keep]
        out[i] = bad
    return out


def kernels_slot_major(rec: dict, rng) -> None:
    """The three kernels of the slot-major pools against their plain versions:
    decode attention over bf16 and int8 pools at head_dim 16, 80, 96, 100 and
    128 with groups of 1, 4 and 5 query heads, over contexts that end
    mid-page, an empty slot, with and without a sliding window shorter than
    the contexts, and at the serving shapes (batch 8, H2O-Danube-1.8B's 32 / 8
    heads of 80 and Qwen2.5-14B's 40 / 8 of 128, contexts up to 3712, window
    0 and 300); at the split edges of this card's split count at Danube's
    heads (contexts 1, 64, 65, two whole tiles a split and one token past, an
    empty slot; windows 0, 40 and 300, 40 starting mid-tile), and at head_dim
    192 and 256 (G 2) and 33 (G 5), each over unit-variance pools, pools with
    NaN in every row no sequence attends to and pools whose V rows are near 6
    (outputs in [4, 8), held against the plain version's fp32 output:
    probabilities rounded to bf16 would show); the row write's copy mode
    (rows 11 and 12 in one wrapper) bit-exact, bf16 and int8 rows, a decode
    step's rows and a chunk starting mid-page. Then timed: decode at
    H2O-Danube-1.8B's shape (batch 8, context 3712, 32 / 8 heads of 80) and at
    Qwen2.5-14B's heads (40 / 8 of 128, the layout ZT_NO_PACKED_KV=1 gives
    it), beside SDPA on rows gathered (and dequantized) beforehand; the write
    at 8 and 512 rows of both shapes beside ``index_copy_`` on the pools' 2-D
    views."""
    from zhilight_tpu_torch.kvcache.paged import _quantize_rows, slot_indices
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA

    F, S = torch.nn.functional, 16
    KINDS = ("plain", "nan", "v6")

    def pools(Hkv, slots, D, int8):
        """Pools [1, N, Hkv, D]: (k, v) bf16, or (k, v, k_scales, v_scales)
        int8 with head-major scales [Hkv, N + 1]; and the K and V rows [N,
        Hkv, D] in bf16 (dequantized beforehand) for the library call."""
        k, v = _randn(rng, slots, Hkv, D), _randn(rng, slots, Hkv, D)
        if not int8:
            return (k[None], v[None]), (k, v)
        (k_q, k_s), (v_q, v_s) = _quantize_rows(k), _quantize_rows(v)
        pad = torch.zeros(Hkv, 1, device="cuda")
        deq = tuple((x.float() * sc[..., None]).to(torch.bfloat16) for x, sc in ((k_q, k_s), (v_q, v_s)))
        return (k_q[None], v_q[None], torch.cat([k_s.t(), pad], 1).contiguous(),
                torch.cat([v_s.t(), pad], 1).contiguous()), deq

    # -- decode attention over bf16, then int8 pools -----------------------------
    for int8, name in ((False, "paged_decode_attention"), (True, "paged_decode_attention_q")):
        fn, plain = ((PA.paged_decode_attention_q, PA.paged_decode_attention_q_plain) if int8
                     else (PA.paged_decode_attention, PA.paged_decode_attention_plain))
        kind = "int8" if int8 else "bf16"

        def check(ctx, Hq, Hkv, D, windows, kinds=("plain",)):
            """The kernel against its plain version over unit-variance pools
            ("plain"), the same pools with NaN in every row no sequence
            attends to ("nan": compared with the plain version over the clean
            pools) and pools whose V rows are near 6 ("v6"); returns the
            largest error."""
            tables, npages = _paged(rng, ctx, S)
            pk, _ = pools(Hkv, npages * S, D, int8)
            q = _randn(rng, len(ctx), Hq, D)
            if "v6" in kinds:
                v6 = _v6(rng, npages * S, Hkv, D)
                if int8:
                    v_q, v_s = _quantize_rows(v6)
                    pad = torch.zeros(Hkv, 1, device="cuda")
                    v6 = (pk[0], v_q[None], pk[2], torch.cat([v_s.t(), pad], 1).contiguous())
                else:
                    v6 = (pk[0], v6[None])
            e_max = 0.0
            for window in windows:
                tail = (_dev(tables), _dev(ctx), S, 1.0 / np.sqrt(D), window)
                want = plain(q, *pk, *tail)
                runs = {"plain": (pk, want)}
                if "nan" in kinds:
                    runs["nan"] = (_poisoned(pk, _read_slots(tables, ctx, window), int8), want)
                if "v6" in kinds:  # against the plain version's fp32 output, before its
                    # one rounding to bf16: two roundings of close fp32 values may
                    # differ by a whole ulp (2^-5 here), more than ATTN_TOL
                    runs["v6"] = (v6, plain(q.float(), *v6, *tail))
                for k_ in kinds:
                    pools_, want_ = runs[k_]
                    got = fn(q, *pools_, *tail)
                    e = (got.float() - want_.float()).abs().max().item()
                    label = (f"{name} ({k_}) Hq={Hq} Hkv={Hkv} D={D} window={window} "
                             f"ctx={ctx.tolist()}")
                    if not (torch.isfinite(got).all() and e <= ATTN_TOL):
                        raise AssertionError(f"{label}: max abs err {e} > {ATTN_TOL}")
                    if got[torch.from_numpy(ctx == 0)].any():
                        raise AssertionError(f"{label}: an empty slot is not zero")
                    if k_ == "v6" and not (want_[torch.from_numpy(ctx > 0)].float().abs().min() >= 4
                                           and want_.float().abs().max() < 8):
                        raise AssertionError(f"{label}: outputs outside [4, 8)")
                    e_max = max(e_max, e)
            return e_max

        ctx = np.array([700, 1, 0, 17, 33, 257, 16, 129], np.int32)  # slot 2 empty
        err = max(check(ctx, 2 * G, 2, D, (0, 40)) for D in (16, 80, 96, 100, 128)
                  for G in (1, 4, 5))
        print(f"kernels: {name} ({kind} slot-major pools) at D 16, 80, 96, 100, 128, G 1, 4, 5, "
              f"window 0 and 40, contexts {ctx.tolist()}: max abs err {err:.3e}", flush=True)
        # the split edges at Danube's heads on this card's split count (2
        # whole tiles a split, then one token past), a window of 40 starting
        # mid-tile, and head_dim 192 and 256 (G 2) and an odd 33 (G 5); each
        # also over pools with NaN in every row no sequence attends to and
        # with V rows near 6
        lib = "paged_attention_q" if int8 else "paged_attention"
        splits = A.decode_splits(8, 8, 4, 3712, A._capacity(torch.device("cuda"), 80, lib))
        edge = np.array([3712, 1, 0, 64, 65, 128 * splits, 128 * splits + 1, 2000], np.int32)
        e = max([check(edge, **DANUBE_HEADS, windows=(0, 40, 300), kinds=KINDS)]
                + [check(edge, 2 * G, 2, D, (0, 40), kinds=KINDS)
                   for D, G in ((192, 2), (256, 2), (33, 5))])
        print(f"kernels: {name} ({kind} slot-major pools) at the split edges ({splits} splits, "
              f"contexts {edge.tolist()}) at Danube's heads, windows 0, 40, 300, and at D 192, "
              f"256 (G 2), 33 (G 5), windows 0 and 40; plain, NaN-poisoned and V near 6 "
              f"pools: max abs err {e:.3e}", flush=True)
        err = max(err, e)
        # the serving shapes: H2O-Danube-1.8B's batch and heads (the grid the
        # main path launches) and Qwen2.5-14B's heads (G 5: two query-row
        # groups a block), at contexts up to 3712 that cut into ranges
        for model, heads in (("H2O-Danube-1.8B", DANUBE_HEADS), ("Qwen2.5-14B", QWEN_HEADS)):
            e = 0.0
            for ctx in ([3712, 7, 513, 1500, 100, 16, 250, 3201],
                        [3712, 7, 0, 1500, 100, 16, 250, 3201]):
                e = max(e, check(np.array(ctx, np.int32), **heads, windows=(0, 300)))
            print(f"kernels: {name} ({kind} slot-major pools) at {model}'s heads {heads}, "
                  f"batch 8, contexts up to 3712 (one empty), window 0 and 300: max abs err "
                  f"{e:.3e}", flush=True)
            err = max(err, e)

        def timed(B, Hq, Hkv, D, CTX):
            maxp = CTX // S + 2
            tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
            pk, (kr, vr) = pools(Hkv, B * maxp * S, D, int8)
            q = _randn(rng, B, Hq, D)
            args = (q, *pk, _dev(tables), _dev(np.full(B, CTX, np.int32)), S, 1.0 / np.sqrt(D))
            slots = slot_indices(_dev(tables), S)[:, :CTX]                # [B, CTX]
            kg = kr[slots].transpose(1, 2).contiguous()                   # [B, Hkv, CTX, D]
            vg = vr[slots].transpose(1, 2).contiguous()
            gqa = dict(enable_gqa=True) if Hq != Hkv else {}
            nbytes = (2 * B * CTX * Hkv * D * pk[0].element_size() + 2 * q.numel() * 2
                      + tables.size * 4 + B * 4)
            if int8:
                nbytes += B * CTX * Hkv * 2 * 4  # one K and one V scale per (token, KV head)
            t_b, by = bound(nbytes, 4 * B * Hq * CTX * D)
            return dict(
                ms=time_ms(lambda: fn(*args)),
                plain_ms=time_ms(lambda: plain(*args), reps=10),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                                                          **gqa)),
                bound_ms=t_b, bound_by=by,
            )

        _record(rec, name, err, f"H2O-Danube-1.8B batch 8, context 3712, {kind} pool", {
            f"H2O-Danube-1.8B batch 8, context 3712, {kind} pool":
                timed(8, CTX=3712, **DANUBE_HEADS),
            f"Qwen2.5-14B heads batch 8, context 3712, {kind} slot-major pool":
                timed(8, CTX=3712, **QWEN_HEADS),
        })

    # -- the row write (copy mode): bit-exact, then timed ------------------------
    def write_case(T_, start, Hkv, D, int8, zero_pools=False):
        if start is None:  # decode: one row per sequence, one skipped
            npages = max(64, 2 * T_)
            slots = rng.permutation(npages)[:T_] * S + rng.integers(0, S, T_)
            slots[T_ // 2] = -1
        else:  # a chunk starting mid-page through a shuffled table
            npages = (start + T_) // S + 4
            table = rng.permutation(npages)
            pos = np.arange(start, start + T_)
            slots = table[pos // S] * S + pos % S
        if int8:
            rows = [_dev(rng.integers(-127, 128, (T_, Hkv, D)).astype(np.int8)) for _ in "kv"]
        else:
            rows = [_randn(rng, T_, Hkv, D) for _ in "kv"]
        shape = (1, npages * S, Hkv, D)
        pk = [torch.zeros(shape, dtype=rows[0].dtype, device="cuda") if zero_pools
              else (_randn(rng, *shape) * 40).to(rows[0].dtype) for _ in "kv"]
        return pk, rows, _dev(slots.astype(np.int32))

    name, fn, plain = "write_rows_pair", W.write_rows_pair, W.write_rows_pair_plain
    for hd in ((8, 80), (8, 128), (2, 16), (1, 100)):
        for int8 in (False, True):
            for T_, start in ((8, None), (512, 3205)):
                pk, rows, slots = write_case(T_, start, *hd, int8)
                got = fn(*(p.clone() for p in pk), *rows, slots)
                want = plain(*(p.clone() for p in pk), *rows, slots)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name} Hkv={hd[0]} D={hd[1]} T={T_} int8={int8}: "
                                         "not bit-exact")
    print(f"kernels: {name} bit-exact at (Hkv, D) (8, 80), (8, 128), (2, 16), (1, 100), "
          "bf16 and int8 rows, 8 rows and a 512-token chunk starting mid-page", flush=True)
    shapes = {}
    # the rows of the reference's write_rows_2d_pair (Danube) and paged_write_rows (Qwen heads)
    for model, (Hkv, D) in (("H2O-Danube-1.8B", (8, 80)), ("Qwen2.5-14B", (8, 128))):
        for T_, int8 in ((8, False), (512, False), (8, True)):
            # distinct rows on exclusive pages (the library call takes no skipped rows)
            pk, rows, _ = write_case(T_, None, Hkv, D, int8, zero_pools=True)
            idx = torch.from_numpy(rng.permutation(pk[0].shape[1] // S)[:T_] * S).cuda()
            slots = idx.to(torch.int32)
            k2, v2 = (p[0].view(p.shape[1], -1) for p in pk)
            kr2, vr2 = (r.reshape(T_, -1) for r in rows)
            t_b, by = bound(2 * 2 * T_ * Hkv * D * rows[0].element_size() + T_ * 4, 0)

            def library():  # the K rows, then the V rows
                k2.index_copy_(0, idx, kr2)
                v2.index_copy_(0, idx, vr2)

            shapes[f"{model} {T_} rows {'int8' if int8 else 'bf16'}"] = dict(
                ms=time_ms(lambda: fn(*pk, *rows, slots)),
                plain_ms=time_ms(lambda: plain(*pk, *rows, slots)),
                library_ms=time_ms(library), bound_ms=t_b, bound_by=by,
            )
    _record(rec, name, 0.0, "H2O-Danube-1.8B 8 rows bf16", shapes)


def _partial_err(got, want, ctx) -> float:
    """Partial-mode error: |m| where l > 0, l and acc over their largest plain
    value (the unnormalized sums grow with the context); an empty context must
    give exactly m = -2e38, l = 0, acc = 0."""
    (m, l, acc), (wm, wl, wacc) = got, want
    live, empty = wl > 0, torch.from_numpy(np.asarray(ctx) == 0).to(m.device)
    if not (torch.all(m[empty] == -2e38) and not l[empty].any() and not acc[empty].any()):
        raise AssertionError("partial mode: an empty pool is not (-2e38, 0, 0)")
    if not all(torch.isfinite(t).all() for t in (l, acc)):
        raise AssertionError("partial mode: non-finite l or acc")
    return max((m[live] - wm[live]).abs().max().item(),
               ((l - wl).abs().max() / wl.abs().max()).item(),
               ((acc - wacc).abs().max() / wacc.abs().max()).item())


# window side-KV flush cases (page size 16, Kw 8): entries mid-page, on a
# page boundary, on a page's last row; n_rows 0, some and all; runs that
# cross into the next page
FLUSH_ENTRY = [13, 16, 15, 3, 40, 31, 0, 57, 100, 111, 64, 7, 8, 200, 95, 48]
FLUSH_ROWS = [8, 0, 4, 8, 1, 8, 5, 7, 8, 8, 2, 0, 6, 8, 3, 8]


def kernels_window(rec: dict, rng) -> None:
    """The window side-KV kernels against their plain versions, then timed:
    the partial modes of the three decode kernels at MiniCPM-2B's shape (batch
    16, context 512, one empty pool), Qwen2.5-14B's (batch 8, pool lengths
    3712, 7, 513, 0, 1500, 100, 16, 250; bf16 and int8 pools) and
    DeepSeek-V2-Lite's (batch 8, up to 2816); the two flushes bit-exact at
    batch 8 and 16 with 8 window rows, bf16 and int8 rows at MiniCPM-2B's and
    Qwen2.5-14B's pools, bf16 latent rows of 576."""
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W

    S = 16
    mini, qwen = MINICPM_HEADS, QWEN_HEADS

    def partial_case(B, Hq, Hkv, D, ctx, int8, rng=rng):
        ctx = np.asarray(ctx, np.int32)
        tables, npages = _paged(rng, ctx, S)
        pools, _ = _pool_args(rng, Hkv, npages * S, D, int8)
        return ctx, (_randn(rng, B, Hq, D), *pools, _dev(tables), _dev(ctx), S, 1.0 / np.sqrt(D))

    def time_partial(fn, plain, args, B, Hq, Hkv, D, CTX, int8):
        nbytes = (B * CTX * Hkv * 2 * D * args[1].element_size() + args[0].numel() * 2
                  + B * Hq * (D + 2) * 4 + args[-4].numel() * 4 + B * 4)
        if int8:
            nbytes += B * CTX * Hkv * 2 * 4
        t_b, by = bound(nbytes, 4 * B * Hq * CTX * D)
        # no PyTorch call returns unnormalized flash partials: library_ms is null
        return dict(ms=time_ms(lambda: fn(*args)), plain_ms=time_ms(lambda: plain(*args), reps=10),
                    library_ms=None, bound_ms=t_b, bound_by=by)

    qwen_ctx = [3712, 7, 513, 0, 1500, 100, 16, 250]
    mini_ctx = [512] * 5 + [0] + [512] * 10
    for int8, name in ((False, "paged_decode_attention_hm_partial"),
                       (True, "paged_decode_attention_hm_q_partial")):
        fn = A.paged_decode_attention_hm_q_partial if int8 else A.paged_decode_attention_hm_partial
        plain = (A.paged_decode_attention_hm_q_partial_plain if int8
                 else A.paged_decode_attention_hm_partial_plain)
        kind, err, shapes = "int8" if int8 else "bf16", 0.0, {}
        cases = [(16, mini, mini_ctx, "MiniCPM-2B batch 16, context 512", rng),
                 (8, qwen, qwen_ctx, "Qwen2.5-14B batch 8, pool lengths up to 3712", rng)]
        if not int8:  # the bf16 kernel's split edges, and head_dim 256, on inputs of their own
            rng3 = np.random.default_rng(3)
            cases += [(8, qwen, SPLIT_CTX, "Qwen2.5-14B batch 8, split edges", rng3),
                      (8, GEMMA2_HEADS, SPLIT_CTX, "head_dim 256 (16 / 8 heads), split edges",
                       rng3)]
        for B, heads, ctx, label, case_rng in cases:
            ctx, args = partial_case(B, **heads, ctx=ctx, int8=int8, rng=case_rng)
            e = _partial_err(fn(*args), plain(*args), ctx)
            print(f"kernels: {name} {label}: partial err {e:.3e}", flush=True)
            if not e <= ATTN_TOL:
                raise AssertionError(f"{name} {label}: partial err {e} > {ATTN_TOL}")
            err = max(err, e)
        for B, heads, CTX, label in ((16, mini, 512, f"MiniCPM-2B batch 16, context 512, {kind} pool"),
                                     (8, qwen, 3712, f"Qwen2.5-14B batch 8, context 3712, {kind} pool")):
            _, args = partial_case(B, **heads, ctx=[CTX] * B, int8=int8)
            shapes[label] = time_partial(fn, plain, args, B, **heads, CTX=CTX, int8=int8)
        _record(rec, name, err, list(shapes)[1 if int8 else 0], shapes)

    X, VD, H = 576, 512, 16
    scale = 1.0 / np.sqrt(192)
    err = 0.0
    for ctx in ([2816, 7, 0, 1500, 100, 16, 1, 2305], [64, 65, 63, 128, 2816, 2815, 0, 640]):
        ctx = np.array(ctx, np.int32)
        tables, npages = _paged(rng, ctx, S)
        args = (_randn(rng, 8, H, X), _randn(rng, npages * S, X), _dev(tables), _dev(ctx), S, scale, VD)
        e = _partial_err(A.paged_mla_decode_partial(*args), A.paged_mla_decode_partial_plain(*args), ctx)
        print(f"kernels: paged_mla_decode_partial ctx={ctx.tolist()}: partial err {e:.3e}", flush=True)
        if not e <= ATTN_TOL:
            raise AssertionError(f"MLA partial ctx {ctx}: partial err {e} > {ATTN_TOL}")
        err = max(err, e)
    B, CTX, maxp = 8, 2816, 3072 // S
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    args = (_randn(rng, B, H, X), _randn(rng, B * maxp * S, X), _dev(tables),
            _dev(np.full(B, CTX, np.int32)), S, scale, VD)
    t_b, by = bound(B * CTX * X * 2 + B * H * X * 2 + B * H * (VD + 2) * 4 + tables.size * 4 + B * 4,
                    2 * B * H * CTX * (X + VD))
    label = f"DeepSeek-V2-Lite batch {B}, context {CTX}, 16 heads"
    _record(rec, "paged_mla_decode_partial", err, label, {label: dict(
        ms=time_ms(lambda: A.paged_mla_decode_partial(*args)),
        plain_ms=time_ms(lambda: A.paged_mla_decode_partial_plain(*args), reps=10),
        library_ms=None, bound_ms=t_b, bound_by=by)})

    # -- the flushes: bit-exact, then timed with every window row live -------
    def flush_case(B, H, X, dtype, entry, n_rows):
        entry, n_rows = np.asarray(entry, np.int32), np.asarray(n_rows, np.int32)
        tables, npages = _paged(rng, entry + 8, S)
        lead = (H,) if H else ()
        shape_p, shape_s = (*lead, npages * S, X), (B, *lead, 8, X)
        if dtype == torch.int8:
            pool, side = (_dev(rng.integers(-127, 128, sh).astype(np.int8)) for sh in (shape_p, shape_s))
        else:
            pool, side = _randn(rng, *shape_p), _randn(rng, *shape_s)
        return pool, (side, _dev(entry), _dev(n_rows), _dev(tables), S)

    cases = (("flush_side_rows_hm", 16, 36, 128, torch.bfloat16, "MiniCPM-2B"),
             ("flush_side_rows_hm", 16, 36, 128, torch.int8, "MiniCPM-2B"),
             ("flush_side_rows_hm", 8, 8, 256, torch.bfloat16, "Qwen2.5-14B"),
             ("flush_side_rows_hm", 8, 8, 256, torch.int8, "Qwen2.5-14B"),
             ("flush_side_rows_2d", 8, 0, 576, torch.bfloat16, "DeepSeek-V2-Lite"),
             ("flush_side_rows_2d", 16, 0, 576, torch.bfloat16, "DeepSeek-V2-Lite"))
    shapes = {"flush_side_rows_hm": {}, "flush_side_rows_2d": {}}
    for name, B, H, X, dtype, model in cases:
        fn, plain = getattr(W, name), getattr(W, name + "_plain")
        pool, args = flush_case(B, H, X, dtype, FLUSH_ENTRY[:B], FLUSH_ROWS[:B])
        got, want = fn(pool.clone(), *args), plain(pool.clone(), *args)
        torch.cuda.synchronize()
        what = f"{name} {model} B={B} rows of {X} {str(dtype)[6:]}"
        if not torch.equal(got, want) or torch.equal(got, pool):
            raise AssertionError(f"{what}: not bit-exact")
        print(f"kernels: {what}, Kw 8, n_rows {FLUSH_ROWS[:B]}: bit-exact", flush=True)
        label = f"{model} window, B {B}, Kw 8, {str(dtype)[6:]} rows"
        # timed with every row live, against index_copy_ of the same rows
        # laid out beforehand, at slots computed on the device
        pool, args = flush_case(B, H, X, dtype, [16 * b + 3 for b in range(B)], [8] * B)
        side, entry, n_rows, tables, _ = args
        slots = W.side_slots(entry, n_rows, tables, S, 8).reshape(-1)
        rows = (side.transpose(0, 1).reshape(H, B * 8, X).contiguous() if H
                else side.reshape(B * 8, X))
        row_bytes = (H or 1) * X * side.element_size()
        t_b, by = bound(2 * B * 8 * row_bytes + tables.numel() * 4 + B * 8, 0)
        shapes[name][label] = dict(
            ms=time_ms(lambda: fn(pool, *args)),
            plain_ms=time_ms(lambda: plain(pool, *args)),
            library_ms=time_ms(lambda: pool.index_copy_(1 if H else 0, slots, rows)),
            bound_ms=t_b, bound_by=by)
    _record(rec, "flush_side_rows_hm", 0.0, "MiniCPM-2B window, B 16, Kw 8, bfloat16 rows",
            shapes["flush_side_rows_hm"])
    _record(rec, "flush_side_rows_2d", 0.0, "DeepSeek-V2-Lite window, B 8, Kw 8, bfloat16 rows",
            shapes["flush_side_rows_2d"])


def parent_flush(csrc: str):
    """The per-layer flush of an earlier tree (``csrc`` its
    zhilight_tpu_torch/csrc): kv_flush.cu built by nvcc with this tree's flags
    and driven through its C signature (one layer a launch, rows in the pool's
    type). Returns {"hm": fn, "2d": fn}, each fn(pool, side, entry_pos, n_rows,
    page_tables, S) over a pool [H, N, X] (latent: [1, N, X]) and side rows
    [B, H, Kw, X] (latent: [B, Kw, X])."""
    import ctypes
    import tempfile

    from zhilight_tpu_torch.ops.cuda import _build

    out = f"{tempfile.mkdtemp(prefix='zt_parent_')}/kv_flush.so"
    t0 = time.monotonic()
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", out, f"{csrc}/kv_flush.cu"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"parent kv_flush: nvcc exit {proc.returncode}\n{proc.stdout}")
    fn = ctypes.CDLL(out).zt_flush_side_rows
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_longlong, i, i, i, p]
    print(f"kernels: parent's kv_flush built in {time.monotonic() - t0:.1f} s", flush=True)

    def launch(pool3, side4, entry, n_rows, tables, S):
        H, N, X = pool3.shape
        B, _, Kw, _ = side4.shape
        _build.check(fn(pool3.data_ptr(), side4.data_ptr(), entry.data_ptr(), n_rows.data_ptr(),
                        tables.data_ptr(), B, H, Kw, N, tables.shape[1], S,
                        X * pool3.element_size(), torch.cuda.current_stream().cuda_stream),
                     "parent flush")

    return {"hm": lambda pool, side, *a: launch(pool, side, *a),
            "2d": lambda pool, side, *a: launch(pool, side[:, None], *a)}


def window_flush_sequence(flush_one, pools, side, entry, n_rows, tables, S, k_scales=None,
                          v_scales=None):
    """The window flush the layered launch replaces (the parent tree's
    flush_window_rows): one flush launch a layer through ``flush_one`` and,
    over int8 pools, each layer's plain requantization (stack, quantize_rows,
    cat) and two scale scatters at side_scale_index's columns (computed once
    a window; dead rows into the spare column N)."""
    from zhilight_tpu_torch.ops.cuda import kv_write as W

    if k_scales is None:
        for pool, rows in zip(pools, side):
            flush_one(pool, rows, entry, n_rows, tables, S)
        return
    N = pools[0].shape[1]
    sl = W.side_slots(entry, n_rows, tables, S, side.shape[3])
    index = torch.where((sl < 0) | (sl >= N), N, sl).reshape(-1)
    D = side.shape[-1] // 2
    for pool, rows, ks, vs in zip(pools, side, k_scales, v_scales):
        codes, scales = W.quantize_rows(torch.stack((rows[..., :D], rows[..., D:])))
        rows8 = torch.cat((codes[0], codes[1]), dim=-1)
        H = rows8.shape[1]
        ks[:, index] = scales[0].transpose(0, 1).reshape(H, -1)
        vs[:, index] = scales[1].transpose(0, 1).reshape(H, -1)
        flush_one(pool, rows8, entry, n_rows, tables, S)


# the layered flush's windows: label -> (layers, batch, KV heads (0: the
# latent pool), row elements, pool kind); Kw 8 throughout
LAYERED_FLUSH = {
    "MiniCPM-2B window (40 layers, B 16, 36 heads, rows of 2 x 64 bf16)":
        (40, 16, 36, 128, "bf16"),
    "Qwen2.5-14B int8 window (48 layers, B 8, 8 heads, fp32 rows of 2 x 128 into int8)":
        (48, 8, 8, 256, "int8"),
    "DeepSeek-V2-Lite window (27 layers, B 8, latent rows of 576 bf16)": (27, 8, 0, 576, "bf16"),
}


def _layered_case(rng, L_, B, H, X, kind, entry, n_rows, Kw=8):
    """L layers' pools (int8 pools with -1 scales) and side rows [L, B, (H,) Kw, X]."""
    S = 16
    entry, n_rows = np.asarray(entry, np.int32), np.asarray(n_rows, np.int32)
    tables, npages = _paged(rng, entry + Kw, S)
    N, lead = npages * S, ((H,) if H else (1,))
    if kind == "int8":
        pools = [_dev(rng.integers(-127, 128, (*lead, N, X)).astype(np.int8)) for _ in range(L_)]
        scales = ([torch.full((H, N + 1), -1.0, device="cuda") for _ in range(L_)],
                  [torch.full((H, N + 1), -1.0, device="cuda") for _ in range(L_)])
        side = _dev(rng.standard_normal((L_, B, H, Kw, X)).astype(np.float32))
    else:
        with elem_dtype(torch.float16 if kind == "fp16" else torch.bfloat16):
            pools = [_randn(rng, *lead, N, X) for _ in range(L_)]
            side = _randn(rng, L_, B, *((H,) if H else ()), Kw, X)
        scales = ()
    return pools, scales, side, (_dev(entry), _dev(n_rows), _dev(tables), S)


def check_layered_flush(W, rng, L_, B, H, X, kind, entry, n_rows, Kw=8) -> None:
    """The layered flush bit-exact against its plain version: pools and scale
    arrays (a dead row writes no scale: the spare column stays -1)."""
    pools, scales, side, args = _layered_case(rng, L_, B, H, X, kind, entry, n_rows, Kw)
    fn, plain = ((W.flush_side_layers_hm, W.flush_side_layers_hm_plain) if H else
                 (W.flush_side_layers_2d, W.flush_side_layers_2d_plain))
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    got_sc = tuple([t.clone() for t in a] for a in scales)
    want_sc = tuple([t.clone() for t in a] for a in scales)
    fn(got, side, *args, *got_sc)
    plain(want, side, *args, *want_sc)
    torch.cuda.synchronize()
    what = (f"{fn.__name__} {L_} layers, B {B}, {H or 'latent'} heads, rows of {X}, {kind}, "
            f"Kw {Kw}, live rows {list(n_rows)}")
    ok = all(torch.equal(g, w) for g, w in zip(got, want)) and not torch.equal(got[-1], pools[-1])
    for g, w in zip(sum(got_sc, []), sum(want_sc, [])):
        ok = ok and torch.equal(g, w) and bool((g[:, -1] == -1).all())
    if not ok:
        raise AssertionError(f"{what}: not bit-exact")
    print(f"kernels: {what}: bit-exact", flush=True)


def kernels_layered_flush(rec: dict, rng, parent_csrc: str = "") -> None:
    """The layered flush (rows 14 and 15 redesigned: every layer of a window
    in one launch, an int8 pool's requantization and scale scatter in it)
    bit-exact against its plain version over bf16, fp16, int8 and latent
    pools, with dead slots, windows that cross a page and a window of a whole
    page; then timed with every window row live at LAYERED_FLUSH's windows
    beside the sequence it replaces (window_flush_sequence through this
    tree's per-layer flush) and, with ``parent_csrc``, that sequence through
    the earlier tree's per-layer flush, in turns (parent, new, new, parent),
    device and host-inclusive."""
    from zhilight_tpu_torch.ops.cuda import kv_write as W

    for (L_, B, H, X, kind), Kw in (((40, 16, 36, 128, "bf16"), 8), ((4, 8, 8, 256, "fp16"), 8),
                                    ((48, 8, 8, 256, "int8"), 8), ((3, 16, 36, 128, "int8"), 8),
                                    ((2, 8, 8, 256, "int8"), 16), ((27, 8, 0, 576, "bf16"), 8),
                                    ((2, 8, 0, 576, "fp16"), 16)):
        check_layered_flush(W, rng, L_, B, H, X, kind, FLUSH_ENTRY[:B],
                            np.minimum(FLUSH_ROWS[:B], Kw), Kw)
    parent = parent_flush(parent_csrc) if parent_csrc else None
    shapes = {"flush_side_layers_hm": {}, "flush_side_layers_2d": {}}
    res = {}
    turns = _turns(res)
    for label, (L_, B, H, X, kind) in LAYERED_FLUSH.items():
        name = "flush_side_layers_hm" if H else "flush_side_layers_2d"
        fn, plain = getattr(W, name), getattr(W, name + "_plain")
        one = W.flush_side_rows_hm if H else W.flush_side_rows_2d
        pools, scales, side, args = _layered_case(rng, L_, B, H, X, kind,
                                                  [16 * b + 3 for b in range(B)], [8] * B)
        new = lambda: fn(pools, side, *args, *scales)
        replaced = lambda f=one: window_flush_sequence(f, pools, side, *args, *scales)
        rows = L_ * B * 8 * (H or 1)
        if kind == "int8":  # fp32 rows of 2D read; int8 codes and two fp32 scales written
            nbytes = rows * (X * 4 + X + 8)
        else:
            nbytes = 2 * rows * X * side.element_size()
        t_b, by = bound(nbytes + args[2].numel() * 4 + 2 * B * 4, 0)
        seq_launches = device_kernels(replaced)
        if kind == "int8":  # where the replaced sequence's device time goes
            profile(f"replaced sequence, {label}", replaced)
        shapes[name][label] = dict(
            ms=time_ms(new), plain_ms=time_ms(lambda: plain(pools, side, *args, *scales), reps=5),
            # no one PyTorch call writes L separate pools
            library_ms=None, bound_ms=t_b, bound_by=by,
            call_ms=time_ms(new, backlog=False), device_kernels=device_kernels(new),
            sequence_ms=time_ms(replaced), sequence_call_ms=time_ms(replaced, backlog=False),
            sequence_launches=seq_launches)
        if parent is not None:
            old = lambda f=parent["hm" if H else "2d"]: window_flush_sequence(
                f, pools, side, *args, *scales)
            turns(f"{label}, device", old, new)
            call_res = {}
            _turns(call_res, backlog=False)(f"{label}, host-inclusive", old, new)
            res.update(call_res)
            shapes[name][label]["parent_turns"] = {k: v for k, v in res.items() if label in k}
    _record(rec, "flush_side_layers_hm", 0.0, list(LAYERED_FLUSH)[0], shapes["flush_side_layers_hm"])
    _record(rec, "flush_side_layers_2d", 0.0, list(LAYERED_FLUSH)[2], shapes["flush_side_layers_2d"])


def _hold(what: str, err: float, limit: float) -> float:
    print(f"kernels: fp16 {what}: err {err:.3e} (limit {limit})", flush=True)
    if not (np.isfinite(err) and err <= limit):
        raise AssertionError(f"fp16 {what}: err {err} > {limit}")
    return err


def _time_slot_major(rng, B, Hq, Hkv, D, CTX) -> float:
    """The slot-major decode (row 10) at B sequences of CTX tokens, device ms."""
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA

    S, maxp = 16, CTX // 16 + 2
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    pools = [_randn(rng, 1, B * maxp * S, Hkv, D) for _ in "kv"]
    args = (_randn(rng, B, Hq, D), *pools, _dev(tables), _dev(np.full(B, CTX, np.int32)), S,
            1.0 / np.sqrt(D))
    return time_ms(lambda: PA.paged_decode_attention(*args))


def kernels_fp16(rec: dict, rng) -> None:
    """Every kernel the fp16 fault touched (rows 1-13 and 16; rows 14-15 in
    kernels_layered_flush) with fp16 q, rows and model-dtype pools (int8
    pools: fp16 q) against its plain version in fp16, at main-path shapes:
    attention within ATTN_TOL (head-major decode and prefill against their
    twins too), the prologues bit-exact, the int4, grouped int4 and FP8
    matmuls (x to bf16 and the result back, as the reference's kernels) within
    their tolerances of the largest plain output. Then rows 2, 3 and 10 timed
    in fp16 beside bf16 at Qwen2.5-14B's and H2O-Danube-1.8B's shapes, each
    result under ``rec[name]["fp16"]``."""
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import fp8_matmul as F8
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P
    from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
    from zhilight_tpu_torch.ops.cuda import quant_ragged as R
    from zhilight_tpu_torch.ops.quant import pack_int4

    S, qwen, mini = 16, QWEN_HEADS, MINICPM_HEADS
    errs = {}
    rel = lambda got, want: ((got.float() - want.float()).abs().max()
                             / want.float().abs().max()).item()
    absd = lambda got, want: (got.float() - want.float()).abs().max().item()
    with elem_dtype(torch.float16):
        # rows 2 and 5, 3 and 6: the head-major attention kernels
        dec = [dict(B=8, **qwen, ctx=SPLIT_CTX, window=0),
               dict(B=16, **mini, ctx_max=1024, window=100),
               dict(B=8, **GEMMA2_HEADS, ctx=SPLIT_CTX, window=0)]
        pre = [dict(cache_lens=[3200], q_lens=[512], TC=512, **qwen),
               dict(cache_lens=[0, 16, 5, 300], q_lens=[128, 37, 0, 100], TC=128, **mini)]
        errs["paged_decode_attention_hm"] = check_decode(rng, A, dec, False)
        errs["paged_decode_attention_hm_q"] = check_decode(rng, A, dec, True)
        errs["paged_prefill_attention_hm_packed"] = check_prefill(rng, P, pre, False)
        errs["paged_prefill_attention_hm_packed_q"] = check_prefill(rng, P, pre, True)
        # 2p and 5p: the partial modes
        ctx = np.array([3712, 7, 513, 0, 1500, 100, 16, 250], np.int32)
        tables, npages = _paged(rng, ctx, S)
        for int8, name in ((False, "paged_decode_attention_hm_partial"),
                           (True, "paged_decode_attention_hm_q_partial")):
            pools, _ = _pool_args(rng, qwen["Hkv"], npages * S, qwen["D"], int8)
            args = (_randn(rng, 8, qwen["Hq"], qwen["D"]), *pools, _dev(tables), _dev(ctx), S,
                    1.0 / np.sqrt(qwen["D"]))
            errs[name] = _hold(name, _partial_err(getattr(A, name)(*args),
                                                  getattr(A, name + "_plain")(*args), ctx), ATTN_TOL)
        # 2b, 2bp and the fused latent mode (row 16): DeepSeek-V2-Lite's latent rows
        lctx = np.array([2816, 7, 0, 1500, 100, 16, 1, 2305], np.int32)
        tables, npages = _paged(rng, lctx, S)
        args = (_randn(rng, 8, 16, 576), _randn(rng, npages * S, 576), _dev(tables), _dev(lctx),
                S, 1.0 / np.sqrt(192), 512)
        got = A.paged_mla_decode(*args)
        errs["paged_mla_decode"] = _hold("paged_mla_decode", max(
            absd(got, A.paged_mla_decode_plain(*args)), absd(got, A.paged_mla_decode_twin(*args))),
            ATTN_TOL)
        errs["paged_mla_decode_partial"] = _hold("paged_mla_decode_partial", _partial_err(
            A.paged_mla_decode_partial(*args), A.paged_mla_decode_partial_plain(*args), lctx),
            ATTN_TOL)
        slots = _dev(np.array([tables[b, (c - 1) // S] * S + (c - 1) % S if c else -1
                               for b, c in enumerate(lctx)], np.int32))
        pool, new = _randn(rng, 1, npages * S, 576), _randn(rng, 8, 576)
        pools = [pool.clone(), pool.clone()]
        tail = (new, slots, _dev(tables), _dev(lctx), S, 1.0 / np.sqrt(192), 512)
        got = PA.paged_mla_decode_fused(args[0], pools[0], *tail)
        want = PA.paged_mla_decode_fused_plain(args[0], pools[1], *tail)
        if not torch.equal(pools[0], pools[1]):
            raise AssertionError("fp16 paged_mla_decode_fused: pools differ")
        errs["paged_mla_decode_fused"] = _hold("paged_mla_decode_fused", absd(got, want), ATTN_TOL)
        # 10 and 13 (slot-major decode, fp16 and int8 pools) and 16 (fused)
        dctx = np.array([3712, 1, 0, 17, 33, 257, 16, 129], np.int32)
        tables, npages = _paged(rng, dctx, S)
        d = DANUBE_HEADS
        q = _randn(rng, 8, d["Hq"], d["D"])
        k, v = _randn(rng, npages * S, d["Hkv"], d["D"]), _randn(rng, npages * S, d["Hkv"], d["D"])
        tail = (_dev(tables), _dev(dctx), S, 1.0 / np.sqrt(d["D"]), 0)
        errs["paged_decode_attention"] = _hold("paged_decode_attention", absd(
            PA.paged_decode_attention(q, k[None], v[None], *tail),
            PA.paged_decode_attention_plain(q, k[None], v[None], *tail)), ATTN_TOL)
        (kq, ks), (vq, vs) = W.quantize_rows(k), W.quantize_rows(v)
        pad = torch.zeros(d["Hkv"], 1, device="cuda")
        pools8 = (kq[None], vq[None], torch.cat([ks.t(), pad], 1).contiguous(),
                  torch.cat([vs.t(), pad], 1).contiguous())
        errs["paged_decode_attention_q"] = _hold("paged_decode_attention_q", absd(
            PA.paged_decode_attention_q(q, *pools8, *tail),
            PA.paged_decode_attention_q_plain(q, *pools8, *tail)), ATTN_TOL)
        fslots = _dev(np.array([tables[b, (c - 1) // S] * S + (c - 1) % S if c else -1
                                for b, c in enumerate(dctx)], np.int32))
        kn, vn = _randn(rng, 8, d["Hkv"], d["D"]), _randn(rng, 8, d["Hkv"], d["D"])
        pools = [[k[None].clone(), v[None].clone()] for _ in "ab"]
        got = PA.paged_decode_attention_fused(q, *pools[0], kn, vn, fslots, *tail)
        want = PA.paged_decode_attention_fused_plain(q, *pools[1], kn, vn, fslots, *tail)
        if not all(torch.equal(a, b) for a, b in zip(*pools)):
            raise AssertionError("fp16 paged_decode_attention_fused: pools differ")
        errs["paged_decode_attention_fused"] = _hold("paged_decode_attention_fused",
                                                     absd(got, want), ATTN_TOL)
        # rows 1, 7 and 12: the prologues, bit-exact
        for name, case in (("rope_write_rows_hm", lambda i8: prologue_hm_case(
                               rng, 8, qwen["Hq"], qwen["Hkv"], qwen["D"], i8, True, True)[:2]),
                           ("rope_write_rows_pair", lambda i8: prologue_pair_case(
                               rng, 8, d["Hq"], d["Hkv"], d["D"], i8, True, True)),
                           ("rope_write_rows_2d", lambda i8: prologue_2d_case(rng, 8, True, True))):
            for int8 in ((False, True) if name != "rope_write_rows_2d" else (False,)):
                pargs, pool = case(int8)
                pool = pool if isinstance(pool, list) else [pool]
                got_p, want_p = [t.clone() for t in pool], [t.clone() for t in pool]
                fn, plain = getattr(W, name), getattr(W, name + "_plain")
                if name == "rope_write_rows_pair":
                    got, want = (fn(*got_p[:2], *pargs, *got_p[2:]),
                                 plain(*want_p[:2], *pargs, *want_p[2:]))
                else:
                    got, want = fn(got_p[0], *pargs, *got_p[1:]), plain(want_p[0], *pargs, *want_p[1:])
                N = pool[0].shape[1]
                same = torch.equal(got, want) and all(
                    torch.equal(a[..., :N] if a.dtype == torch.float32 else a,
                                b[..., :N] if b.dtype == torch.float32 else b)
                    for a, b in zip(got_p, want_p))
                _hold(f"{name} ({'int8' if int8 else 'fp16'} pool), bit-exact", 0.0 if same else 1.0, 0)
                errs[name] = 0.0
        # rows 4, 8 and 9: fp16 x cast to bf16 and the result back
        K, N, gs = 5120, 1024, 128
        w4 = pack_int4(torch.from_numpy(rng.integers(0, 16, (K, N)).astype(np.int8))).cuda()
        sc = _dev((rng.random((K // gs, N)) * 0.004 + 0.001).astype(np.float32))
        zr = _dev(rng.integers(1, 16, (K // gs, N)).astype(np.float32))
        x = _randn(rng, 8, K)
        got = Q.w4a16_matmul(x, w4, sc, zr)
        errs["w4a16_matmul"] = _hold("w4a16_matmul (q/k/v K 5120, N 1024, M 8)", rel(
            got, Q.w4a16_matmul_plain(x, w4, sc, zr)), W4A16_TOL)
        if got.dtype != torch.float16:
            raise AssertionError(f"fp16 w4a16_matmul returned {got.dtype}")
        w_p, s4, z4 = _expert_stack(rng, 2048, 1408)
        xr, dest, te, occ = _ragged_rows(rng, _routed(48, 5), 8, 2048)
        got = R.w4a16_ragged_matmul(xr, w_p, s4, z4, te, occ)[dest]
        errs["w4a16_ragged_matmul"] = _hold("w4a16_ragged_matmul (gate/up, 48 rows)", rel(
            got, R.w4a16_ragged_matmul_plain(xr, w_p, s4, z4, te, occ)[dest]), W4A16_TOL)
        w = torch.from_numpy(rng.standard_normal((4096, 1024)).astype(np.float32)).cuda() * 0.02
        w8, bs = fp8_block_quantize(w)
        w8 = w8.view(torch.uint8).t().contiguous().view(torch.float8_e4m3fn)
        bs = bs.t().contiguous()
        x = _randn(rng, 8, 1024)
        errs["fp8_block_matmul"] = _hold("fp8_block_matmul (M 8, K 1024, N 4096)", rel(
            F8.fp8_block_matmul(x, w8, bs), F8.fp8_block_matmul_plain(x, w8, bs)), FP8_TOL)
    for name, e in errs.items():
        rec[name].setdefault("fp16", {})["max_abs_err"] = e
    # fp16 beside bf16 at one shape each (rows 2, 3, 10)
    for name, label, timed in (
            ("paged_decode_attention_hm", "Qwen2.5-14B batch 8, context 3712",
             lambda r: time_decode(r, A, 8, **qwen, CTX=3712, int8=False)["ms"]),
            ("paged_prefill_attention_hm_packed", "Qwen2.5-14B 512-token chunk at cache 3200",
             lambda r: time_prefill(r, P, **qwen, CL=3200, QL=512, int8=False)["ms"]),
            ("paged_decode_attention", "H2O-Danube-1.8B batch 8, context 3712",
             lambda r: _time_slot_major(r, 8, **d, CTX=3712))):
        t = {}
        for dtype in (torch.bfloat16, torch.float16, torch.float16, torch.bfloat16):
            with elem_dtype(dtype):
                t.setdefault(str(dtype)[6:], []).append(timed(np.random.default_rng(12)))
        rec[name]["fp16"].update(shape=label, ms=t["float16"], bf16_ms=t["bfloat16"])
        print(f"kernels: {name} at {label}: fp16 {t['float16'][0]:.4f} / {t['float16'][1]:.4f} ms, "
              f"bf16 {t['bfloat16'][0]:.4f} / {t['bfloat16'][1]:.4f} ms (in turns)", flush=True)


# ---------------------------------------------------------------------------
# phase: serve (the main paths)
# ---------------------------------------------------------------------------

def kernels_fused(rec: dict, rng) -> None:
    """The fused write + attend kernels (ZT_FUSED_KV=1) against their plain
    versions, the pools after each call bit-exact: the slot-major mode at
    H2O-Danube-1.8B's shape (batch 8, 32 / 8 heads of 80) and Qwen2.5-14B's
    heads (40 / 8 of 128), the packed single pool at Danube's heads, contexts
    up to 3712 with slot 2 frozen, then with a context of 1 and an empty one,
    windows 0 and 300 (output within ATTN_TOL); at the split edges and the
    head dims of the unfused checks (kernels_slot_major), both pool modes,
    over unit-variance, NaN-poisoned (the written rows NaN until the call)
    and V-near-6 pools; the latent mode at
    DeepSeek-V2-Lite's shape (batch 8, 16 heads, rows of 576, contexts up to
    2816; within ATTN_TOL of the largest output: its tiles round the
    probabilities to bf16). Then timed at the serving contexts (batch 8 at
    3712; 2816) beside the byte bound (the unfused pair's bytes plus the new
    rows read and written), the plain version, the unfused pair of port
    kernels it replaces (row write, then decode: kernels 12 + 10; 7 + 2b) and
    a library pair (``index_copy_`` of the rows, then SDPA on rows gathered
    beforehand): no single PyTorch call writes and attends."""
    from zhilight_tpu_torch.kvcache.paged import slot_indices
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA

    F, S, B = torch.nn.functional, 16, 8

    def inputs(ctx):
        """Shuffled tables over ``ctx``, the new rows' slots (position ctx - 1;
        slot 2 frozen, an empty context -1)."""
        ctx = np.array(ctx, np.int32)
        tables, npages = _paged(rng, ctx, S)
        slots = np.array([tables[b, (c - 1) // S] * S + (c - 1) % S if c > 0 else -1
                          for b, c in enumerate(ctx)], np.int32)
        slots[2] = -1
        return _dev(tables), npages, _dev(slots), _dev(ctx)

    err = 0.0
    for model, heads, packed in (("H2O-Danube-1.8B", DANUBE_HEADS, False),
                                 ("Qwen2.5-14B", QWEN_HEADS, False),
                                 ("H2O-Danube-1.8B", DANUBE_HEADS, True)):
        Hq, Hkv, D = heads["Hq"], heads["Hkv"], heads["D"]
        e_model = 0.0
        for ctx in ([3712, 7, 513, 1500, 100, 16, 250, 3201], [3712, 1, 513, 0, 100, 16, 250, 17]):
            tables, npages, slots, ctx_t = inputs(ctx)
            k, v = _randn(rng, npages * S, Hkv, D), _randn(rng, npages * S, Hkv, D)
            pools = (torch.cat((k, v), -1)[None],) if packed else (k[None], v[None])
            q = _randn(rng, B, Hq, D)
            k_new, v_new = _randn(rng, B, Hkv, D), _randn(rng, B, Hkv, D)
            for window in (0, 300):
                gp, wp = [p.clone() for p in pools], [p.clone() for p in pools]
                tail = (k_new, v_new, slots, tables, ctx_t, S, 1.0 / np.sqrt(D), window)
                got = PA.paged_decode_attention_fused(q, gp[0], None if packed else gp[1], *tail)
                want = PA.paged_decode_attention_fused_plain(q, wp[0], None if packed else wp[1],
                                                             *tail)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                what = f"fused decode {model} packed={packed} window={window} ctx={ctx}"
                if not np.isfinite(e) or e > ATTN_TOL:
                    raise AssertionError(f"{what}: max abs err {e} > {ATTN_TOL}")
                if not all(torch.equal(g, w) for g, w in zip(gp, wp)):
                    raise AssertionError(f"{what}: pools differ from the plain version's")
                e_model = max(e_model, e)
        print(f"kernels: paged_decode_attention_fused at {model}'s heads {heads} "
              f"{'(packed pool)' if packed else '(two pools)'}, batch 8, contexts up to 3712 "
              f"(one frozen, then ctx 1 and 0), window 0 and 300: max abs err {e_model:.3e}, "
              f"pools bit-exact", flush=True)
        err = max(err, e_model)

    def edge_case(ctx, Hq, Hkv, D, packed, windows):
        """The fused kernel against its plain version over unit-variance
        pools, over the same pools with NaN in every row no sequence attends
        to (the written rows included: NaN until the call writes them) and
        with V rows near 6 (the new V rows too; outputs in [4, 8)); the
        written rows equal the new ones. Returns the largest error."""
        tables, npages, slots, ctx_t = inputs(ctx)
        q = _randn(rng, B, Hq, D)
        k_new, v_new = _randn(rng, B, Hkv, D), _randn(rng, B, Hkv, D)
        written = (slots >= 0) & (ctx_t >= 1)
        e_max = 0.0
        for kind in ("plain", "nan", "v6"):
            k = _randn(rng, npages * S, Hkv, D)
            v = _v6(rng, npages * S, Hkv, D) if kind == "v6" else _randn(rng, npages * S, Hkv, D)
            vn = _v6(rng, B, Hkv, D) if kind == "v6" else v_new
            clean = (torch.cat((k, v), -1)[None],) if packed else (k[None], v[None])
            for window in windows:
                tail = (k_new, vn, slots, tables, ctx_t, S, 1.0 / np.sqrt(D), window)
                gp = [p.clone() for p in clean]
                if kind == "nan":
                    gp = _poisoned(gp, _read_slots(tables.cpu(), ctx, window, fused=True), False)
                wp = [p.clone() for p in clean]
                got = PA.paged_decode_attention_fused(q, gp[0], None if packed else gp[1], *tail)
                # V near 6: against the plain version's fp32 output (kernels_slot_major)
                want = PA.paged_decode_attention_fused_plain(
                    q.float() if kind == "v6" else q, wp[0], None if packed else wp[1], *tail)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                what = (f"fused decode ({kind}) Hq={Hq} Hkv={Hkv} D={D} packed={packed} "
                        f"window={window} ctx={ctx}")
                if not (torch.isfinite(got).all() and e <= ATTN_TOL):
                    raise AssertionError(f"{what}: max abs err {e} > {ATTN_TOL}")
                rows = slots[written].long()
                if not all(torch.equal(g[0, rows], w[0, rows]) for g, w in zip(gp, wp)):
                    raise AssertionError(f"{what}: written rows differ from the plain version's")
                if kind == "v6" and not (want.float().abs().min() >= 4
                                         and want.float().abs().max() < 8):
                    raise AssertionError(f"{what}: outputs outside [4, 8)")
                e_max = max(e_max, e)
        return e_max

    # the split edges at Danube's heads on this card's split count (counting
    # the new token: no pool token, 64 and 65 pool tokens, 2 whole tiles a
    # split and one token past), a window of 40 starting mid-tile, and head_dim
    # 192 and 256 (G 2) and an odd 33 (G 5), both pool modes
    splits = A.decode_splits(B, 8, 4, 3712, A._capacity(torch.device("cuda"), 80,
                                                         "paged_attention_fused"))
    edge = [3712, 1, 0, 65, 66, 128 * splits + 1, 128 * splits + 2, 2000]
    e = 0.0
    for packed in (False, True):
        e = max([e, edge_case(edge, **DANUBE_HEADS, packed=packed, windows=(0, 40, 300))]
                + [edge_case(edge, 2 * G, 2, D, packed, (0, 40))
                   for D, G in ((192, 2), (256, 2), (33, 5))])
    print(f"kernels: paged_decode_attention_fused at the split edges ({splits} splits, contexts "
          f"{edge}) at Danube's heads, windows 0, 40, 300, and at D 192, 256 (G 2), 33 (G 5), "
          f"windows 0 and 40, two pools and packed; plain, NaN-poisoned and V near 6 pools: "
          f"max abs err {e:.3e}, written rows bit-exact", flush=True)
    err = max(err, e)

    def timed(Hq, Hkv, D, CTX):
        maxp = CTX // S + 2
        N = B * maxp * S
        tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
        k, v = _randn(rng, N, Hkv, D), _randn(rng, N, Hkv, D)
        q = _randn(rng, B, Hq, D)
        k_new, v_new = _randn(rng, B, Hkv, D), _randn(rng, B, Hkv, D)
        idx = _dev(tables[:, (CTX - 1) // S] * S + (CTX - 1) % S).long()
        slots, tables_d, ctx = idx.to(torch.int32), _dev(tables), _dev(np.full(B, CTX, np.int32))
        scale = 1.0 / np.sqrt(D)
        args = (q, k[None], v[None], k_new, v_new, slots, tables_d, ctx, S, scale)

        def pair():  # kernel 12, then kernel 10 over the written pool
            W.write_rows_pair(k[None], v[None], k_new, v_new, slots)
            PA.paged_decode_attention(q, k[None], v[None], tables_d, ctx, S, scale)

        sl = slot_indices(tables_d, S)[:, :CTX]
        kg, vg = (x[sl].transpose(1, 2).contiguous() for x in (k, v))  # [B, Hkv, CTX, D]
        k2, v2 = k.view(N, -1), v.view(N, -1)
        kr, vr = k_new.reshape(B, -1), v_new.reshape(B, -1)

        def library():
            k2.index_copy_(0, idx, kr)
            v2.index_copy_(0, idx, vr)
            F.scaled_dot_product_attention(q[:, :, None], kg, vg, enable_gqa=True)

        row = Hkv * D * 2
        nbytes = (2 * B * (CTX - 1) * row + 2 * q.numel() * 2 + 4 * B * row + tables.size * 4
                  + 3 * B * 4)
        t_b, by = bound(nbytes, 4 * B * Hq * CTX * D)
        return dict(ms=time_ms(lambda: PA.paged_decode_attention_fused(*args)),
                    plain_ms=time_ms(lambda: PA.paged_decode_attention_fused_plain(*args), reps=10),
                    unfused_pair_ms=time_ms(pair), library_ms=time_ms(library),
                    bound_ms=t_b, bound_by=by)

    _record(rec, "paged_decode_attention_fused", err, "H2O-Danube-1.8B batch 8, context 3712", {
        "H2O-Danube-1.8B batch 8, context 3712": timed(CTX=3712, **DANUBE_HEADS),
        "Qwen2.5-14B heads batch 8, context 3712, slot-major": timed(CTX=3712, **QWEN_HEADS),
    })

    # -- the latent mode ---------------------------------------------------------
    H, X, VD = 16, 576, 512
    scale = 1.0 / np.sqrt(192)
    err = rel_err = 0.0
    for ctx in ([2816, 7, 513, 1500, 100, 16, 250, 2305], [2816, 1, 513, 0, 100, 16, 250, 17]):
        tables, npages, slots, ctx_t = inputs(ctx)
        pool = _randn(rng, 1, npages * S, X)
        q, new = _randn(rng, B, H, X), _randn(rng, B, X)
        gp, wp = pool.clone(), pool.clone()
        tail = (new, slots, tables, ctx_t, S, scale, VD)
        got = PA.paged_mla_decode_fused(q, gp, *tail)
        want = PA.paged_mla_decode_fused_plain(q, wp, *tail)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        r = e / want.float().abs().max().item()
        print(f"kernels: paged_mla_decode_fused B=8 H={H} ctx={ctx}: max abs err {e:.3e}, "
              f"{r:.3e} of the largest output", flush=True)
        if not np.isfinite(e) or r > ATTN_TOL:
            raise AssertionError(f"fused latent decode ctx {ctx}: rel err {r} > {ATTN_TOL}")
        if not torch.equal(gp, wp):
            raise AssertionError(f"fused latent decode ctx {ctx}: pool differs from the plain one")
        err, rel_err = max(err, e), max(rel_err, r)
    CTX = 2816
    maxp = 3072 // S
    tables = np.stack([b * maxp + np.arange(maxp) for b in range(B)]).astype(np.int32)
    pool, q, new = _randn(rng, 1, B * maxp * S, X), _randn(rng, B, H, X), _randn(rng, B, X)
    idx = _dev(tables[:, (CTX - 1) // S] * S + (CTX - 1) % S).long()
    slots, tables_d, ctx = idx.to(torch.int32), _dev(tables), _dev(np.full(B, CTX, np.int32))
    args = (q, pool, new, slots, tables_d, ctx, S, scale, VD)

    def pair():  # kernel 7, then kernel 2b over the written pool
        W.write_rows_2d(pool, new, slots)
        A.paged_mla_decode(q, pool[0], tables_d, ctx, S, scale, v_dim=VD)

    lat = pool[0].reshape(B, maxp * S, X)[:, None, :CTX]  # latents gathered beforehand
    kg = lat.contiguous().expand(-1, H, -1, -1)
    vg = lat[..., :VD].contiguous().expand(-1, H, -1, -1)

    def library():
        pool[0].index_copy_(0, idx, new)
        F.scaled_dot_product_attention(q[:, :, None], kg, vg, scale=scale)

    t_b, by = bound(B * (CTX - 1) * X * 2 + q.numel() * 2 + B * H * VD * 2 + 2 * B * X * 2
                    + tables.size * 4 + 3 * B * 4, 2 * B * H * CTX * (X + VD))
    label = f"DeepSeek-V2-Lite batch {B}, context {CTX}, 16 heads"
    print(f"kernels: paged_mla_decode_fused over every case max rel err {rel_err:.3e}", flush=True)
    _record(rec, "paged_mla_decode_fused", err, label, {label: dict(
        ms=time_ms(lambda: PA.paged_mla_decode_fused(*args)),
        plain_ms=time_ms(lambda: PA.paged_mla_decode_fused_plain(*args), reps=10),
        unfused_pair_ms=time_ms(pair), library_ms=time_ms(library), bound_ms=t_b, bound_by=by,
    )})


def _counters():
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import fp8_matmul as F8
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P
    from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
    from zhilight_tpu_torch.ops.cuda import quant_ragged as R

    return {
        "paged_decode_attention": PA.paged_decode_attention,
        "write_rows_pair": W.write_rows_pair,
        "paged_decode_attention_q": PA.paged_decode_attention_q,
        "fp8_block_matmul": F8.fp8_block_matmul,
        "write_rows_2d": W.write_rows_2d,
        "paged_mla_decode": A.paged_mla_decode,
        "w4a16_ragged_matmul": R.w4a16_ragged_matmul,
        "write_rows_hm": W.write_rows_hm,
        "paged_decode_attention_hm": A.paged_decode_attention_hm,
        "paged_prefill_attention_hm_packed": P.paged_prefill_attention_hm_packed,
        "w4a16_matmul": Q.w4a16_matmul,
        "paged_decode_attention_hm_q": A.paged_decode_attention_hm_q,
        "paged_prefill_attention_hm_packed_q": P.paged_prefill_attention_hm_packed_q,
        "flush_side_rows_hm": W.flush_side_rows_hm,
        "flush_side_rows_2d": W.flush_side_rows_2d,
        "flush_side_layers_hm": W.flush_side_layers_hm,
        "flush_side_layers_2d": W.flush_side_layers_2d,
        "paged_decode_attention_hm_partial": A.paged_decode_attention_hm_partial,
        "paged_decode_attention_hm_q_partial": A.paged_decode_attention_hm_q_partial,
        "paged_mla_decode_partial": A.paged_mla_decode_partial,
        "paged_decode_attention_fused": PA.paged_decode_attention_fused,
        "paged_mla_decode_fused": PA.paged_mla_decode_fused,
        "rope_write_rows_hm": W.rope_write_rows_hm,
        "rope_write_rows_2d": W.rope_write_rows_2d,
        "rope_write_rows_pair": W.rope_write_rows_pair,
    }


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions, by replacing
    the kernel modules that the model and the KV cache call through (for
    this script's plain-path reference forward only)."""
    from types import SimpleNamespace
    from unittest import mock

    from zhilight_tpu_torch.kvcache import paged as paged_mod
    from zhilight_tpu_torch.models import llama as llama_mod
    from zhilight_tpu_torch.models import mla as mla_mod
    from zhilight_tpu_torch.models import moe as moe_mod
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import fp8_matmul as F8
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA
    from zhilight_tpu_torch.ops.cuda import prefill_attention as P
    from zhilight_tpu_torch.ops.cuda import quant_matmul as Q
    from zhilight_tpu_torch.ops.cuda import quant_ragged as R

    def single(packed_plain):
        """The one-segment wrapper's signature over a packed plain version."""
        def fn(q, *rest):
            *pools, table, cache_len, q_len, S, scale, sw = rest
            return packed_plain(q, *pools, table.reshape(1, -1), cache_len.reshape(1),
                                q_len.reshape(1), S, scale, sw)
        return fn

    with mock.patch.object(paged_mod, "kv_write",
                           SimpleNamespace(write_rows_hm=W.write_rows_hm_plain,
                                           write_rows_2d=W.write_rows_2d_plain,
                                           rope_write_rows_hm=W.rope_write_rows_hm_plain,
                                           rope_write_rows_2d=W.rope_write_rows_2d_plain,
                                           scatter_scales=W.scatter_scales,
                                           write_rows_pair=W.write_rows_pair_plain,
                                           rope_write_rows_pair=W.rope_write_rows_pair_plain,
                                           flush_side_rows_hm=W.flush_side_rows_hm_plain,
                                           flush_side_rows_2d=W.flush_side_rows_2d_plain,
                                           flush_side_layers_hm=W.flush_side_layers_hm_plain,
                                           flush_side_layers_2d=W.flush_side_layers_2d_plain)), \
         mock.patch.object(llama_mod, "paged_attention", SimpleNamespace(
             paged_decode_attention=PA.paged_decode_attention_plain,
             paged_decode_attention_q=PA.paged_decode_attention_q_plain,
             paged_decode_attention_fused=PA.paged_decode_attention_fused_plain)), \
         mock.patch.object(mla_mod, "attn_headmajor",
                           SimpleNamespace(paged_mla_decode=A.paged_mla_decode_plain)), \
         mock.patch.object(mla_mod, "paged_attention",
                           SimpleNamespace(paged_mla_decode_fused=PA.paged_mla_decode_fused_plain)), \
         mock.patch.object(moe_mod, "quant_ragged", SimpleNamespace(
             w4a16_ragged_matmul=R.w4a16_ragged_matmul_plain)), \
         mock.patch.object(llama_mod, "attn_headmajor", SimpleNamespace(
             paged_decode_attention_hm=A.paged_decode_attention_hm_plain,
             paged_decode_attention_hm_q=A.paged_decode_attention_hm_q_plain)), \
         mock.patch.object(llama_mod, "prefill_attention", SimpleNamespace(
             paged_prefill_attention_hm=single(P.paged_prefill_attention_hm_packed_plain),
             paged_prefill_attention_hm_packed=P.paged_prefill_attention_hm_packed_plain,
             paged_prefill_attention_hm_q=single(P.paged_prefill_attention_hm_packed_q_plain),
             paged_prefill_attention_hm_packed_q=P.paged_prefill_attention_hm_packed_q_plain)), \
         mock.patch.object(Q, "w4a16_matmul", Q.w4a16_matmul_plain), \
         mock.patch.object(F8, "fp8_block_matmul", F8.fp8_block_matmul_plain):
        yield


def _prefill_logits(ex, prompt, quantized=None, emb=None):
    """Last-token logits [V] of one prompt through the model's forward on a
    scratch cache (identity page table) of the serving pool's kind, or as
    ``quantized`` says; ``emb`` [n, d] (fp32, host) replaces the prompt's
    token embeddings, cast to the model's dtype as the executor casts them."""
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models.base import PrefillMeta

    cfg, S, n = ex.cfg, ex.page_size, len(prompt)
    rows = None if emb is None else ex._emb_arg(np.asarray(emb, np.float32), n)
    pages = (n + S - 1) // S
    cache = ex.new_cache(pages, quantized)
    i32 = dict(dtype=torch.int32, device=ex.device)
    meta = PrefillMeta(
        positions=torch.arange(n, **i32), slot_mapping=torch.arange(n, **i32),
        page_table=torch.arange(pages, **i32), cache_len=torch.tensor(0, **i32),
        q_len=torch.tensor(n, **i32),
    )
    with torch.no_grad():
        logits, _ = L.forward_prefill(ex.params, cfg, ex.rope,
                                      torch.tensor(prompt, **i32), meta, cache, rows)
    return logits


def _decode_step_logits(ex, prompts, chunk=512):
    """One decode step's logits [B, V], through the kernels and through the
    plain path, after each prompt was prefilled (kernel path, ``chunk``-token
    chunks) into a scratch cache; every slot decodes the argmax of its
    prompt's last logits, so the contexts are the prompts' lengths + 1."""
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta

    cfg, S, B = ex.cfg, ex.page_size, len(prompts)
    i32 = dict(dtype=torch.int32, device=ex.device)
    maxp = max(len(p) // S + 1 for p in prompts)
    cache = ex.new_cache(B * maxp)
    tables = torch.arange(B * maxp, **i32).reshape(B, maxp)

    def slots(b, pos):
        return tables[b, (pos // S).long()] * S + pos % S

    nxt = []
    with torch.no_grad():
        for b, p in enumerate(prompts):
            for start in range(0, len(p), chunk):
                toks = torch.tensor(p[start : start + chunk], **i32)
                pos = torch.arange(start, start + len(toks), **i32)
                meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos),
                                   page_table=tables[b], cache_len=torch.tensor(start, **i32),
                                   q_len=torch.tensor(len(toks), **i32))
                logits, cache = L.forward_prefill(ex.params, cfg, ex.rope, toks, meta, cache)
            nxt.append(int(logits.argmax()))
        n = torch.tensor([len(p) for p in prompts], **i32)
        meta = DecodeMeta(positions=n, slot_mapping=slots(torch.arange(B, device=ex.device), n),
                          page_tables=tables, context_lens=n + 1)
        tokens = torch.tensor(nxt, **i32)
        got, _ = L.forward_decode(ex.params, cfg, ex.rope, tokens, meta, cache)
        with plain_kernels():
            want, _ = L.forward_decode(ex.params, cfg, ex.rope, tokens, meta, cache)
    return got, want


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def serve_path(label: str, llm, rec: dict, seed: int, lens=SERVE_LENS, compare_plain=True):
    """One main path: 8 concurrent requests (prompts of ``lens`` tokens, 32
    new tokens, 2 sampled) with the launch counters zeroed just before and
    read just after, then the first-token logits and one decode step's logits
    (every prompt's continuation) against the plain path (not for a path that
    adds no kernel to one already held: ``compare_plain=False``). Returns the
    prompts and the kernel path's first-token logits of prompt 1."""
    from unittest import mock

    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
    from zhilight_tpu_torch.models import llama as L

    ex, cfg, expect = llm.executor, llm.model_config, PATHS[label]
    warm_s = ex.warmup()
    weights = sum(t.numel() * t.element_size() for t in _leaves(ex.params))
    print(f"serve: {label}: {cfg.num_layers} layers, {weights / 2**30:.2f} GiB of weights, "
          f"{ex.num_pages} KV pages, decode window {ex.decode_window}, "
          f"warmup {warm_s:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
    MAXLEN = 32
    gargs = [GeneratorArg(max_length=MAXLEN) for _ in lens]
    gargs[1] = GeneratorArg(max_length=MAXLEN, temperature=0.8, top_p=0.9, seed=7)
    gargs[6] = GeneratorArg(max_length=MAXLEN, temperature=0.8, top_p=0.9, seed=11)

    prefills = [0]  # model forwards over prefill chunks (single, packed, chained)
    backbone = L.backbone

    def counted(*a, **kw):
        prefills[0] += a[7] == "prefill"
        return backbone(*a, **kw)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    gen = DynamicBatchGenerator(llm).start()
    try:
        t0 = time.monotonic()
        with mock.patch.object(L, "backbone", counted):
            results = gen.batch_generate(prompts, gargs, timeout=600)
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        solo = [gen.generate(prompts[0], GeneratorArg(max_length=MAXLEN), timeout=300)
                for _ in range(2)]
    finally:
        gen.stop()
    for name, n in launches.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"][label] = n
    print(f"serve: {label}: {len(prompts)} requests in {wall:.2f} s, {prefills[0]} prefill "
          f"forwards; launches {launches}", flush=True)
    write = FUSED_PREFILL_WRITES.get(label)
    if write and launches[write] != cfg.num_layers * prefills[0]:
        raise AssertionError(f"{label}: {launches[write]} {write} launches, not {cfg.num_layers} "
                             f"layers x {prefills[0]} prefill forwards: a decode step wrote rows")
    for n, a, r in zip(lens, gargs, results):
        out = r.outputs[0]
        print(f"serve: {label}: prompt {n} temp {a.temperature}: {len(out.token_ids)} tokens, "
              f"finish {out.finish_reason}, first tokens {out.token_ids[:6]}", flush=True)
        if not (len(out.token_ids) == MAXLEN or out.finish_reason == "stop"):
            raise AssertionError(f"prompt {n}: {len(out.token_ids)} tokens, {out.finish_reason}")
        if out.logprobs is None or not np.all(np.isfinite(out.logprobs)):
            raise AssertionError(f"prompt {n}: non-finite logprobs")
    if any(launches[name] == 0 for name in expect):
        raise AssertionError(f"{label}: a kernel of the path never launched: {launches}")
    if any(n for name, n in launches.items() if name not in expect):
        raise AssertionError(f"{label}: a kernel of another path launched: {launches}")
    if solo[0].outputs[0].token_ids != solo[1].outputs[0].token_ids:
        raise AssertionError("a repeated greedy request returned other tokens")
    same = sum(a == b for a, b in zip(solo[0].outputs[0].token_ids, results[0].outputs[0].token_ids))
    print(f"serve: {label}: repeated greedy request identical; agrees with its batched run "
          f"on {same}/{MAXLEN} tokens", flush=True)
    if not compare_plain:
        return prompts, None

    # first-token logits: main path (kernels) against the plain path, on the card
    prompt = prompts[1]
    first = got = _prefill_logits(ex, prompt)
    with plain_kernels():
        want = _prefill_logits(ex, prompt)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite first-token logits")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top_k, top_p = torch.topk(got, 5).indices.tolist(), torch.topk(want, 5).indices.tolist()
    print(f"serve: {label}: first-token logits kernel vs plain: max rel err {rel:.3e} "
          f"(tolerance {LOGIT_TOL}); argmax {top_k[0]} vs {top_p[0]}; "
          f"top-5 overlap {len(set(top_k) & set(top_p))}/5", flush=True)
    if rel > LOGIT_TOL or top_k[0] != top_p[0]:
        raise AssertionError(f"{label}: first-token logits differ: {rel} > {LOGIT_TOL} "
                             f"or argmax {top_k[0]} != {top_p[0]}")

    # one decode step of the 8 prompts (contexts of the prompts + 1) against the plain
    # path; a row's argmax may differ only where the plain logits put the
    # kernel's pick within the tolerance of their own maximum
    got, want = _decode_step_logits(ex, prompts)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite decode-step logits")
    scale = want.abs().amax(-1)
    rel = ((got - want).abs().amax(-1) / scale).max().item()
    pick = got.argmax(-1)
    same = int((pick == want.argmax(-1)).sum())
    slack = ((want.amax(-1) - want.gather(-1, pick[:, None])[:, 0]) / scale).max().item()
    print(f"serve: {label}: decode-step logits kernel vs plain (batch {len(prompts)}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.dim_head}, contexts "
          f"{min(lens) + 1} to {max(lens) + 1}): max rel err {rel:.3e} (tolerance {LOGIT_TOL}); "
          f"argmax same on {same}/{len(prompts)} rows, worst pick {slack:.3e} of max |logit| "
          f"below the plain maximum", flush=True)
    if rel > LOGIT_TOL or slack > LOGIT_TOL:
        raise AssertionError(f"{label}: decode-step logits differ: {rel} or {slack} > {LOGIT_TOL}")
    return prompts, first


def pool_rows(label: str, ex, written: torch.Tensor, what: str) -> None:
    """copy_slots and swap_out_rows -> swap_in_rows, bit-exact over every array
    of the serving cache: 64 rows the requests wrote (``written`` [N] says
    which) are copied and swapped into 128 rows nothing has written yet."""
    cache = ex.cache
    src, free = torch.nonzero(written)[:64, 0], torch.nonzero(~written)[:128, 0]
    if len(src) < 64 or len(free) < 128:
        raise AssertionError(f"{label}: {len(src)} written and {len(free)} free pool rows")
    rows = src.cpu().numpy().astype(np.int32)
    dst = free.cpu().numpy().astype(np.int32)
    before = [[arr[:, src].clone() for arr in arrays] for arrays in cache.arrays()]
    ex.copy_slots(rows, dst[:64])
    ex.swap_in_rows(dst[64:], ex.swap_out_rows(rows))
    torch.cuda.synchronize()
    n = 0
    for arrays, saved in zip(cache.arrays(), before):
        for arr, want in zip(arrays, saved):
            if not (torch.equal(arr[:, free[:64]], want) and torch.equal(arr[:, free[64:]], want)):
                raise AssertionError(f"{label}: pool rows moved by copy or swap differ")
            if not torch.equal(arr[:, src], want):
                raise AssertionError(f"{label}: copy or swap changed its source rows")
            n += 1
    print(f"serve: {label}: copy_slots and swap_out_rows -> swap_in_rows bit-exact over "
          f"{n} arrays ({ex.cfg.num_layers} layers x {what}), 64 rows each", flush=True)


def pool_rows_and_scoring(label: str, llm, prompts, bf16_first) -> None:
    """On the int8-KV executor: copy_slots and swap_out_rows -> swap_in_rows
    bit-exact over the pool and both scale arrays, one beam request, and
    calc_logits against the prefill logits of the same prompt."""
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg

    ex = llm.executor
    cache = ex.cache
    if not (cache.quantized and cache.k[0].dtype == torch.int8
            and len(cache.arrays()) == (3 if cache.packed else 4)):
        raise AssertionError(f"{label}: the serving pool is not int8 with scales")
    # rows the requests wrote: their K scales are set
    pool_rows(label, ex, cache.k_scale[0][0, : cache.num_slots] != 0,
              "pool, k_scale, v_scale" if cache.packed else "K pool, V pool, k_scale, v_scale")

    with DynamicBatchGenerator(llm) as gen:
        t0 = time.monotonic()
        beam = gen.generate(prompts[5], GeneratorArg(beam_size=2, num_results=2, max_length=8),
                            timeout=300)
        beam_s = time.monotonic() - t0
    outs = [(o.token_ids, round(o.score, 4)) for o in beam.outputs]
    if not outs or not all(len(t) > 0 and np.isfinite(sc) for t, sc in outs):
        raise AssertionError(f"{label}: beam request returned {outs}")
    print(f"serve: {label}: beam request (beam 2, 8 new tokens) in {beam_s:.2f} s: {outs}",
          flush=True)

    # calc_logits runs on a scratch cache in the model's dtype, beside the
    # int8 pool: its last row is the first-token logits of a bf16-KV prefill
    prompt = prompts[1]
    t0 = time.monotonic()
    scored = torch.from_numpy(llm.calc_logits(prompt)).to(ex.device)
    score_s = time.monotonic() - t0
    want = _prefill_logits(ex, prompt, quantized=False)
    if scored.shape != (len(prompt), ex.cfg.vocab_size) or not torch.isfinite(scored).all():
        raise AssertionError(f"{label}: calc_logits returned {tuple(scored.shape)}")
    rel = ((scored[-1] - want).abs().max() / want.abs().max()).item()
    rel8 = ((scored[-1] - _prefill_logits(ex, prompt)).abs().max() / want.abs().max()).item()
    rel_paths = ((bf16_first - _prefill_logits(ex, prompt)).abs().max() / bf16_first.abs().max()).item()
    print(f"serve: {label}: calc_logits ({len(prompt)} tokens, {score_s:.2f} s) last row vs "
          f"prefill logits over a bf16 scratch cache: max rel err {rel:.3e} (tolerance "
          f"{LOGIT_TOL}); vs prefill logits over an int8 cache {rel8:.3e}; int8-KV first-token "
          f"logits vs the bf16-KV path's {rel_paths:.3e} (printed, not held)", flush=True)
    if rel > LOGIT_TOL or int(scored[-1].argmax()) != int(want.argmax()):
        raise AssertionError(f"{label}: calc_logits differs from the prefill logits: {rel}")


def window_path(label: str, base, engine_config, rec: dict, args, lens=SERVE_LENS):
    """A decode-window side-KV path: a second ``LLM`` over ``base``'s weights,
    its executor built with ZT_WINDOW_KV=1 set for it alone, serving the 8
    requests (``serve_path``: the partial kernels and the flush, never the
    normal decode), then :func:`window_check`."""
    from zhilight_tpu_torch.llm import LLM

    with env_switch("ZT_WINDOW_KV", True):
        llm = LLM(model_config=base.model_config, quant_config=base.quant_config,
                  params=base.executor.params, engine_config=engine_config, device="cuda")
    ex = llm.executor
    if not (ex.window_kv and ex._use_side_window(ex.decode_window)):
        raise AssertionError(f"{label}: the executor does not take the side-buffer path")
    prompts, _ = serve_path(label, llm, rec, args.seed, lens, compare_plain=False)
    window_check(label, ex, prompts)
    args.llms[label] = llm
    release_pool(llm)


def window_check(label: str, ex, prompts, K: int = 8) -> None:
    """One K-step decode window of the 8 prompts (prefilled through the
    kernels in 512-token chunks into a scratch cache, which is then copied),
    run with side buffers (``forward_decode_window`` + ``flush_window_rows``)
    and per step (``forward_decode``) on the same weights, both fed the
    per-step path's greedy tokens. Held: during the window no row write
    launches and the flush launches once, for every layer; at each step every row's
    logits agree within LOGIT_TOL of the largest and the window's pick lies
    within LOGIT_TOL of the per-step maximum; after the flush every layer's
    rows are bit-equal to the window's side rows (requantized for an int8
    pool), and layer 0's to the per-step path's (int8: codes within 1,
    scales within 2^-8 relative, as this step's rows are dequantized to bf16
    inside the window and requantized at the flush)."""
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta

    cfg, S, B = ex.cfg, ex.page_size, len(prompts)
    i32 = dict(dtype=torch.int32, device=ex.device)
    maxp = max((len(p) + K) // S + 1 for p in prompts)
    cache = ex.new_cache(B * maxp)
    tables = torch.arange(B * maxp, **i32).reshape(B, maxp)
    rows_b = torch.arange(B, device=ex.device)

    def slots(b, pos):
        return tables[b, (pos // S).long()] * S + pos % S

    counters = _counters()
    with torch.no_grad():
        nxt = []
        for b, p in enumerate(prompts):
            for start in range(0, len(p), 512):
                toks = torch.tensor(p[start : start + 512], **i32)
                pos = torch.arange(start, start + len(toks), **i32)
                meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos), page_table=tables[b],
                                   cache_len=torch.tensor(start, **i32),
                                   q_len=torch.tensor(len(toks), **i32))
                logits, cache = L.forward_prefill(ex.params, cfg, ex.rope, toks, meta, cache)
            nxt.append(int(logits.argmax()))
        step_cache = dataclasses.replace(cache, **{
            f: [a.clone() for a in getattr(cache, f)] for f in ("k", "v", "latent", "k_scale", "v_scale")
            if getattr(cache, f) is not None})
        n = torch.tensor([len(p) for p in prompts], **i32)
        side_dtype = torch.float32 if cache.quantized else cfg.torch_dtype
        side = L.new_side_rows(cfg, B, K, side_dtype, ex.device)
        valid = torch.zeros(B, K, dtype=torch.bool, device=ex.device)
        tokens = torch.tensor(nxt, **i32)
        writes = 0
        worst_rel, worst_slack, same = 0.0, 0.0, 0
        for k in range(K):
            pos = n + k
            meta = DecodeMeta(positions=pos, slot_mapping=slots(rows_b, pos), page_tables=tables,
                              context_lens=pos + 1)
            valid[:, k] = True
            w0 = sum(counters[w].launches for w in ROW_WRITES)
            got, cache, side = L.forward_decode_window(ex.params, cfg, ex.rope, tokens, meta, cache,
                                                       side, valid, n, k)
            writes += sum(counters[w].launches for w in ROW_WRITES) - w0
            want, step_cache = L.forward_decode(ex.params, cfg, ex.rope, tokens, meta, step_cache)
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                raise AssertionError(f"{label}: non-finite window logits at step {k}")
            scale = want.abs().amax(-1)
            worst_rel = max(worst_rel, ((got - want).abs().amax(-1) / scale).max().item())
            pick = got.argmax(-1)
            same += int((pick == want.argmax(-1)).sum())
            worst_slack = max(worst_slack, ((want.amax(-1) - want.gather(-1, pick[:, None])[:, 0])
                                            / scale).max().item())
            tokens = want.argmax(-1).to(torch.int32)
        flush = counters["flush_side_layers_2d" if cfg.mla.enabled else "flush_side_layers_hm"]
        f0 = flush.launches
        cache = L.flush_window_rows(cfg, cache, side, valid, n, tables)
        flushes = flush.launches - f0
    torch.cuda.synchronize()
    print(f"serve: {label}: one {K}-step window with side buffers vs per step (batch {B}, "
          f"contexts {min(map(len, prompts)) + 1} to {max(map(len, prompts)) + K}): logits max rel "
          f"err {worst_rel:.3e} (tolerance {LOGIT_TOL}); argmax same on {same}/{B * K} rows, worst "
          f"pick {worst_slack:.3e} of max |logit| below the per-step maximum; row writes during "
          f"the window {writes}, flush launches {flushes} ({cfg.num_layers} layers)", flush=True)
    if worst_rel > LOGIT_TOL or worst_slack > LOGIT_TOL:
        raise AssertionError(f"{label}: window logits differ from per-step: {worst_rel}, {worst_slack}")
    if writes or flushes != 1:
        raise AssertionError(f"{label}: {writes} row writes in the window, {flushes} flushes")

    # the pool after the flush: every layer holds exactly the window's side
    # rows (an int8 pool their requantization); layer 0's rows are the
    # per-step path's too (the same tokens give the same rows there; deeper
    # layers attend over rounding-level differences, printed, not held)
    from zhilight_tpu_torch.kvcache.paged import _quantize_rows

    written = slots(rows_b[:, None], n[:, None] + torch.arange(K, device=ex.device)).reshape(-1).long()
    mismatched, per_step = [], []
    for layer, rows in enumerate(side):
        if cfg.mla.enabled:
            want = [rows.reshape(1, B * K, -1)]
        elif cache.quantized:
            D = rows.shape[-1] // 2
            codes, scales = _quantize_rows(torch.stack((rows[..., :D], rows[..., D:])))
            want = [torch.cat((codes[0], codes[1]), -1), scales[0], scales[1]]
        else:
            want = [rows]
        if not cfg.mla.enabled:  # [B, Hkv, K(, X)] -> [Hkv, B * K(, X)] as the pool holds them
            want = [w.transpose(0, 1).reshape(w.shape[1], B * K, *w.shape[3:]) for w in want]
        for arrays, ref, w in zip(cache.arrays(), step_cache.arrays(), want):
            got = arrays[layer][:, written]
            if not torch.equal(got, w):
                mismatched.append(layer)
            diff = (got.float() - ref[layer][:, written].float()).abs().max()
            per_step.append((layer, (diff / ref[layer][:, written].float().abs().max()).item()))
    layer0 = [rel for layer, rel in per_step if layer == 0]
    print(f"serve: {label}: pools after the flush ({len(written)} rows a layer): every layer's rows "
          f"equal to the window's side rows{' requantized' if cache.quantized else ''}: "
          f"{not mismatched}; against the per-step writes, layer 0 max rel diff "
          f"{max(layer0):.3e}, every layer {max(rel for _, rel in per_step):.3e}", flush=True)
    if mismatched:
        raise AssertionError(f"{label}: flushed rows differ from the side rows in layers {mismatched}")
    if cache.quantized:  # bf16 dequantized rows requantized: a code may move by one
        codes_ok = (cache.k[0][:, written].int() - step_cache.k[0][:, written].int()).abs().max() <= 1
        if not (codes_ok and max(layer0[1:]) <= 2.0 ** -8):
            raise AssertionError(f"{label}: layer 0's int8 rows differ from the per-step path's")
    elif max(layer0) != 0:
        raise AssertionError(f"{label}: layer 0's rows differ from the per-step path's")


def fused_path(label: str, base, engine_config, rec: dict, args, lens=SERVE_LENS):
    """A fused write + attend path: a second ``LLM`` over ``base``'s weights,
    its executor built with ZT_FUSED_KV=1 set for it alone, serving the 8
    requests (``serve_path``: the fused kernel and never the unfused decode;
    row writes only in prefill), then :func:`fused_check`."""
    from zhilight_tpu_torch.llm import LLM

    with env_switch("ZT_FUSED_KV", True):
        llm = LLM(model_config=base.model_config, quant_config=base.quant_config,
                  params=base.executor.params, engine_config=engine_config, device="cuda")
    if not llm.executor.fused_kv:
        raise AssertionError(f"{label}: the executor did not read ZT_FUSED_KV")
    prompts, _ = serve_path(label, llm, rec, args.seed, lens, compare_plain=False)
    fused_check(label, llm.executor, prompts)
    args.llms[label] = llm
    release_pool(llm)


def _unrounded_latent_decode(q_eff, latent_pool, page_tables, context_lens, page_size, scale,
                             v_dim, emit_partial=False):
    """The latent decode with p not rounded: the partial-mode kernel's (m, l,
    acc) normalized, zero for an empty slot (l = 0, acc = 0)."""
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A

    assert not emit_partial
    _, l, acc = A.paged_mla_decode_partial(q_eff, latent_pool, page_tables, context_lens,
                                           page_size, scale, v_dim)
    return (acc / l.clamp_min(1e-20)[..., None]).to(q_eff.dtype)


def fused_check(label: str, ex, prompts) -> None:
    """One batch-8 decode step of the prompts (prefilled through the kernels
    in 512-token chunks into a scratch cache, which is then copied), fused
    (``DecodeMeta.fused``) and unfused, on the same weights and tokens. Held:
    the fused step launches the fused kernel once a layer and no unfused
    decode and no row write; the logits agree within LOGIT_TOL of the largest
    with the same argmax on every row. Over the latent pool the unfused
    decode rounds p to bf16, as the reference's _kernel_hm does, and the fused
    one does not, as its _kernel_bs_fused does not: there the argmax is held
    against a second unfused step whose latent decode is the partial-mode
    kernel normalized (p not rounded, as in the fused mode), and against the
    model's own unfused step the logits are held within LOGIT_TOL and the
    argmax agreement is printed; every layer's pools equal the pre-step
    pools with the rows the fused kernel was given stored by the unfused
    write kernel, and layer 0's rows equal the unfused step's (the same
    inputs; deeper layers' rows follow the rounding of their inputs:
    printed, not held)."""
    from types import SimpleNamespace
    from unittest import mock

    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models import mla as M
    from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
    from zhilight_tpu_torch.ops.cuda import kv_write as W
    from zhilight_tpu_torch.ops.cuda import paged_attention as PA

    cfg, S, B = ex.cfg, ex.page_size, len(prompts)
    mla = cfg.mla.enabled
    i32 = dict(dtype=torch.int32, device=ex.device)
    maxp = max(len(p) // S + 1 for p in prompts)
    cache = ex.new_cache(B * maxp)
    tables = torch.arange(B * maxp, **i32).reshape(B, maxp)
    rows_b = torch.arange(B, device=ex.device)

    def slots(b, pos):
        return tables[b, (pos // S).long()] * S + pos % S

    with torch.no_grad():
        nxt = []
        for b, p in enumerate(prompts):
            for start in range(0, len(p), 512):
                toks = torch.tensor(p[start : start + 512], **i32)
                pos = torch.arange(start, start + len(toks), **i32)
                meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos), page_table=tables[b],
                                   cache_len=torch.tensor(start, **i32),
                                   q_len=torch.tensor(len(toks), **i32))
                logits, cache = L.forward_prefill(ex.params, cfg, ex.rope, toks, meta, cache)
            nxt.append(int(logits.argmax()))
    fields = ("latent",) if mla else ("k", "v")
    pre = dataclasses.replace(cache, **{f: [a.clone() for a in getattr(cache, f)] for f in fields})
    n = torch.tensor([len(p) for p in prompts], **i32)
    meta = DecodeMeta(positions=n, slot_mapping=slots(rows_b, n), page_tables=tables,
                      context_lens=n + 1)
    tokens = torch.tensor(nxt, **i32)

    name = "paged_mla_decode_fused" if mla else "paged_decode_attention_fused"
    kernel, given = getattr(PA, name), []

    def capture(*a, **kw):  # the rows each layer hands the fused kernel
        given.append((a[2],) if mla else (a[3], a[4]))
        return kernel(*a, **kw)

    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    # the model module calls the wrapper through its `paged_attention` name
    with torch.no_grad(), mock.patch.object(M if mla else L, "paged_attention",
                                            SimpleNamespace(**{name: capture})):
        got, cache = L.forward_decode(ex.params, cfg, ex.rope, tokens,
                                      dataclasses.replace(meta, fused=True), cache)
    torch.cuda.synchronize()
    launched = {k: c.launches - before[k] for k, c in counters.items()
                if c.launches != before[k] and "matmul" not in k}  # attention and row writes
    if launched != {name: cfg.num_layers}:
        raise AssertionError(f"{label}: the fused step launched {launched}")
    mismatched = []
    for layer, rows in enumerate(given):
        if mla:
            want = [W.write_rows_2d(pre.latent[layer].clone(), rows[0], meta.slot_mapping)]
            have = [cache.latent[layer]]
        else:
            want = list(W.write_rows_pair(pre.k[layer].clone(), pre.v[layer].clone(),
                                          *rows, meta.slot_mapping))
            have = [cache.k[layer], cache.v[layer]]
        if not all(torch.equal(w, h) for w, h in zip(want, have)):
            mismatched.append(layer)
        del want
    with torch.no_grad():
        want, pre = L.forward_decode(ex.params, cfg, ex.rope, tokens, meta, pre)
        held = want
        if mla:  # the same step (its row writes rewrite the same rows) with p not rounded
            with mock.patch.object(A, "paged_mla_decode", _unrounded_latent_decode):
                held, pre = L.forward_decode(ex.params, cfg, ex.rope, tokens, meta, pre)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in (got, want, held)):
        raise AssertionError(f"{label}: non-finite decode-step logits")
    rel = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    rel_held = ((got - held).abs().amax(-1) / held.abs().amax(-1)).max().item()
    pick = got.argmax(-1)
    same = int((pick == want.argmax(-1)).sum())
    same_held = int((pick == held.argmax(-1)).sum())
    written = meta.slot_mapping.long()
    per_layer = []
    for f in fields:
        for layer, (a, b) in enumerate(zip(getattr(cache, f), getattr(pre, f))):
            ga, gb = a[0][written].float(), b[0][written].float()
            per_layer.append((layer, ((ga - gb).abs().max() / gb.abs().max()).item()))
    layer0 = max(r for layer, r in per_layer if layer == 0)
    unrounded = (f"; against the unfused step with p not rounded (the partial-mode kernel "
                 f"normalized): logits max rel err {rel_held:.3e}, argmax same on "
                 f"{same_held}/{B} rows") if mla else ""
    print(f"serve: {label}: one decode step fused vs unfused (batch {B}, contexts "
          f"{min(map(len, prompts)) + 1} to {max(map(len, prompts)) + 1}): logits max rel err "
          f"{rel:.3e} (tolerance {LOGIT_TOL}); argmax same on {same}/{B} rows{unrounded}; "
          f"{name} launches "
          f"{cfg.num_layers}, no unfused decode or row write; every layer's pools equal to the "
          f"unfused write of the kernel's rows: {not mismatched}; written rows against the "
          f"unfused step's, layer 0 max rel diff {layer0:.3e}, every layer "
          f"{max(r for _, r in per_layer):.3e}", flush=True)
    if rel > LOGIT_TOL or rel_held > LOGIT_TOL or same_held != B:
        raise AssertionError(f"{label}: fused logits differ from unfused: {rel}, {rel_held}, "
                             f"argmax {same_held}/{B}")
    if mismatched:
        raise AssertionError(f"{label}: pools differ from the unfused write in layers {mismatched}")
    if layer0 != 0:
        raise AssertionError(f"{label}: layer 0's rows differ from the unfused step's")


def release_pool(llm) -> None:
    """Drop a path's KV pool until the timing phase rebuilds it, so that only
    one path's pool is held at a time."""
    llm.executor.cache = None
    llm.executor._decode_carry = None
    torch.cuda.empty_cache()


def qwen_engine_config(kv_dtype: str = "bfloat16"):
    """bench.py's serving stage: batch 8, max_model_len 3904, 512-token chunks;
    the pool is sized from the free device memory (1952 pages of 16)."""
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig

    return EngineConfig(
        max_model_len=3904,
        cache=CacheConfig(page_size=16, kv_dtype=kv_dtype),
        scheduler=SchedulerConfig(max_batch=8, chunk_size=512),
    )


def load_qwen(seed: int):
    """Qwen2.5-14B GPTQ-Int4 from HF-format tensors made from ``seed``,
    through the port's map_hf_params into ``LLM``."""
    from zhilight_tpu_torch.config import QuantConfig, adapt_hf_config
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.ops.quant import pack_int4
    from zhilight_tpu_torch.utils.hf_loader import map_hf_params
    from zhilight_tpu_torch.utils.quant_convert import unpack_gptq

    hf = QWEN14B_GPTQ
    cfg, qcfg = adapt_hf_config(hf), QuantConfig.from_hf_config(hf)
    keep = {}
    t0 = time.monotonic()
    params = map_hf_params(qwen_hf_tensors(hf, seed, keep), cfg, quant_method="gptq",
                           device="cuda")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    # the loader repacked qweight straight to planar on the GPU; hold one
    # projection against the canonical route on the host (unpack to int8
    # nibbles, then pack_int4)
    canon = pack_int4(torch.from_numpy(unpack_gptq(**keep["q_proj"])["w_p"]))
    if not torch.equal(params["layers"]["0"]["attn"]["q_proj"]["w_p"].cpu(), canon):
        raise AssertionError("GPTQ planar repack on the GPU differs from unpack_gptq + pack_int4")
    llm = LLM(model_config=cfg, quant_config=qcfg, params=params,
              engine_config=qwen_engine_config(), device="cuda")
    q = llm.executor.params["layers"]["0"]["attn"]["q_proj"]
    print(f"serve: Qwen2.5-14B GPTQ-Int4: HF tensors made from seed {seed} in "
          f"{keep['make_s']:.1f} s; map_hf_params(gptq) on the GPU in "
          f"{load_s - keep['make_s']:.1f} s (load and conversion {load_s:.1f} s in all); "
          f"layer-0 q_proj w_p {q['w_p'].dtype} {tuple(q['w_p'].shape)}, scales "
          f"{q['scales'].dtype}, bit-identical to unpack_gptq + pack_int4 on the host", flush=True)
    return llm


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def fp16_qwen_path(rec: dict, args, base) -> None:
    """Qwen2.5-14B GPTQ-Int4 as an fp16 checkpoint: the configuration with
    ``"torch_dtype": "float16"`` (as the published GPTQ configs give it) over
    the bf16 path's GPTQ leaves and its dense leaves cast to fp16 (what the
    loader makes of the same checkpoint in fp16), a packed fp16 pool. The
    main path with its kernel counts and logits against the plain path
    (serve_path), then teacher-forced greedy decoding against the plain path."""
    from zhilight_tpu_torch.config import adapt_hf_config
    from zhilight_tpu_torch.llm import LLM

    label = "Qwen2.5-14B-GPTQ-Int4-fp16"
    cfg = adapt_hf_config(dict(QWEN14B_GPTQ, torch_dtype="float16"))
    if cfg.torch_dtype != torch.float16:
        raise AssertionError(f"{label}: the adapter gave {cfg.torch_dtype}")
    params = _tree_map(base.executor.params, lambda t: t.to(torch.float16)
                       if torch.is_tensor(t) and t.dtype == torch.bfloat16 else t)
    llm = LLM(model_config=cfg, quant_config=base.quant_config, params=params,
              engine_config=qwen_engine_config(), device="cuda")
    cache = llm.executor.cache
    if not (cache.packed and cache.k[0].dtype == torch.float16):
        raise AssertionError(f"{label}: pool {cache.k[0].dtype}, packed {cache.packed}")
    prompts, _ = serve_path(label, llm, rec, args.seed)
    teacher_forced(label, llm.executor, prompts[:4], steps=8)
    args.llms[label] = llm
    release_pool(llm)


def teacher_forced(label: str, ex, prompts, steps: int, embs=None, against: str = "plain",
                   pages_per_seq: int = 0, batch: int = 0, tol: float = 2e-2) -> None:
    """The prompts prefilled through the kernels (512-token chunks; ``embs``:
    each prompt's embedding rows [n, d], fp32 on the host, or None) into a
    scratch cache, then ``steps`` batched decode steps fed the other side's
    argmax. ``against="plain"``: the cache copied and decoded through the
    plain path (plain_kernels), each latent decode (row 2b) of the kernel
    side held against its split-count twin and its plain version on the
    same inputs (ATTN_TOL, idle rows zero, as the kernels phase holds it).
    ``against="ids"``: the prompts as token ids prefilled and decoded
    through the kernels into a cache of their own, the first-token logits
    held too. ``pages_per_seq`` and ``batch``: the decode's page-table width
    and row count, by default what the prompts need; the serving engine's
    (its max_pages_per_seq and max_batch, the rows past the prompts idle at
    context 0 as the engine's idle slots) give the kernels the engine's
    shapes and split plans.

    MoE routing: where a token's top-k experts on the kernel side part from
    the other side's in the same layer and step, the parting must be a near
    tie (the other side's gap between its k-th expert and the kernel side's
    pick at most twice the row's largest router-logit difference); the token
    then takes the other side's experts and weights, so that one rounding
    flip does not stand for the rest of the step (as
    tests/test_torch_multimodal.py holds the port's MoE to the reference's).
    Held (the teacher-forced rule of the fused-KV card test): every step's
    logits within ``tol`` of the row's largest logit on the other side, and
    the same argmax wherever that side's top-2 gap exceeds twice the largest
    difference."""
    from types import SimpleNamespace
    from unittest import mock

    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models import mla as mla_mod
    from zhilight_tpu_torch.models import moe as moe_mod
    from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta
    from zhilight_tpu_torch.ops.cuda import attn_headmajor as A

    cfg, S, B = ex.cfg, ex.page_size, len(prompts)
    i32 = dict(dtype=torch.int32, device=ex.device)
    maxp = pages_per_seq or max((len(p) + steps) // S + 1 for p in prompts)
    rows = max(batch, B)
    tables = torch.full((rows, maxp), -1, **i32)
    tables[:B] = torch.arange(B * maxp, **i32).reshape(B, maxp)
    slots = lambda b, pos: (tables[b, (pos // S).long()] * S + pos % S).to(torch.int32)
    active, idle = torch.arange(B, device=ex.device), torch.zeros(rows - B, **i32)

    def prefill(embs):
        cache, last = ex.new_cache(B * maxp), []
        for b, p in enumerate(prompts):
            for start in range(0, len(p), 512):
                toks = torch.tensor(p[start : start + 512], **i32)
                pos = torch.arange(start, start + len(toks), **i32)
                meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos), page_table=tables[b],
                                   cache_len=torch.tensor(start, **i32),
                                   q_len=torch.tensor(len(toks), **i32))
                emb = None if embs is None or embs[b] is None else ex._emb_arg(
                    np.asarray(embs[b][start : start + 512], np.float32), len(toks))
                logits, cache = L.forward_prefill(ex.params, cfg, ex.rope, toks, meta, cache, emb)
            last.append(logits.float())
        return cache, torch.stack(last)

    select, mla = moe_mod.select_experts, A.paged_mla_decode
    routes, seen = [], dict(routed=0, parted=0, ratio=0.0, calls=0, twin=0.0, plain=0.0, size=0.0)

    def select_other(logits, m, bias=None):
        weights, ids = select(logits, m, bias)
        routes.append((logits[:B], ids[:B], weights[:B]))
        return weights, ids

    def select_kernels(logits, m, bias=None):
        weights, ids = select(logits, m, bias)
        o_logits, o_ids, o_weights = routes.pop(0)
        parted = (ids[:B].sort(-1).values != o_ids.sort(-1).values).any(-1)
        seen["routed"] += B
        for r in parted.nonzero().flatten().tolist():
            own = sorted(set(ids[r].tolist()) - set(o_ids[r].tolist()))
            gap = o_logits[r, o_ids[r].long()].min() - o_logits[r, own].max()
            ratio = (gap / (o_logits[r] - logits[r]).abs().max()).item()
            if not ratio <= 2:
                raise AssertionError(f"{label}: routing parted off a near tie (gap {ratio} x the "
                                     f"router-logit difference)")
            seen["parted"], seen["ratio"] = seen["parted"] + 1, max(seen["ratio"], ratio)
            ids[r], weights[r] = o_ids[r], o_weights[r]
        return weights, ids

    def mla_checked(q, pool, page_tables, context_lens, page_size, scale, v_dim, **kw):
        out = mla(q, pool, page_tables, context_lens, page_size, scale, v_dim, **kw)
        if kw.get("emit_partial"):
            return out
        live = context_lens > 0
        plan = A.mla_plan(q.device, q.shape[0], q.shape[1], page_tables.shape[1] * page_size)
        twin = A.paged_mla_decode_twin(q, pool, page_tables, context_lens, page_size, scale,
                                       v_dim, plan)
        plain = A.paged_mla_decode_plain(q, pool, page_tables, context_lens, page_size, scale,
                                         v_dim)
        e_twin = (out[live].float() - twin[live].float()).abs().max().item()
        e_plain = (out[live].float() - plain[live].float()).abs().max().item()
        if not (e_twin <= ATTN_TOL and e_plain <= ATTN_TOL) or out[~live].any():
            raise AssertionError(f"{label}: row 2b at B {q.shape[0]}, plan {plan}: error {e_twin}"
                                 f" (twin) / {e_plain} (plain), or an idle row not zero")
        seen["calls"] += 1
        seen["twin"], seen["plain"] = max(seen["twin"], e_twin), max(seen["plain"], e_plain)
        seen["size"] = max(seen["size"], plain[live].float().abs().max().item())
        return out

    steps_out = []
    with torch.no_grad():
        got_cache, got_first = prefill(embs)
        if against == "plain":
            other, want_first, side = plain_kernels, got_first, "the plain path"
            want_cache = dataclasses.replace(got_cache, **{
                f: [a.clone() for a in getattr(got_cache, f)]
                for f in ("k", "v", "latent", "k_scale", "v_scale")
                if getattr(got_cache, f) is not None})
            checked = mock.patch.object(mla_mod, "attn_headmajor",
                                        SimpleNamespace(paged_mla_decode=mla_checked))
        elif against == "ids":
            want_cache, want_first = prefill(None)
            other, side = contextlib.nullcontext, "the prompts as token ids"
            checked = contextlib.nullcontext()
            steps_out.append((got_first, want_first))
        else:
            raise ValueError(f"against={against!r}")
        tokens = want_first.argmax(-1).to(torch.int32)
        n = torch.tensor([len(p) for p in prompts], **i32)
        for k in range(steps):
            pos = n + k
            meta = DecodeMeta(positions=torch.cat([pos, idle]),
                              slot_mapping=torch.cat([slots(active, pos), idle - 1]),
                              page_tables=tables, context_lens=torch.cat([pos + 1, idle]))
            fed = torch.cat([tokens, idle])
            with other(), mock.patch.object(moe_mod, "select_experts", select_other):
                want, want_cache = L.forward_decode(ex.params, cfg, ex.rope, fed, meta, want_cache)
            with checked, mock.patch.object(moe_mod, "select_experts", select_kernels):
                got, got_cache = L.forward_decode(ex.params, cfg, ex.rope, fed, meta, got_cache)
            got, want = got[:B].float(), want[:B].float()
            steps_out.append((got, want))
            tokens = want.argmax(-1).to(torch.int32)
    diff = max((g - w).abs().max().item() for g, w in steps_out)
    worst_rel, worst_gap, same = 0.0, 0.0, 0
    for g, w in steps_out:
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{label}: non-finite teacher-forced logits")
        worst_rel = max(worst_rel, ((g - w).abs().amax(-1) / w.abs().amax(-1)).max().item())
        top2 = w.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        parted = g.argmax(-1) != w.argmax(-1)
        same += int((~parted).sum())
        if parted.any():
            worst_gap = max(worst_gap, gap[parted].max().item())
    notes = ""
    if seen["routed"]:
        notes += (f"; MoE routing parted on {seen['parted']}/{seen['routed']} token-layers, each a "
                  f"near tie (gap up to {seen['ratio']:.3f} x the router-logit difference)")
    if seen["calls"]:
        notes += (f"; row 2b in {seen['calls']} calls against its split-count twin / plain "
                  f"version: max abs err {seen['twin']:.3e} / {seen['plain']:.3e} (tolerance "
                  f"{ATTN_TOL}, outputs up to {seen['size']:.3f}), idle rows zero")
    print(f"serve: {label}: teacher-forced {steps} decode steps of {B} prompts in a batch of "
          f"{rows} (contexts {min(map(len, prompts)) + 1} to {max(map(len, prompts)) + steps}, "
          f"page tables of {maxp} pages) against {side}: logits max rel err {worst_rel:.3e} "
          f"(tolerance {tol}), largest |diff| {diff:.3e}; greedy picks equal on "
          f"{same}/{B * len(steps_out)}, largest top-2 gap where they part {worst_gap:.3e} "
          f"(allowed: up to twice the largest |diff|){notes}", flush=True)
    if worst_rel > tol or worst_gap > 2 * diff:
        raise AssertionError(f"{label}: teacher-forced logits differ: {worst_rel}, gap {worst_gap}")


# the serve phase's DeepSeek-V2-Lite GPTQ-Int4 paths (served, window, fused)
# at a cut depth, full width: 8 of its 27 layers (the dense first layer and
# seven MoE layers), which leave the default run's time to the tp phase's
# pipelined Qwen2.5-14B at all 48 (the 27-layer paths took 205-228 s, load
# and conversion 58.8 s of it); the tp phase serves DeepSeek-V2-Lite at all
# 27 layers in bf16
SERVE_DEEPSEEK_LAYERS = 8


def deepseek_engine_config():
    """bench.py:433-436's DeepSeek serving stage: batch 8, max_model_len 3072
    (2816-token prompts), 512-token chunks; the latent pool holds 8 x 3072 tokens."""
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig

    return EngineConfig(
        max_model_len=3072,
        cache=CacheConfig(page_size=16),
        scheduler=SchedulerConfig(max_batch=8, chunk_size=512),
    )


def map_hf_params_by_layer(tensors, cfg, quant_method: str, shard=None, layers=None):
    """The port's map_hf_params on one layer's HF tensors at a time, on the
    GPU, so that neither the host nor the GPU holds a checkpoint twice
    (``shard``: a TP rank's, ``layers``: a pipeline stage's, as map_hf_params
    takes them). Returns the parameter tree and the number of tensors."""
    from zhilight_tpu_torch.utils.hf_loader import map_hf_params

    params, n_tensors = {}, 0

    def convert(group):
        nonlocal n_tensors
        n_tensors += len(group)
        tree = map_hf_params(group, cfg, quant_method=quant_method, device="cuda", shard=shard,
                             layers=layers)
        params.setdefault("layers", {}).update(tree.pop("layers", {}))
        params.update(tree)

    group, layer = [], None
    for name, value in tensors:
        key = name.split(".")[2] if name.startswith("model.layers.") else name
        if group and key != layer:
            convert(group)
            group = []
        layer = key
        group.append((name, value))
    convert(group)
    torch.cuda.synchronize()
    return params, n_tensors


def load_deepseek(label: str, hf: dict, seed: int, quant_experts: bool = True):
    """DeepSeek-V2-Lite from HF-format tensors made from ``seed``, converted by
    the port's map_hf_params one layer at a time (neither the host nor the GPU
    holds the checkpoint twice), into ``LLM``."""
    from zhilight_tpu_torch.config import QuantConfig, adapt_hf_config
    from zhilight_tpu_torch.llm import LLM

    cfg, qcfg = adapt_hf_config(hf), QuantConfig.from_hf_config(hf)
    keep = {}
    t0 = time.monotonic()
    params, n_tensors = map_hf_params_by_layer(
        deepseek_hf_tensors(hf, seed, keep, quant_experts), cfg, "gptq")
    load_s = time.monotonic() - t0
    llm = LLM(model_config=cfg, quant_config=qcfg, params=params,
              engine_config=deepseek_engine_config(), device="cuda")
    mlp = llm.executor.params["layers"][str(cfg.num_layers - 1)]["mlp"]
    router, down = mlp["router"]["w"], mlp["experts"]["down_proj"]
    kinds = ({k: (str(v.dtype), tuple(v.shape)) for k, v in down.items()})
    print(f"serve: {label}: {n_tensors} HF tensors made from seed {seed} in {keep['make_s']:.1f} s; "
          f"map_hf_params(gptq) layer by layer in {load_s - keep['make_s']:.1f} s (load and "
          f"conversion {load_s:.1f} s in all); router {router.dtype} {tuple(router.shape)}, "
          f"expert down_proj stack {kinds}", flush=True)
    if router.dtype != torch.float32:
        raise AssertionError(f"{label}: the router is {router.dtype}, not float32")
    # K = moe_intermediate_size padded to whole pairs of groups (1408 -> 1536)
    gs2 = 2 * hf["quantization_config"]["group_size"]
    k_pad = -(-hf["moe_intermediate_size"] // gs2) * gs2
    want = (hf["n_routed_experts"], k_pad // 2, hf["hidden_size"])
    if quant_experts and (down["w_p"].dtype != torch.uint8 or down["w_p"].shape != want
                          or down["scales"].shape[1] != 2 * k_pad // gs2):
        raise AssertionError(f"{label}: expert down_proj stack is not uint8 {want}: {kinds}")
    return llm


def dense_expert_path(args) -> None:
    """DeepSeek-V2-Lite's configuration with bf16 expert stacks at 4 layers: the
    dense grouped-expert path (the library's grouped GEMM with the group ends on
    the device) beside the MLA kernels, logits against the plain path; and that
    grouped product against one fp32 product per expert."""
    from zhilight_tpu_torch.models import moe as moe_mod

    label = "DeepSeek-V2-Lite-bf16-experts-4-layers"
    llm = load_deepseek(label, dict(DEEPSEEK_V2_LITE_GPTQ, num_hidden_layers=4), args.seed,
                        quant_experts=False)
    ex = llm.executor
    experts = ex.params["layers"]["3"]["mlp"]["experts"]
    if "w" not in experts["gate_proj"] or experts["gate_proj"]["w"].shape != (64, 2048, 1408):
        raise AssertionError(f"{label}: the expert stacks are not dense")
    rng = np.random.default_rng(args.seed)
    sizes = torch.from_numpy(rng.multinomial(48, np.ones(64) / 64)).cuda()
    x = _randn(rng, 48, 2048)
    got = moe_mod._grouped_mm(x, experts["gate_proj"]["w"], sizes).float()
    want = moe_mod._grouped_mm(x.float(), experts["gate_proj"]["w"].float(), sizes)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"serve: {label}: grouped product (48 rows over 64 experts) vs one fp32 product per "
          f"expert: max rel err {rel:.3e} (tolerance {W4A16_TOL})", flush=True)
    if not rel <= W4A16_TOL:
        raise AssertionError(f"{label}: grouped product differs: {rel}")

    prompts = [rng.integers(3, ex.cfg.vocab_size, n).tolist() for n in (100, 700, 16, 1500)]
    got = _prefill_logits(ex, prompts[0])
    with plain_kernels():
        want = _prefill_logits(ex, prompts[0])
    rel = ((got - want).abs().max() / want.abs().max()).item()
    d_got, d_want = _decode_step_logits(ex, prompts)
    scale = d_want.abs().amax(-1)
    d_rel = ((d_got - d_want).abs().amax(-1) / scale).max().item()
    pick = d_got.argmax(-1)
    slack = ((d_want.amax(-1) - d_want.gather(-1, pick[:, None])[:, 0]) / scale).max().item()
    print(f"serve: {label}: logits kernel vs plain path: first token max rel err {rel:.3e}, "
          f"argmax {int(got.argmax())} vs {int(want.argmax())}; decode step (batch 4) max rel err "
          f"{d_rel:.3e}, worst pick {slack:.3e} below the plain maximum (tolerance {LOGIT_TOL})",
          flush=True)
    if not (torch.isfinite(got).all() and torch.isfinite(d_got).all()):
        raise AssertionError(f"{label}: non-finite logits")
    if rel > LOGIT_TOL or int(got.argmax()) != int(want.argmax()) or d_rel > LOGIT_TOL or slack > LOGIT_TOL:
        raise AssertionError(f"{label}: logits differ from the plain path")
    release_pool(llm)


MM_LABEL = "DeepSeek-VL2-small-multimodal"
MM_TEXT_LEN = 1500           # (a): a text prompt, then the same prompt as its embedding rows
MM_IMAGE_SPAN = (64, 400, 36)  # (b), (c): text ids, image rows, text ids
MM_PLACEHOLDER = 100015      # the image span's token id (any id below the vocabulary)
MM_MAXLEN = 16
MM_MAX_BATCH = 8             # the engine decodes all its rows each step, idle ones at context 0


def _table_rows(shim, ids) -> np.ndarray:
    """Embedding rows [n, d] of token ids through the language shim, as the
    vision model takes its text rows (float32 on the host)."""
    return shim(torch.tensor(ids, dtype=torch.long)).numpy()


def _image_prompt(shim, ids, seed: int, scale: float) -> np.ndarray:
    """The prompt's rows: text rows from the shim and, over the placeholder
    span, random "image" rows at the table's scale drawn on the card from
    ``seed``."""
    rows = _table_rows(shim, ids)
    a, n, _ = MM_IMAGE_SPAN
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.randn((n, rows.shape[1]), generator=gen, device="cuda") * scale
    rows[a : a + n] = img.cpu().numpy()
    return rows


def phase_multimodal(rec: dict, args, smi: str) -> None:
    """DeepSeek-VL2-small's language model (VL2_SMALL through adapt_hf_config:
    27 layers, MLA over a latent pool, 64 + 2 experts of 1408, top 6; bf16 with
    bf16 expert stacks, random weights from the seed drawn on the card) fed
    embedding rows, through LLM + DynamicBatchGenerator with prefix caching
    on. With the launch counters zeroed just before and read just after:
    (a) a 1500-token text prompt and the same prompt as its embedding rows,
    same greedy tokens where they do not part, and teacher-forced the same
    logits by the repo's rule (teacher_forced); (b) a text request
    over the placeholder ids, then two image requests over the same ids with
    different image rows at once: neither hits nor adds to the prefix cache,
    and their first-token logits differ; (c) the first image prompt with
    position ids 0..n-1, the tokens of (b) without them. (d) The VL2 wrapper's
    language shim over a stand-in module: the card table's rows, the stand-in
    stripped of its language weights. Then an image prompt's first-token
    logits against the plain path; one and two requests (image rows, text
    rows) decoded teacher-forced through the kernels and the plain path in the
    engine's batch of 8 rows over its page tables, so row 2b at the main
    path's shapes and split plan; the image prompt's TTFT and batch-1 decode
    tok/s; then the weights are freed."""
    import gc

    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig, adapt_hf_config
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg, SearchTask
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.models.multimodal import DeepseekVL2
    from zhilight_tpu_torch.ops.cuda.attn_headmajor import mla_plan

    label = MM_LABEL
    cfg = adapt_hf_config(VL2_SMALL)
    if not (cfg.model_type == "deepseek_v2" and cfg.num_layers == 27 and cfg.dim_model == 2048
            and cfg.mla.kv_lora_rank == 512 and cfg.moe.num_experts == 64 and cfg.moe.top_k == 6
            and cfg.dtype == "bfloat16"):
        raise AssertionError(f"{label}: the nested language_config was not what got parsed: {cfg}")
    t0 = time.monotonic()
    params = L.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    make_s = time.monotonic() - t0
    stack = params["layers"]["1"]["mlp"]["experts"]["gate_proj"]["w"]
    if stack.dtype != torch.bfloat16 or tuple(stack.shape) != (64, 2048, 1408):
        raise AssertionError(f"{label}: expert stacks are not bf16 (64, 2048, 1408)")
    llm = LLM(model_config=cfg, params=params, device="cuda", engine_config=EngineConfig(
        max_model_len=3072, cache=CacheConfig(page_size=16, num_pages=2048,
                                              enable_prefix_caching=True),
        scheduler=SchedulerConfig(max_batch=MM_MAX_BATCH, chunk_size=512)))
    del params, stack
    ex = llm.executor
    try:
        warm_s = ex.warmup()
        n_params = sum(t.numel() for t in _leaves(ex.params))
        weights = sum(t.numel() * t.element_size() for t in _leaves(ex.params))
        print(f"serve: {label}: {cfg.num_layers} layers, {n_params / 1e9:.2f} B parameters, "
              f"{weights / 2**30:.2f} GiB of bf16 weights made on the card from seed {args.seed} "
              f"in {make_s:.1f} s; latent pool of {ex.num_pages} pages x {ex.page_size}, prefix "
              f"caching on; warmup {warm_s:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
              f"allocated", flush=True)

        # (d) the wrapper's language shim over a stand-in whose language holds a
        # large embedding: rows of the card's table, the stand-in's weights gone
        V, D = cfg.vocab_size, cfg.dim_model

        class StandIn(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.vision = torch.nn.Linear(64, 64)
                self.language = torch.nn.Embedding(
                    V, D, _weight=torch.empty(V, D, dtype=torch.bfloat16))

        stand_in = StandIn()
        before = sum(p.numel() for p in stand_in.parameters())
        DeepseekVL2(llm, model_path="")._strip_language(stand_in)
        after = sum(p.numel() for p in stand_in.parameters())
        shim = stand_in.language.get_input_embeddings()
        table = ex.params["embedding"]["w"]
        rng = np.random.default_rng(args.seed + 19)
        probe = torch.from_numpy(rng.integers(0, V, 256))
        host, dev = shim(probe), shim(probe.cuda())
        want = table[probe.cuda()].float()
        if not (after < before // 10 and host.dtype == torch.float32 and host.device.type == "cpu"
                and torch.equal(host, want.cpu()) and dev.is_cuda and torch.equal(dev, want)):
            raise AssertionError(f"{label}: (d) the shim's rows are not the card table's, or the "
                                 f"stand-in kept its weights ({before} -> {after} parameters)")
        print(f"serve: {label}: (d) language shim: 256 ids, rows equal to the card table's "
              f"(float32, on the ids' device); stand-in parameters {before} -> {after}", flush=True)

        scale = table[:4096].float().std().item()
        a, n_img, b = MM_IMAGE_SPAN
        ids = (rng.integers(3, V, a).tolist() + [MM_PLACEHOLDER] * n_img
               + rng.integers(3, V, b).tolist())
        images = [_image_prompt(shim, ids, args.seed + 100 + k, scale) for k in range(2)]
        text = rng.integers(3, V, MM_TEXT_LEN).tolist()
        text_rows = _table_rows(shim, text)
        arange = np.arange(len(ids), dtype=np.int32)

        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        gen = DynamicBatchGenerator(llm).start()
        try:
            t0 = time.monotonic()
            arg = GeneratorArg(max_length=MM_MAXLEN)
            a_text = gen.generate(text, arg, timeout=600).outputs[0].token_ids
            a_emb = gen.generate(text, arg, input_embeddings=text_rows,
                                 timeout=600).outputs[0].token_ids
            gen.generate(ids, GeneratorArg(max_length=2), timeout=600)  # registers its prefix
            cached0 = gen.scheduler.allocator.num_cached
            tasks = [SearchTask(list(ids), arg, input_embeddings=e) for e in images]
            for task in tasks:
                gen.scheduler.submit(task)
            outs = [gen._wait_final(task, 600)[1] for task in tasks]
            for out in outs:
                if isinstance(out, BaseException):
                    raise out
            cached1 = gen.scheduler.allocator.num_cached
            c_pos = gen.generate(ids, arg, input_embeddings=images[0], position_ids=arange,
                                 timeout=600).outputs[0].token_ids
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {name: fn.launches for name, fn in counters.items()}

            # an image prompt's TTFT (a lone request of max_length 1, median of
            # 3 after one more) and batch-1 decode rate over 128 new tokens
            ttft = []
            for _ in range(4):
                t1 = time.monotonic()
                gen.generate(ids, GeneratorArg(max_length=1), input_embeddings=images[1],
                             position_ids=arange, timeout=600)
                ttft.append(time.monotonic() - t1)
            ttft_s = statistics.median(ttft[1:])
            t1 = time.monotonic()
            long = gen.generate(ids, GeneratorArg(max_length=129, ignore_eos=True),
                                input_embeddings=images[1], position_ids=arange, timeout=600)
            long_s = time.monotonic() - t1
        finally:
            gen.stop()

        for name, count in launches.items():
            rec[name]["launches"] += count
            rec[name]["launches_by_path"][label] = count
        print(f"serve: {label}: requests (a)-(c) in {wall:.2f} s; launches {launches}", flush=True)
        print(f"serve: {label}: launches of row 7 (rope_write_rows_2d) "
              f"{launches['rope_write_rows_2d']}, row 2b (paged_mla_decode) "
              f"{launches['paged_mla_decode']}", flush=True)
        expect = PATHS[label]
        if any(launches[name] == 0 for name in expect):
            raise AssertionError(f"{label}: a kernel of the path never launched: {launches}")
        if any(count for name, count in launches.items() if name not in expect):
            raise AssertionError(f"{label}: a kernel of another path launched: {launches}")

        # (a) the text prompt and its own rows: the same greedy tokens, or
        # where they part, teacher-forced the same logits by the repo's rule
        pages = ex.max_pages_per_seq
        print(f"serve: {label}: (a) {MM_TEXT_LEN}-token prompt as token ids and as its "
              f"embedding rows: greedy tokens {'identical' if a_text == a_emb else 'parted'} "
              f"({a_text[:6]} ... / {a_emb[:6]} ...)", flush=True)
        teacher_forced(f"{label} (a)", ex, [text], MM_MAXLEN, embs=[text_rows], against="ids",
                       pages_per_seq=pages, batch=MM_MAX_BATCH)

        # (b) same placeholder ids, different images: no prefix hit, nothing
        # cached, different first-token logits
        firsts = [_prefill_logits(ex, ids, emb=e) for e in images]
        apart = (firsts[0] - firsts[1]).abs().max().item()
        hits = [task.prefix_hit_len for task in tasks]
        print(f"serve: {label}: (b) two image prompts of {len(ids)} tokens ({n_img} image rows) "
              f"over the same ids: prefix hits {hits}, cached prefixes {cached0} -> {cached1}, "
              f"first-token logits apart by up to {apart:.3e}; tokens {outs[0].token_ids[:4]} / "
              f"{outs[1].token_ids[:4]}", flush=True)
        if hits != [0, 0] or cached0 == 0 or cached1 != cached0 or not apart > 0:
            raise AssertionError(f"{label}: (b) image prompts shared the token-keyed prefix cache")

        # (c) position ids 0..n-1 change nothing
        print(f"serve: {label}: (c) position ids 0..{len(ids) - 1} against none: tokens "
              f"{'identical' if c_pos == outs[0].token_ids else 'differ'}", flush=True)
        if c_pos != outs[0].token_ids:
            raise AssertionError(f"{label}: (c) {c_pos} != {outs[0].token_ids}")

        # an image prompt's first-token logits: main path against the plain path
        with plain_kernels():
            plain = _prefill_logits(ex, ids, emb=images[0])
        got = firsts[0]
        if not (torch.isfinite(got).all() and torch.isfinite(plain).all()):
            raise AssertionError(f"{label}: non-finite first-token logits")
        rel = ((got - plain).abs().max() / plain.abs().max()).item()
        print(f"serve: {label}: image prompt first-token logits kernel vs plain: max rel err "
              f"{rel:.3e} (tolerance {LOGIT_TOL}); argmax {int(got.argmax())} vs "
              f"{int(plain.argmax())}", flush=True)
        if rel > LOGIT_TOL or int(got.argmax()) != int(plain.argmax()):
            raise AssertionError(f"{label}: first-token logits differ from the plain path")
        # row 2b at the engine's decode shapes against the plain path: one and
        # two requests in the engine's batch of MM_MAX_BATCH rows (the rest
        # idle at context 0) over its page tables, so with its split plan;
        # each call held to its twin and plain version, the logits to
        # LOGIT_TOL, as MLA + MoE decode logits are held against the plain
        # path (dense_expert_path): through 27 such layers they stay 2-3% of
        # the largest apart with the same routing (PERF.md, section 7)
        plan = mla_plan(torch.device("cuda", 0), MM_MAX_BATCH, cfg.num_heads, pages * ex.page_size)
        print(f"serve: {label}: latent decode split plan of the engine's batch of "
              f"{MM_MAX_BATCH}, {cfg.num_heads} heads, {pages} pages: {plan}", flush=True)
        teacher_forced(label, ex, [ids], 8, embs=[images[0]], pages_per_seq=pages,
                       batch=MM_MAX_BATCH, tol=LOGIT_TOL)
        teacher_forced(label, ex, [ids, text], 8, embs=[images[1], text_rows],
                       pages_per_seq=pages, batch=MM_MAX_BATCH, tol=LOGIT_TOL)

        new = len(long.outputs[0].token_ids)
        decode = (new - 1) / (long_s - ttft_s)
        print(f"timing: {label}: image prompt of {len(ids)} tokens ({n_img} image rows): TTFT "
              f"{ttft_s * 1e3:.2f} ms (median of 3: {', '.join(f'{t * 1e3:.2f}' for t in ttft[1:])})"
              f", batch-1 decode {decode:.2f} tok/s over {new - 1} tokens ({long_s:.2f} s for "
              f"{new}); {smi}", flush=True)
    finally:
        release_pool(llm)
        ex.params = None
        gc.collect()
        torch.cuda.empty_cache()
        print(f"serve: {label}: weights freed, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
              f"allocated", flush=True)


# ---------------------------------------------------------------------------
# tensor parallelism: Qwen2.5-14B in bf16 at TP=2
# ---------------------------------------------------------------------------

# Qwen/Qwen2.5-14B-Instruct's config.json fields: QWEN14B_GPTQ's without its
# quantization_config, bf16 as it ships (48 layers, d 5120, 40 / 8 heads of
# 128, dim_ff 13824, vocab 152064, q/k/v biases)
QWEN14B_BF16 = {k: v for k, v in QWEN14B_GPTQ.items() if k != "quantization_config"}
# deepseek-ai/DeepSeek-V2-Lite's config.json as it ships, bf16 (27 layers, d 2048,
# 16 heads, kv_lora_rank 512, 64 + 2 experts of 1408, top 6, a dense first
# layer of 10944, vocab 102400): DEEPSEEK_V2_LITE_GPTQ without quantization_config
DEEPSEEK_V2_LITE_BF16 = {k: v for k, v in DEEPSEEK_V2_LITE_GPTQ.items()
                         if k != "quantization_config"}
# the tp phase's Qwen path at a cut depth (its width as it ships): 4 of 48
# layers leave room in the run's time for the DeepSeek path at full depth (a
# gloo collective costs 1-3 ms on one host, 25 a step at 12 layers)
TP_QWEN_LAYERS = 4
# the GPTQ-Int4 path's depth in a default run (``--tp-gptq-layers`` sets it;
# its width as it ships): 2 of 48 leave the run's time to the DeepSeek path at
# full depth
TP_GPTQ_LAYERS = 2
# the quantized 2-layer checks: teacher-forced only, at full width
TP_CHECK_LAYERS = 2
# paths whose teacher-forced logits are held to TP=1's own spread (one prompt
# at a time against the batch) where that exceeds LOGIT_TOL: W8A8 quantizes
# each token's activations to int8 codes that a bf16 ulp of difference flips,
# and two TP=1 computations of its 2-layer model part by 6.007e-02 of the
# largest logit (the first card run of the path)
TP_SPREAD_BOUND = ("Qwen2.5-14B-AUTO_INT8-2-layers",)


def _qwen14b(c, layers):
    return (c.num_layers == layers and c.dim_model == 5120 and c.num_heads == 40
            and c.num_kv_heads == 8 and c.dim_head == 128 and c.dim_ff == 13824
            and c.vocab_size == 152064 and c.attn_bias and c.dtype == "bfloat16")


TP_PATHS = {
    # label -> (config.json fields, the geometry they must give, its kernels,
    # the teacher-forced tolerance: what the card holds the model's logits to,
    # how its weights are made (tp_weights), whether it serves the requests
    # (tp_drive) or only runs the teacher-forced logits, the (tp, pp) of its
    # multi-rank run)
    "Qwen2.5-14B-bf16": (
        dict(QWEN14B_BF16, num_hidden_layers=TP_QWEN_LAYERS),
        lambda c: _qwen14b(c, TP_QWEN_LAYERS), ATTENTION_KERNELS, 2e-2, "seed", True, (2, 1)),
    # GPTQ tensors from the seed through the port's loader, each rank keeping its
    # shard: the int4 linears sharded on N (q/k/v, gate/up) and K (o, down)
    # with their group scales; rows 1-4 at a rank's shapes, row 4's fp32 mode
    "Qwen2.5-14B-GPTQ-Int4": (
        dict(QWEN14B_GPTQ, num_hidden_layers=TP_GPTQ_LAYERS),
        lambda c: _qwen14b(c, c.num_layers), ATTENTION_KERNELS + ("w4a16_matmul",), 2e-2,
        "gptq", True, (2, 1)),
    # FP8 block-scaled tensors kept in FP8 (ZT_FP8_KEEP=1): row 9 at a rank's
    # shapes, its fp32 mode in o and down
    "Qwen3-8B-FP8-2-layers": (
        dict(QWEN3_8B_FP8, num_hidden_layers=TP_CHECK_LAYERS),
        lambda c: (c.num_layers == TP_CHECK_LAYERS and c.dim_model == 4096 and c.num_heads == 32
                   and c.num_kv_heads == 8 and c.dim_head == 128 and c.dim_ff == 12288
                   and c.qk_norm and c.vocab_size == 151936),
        ATTENTION_KERNELS + ("fp8_block_matmul",), 2e-2, "fp8", False, (2, 1)),
    # the bf16 weights quantized to W8A8 at load on each rank (AUTO_INT8): the
    # row-parallel shards' column absmax MAX-reduced, their activations'
    # per-token absmax MAX-reduced and int32 products summed
    "Qwen2.5-14B-AUTO_INT8-2-layers": (
        dict(QWEN14B_BF16, num_hidden_layers=TP_CHECK_LAYERS),
        lambda c: _qwen14b(c, TP_CHECK_LAYERS), ATTENTION_KERNELS, 2e-2, "int8", False, (2, 1)),
    # MLA over a replicated latent pool, bf16 experts through the library's
    # grouped GEMM, sharded over the ranks
    "DeepSeek-V2-Lite-bf16": (
        DEEPSEEK_V2_LITE_BF16,
        lambda c: (c.num_layers == 27 and c.dim_model == 2048 and c.num_heads == 16
                   and c.mla.kv_lora_rank == 512 and c.mla.latent_dim == 576
                   and c.moe.num_experts == 64 and c.moe.top_k == 6
                   and c.moe.intermediate_size == 1408
                   and c.moe.shared_expert_intermediate_size == 2816
                   and c.moe.first_k_dense_replace == 1 and c.dim_ff == 10944
                   and c.vocab_size == 102400 and c.dtype == "bfloat16"),
        ("rope_write_rows_2d", "paged_mla_decode"), LOGIT_TOL, "seed", True, (2, 1)),
    # pipeline parallelism: Qwen2.5-14B in bf16 at full width and all 48
    # layers, 24 a stage, each rank drawing the full stream from the seed and
    # keeping its stage (init_params(stage=...))
    "Qwen2.5-14B-bf16-pp": (
        QWEN14B_BF16, lambda c: _qwen14b(c, 48), ATTENTION_KERNELS, 2e-2, "seed", True, (1, 2)),
    # the GPTQ-Int4 path at PP=2 (``--tp-gptq-layers``), each rank converting
    # only its stage's layers (map_hf_params(layers=...))
    "Qwen2.5-14B-GPTQ-Int4-pp": (
        dict(QWEN14B_GPTQ, num_hidden_layers=TP_GPTQ_LAYERS),
        lambda c: _qwen14b(c, c.num_layers), ATTENTION_KERNELS + ("w4a16_matmul",), 2e-2,
        "gptq", True, (1, 2)),
    # TP=2 x PP=2, four rank processes: the pp4 phase's only path (not in the
    # default order), at the tp path's cut depth
    "Qwen2.5-14B-bf16-tp-pp": (
        dict(QWEN14B_BF16, num_hidden_layers=TP_QWEN_LAYERS),
        lambda c: _qwen14b(c, TP_QWEN_LAYERS), ATTENTION_KERNELS, 2e-2, "seed", True, (2, 2)),
}
# the paths scored through the serving loop (LLM.calc_*), and the kernels one
# scoring call launches, once a layer: rows 1 and 3 over a packed pool, row 7
# over a latent one (MLA's prefill attention is plain torch)
TP_SCORED = {"Qwen2.5-14B-bf16": ("rope_write_rows_hm", "paged_prefill_attention_hm_packed"),
             "Qwen2.5-14B-bf16-pp": ("rope_write_rows_hm", "paged_prefill_attention_hm_packed"),
             "DeepSeek-V2-Lite-bf16": ("rope_write_rows_2d",)}
# SmoothQuant on the AUTO_INT8 path: calibration prompts (count, tokens) and alpha
TP_CALIB = (4, 512)
TP_ALPHA = 0.5
TP_LENS = (500, 1500)      # the greedy prompts, 32 new tokens each
TP_NEW = 32
TP_SAMPLED = 200           # a seeded sampled request's prompt
TP_CANCEL = 300            # a request cancelled mid-decode
TP_PAGES = 512             # given: both ranks would size the pool from the same free memory
TP_TIMEOUT = 300           # seconds: a path's limit in the rank processes, their default group's timeout


def tp_shape(label: str):
    """The (tp, pp) of a tp path's multi-rank run."""
    return TP_PATHS[label][6]


def run_names(label: str):
    """The names a tp path's runs take in the launch record: the one-process
    run's, and each rank's of the multi-rank run (``-TP1``, ``-TP2-rank0``
    for a tensor-parallel path; ``-PP1``, ``-PP2-rank0`` or
    ``-TP2xPP2-rank0`` where it is pipelined)."""
    tp, pp = tp_shape(label)
    if pp == 1:
        return f"{label}-TP1", [f"{label}-TP{tp}-rank{r}" for r in range(tp)]
    shape = f"TP{tp}xPP{pp}" if tp > 1 else f"PP{pp}"
    return f"{label}-PP1", [f"{label}-{shape}-rank{r}" for r in range(tp * pp)]


for _label, (_, _, _kernels, *_) in TP_PATHS.items():
    _one, _ranks = run_names(_label)
    for _name in [_one] + _ranks:
        PATHS[_name] = _kernels


def tp_engine_config(tp: int, pp: int = 1):
    """Batch 4, max_model_len 2048, 512-token chunks, a pool of TP_PAGES
    pages of 16 tokens; ``tp`` x ``pp`` ranks."""
    from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, ParallelConfig,
                                           SchedulerConfig)

    return EngineConfig(max_model_len=2048, cache=CacheConfig(page_size=16, num_pages=TP_PAGES),
                        scheduler=SchedulerConfig(max_batch=4, chunk_size=512),
                        parallel=ParallelConfig(tp=tp, pp=pp))


def tp_hf(label: str, args) -> dict:
    """The path's config.json fields (the GPTQ path at ``--tp-gptq-layers``)."""
    hf = TP_PATHS[label][0]
    if TP_PATHS[label][4] == "gptq":
        hf = dict(hf, num_hidden_layers=args.tp_gptq_layers)
    return hf


def tp_config(label: str, args):
    """The path's ModelConfig, its geometry checked."""
    from zhilight_tpu_torch.config import adapt_hf_config

    cfg = adapt_hf_config(tp_hf(label, args))
    if not TP_PATHS[label][1](cfg):
        raise AssertionError(f"tp: {label}: the configuration is not the path's: {cfg}")
    return cfg


def tp_weights(label: str, args, cfg, device, shard=None, stage=None):
    """The path's weights, drawn from ``--seed`` on ``device``, whole or rank
    ``shard = (rank, tp)``'s, of pipeline stage ``stage = (s, pp)`` (its
    layers only: ``init_params(stage=)``, ``map_hf_params(layers=)``): by
    ``init_params`` ("seed"; "int8": then
    quantized to W8A8 as ``LLM`` does an AUTO_INT8 checkpoint, a rank's
    row-parallel scales MAX-reduced over the group), or as HF tensors through
    the port's loader, one layer at a time, each rank converting a whole
    linear and keeping its entry ("gptq": ``qwen_hf_tensors``, its dense
    tensors drawn on ``device``; "fp8":
    ``qwen3_fp8_hf_tensors``, kept in FP8)."""
    from zhilight_tpu_torch.models import llama as L

    kind = TP_PATHS[label][4]
    if kind in ("seed", "int8"):
        params = L.init_params(cfg, seed=args.seed, device=device, shard=shard, stage=stage)
        if kind == "int8":
            from zhilight_tpu_torch.parallel.comm import TPGroup
            from zhilight_tpu_torch.utils.quant_convert import quantize_int8_params

            params = quantize_int8_params(params, tp=TPGroup() if shard else None)
        return params
    hf = tp_hf(label, args)
    if kind == "gptq":
        from zhilight_tpu_torch.parallel.sharding import stage_range

        # the dense tensors (a 152064-row embedding and head) drawn on the card
        layers = None if stage is None else stage_range(cfg, *stage)
        return map_hf_params_by_layer(qwen_hf_tensors(hf, args.seed, {}, device=device), cfg,
                                      "gptq", shard, layers)[0]
    with env_switch("ZT_FP8_KEEP", True):
        return map_hf_params_by_layer(qwen3_fp8_hf_tensors(hf, args.seed), cfg, "fp8", shard)[0]


def tp_kept_whole(ex, tp: int) -> int:
    """The row-parallel linears a rank keeps whole (``shard_linear``: they
    hold tp times the rank's input rows), whose input it all-gathers."""
    from zhilight_tpu_torch.ops.linear import in_rows

    cfg, n = ex.cfg, 0
    for layer in ex.params["layers"].values():
        for group, name, rows in (("attn", "o_proj", cfg.num_heads * cfg.dim_head),
                                  ("mlp", "down_proj", cfg.dim_ff)):
            p = layer[group].get(name)
            if p is not None and not cfg.mla.enabled and in_rows(p) >= tp * rows:
                n += 1
    return n


def tp_count_collectives(group) -> dict:
    """Count, from now on, each collective ``group`` makes, by kind (an
    all-reduce by its dtype, or MAX)."""
    counts = {}
    for op in ("all_reduce", "all_gather"):
        real = getattr(group, op)

        def counted(x, *a, _real=real, _op=op, **kw):
            kind = "max" if "MAX" in str(kw.get("op")) else str(x.dtype).replace("torch.", "")
            counts[f"{_op} {kind}"] = counts.get(f"{_op} {kind}", 0) + 1
            return _real(x, *a, **kw)

        setattr(group, op, counted)
    return counts


def tp_expected_collectives(label: str, cfg, kept_whole: int):
    """A dense path's collectives a forward at TP=2: the embedding's
    all-reduce (model dtype), each row-parallel linear's (an fp32 all-reduce;
    W8A8: the per-token absmax's MAX and the int32 sum; one kept whole: an
    all-gather of its input), the logits' fp32 all-gather. None for an MLA or
    MoE path (tp_collective_count gives a decode step's)."""
    if cfg.moe.enabled or cfg.mla.enabled:
        return None
    reduced = 2 * cfg.num_layers - kept_whole
    want = {"all_reduce bfloat16": 1, "all_gather float32": 1, "all_gather bfloat16": kept_whole}
    if TP_PATHS[label][4] == "int8":
        want.update({"all_reduce max": reduced, "all_reduce int32": reduced})
    else:
        want["all_reduce float32"] = reduced
    return {k: v for k, v in want.items() if v}


def tp_forwards(prompts, tokens) -> int:
    """The forwards tp_forced runs: each prompt's 512-token chunks, then the
    batched decode steps."""
    return sum(-(-len(p) // 512) for p in prompts) + len(tokens[0]) - 1


def tp_prompts(seed: int, vocab: int) -> dict:
    rng = np.random.default_rng(seed + 20)
    return dict(greedy=[rng.integers(3, vocab, n).tolist() for n in TP_LENS],
                sampled=rng.integers(3, vocab, TP_SAMPLED).tolist(),
                cancel=rng.integers(3, vocab, TP_CANCEL).tolist())


def tp_collective_count(cfg) -> int:
    """All-reduces a decode step makes at tp > 1: the embedding's, each
    layer's ``o_proj``, a dense layer's ``down_proj``, a MoE layer's routed
    sum and its shared expert's ``down_proj``."""
    moe = [cfg.is_moe_layer(i) for i in range(cfg.num_layers)]
    shared = 1 if cfg.moe.shared_expert_intermediate_size else 0
    return 1 + cfg.num_layers + sum(1 + shared if m else 1 for m in moe)


def tp_drive(llm, prompts: dict, score: bool = False) -> dict:
    """The phase's requests, in this order, through DynamicBatchGenerator
    (rank 0's, or the TP=1 run's): the 1500-token prompt for one token three
    times (TTFT, the median) and for 32 (batch-1 decode tok/s, as the
    multimodal phase times it), the two greedy prompts together, a seeded
    sampled request, and a request cancelled after its second streamed
    result. With ``score`` the scoring utilities run on the 1500-token
    prompt through the loop: ``calc_hidden_states`` while the greedy batch
    decodes, then ``calc_logits`` (timed), ``calc_log_prob`` and
    ``calc_greedy_match``; their results under "scores" (host arrays).
    Returns the tokens and the times."""
    import threading

    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg, SearchTask
    from zhilight_tpu_torch.engine.task import StreamResultType, TaskStatus

    out, t_start = {}, time.monotonic()
    gen = DynamicBatchGenerator(llm).start()
    try:
        long = prompts["greedy"][1]
        ttft = []
        for _ in range(3):
            t0 = time.monotonic()
            gen.generate(long, GeneratorArg(max_length=1), timeout=TP_TIMEOUT)
            ttft.append(time.monotonic() - t0)
        t0 = time.monotonic()
        out["long"] = gen.generate(long, GeneratorArg(max_length=TP_NEW, ignore_eos=True),
                                   timeout=TP_TIMEOUT).outputs[0].token_ids
        long_s = time.monotonic() - t0
        out["ttft_ms"] = statistics.median(ttft) * 1e3
        out["decode_tok_s"] = (len(out["long"]) - 1) / (long_s - statistics.median(ttft))
        batch = {}

        def greedy():
            try:
                batch["res"] = gen.batch_generate(
                    prompts["greedy"], GeneratorArg(max_length=TP_NEW, ignore_eos=True),
                    timeout=TP_TIMEOUT)
            except BaseException as e:  # noqa: BLE001 - raised below, on this thread
                batch["error"] = e

        if score:
            scores = {}
            th = threading.Thread(target=greedy)
            th.start()
            deadline = time.monotonic() + TP_TIMEOUT
            while not any(t is not None and t.status == TaskStatus.DECODE
                          for t in gen.scheduler.slots):
                if not th.is_alive() or time.monotonic() > deadline:
                    raise AssertionError("tp: the greedy batch never decoded while watched")
                time.sleep(0.0005)
            t0 = time.monotonic()
            scores["hidden"] = llm.calc_hidden_states(long)
            out["score_s"] = time.monotonic() - t0
            th.join()
        else:
            greedy()
        if "error" in batch:
            raise batch["error"]
        out["greedy"] = [r.outputs[0].token_ids for r in batch["res"]]
        if score:
            t0 = time.monotonic()
            scores["logits"] = llm.calc_logits(long)
            out["calc_logits_ms"] = (time.monotonic() - t0) * 1e3
            scores["log_prob"] = np.asarray(llm.calc_log_prob(long)[1], np.float32)
            out["greedy_match"] = llm.calc_greedy_match(long)
            out["score_s"] += time.monotonic() - t0
            out["scores"] = scores
        out["sampled"] = gen.generate(prompts["sampled"], GeneratorArg(
            max_length=TP_NEW, temperature=0.8, top_p=0.9, seed=7),
            timeout=TP_TIMEOUT).outputs[0].token_ids
        task = SearchTask(prompts["cancel"], GeneratorArg(max_length=4 * TP_NEW, ignore_eos=True),
                          stream=True)
        gen.scheduler.submit(task)
        seen, deadline = 0, time.monotonic() + TP_TIMEOUT
        while True:
            flag, payload = task.res_queue.get(timeout=max(deadline - time.monotonic(), 1))
            if flag == StreamResultType.Incremental:
                seen += 1
                if seen == 2:
                    task.cancel()
            elif flag == StreamResultType.Final:
                break
        out["cancelled"] = [int(t) for t in task.output_tokens]
    finally:
        gen.stop()
    out["drive_s"] = time.monotonic() - t_start
    if gen.scheduler.error is not None:
        raise AssertionError("the scheduler failed") from gen.scheduler.error
    return out


def tp_score_recorder(llm, counters, routes=None, share=None) -> list:
    """Record, from now on, each scoring call the executor runs
    (``run_score``; ``run_hidden`` goes through it), on whichever thread runs
    it: its kind, the slots decoding when it started, and the kernel
    launches between its start and end (exact where the call runs on the
    loop's thread, as every TP=2 one does; a TP=1 call on the caller's
    thread may count the loop's launches too). A MoE model's routing, as
    tp_forced shares it: ``routes`` gets a list of each call's routings;
    with ``share`` every call takes the recorded routing where its own
    parts at a near tie (the parted counts added up in ``share``). Returns
    the list."""
    from unittest import mock

    from zhilight_tpu_torch.engine.task import TaskStatus
    from zhilight_tpu_torch.models import moe as M

    ex, seen, run = llm.executor, [], llm.executor.run_score
    if share is not None:
        share.update(routed=0, parted=0, ratio=0.0)
    # the host seconds a call spends in the group's collectives (and a
    # pipeline column's moves)
    in_collectives = [0.0]
    timed_ops = [(ex.tp, op) for op in ("all_reduce", "all_gather") if ex.tp is not None]
    timed_ops += [(ex.pp, op) for op in ("send", "recv", "from_last") if ex.pp is not None]
    for group, op in timed_ops:
        def timed(*a, _real=getattr(group, op), **kw):
            t0 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                in_collectives[0] += time.perf_counter() - t0
        setattr(group, op, timed)

    def recorded(tokens, _kind="score"):
        slots = llm.scheduler.slots if llm.scheduler is not None else []
        decoding = sum(t is not None and t.status == TaskStatus.DECODE for t in slots)
        before = {n: fn.launches for n, fn in counters.items()}
        if routes is not None:
            routes.append([])
        t0, in_collectives[0] = time.perf_counter(), 0.0
        with mock.patch.object(M, "select_experts",
                               tp_route(routes[-1] if routes is not None else None, share)):
            result = run(tokens, _kind)
        seen.append(dict(kind=_kind, decoding=decoding, s=time.perf_counter() - t0,
                         collectives_s=in_collectives[0],
                         launches={n: fn.launches - before[n] for n, fn in counters.items()
                                   if fn.launches != before[n]}))
        return result

    ex.run_score = recorded
    return seen


def tp_score_check(label: str, cfg, one: dict, got: dict, ranks: list,
                   layers: int = 0) -> str:
    """The scoring calls of a TP=2 run (``got``: rank 0's results, ``ranks``:
    both ranks' records) against TP=1's (``one``): logits [T, V] every row
    within the path's tolerance of its largest logit, the argmax kept
    wherever TP=1's top-2 gap exceeds twice the largest difference; hidden
    states within the path's tolerance of their largest entry (2e-2 for the
    dense path; MLA + MoE's 27 bf16 layers part by more, as their
    teacher-forced logits do, even with the routing shared); log-probabilities
    within twice their row's largest logit difference (the bound of a
    log-softmax) plus 1e-3; greedy matches apart by no more than the
    positions whose argmax parted (each a near tie). Each rank ran every
    scoring event, one while requests decoded, and each launched the path's
    scoring kernels once a layer it holds (``layers``: a pipeline stage's;
    default every layer) and nothing else. Returns the summary."""
    tol = TP_PATHS[label][3]
    want, have = torch.from_numpy(one["scores"]["logits"]), torch.from_numpy(got["logits"])
    if not (torch.isfinite(have).all() and have.shape == want.shape
            and have.shape == (TP_LENS[1], cfg.vocab_size)):
        raise AssertionError(f"tp: {label}: scored logits {tuple(have.shape)}, or not finite")
    diff = (have - want).abs()
    row_diff = diff.amax(-1)
    rel = (row_diff / want.abs().amax(-1)).max().item()
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    parted = have.argmax(-1) != want.argmax(-1)
    worst = gap[parted].max().item() if parted.any() else 0.0
    hs_want, hs_got = one["scores"]["hidden"], got["hidden"]
    hs_rel = float(np.abs(hs_got - hs_want).max() / np.abs(hs_want).max())
    lp_err = float((torch.from_numpy(got["log_prob"] - one["scores"]["log_prob"]).abs()
                    - 2 * row_diff[:-1] - 1e-3).max())
    gm = (one["greedy_match"], got["greedy_match"])
    msg = (f"calc_logits [{TP_LENS[1]}, {cfg.vocab_size}] max rel err {rel:.3e} (tolerance "
           f"{tol:.4g}), argmax equal on {int((~parted).sum())}/{parted.numel()}, largest top-2 "
           f"gap where they part {worst:.3e} (allowed {2 * diff.max().item():.3e}); "
           f"calc_hidden_states {hs_rel:.3e} (tolerance {tol:.4g}); calc_log_prob within "
           f"the log-softmax bound by {-lp_err:.3e}; calc_greedy_match {gm[1]} against {gm[0]}")
    if (rel > tol or worst > 2 * diff.max().item() or hs_rel > tol or lp_err > 0
            or abs(gm[1] - gm[0]) > int(parted[:-1].sum())):
        raise AssertionError(f"tp: {label}: TP=2 scoring against TP=1: {msg}")
    layers = layers or cfg.num_layers
    for r in ranks:
        calls = r["score_calls"]
        kinds = [c["kind"] for c in calls]
        if kinds != ["hidden", "score", "score", "score"]:
            raise AssertionError(f"tp: {label}: rank {r['rank']} ran the scoring events {kinds}")
        if not calls[0]["decoding"]:
            raise AssertionError(f"tp: {label}: rank {r['rank']}: no scoring event ran while "
                                 f"the greedy batch decoded")
        want_launches = {name: layers for name in TP_SCORED[label]}
        for c in calls:
            if c["launches"] != want_launches:
                raise AssertionError(f"tp: {label}: rank {r['rank']}: a scoring call launched "
                                     f"{c['launches']}, not {want_launches}")
    return msg


def tp_digests(tree, prefix: str = "") -> dict:
    """sha256 of each leaf's bytes, by path."""
    import hashlib

    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(tp_digests(v, path))
        else:
            out[path] = hashlib.sha256(v.detach().contiguous().view(torch.uint8).cpu().numpy()
                                       .tobytes()).hexdigest()
    return out


def tp_calib_prompts(seed: int, vocab: int) -> list:
    rng = np.random.default_rng(seed + 23)
    return [rng.integers(3, vocab, TP_CALIB[1]).tolist() for _ in range(TP_CALIB[0])]


def pp_count_moves(group) -> dict:
    """Count, from now on, each move of the hidden state ``group`` (a
    pipeline column) makes, by kind: ``send`` and ``recv`` (a hand-off
    between adjacent stages), ``from_last`` (the last stage's broadcast)."""
    counts = {}
    for op in ("send", "recv", "from_last"):
        def counted(*a, _real=getattr(group, op), _op=op, **kw):
            counts[_op] = counts.get(_op, 0) + 1
            return _real(*a, **kw)

        setattr(group, op, counted)
    return counts


def pp_moves_ms(group, cfg, device) -> dict:
    """Wall ms of one move of the bf16 hidden state over a pipeline column,
    the host's time included (20 after 3, synchronised), at a decode step of
    the engine's 4 slots and at a 512-token chunk: the hand-off down the
    column (each stage receives, then sends on) and the last stage's
    broadcast to every stage. Every rank of the column calls it together."""
    out = {}
    for rows in (4, 512):
        shape = (rows, cfg.dim_model)
        x = torch.randn(shape, device=device).to(torch.bfloat16)

        def hand_off():
            y = x if group.first else group.recv(shape, torch.bfloat16, device)
            if not group.last:
                group.send(y)

        def from_last():
            group.from_last(x if group.last else None, shape, torch.bfloat16, device)

        for what, fn in ((f"hand-off bf16 [{rows}, d]", hand_off),
                         (f"from_last bf16 [{rows}, d]", from_last)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize(device)
            out[what] = (time.perf_counter() - t0) / 20 * 1e3
    return out


def tp_smooth(args, label: str, cfg, device, path_dir: str, forced: dict, shard=None) -> dict:
    """SmoothQuant on the AUTO_INT8 path, at TP=1 (``shard`` None) or on one
    rank of TP=2: the bf16 weights drawn from the seed (a rank's shard),
    ``LLM.calc_act_scales`` on seeded prompts (at TP=2 every rank together);
    the weights quantized with TP=1's scales (a rank: broadcast from rank 0,
    its shard quantized with ``tp=``), each quantized leaf's digest (TP=1:
    those of each rank's shard of its tree); then the calibrated model's
    teacher-forced logits along the path's tokens (TP=1 also one prompt at a
    time, its spread). TP=1 writes its scales and digests to ``path_dir``."""
    import gc

    import torch.distributed as dist

    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.parallel.sharding import shard_params
    from zhilight_tpu_torch.utils.quant_convert import quantize_int8_params

    world = 1 if shard is None else shard[1]
    t0 = time.monotonic()
    base = LLM(model_config=cfg, params=L.init_params(cfg, seed=args.seed, device=device,
                                                       shard=shard),
               engine_config=tp_engine_config(world), device=device)
    t1 = time.monotonic()
    scales = base.calc_act_scales(tp_calib_prompts(args.seed, cfg.vocab_size),
                                  calib_len=TP_CALIB[1])
    out = dict(calib_s=time.monotonic() - t1, sites=len(scales))
    scales_path = os.path.join(path_dir, "act_scales.npz")
    if shard is None:
        np.savez(scales_path, **scales)
        one = scales
    else:
        box = [dict(np.load(scales_path)) if shard[0] == 0 else None]
        dist.broadcast_object_list(box, src=0)
        one = box[0]
        out["scales_sha"] = tp_digests({k: torch.from_numpy(v) for k, v in scales.items()})
        out["scales_rel"] = {k: float(np.abs(scales[k] - one[k]).max() / np.abs(one[k]).max())
                             for k in one}
        out["scales_whole"] = all(scales[k].shape == one[k].shape for k in one)
    params = base.executor.params
    release_pool(base)
    base.executor = None
    tp = None if shard is None else base.tp_group
    q = quantize_int8_params(params, one, TP_ALPHA, tp=tp)
    del params, base
    layers = {"layers": q["layers"]}
    if shard is None:
        got = [tp_digests(shard_params(layers, r, 2, cfg)) for r in range(2)]
        with open(os.path.join(path_dir, "smooth_digests.json"), "w") as f:
            json.dump(got, f)
        got = got[0]
    else:
        want = json.load(open(os.path.join(path_dir, "smooth_digests.json")))[shard[0]]
        got = tp_digests(layers)
        out["leaves"] = len(got)
        out["leaves_equal"] = sum(got.get(k) == v for k, v in want.items())
        out["leaves_want"] = len(want)
    out["smooth_leaves"] = sum(k.endswith(".smooth") for k in got)
    gc.collect()
    llm = LLM(model_config=cfg, params=q, engine_config=tp_engine_config(world), device=device)
    del q
    ex = llm.executor
    out["logits"] = tp_forced(ex, forced["prompts"], forced["tokens"])
    if shard is None:
        out["floor"] = torch.cat([tp_forced(ex, [p], [t]) for p, t in zip(forced["prompts"],
                                                                           forced["tokens"])])
    release_pool(llm)
    ex.params, llm, ex = None, None, None
    gc.collect()
    torch.cuda.empty_cache()
    out["smooth_s"] = time.monotonic() - t0
    return out


def tp_route(routes=None, share=None):
    """``models.moe.select_experts`` as tp_forced shares it: appending each
    routing (router logits, expert ids, weights, on the host) to ``routes``;
    or, with ``share`` (a dict holding such a list under "routes"), taking
    each one's experts and weights where this side's part from the recorded
    one in the same order, if the parting is a near tie (see tp_forced),
    counted in ``share``'s "routed", "parted" and "ratio" (set them first);
    else the function itself. Starts ``share``'s replay at its first
    routing."""
    from zhilight_tpu_torch.models import moe as M

    select = M.select_experts

    def recorded(logits, m, bias=None):
        weights, ids = select(logits, m, bias)
        routes.append((logits.float().cpu(), ids.cpu(), weights.cpu()))
        return weights, ids

    def shared(logits, m, bias=None):
        weights, ids = select(logits, m, bias)
        o_logits, o_ids, o_weights = (t.to(logits.device) for t in share["routes"][share["calls"]])
        share["calls"] += 1
        parted = (ids.sort(-1).values != o_ids.sort(-1).values).any(-1)
        share["routed"] += ids.shape[0]
        # each parted row: the gap between its recorded k-th expert and the
        # best of this side's own picks, over the row's largest difference
        own = (ids[:, :, None] != o_ids[:, None, :]).all(-1)
        own_max = o_logits.gather(1, ids.long()).masked_fill(~own, float("-inf")).amax(-1)
        gap = o_logits.gather(1, o_ids.long()).amin(-1) - own_max
        ratios = (gap / (o_logits - logits.float()).abs().amax(-1))[parted].tolist()
        if not all(r <= 2 for r in ratios):
            raise AssertionError(f"tp: routing parted off a near tie (gap {max(ratios)} x the "
                                 f"router-logit difference)")
        share["parted"] += len(ratios)
        share["ratio"] = max([share["ratio"]] + ratios)
        return (torch.where(parted[:, None], o_weights, weights),
                torch.where(parted[:, None], o_ids, ids))

    if share is not None:
        share["calls"] = 0
    return recorded if routes is not None else shared if share is not None else select


def tp_forced(ex, prompts, tokens, routes=None, share=None) -> torch.Tensor:
    """Teacher-forced logits [B, N, V] (fp32, on the host): the prompts
    prefilled (512-token chunks) into a scratch cache, then N - 1 batched
    decode steps fed ``tokens`` (the TP=1 run's greedy tokens), so row k
    holds the logits that pick tokens[b][k]. Every rank of a TP or PP run
    calls it together (a pipeline stage through its own forwards,
    ``ex.model``, over a scratch cache of its layers).

    MoE routing, as ``teacher_forced`` shares it: ``routes`` (a list) records
    every routing (router logits, expert ids, weights, on the host); with
    ``share`` (a dict holding such a list under "routes", the TP=1 run's)
    each routing is held against the recorded one in the same order: where
    a token's experts part, the parting must be a near tie (the recorded
    gap between its k-th expert and this side's pick at most twice the row's
    largest router-logit difference), and the token then takes the recorded
    experts and weights, so that one rounding flip does not stand for the
    rest of the run; ``share`` counts the routed and parted token-layers and
    the largest gap ratio."""
    from unittest import mock

    from zhilight_tpu_torch.models import moe as M
    from zhilight_tpu_torch.models.base import DecodeMeta, PrefillMeta

    if share is not None:
        share.update(routed=0, parted=0, ratio=0.0)
    route = tp_route(routes, share)
    cfg, S, B, N = ex.cfg, ex.page_size, len(prompts), len(tokens[0])
    i32 = dict(dtype=torch.int32, device=ex.device)
    maxp = max(len(p) + N for p in prompts) // S + 1
    tables = torch.arange(B * maxp, **i32).reshape(B, maxp)
    slots = lambda b, pos: (tables[b, (pos // S).long()] * S + pos % S).to(torch.int32)
    cache, rows = ex.new_cache(B * maxp), [[] for _ in range(B)]
    with torch.no_grad(), mock.patch.object(M, "select_experts", route):
        for b, p in enumerate(prompts):
            for start in range(0, len(p), 512):
                toks = torch.tensor(p[start : start + 512], **i32)
                pos = torch.arange(start, start + len(toks), **i32)
                meta = PrefillMeta(positions=pos, slot_mapping=slots(b, pos), page_table=tables[b],
                                   cache_len=torch.tensor(start, **i32),
                                   q_len=torch.tensor(len(toks), **i32))
                logits, cache = ex.model.forward_prefill(ex.params, cfg, ex.rope, toks, meta,
                                                         cache, tp=ex.tp)
            rows[b].append(logits.float().cpu())
        fed = torch.tensor(tokens, **i32)
        n = torch.tensor([len(p) for p in prompts], **i32)
        active = torch.arange(B, device=ex.device)
        for k in range(N - 1):
            pos = n + k
            meta = DecodeMeta(positions=pos, slot_mapping=slots(active, pos), page_tables=tables,
                              context_lens=pos + 1)
            logits, cache = ex.model.forward_decode(ex.params, cfg, ex.rope, fed[:, k], meta,
                                                    cache, tp=ex.tp)
            for b in range(B):
                rows[b].append(logits[b].float().cpu())
    return torch.stack([torch.stack(r) for r in rows])


def _tp_counters():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def tp_routing():
    """Record every routing's expert ids on the device (no sync) from now
    on; returns the list they are appended to."""
    from zhilight_tpu_torch.models import moe as M

    seen, select = [], M.select_experts

    def recorded(*a, **kw):
        weights, ids = select(*a, **kw)
        seen.append(ids.reshape(-1))
        return weights, ids

    M.select_experts = recorded
    return seen


def tp_rank(args) -> int:
    """One rank of the tp phase's multi-rank run (``--tp-rank`` of
    ``--tp-world``: 2 in the tp phase, 4 in pp4): joins the others over an
    explicit gloo group on the one GPU (``--tp-backend nccl``: NCCL, a GPU a
    rank), then runs each path of ``--tp-models`` in turn (tp_rank_path), one
    process for them all."""
    import datetime

    import torch.distributed as dist

    from zhilight_tpu_torch.engine import SearchTask

    rank, world, nccl = args.tp_rank, args.tp_world, args.tp_backend == "nccl"
    device = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=f"tcp://127.0.0.1:{args.tp_port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    finished = {}
    finish = SearchTask.finish

    def recorded(self):
        finished[str(self.task_id)] = [int(t) for t in self.output_tokens]
        finish(self)

    SearchTask.finish = recorded
    for label in args.tp_models.split(","):
        finished.clear()
        tp_rank_path(args, label, rank, world, device, finished)
        print(f"tp rank {rank}: {label} done", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    print(f"tp rank {rank}: done", flush=True)
    return 0


def tp_rank_path(args, label: str, rank: int, world: int, device, finished: dict) -> None:
    """One tp path on one rank: draws the full tensors from the seed one
    layer at a time and keeps its shard (``tp_weights``: its heads, its half
    of the experts, its int4 / FP8 / W8A8 columns or rows; a pipelined path:
    its stage's layers, stage ``rank // tp``), serves through LLM: rank 0
    drives the requests (tp_drive), the others run the lockstep scheduler
    until rank 0's shutdown sentinel (a check path serves none).
    Then both run the teacher-forced logits along the TP=1 run's tokens,
    counting their collectives (the W8A8 path: then holds int8_linear's
    row-parallel product to the unsharded one, tp_w8a8_exact), write what
    they saw to the path's directory under ``--tp-dir`` (among it a digest
    of every routing's expert ids) and free the path."""
    import gc
    import hashlib

    import torch.distributed as dist

    from zhilight_tpu_torch.engine import DynamicBatchGenerator
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import moe as M

    path_dir = os.path.join(args.tp_dir, label)
    t_path = time.monotonic()
    torch.cuda.reset_peak_memory_stats(device)
    cfg = tp_config(label, args)
    drive = TP_PATHS[label][5]
    tp, pp = tp_shape(label)
    if tp * pp != world:
        raise AssertionError(f"tp: {label} runs on {tp * pp} ranks, not {world}")
    t0 = time.monotonic()
    params = tp_weights(label, args, cfg, device, shard=(rank % tp, tp) if tp > 1 else None,
                        stage=(rank // tp, pp) if pp > 1 else None)
    llm = LLM(model_config=cfg, params=params, engine_config=tp_engine_config(tp, pp),
              device=device)
    del params
    ex = llm.executor
    setup_s = time.monotonic() - t0
    warm_s = ex.warmup()
    counters = _tp_counters()
    score_share = None
    if label in TP_SCORED and cfg.moe.enabled:
        # TP=1's routing of its calc_logits call, shared as tp_forced shares it
        score_share = dict(routes=torch.load(os.path.join(path_dir, "score_routes.pt")))
    score_calls = (tp_score_recorder(llm, counters, share=score_share) if label in TP_SCORED
                   else [])
    select = M.select_experts
    routed = tp_routing()
    pool = ex.cache.latent if ex.cache.is_latent else ex.cache.k
    out = dict(rank=rank, setup_s=setup_s, warmup_s=warm_s, pool_layers=len(pool),
               layers=sorted(int(i) for i in ex.params["layers"]),
               weights_gib=sum(t.numel() * t.element_size() for t in _leaves(ex.params)) / 2**30,
               pool=list(pool[0].shape), heads=[ex.cfg.num_heads, ex.cfg.num_kv_heads],
               experts=sorted({v.shape[0] for layer in ex.params["layers"].values()
                               for proj in layer["mlp"].get("experts", {}).values()
                               for v in proj.values()}),
               backend=dist.get_backend())
    prompts = tp_prompts(args.seed, cfg.vocab_size)
    if not drive:
        pass
    elif rank == 0:
        out.update(tp_drive(llm, prompts, score=label in TP_SCORED))
        for name, value in out.pop("scores", {}).items():
            np.save(os.path.join(path_dir, f"tp2_score_{name}.npy"), value)
    else:
        gen = DynamicBatchGenerator(llm).start()
        gen.scheduler._thread.join(timeout=TP_TIMEOUT)
        if gen.scheduler._thread.is_alive() or gen.scheduler.error is not None:
            raise AssertionError(f"rank {rank}: the lockstep scheduler did not stop cleanly: "
                                 f"{gen.scheduler.error!r}")
        out["sessions_left"] = len(gen.scheduler.sessions)
        del gen
    torch.cuda.synchronize()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    out["score_calls"] = score_calls
    if score_share is not None:
        out["score_routing"] = {k: score_share[k] for k in ("routed", "parted", "ratio")}
    out["finished"] = dict(finished)
    forced = json.load(open(os.path.join(path_dir, "forced.json")))
    share = None
    if cfg.moe.enabled:
        share = dict(routes=torch.load(os.path.join(path_dir, "routes.pt")))
    collectives = tp_count_collectives(llm.tp_group) if llm.tp_group is not None else {}
    moves = pp_count_moves(llm.pp_group) if llm.pp_group is not None else {}
    before = {name: fn.launches for name, fn in counters.items()}
    t0 = time.monotonic()
    logits = tp_forced(ex, forced["prompts"], forced["tokens"], share=share)
    out["forced_s"] = time.monotonic() - t0
    torch.cuda.synchronize()
    out["forced_launches"] = {name: fn.launches - before[name] for name, fn in counters.items()
                              if fn.launches != before[name]}
    if not drive:  # the path's launches are the teacher-forced run's
        torch.cuda.synchronize()
        out["launches"] = {name: fn.launches for name, fn in counters.items()}
    n = tp_forwards(forced["prompts"], forced["tokens"])
    out["collectives"] = {k: v / n for k, v in collectives.items()}
    out["moves"] = {k: v / n for k, v in moves.items()}
    out["kept_whole"] = tp_kept_whole(ex, tp) if tp > 1 else 0
    if share is not None:
        out["shared_routing"] = {k: share[k] for k in ("routed", "parted", "ratio")}
    out["logits_sha"] = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
    out["routings"] = len(routed)
    if routed:
        out["experts_sha"] = hashlib.sha256(torch.cat(routed).cpu().numpy().tobytes()).hexdigest()
    M.select_experts = select
    if rank == 0:
        np.save(os.path.join(path_dir, "tp2_logits.npy"), logits.numpy())
    if TP_PATHS[label][4] == "int8":
        out["w8a8_exact"] = tp_w8a8_exact(llm.tp_group, device, args.seed)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    if llm.tp_group is not None:
        out["collectives_ms"] = tp_collectives(llm.tp_group, cfg, device)
    if llm.pp_group is not None:
        out["moves_ms"] = pp_moves_ms(llm.pp_group, cfg, device)
    release_pool(llm)
    ex.params, llm, ex = None, None, None
    gc.collect()
    torch.cuda.empty_cache()
    if TP_PATHS[label][4] == "int8":
        sq = tp_smooth(args, label, cfg, device, path_dir, forced, shard=(rank, world))
        logits = sq.pop("logits")
        sq["logits_sha"] = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
        if rank == 0:
            np.save(os.path.join(path_dir, "tp2_smooth_logits.npy"), logits.numpy())
        out["smooth"] = sq
    out["left_gib"] = torch.cuda.memory_allocated(device) / 2**30
    out["path_s"] = time.monotonic() - t_path
    with open(os.path.join(path_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# the W8A8 card check: Qwen2.5-14B's row-parallel linears at TP=2 (o_proj
# 5120 -> 2560 rows a rank, down_proj 13824 -> 6912; both 5120 columns), at a
# decode step's 4 rows and a 512-token chunk
TP_W8A8_SHAPES = ((5120, 5120), (13824, 5120))
TP_W8A8_ROWS = (4, 512)


def tp_w8a8_exact(group, device, seed: int) -> dict:
    """``int8_linear`` at a row-parallel rank's shapes on the card, every
    rank given the same inputs (bf16 x [M, K] with an outlier in the last
    rank's columns; a bf16 weight quantized whole by AUTO_INT8; with and
    without a smooth vector): each rank's product of its shard (shard_linear)
    and its K / tp columns over ``group`` (the per-token absmax MAX-reduced,
    the int32 partials summed) against the unsharded product, bit for bit.
    Two planted faults show that the check sees what it guards: a rank-local
    absmax (no MAX) and a missing int32 sum must each give another result;
    their largest errors relative to the row's largest output are returned
    beside the cases' count."""
    from zhilight_tpu_torch.ops.quant import int8_linear
    from zhilight_tpu_torch.parallel.sharding import shard_linear
    from zhilight_tpu_torch.utils.quant_convert import auto_int8_from_fp

    class Fault:
        """``group`` with one collective left out: the MAX ("max") or the
        int32 sum ("int32")."""

        def __init__(self, skip):
            self.skip = skip

        def all_reduce(self, x, op=None):
            maxed = "MAX" in str(op)
            if maxed if self.skip == "max" else (not maxed and x.dtype == torch.int32):
                return x
            return group.all_reduce(x, op=op)

    r, tp = group.rank, group.world
    gen = torch.Generator(device).manual_seed(seed + 22)
    out = dict(cases=0, equal=0, fault_max=[], fault_int32=[])
    for K, N in TP_W8A8_SHAPES:
        w = (torch.randn(K, N, generator=gen, device=device) / K ** 0.5).to(torch.bfloat16)
        smooth = torch.rand(K, generator=gen, device=device) + 0.5
        for smoothed in (False, True):
            p = auto_int8_from_fp(w)
            if smoothed:
                p["smooth"] = smooth
            shard = shard_linear("layers.0.mlp.down_proj", p, r, tp)
            k = K // tp
            for M in TP_W8A8_ROWS:
                x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
                x[M // 2, K - 1 - k // 3] = 40.0  # the last rank's columns
                want = int8_linear(p, x)
                xs = x[:, r * k:(r + 1) * k]
                got = int8_linear(shard, xs, group)
                out["cases"] += 1
                out["equal"] += int(torch.equal(got, want))
                scale = want.float().abs().amax(-1, keepdim=True)
                for fault in ("max", "int32"):
                    bad = int8_linear(shard, xs, Fault(fault)).float()
                    out[f"fault_{fault}"].append(((bad - want.float()).abs() / scale).max().item())
    return out


def tp_collectives(group, cfg, device) -> dict:
    """Wall ms of one collective at the model's shapes on this group, the
    host's time included (20 calls after 3, synchronised): the fp32
    all-reduce of a row-parallel product or a MoE layer's routed sum at a
    decode step of the engine's 4 slots and at a 512-token chunk, and the
    all-gather of a decode step's fp32 logits (a rank's vocab slice). A
    decode step makes tp_collective_count all-reduces (the embedding's in the
    model's dtype, the others fp32) and one all-gather."""
    V = cfg.vocab_size // group.world
    cases = {"all_reduce fp32 [4, d]": (group.all_reduce, (4, cfg.dim_model)),
             "all_reduce fp32 [512, d]": (group.all_reduce, (512, cfg.dim_model)),
             "all_gather fp32 [4, V / tp]": (lambda x: group.all_gather(x, -1), (4, V))}
    out = {}
    for label, (fn, shape) in cases.items():
        x = torch.randn(shape, device=device)
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(20):
            fn(x)
        torch.cuda.synchronize(device)
        out[label] = (time.perf_counter() - t0) / 20 * 1e3
    return out


def tp_compare(label: str, want: torch.Tensor, got: torch.Tensor, want_tokens, got_tokens,
               floor: torch.Tensor, tol: float, spread: bool = False) -> str:
    """Teacher-forced logits [B, N, V] of the TP=2 run against the TP=1 run's
    along the TP=1 tokens. The TP=2 greedy tokens equal TP=1's; where they
    part, the first parting is a near tie by the repo's teacher-forced rule
    (that row within ``tol`` of its largest logit: the path's, 2e-2 for a
    dense model, LOGIT_TOL for MLA + MoE; the TP=1 top-2 gap at most twice
    the largest difference). Every row lies within LOGIT_TOL of its
    largest logit (the bound serve_path holds two computations of a
    full-depth model to) and keeps the TP=1 argmax wherever the TP=1 top-2 gap
    exceeds twice the largest difference. ``floor``: the same rows at TP=1
    one prompt at a time, against the batch: the rounding noise between two
    computations of one model, printed beside; with ``spread`` the rows are
    held to the larger of LOGIT_TOL and 1.25 times that noise."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{label}: non-finite teacher-forced logits")
    diff = (got - want).abs().max().item()
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)  # [B, N]
    noise = ((floor - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    bound = max(LOGIT_TOL, 1.25 * noise) if spread else LOGIT_TOL
    top2 = want.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    parted = got.argmax(-1) != want.argmax(-1)
    worst = gap[parted].max().item() if parted.any() else 0.0
    notes = []
    for b, (w, g) in enumerate(zip(want_tokens, got_tokens)):
        k = next((k for k, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if k is None:
            if len(w) != len(g):
                raise AssertionError(f"{label}: prompt {b}: {len(g)} tokens, not {len(w)}")
            continue
        notes.append(f"prompt {b} parts at token {k} (top-2 gap there {gap[b, k].item():.3e}, "
                     f"rel err {rel[b, k].item():.3e})")
        if rel[b, k].item() > tol or gap[b, k].item() > 2 * diff:
            raise AssertionError(f"{label}: prompt {b}: the greedy tokens part at {k}, off a near "
                                 f"tie: {notes[-1]}, largest |diff| {diff}")
    msg = (f"teacher-forced {want.shape[1]} positions of {want.shape[0]} prompts: logits max rel "
           f"err {rel.max().item():.3e} (tolerance {bound:.4g}; TP=1 one prompt at a time against "
           f"its batch: {noise:.3e}), largest |diff| {diff:.3e}; argmax equal on "
           f"{int((~parted).sum())}/{parted.numel()}, largest top-2 gap where they part "
           f"{worst:.3e} (allowed: up to twice the largest |diff|); "
           f"{'; '.join(notes) or 'the greedy tokens are equal'}")
    if rel.max().item() > bound or worst > 2 * diff:
        raise AssertionError(f"{label}: {msg}")
    return msg


def phase_tp(rec: dict, args, smi: str) -> None:
    """The TP_PATHS: Qwen2.5-14B in bf16 at a cut depth (TP_QWEN_LAYERS of
    48, full width), Qwen2.5-14B GPTQ-Int4 (at ``--tp-gptq-layers``), the
    FP8 and AUTO_INT8 2-layer checks and DeepSeek-V2-Lite in bf16 at full
    width and depth (MLA + MoE), random weights drawn on the card from the
    seed. Each is served (or, the checks, teacher-forced) at TP=1 in this
    process, one after the other (tp_one); then two rank processes on the one
    GPU over an explicit gloo group (NCCL refuses two ranks on one device;
    ``--tp-backend nccl`` runs a GPU a rank) run every path at TP=2 in the
    same order, one launch for them all (tp_rank); then each path's TP=2 run
    is held to its TP=1 run (tp_check)."""
    import shutil
    import tempfile

    nccl = args.tp_backend == "nccl"
    if nccl and torch.cuda.device_count() < 2:
        raise RuntimeError(f"--tp-backend nccl runs a GPU a rank: 2 needed, "
                           f"{torch.cuda.device_count()} visible")
    labels = [label for label in TP_PATHS if tp_shape(label)[0] * tp_shape(label)[1] == 2]
    tmp = tempfile.mkdtemp(prefix="zt-tp-")  # the ranks' results; removed at the end
    try:
        ones = {}
        for label in labels:
            os.makedirs(os.path.join(tmp, label))
            ones[label] = tp_one(rec, args, label, os.path.join(tmp, label))
        tp_launch(args, labels, tmp)
        for label in labels:
            check = tp_check if tp_shape(label)[1] == 1 else pp_check
            check(rec, args, smi, label, ones[label], os.path.join(tmp, label))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_pp4(rec: dict, args, smi: str) -> None:
    """Qwen2.5-14B in bf16 at TP=2 x PP=2 (``Qwen2.5-14B-bf16-tp-pp``, at the
    tp path's cut depth, TP_QWEN_LAYERS of 48, full width): the one-process
    run in this process (tp_one), then four rank processes (stage ``r //
    2``, TP rank ``r % 2``), over gloo on the one GPU or, with
    ``--tp-backend nccl``, a GPU a rank (four needed), then pp_check."""
    import shutil
    import tempfile

    if args.tp_backend == "nccl" and torch.cuda.device_count() < 4:
        raise RuntimeError(f"--phases pp4 --tp-backend nccl runs a GPU a rank: 4 needed, "
                           f"{torch.cuda.device_count()} visible")
    label = "Qwen2.5-14B-bf16-tp-pp"
    tmp = tempfile.mkdtemp(prefix="zt-pp4-")
    try:
        path_dir = os.path.join(tmp, label)
        os.makedirs(path_dir)
        one = tp_one(rec, args, label, path_dir)
        tp_launch(args, [label], tmp, world=4)
        pp_check(rec, args, smi, label, one, path_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the hosts phase: multi-host serving and data-parallel replicas
# ---------------------------------------------------------------------------

HOSTS_NEW = 32             # new tokens a request, EOS ignored
HOSTS_PAGES = 512          # given: processes sharing a GPU would size their pools from its free memory
HOSTS_TIMEOUT = 600        # seconds: the rank processes' limit, their groups' timeout
HOSTS_PLANE_ROUNDS = 200   # all_min round trips timed on every rank
HOSTS_PATHS = {
    # label -> the rank processes of its multi-process run
    # MiniCPM-2B in bf16 at full width and depth, as two hosts joined by the
    # TCP control plane alone, each a whole replica (the plane tier)
    "MiniCPM-2B-bf16-hosts": 2,
    # Qwen2.5-14B in bf16 at full width and TP_QWEN_LAYERS of 48, TP=2 x
    # DP=2: two emulated hosts of two ranks sharing one world (the mesh tier)
    "Qwen2.5-14B-bf16-tp-dp": 4,
}
for _label, _world in HOSTS_PATHS.items():
    for _name in [f"{_label}-one"] + [f"{_label}-rank{r}" for r in range(_world)]:
        PATHS[_name] = ATTENTION_KERNELS


def hosts_config(label: str, args):
    """The path's ModelConfig: MiniCPM-2B, or the tp phase's Qwen2.5-14B bf16
    at TP_QWEN_LAYERS."""
    return minicpm_2b() if label.startswith("MiniCPM") else tp_config("Qwen2.5-14B-bf16", args)


def hosts_parallel(label: str, rank: int, port: int):
    """Rank ``rank``'s ParallelConfig: the plane tier's host ``rank`` of 2
    (the TCP plane at ZT_CONTROL_ADDR), or TP=2 x DP=2 over 2 hosts of 2
    ranks sharing one world from the coordinator at ``port``."""
    from zhilight_tpu_torch.config import ParallelConfig

    if label.startswith("MiniCPM"):
        return ParallelConfig(num_hosts=2, host_rank=rank)
    return ParallelConfig(tp=2, dp=2, num_hosts=2, host_rank=rank // 2,
                          coordinator_address=f"127.0.0.1:{port}")


def hosts_engine_config(parallel=None):
    """Batch 8, max_model_len 4096, 512-token chunks, HOSTS_PAGES pages of
    16; one process unless ``parallel`` says otherwise."""
    from zhilight_tpu_torch.config import (CacheConfig, EngineConfig, ParallelConfig,
                                           SchedulerConfig)

    return EngineConfig(max_model_len=4096,
                        cache=CacheConfig(page_size=16, num_pages=HOSTS_PAGES),
                        scheduler=SchedulerConfig(max_batch=8, chunk_size=512),
                        parallel=parallel or ParallelConfig())


def hosts_prompts(seed: int, vocab: int) -> list:
    """The 8 requests' prompts, SERVE_LENS tokens each."""
    rng = np.random.default_rng(seed + 30)
    return [rng.integers(3, vocab, n).tolist() for n in SERVE_LENS]


def hosts_drive(llm, prompts) -> dict:
    """Rank 0's requests (or the one-process run's): the 8 prompts,
    HOSTS_NEW greedy tokens each, queued before the loop starts, so that its
    first iteration admits them all and every run batches them alike; then
    the 1500-token prompt for one token three times (TTFT, the median) and
    for HOSTS_NEW (batch-1 decode tok/s). Each broadcast of the control plane
    is timed on this rank (the cost an iteration pays). Returns the tokens
    and the times."""
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg, SearchTask

    out, t_start = {}, time.monotonic()
    gen = DynamicBatchGenerator(llm)
    plane, spent = llm.executor.plane, []
    broadcast = plane.broadcast

    def timed(obj):
        t0 = time.perf_counter()
        try:
            return broadcast(obj)
        finally:
            spent.append(time.perf_counter() - t0)

    plane.broadcast = timed
    tasks = [SearchTask(p, GeneratorArg(max_length=HOSTS_NEW, ignore_eos=True)) for p in prompts]
    for task in tasks:
        gen.scheduler.submit(task)
    gen.start()
    try:
        out["greedy"] = []
        for task in tasks:
            result = gen._wait_final(task, HOSTS_TIMEOUT)[1]
            if isinstance(result, BaseException):
                raise result
            out["greedy"].append([int(t) for t in result.token_ids])
        out["batch_s"] = time.monotonic() - t_start
        long, ttft = prompts[3], []
        for _ in range(3):
            t0 = time.monotonic()
            gen.generate(long, GeneratorArg(max_length=1), timeout=HOSTS_TIMEOUT)
            ttft.append(time.monotonic() - t0)
        t0 = time.monotonic()
        out["long"] = gen.generate(long, GeneratorArg(max_length=HOSTS_NEW, ignore_eos=True),
                                   timeout=HOSTS_TIMEOUT).outputs[0].token_ids
        long_s = time.monotonic() - t0
    finally:
        gen.stop()
        plane.broadcast = broadcast
    if gen.scheduler.error is not None:
        raise AssertionError("the scheduler failed") from gen.scheduler.error
    out["ttft_ms"] = statistics.median(ttft) * 1e3
    out["decode_tok_s"] = (len(out["long"]) - 1) / (long_s - statistics.median(ttft))
    out["broadcasts"] = len(spent)
    out["broadcast_ms"] = statistics.mean(spent) * 1e3 if spent else None
    out["drive_s"] = time.monotonic() - t_start
    return out


def hosts_one(rec: dict, args, label: str, path_dir: str) -> dict:
    """A hosts path in one process: the requests (hosts_drive), launch
    counters zeroed just before and read just after; then the teacher-forced
    logits along its greedy tokens (tp_forced) and, for the TP path, the
    same one prompt at a time (the noise between two computations of one
    model). Writes the tokens the ranks feed to ``path_dir``; frees the
    weights."""
    import gc
    import hashlib

    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    cfg = hosts_config(label, args)
    t0 = time.monotonic()
    llm = LLM(model_config=cfg, params=L.init_params(cfg, seed=args.seed, device="cuda"),
              engine_config=hosts_engine_config(), device="cuda")
    ex = llm.executor
    setup_s = time.monotonic() - t0
    warm_s = ex.warmup()
    prompts = hosts_prompts(args.seed, cfg.vocab_size)
    counters = _tp_counters()
    one = hosts_drive(llm, prompts)
    torch.cuda.synchronize()
    one["launches"] = {name: fn.launches for name, fn in counters.items()}
    _tp_launches(rec, f"{label}-one", one["launches"], cfg.num_layers)
    with open(os.path.join(path_dir, "forced.json"), "w") as f:
        json.dump(dict(prompts=prompts, tokens=one["greedy"]), f)
    t0 = time.monotonic()
    one["want"] = tp_forced(ex, prompts, one["greedy"])
    one["forced_s"] = time.monotonic() - t0
    one["logits_sha"] = hashlib.sha256(one["want"].numpy().tobytes()).hexdigest()
    if not label.startswith("MiniCPM"):
        one["floor"] = torch.cat([tp_forced(ex, [p], [t]) for p, t in zip(prompts, one["greedy"])])
    print(f"hosts: {label} one process: {cfg.num_layers} layers, set-up {setup_s:.1f} s, warmup "
          f"{warm_s:.1f} s, requests {one['drive_s']:.1f} s, teacher-forced {one['forced_s']:.1f} "
          f"s; launches {({k: v for k, v in one['launches'].items() if v})}", flush=True)
    release_pool(llm)
    ex.params, llm, ex = None, None, None
    gc.collect()
    torch.cuda.empty_cache()
    return one


def hosts_launch(args, label: str, tmp: str) -> None:
    """The multi-process run of a hosts path: its rank processes (hosts_rank),
    started together; the plane tier's hosts find host 0 at ZT_CONTROL_ADDR,
    the mesh tier's ranks their world at the coordinator (``--hosts-port``).
    Under ``--tp-backend nccl`` each emulated host sees its own GPUs
    (CUDA_VISIBLE_DEVICES: a GPU a rank, host 0 the first ones). Raises with
    a rank's log where one fails or outlasts HOSTS_TIMEOUT."""
    world, nccl = HOSTS_PATHS[label], args.tp_backend == "nccl"
    per_host = world // 2
    port, ctrl = _tp_free_port(), _tp_free_port()
    t0 = time.monotonic()
    procs = []
    for r in range(world):
        env = dict(os.environ, LOCAL_RANK=str(r % per_host))
        if world == 2:  # the plane tier: host 0 binds the TCP plane's port
            env["ZT_CONTROL_ADDR"] = f"127.0.0.1:{ctrl}"
        if nccl:
            host = r // per_host
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(host * per_host + i)
                                                   for i in range(per_host))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--hosts-rank", str(r), "--hosts-path",
             label, "--hosts-port", str(port), "--tp-dir", tmp, "--seed", str(args.seed),
             "--tp-backend", args.tp_backend],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(HOSTS_TIMEOUT - (time.monotonic() - t0),
                                                  1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"hosts: {label}: rank {r} exited {p.returncode}:\n{log[-6000:]}")
    print(f"hosts: {label}: {world} rank processes, {time.monotonic() - t0:.1f} s", flush=True)


def hosts_rank(args) -> int:
    """One rank process of a hosts path (``--hosts-rank`` of
    HOSTS_PATHS[``--hosts-path``]): builds the path's LLM at its
    ParallelConfig (the TP path's weights: its TP rank's shard, drawn from
    the seed as every replica draws it), times HOSTS_PLANE_ROUNDS ``all_min``
    round trips of the plane, then drives the requests on rank 0
    (hosts_drive) while the others run the lockstep loop until rank 0's
    shutdown, launch counters zeroed just before; then every rank runs the
    teacher-forced logits along the one-process run's tokens and writes
    what it saw (digests of its logits and, for the TP path, of its shard)
    under ``--tp-dir``."""
    import datetime
    import hashlib

    import torch.distributed as dist

    from zhilight_tpu_torch.engine import DynamicBatchGenerator, SearchTask
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L
    from zhilight_tpu_torch.parallel.comm import leave

    label, rank, nccl = args.hosts_path, args.hosts_rank, args.tp_backend == "nccl"
    pcfg = hosts_parallel(label, rank, args.hosts_port)
    world = pcfg.num_devices
    # NCCL: the rank's GPU on its emulated host (hosts_launch)
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) if nccl else 0)
    if world > 1 and not nccl:
        # gloo, every rank on the one GPU: the world made here, over both
        # hosts, which LLM then checks against host_rank (NCCL: LLM makes it
        # from the coordinator itself)
        dist.init_process_group("gloo", init_method=f"tcp://{pcfg.coordinator_address}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=HOSTS_TIMEOUT))
    finished = {}
    finish = SearchTask.finish

    def recorded(self):
        finished[str(self.task_id)] = [int(t) for t in self.output_tokens]
        finish(self)

    SearchTask.finish = recorded
    t0 = time.monotonic()
    cfg = hosts_config(label, args)
    torch.cuda.set_device(device)
    params = L.init_params(cfg, seed=args.seed, device=device,
                           shard=(rank % pcfg.tp, pcfg.tp) if pcfg.tp > 1 else None)
    llm = LLM(model_config=cfg, params=params, engine_config=hosts_engine_config(pcfg),
              device=device)
    del params
    ex = llm.executor
    out = dict(rank=llm.rank, world=ex.plane.world, plane=type(ex.plane).__name__,
               device=str(ex.device), setup_s=time.monotonic() - t0, warmup_s=ex.warmup(),
               heads=[ex.cfg.num_heads, ex.cfg.num_kv_heads],
               backend=dist.get_backend() if dist.is_initialized() else None)
    t0 = time.perf_counter()
    for _ in range(HOSTS_PLANE_ROUNDS):
        ex.plane.all_min(rank)
    out["all_min_ms"] = (time.perf_counter() - t0) * 1e3 / HOSTS_PLANE_ROUNDS
    prompts = hosts_prompts(args.seed, cfg.vocab_size)
    counters = _tp_counters()
    if llm.rank == 0:
        out.update(hosts_drive(llm, prompts))
    else:
        gen = DynamicBatchGenerator(llm).start()
        gen.scheduler._thread.join(timeout=HOSTS_TIMEOUT)
        if gen.scheduler._thread.is_alive() or gen.scheduler.error is not None:
            raise AssertionError(f"rank {rank}: the lockstep scheduler did not stop cleanly: "
                                 f"{gen.scheduler.error!r}")
    torch.cuda.synchronize()
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    out["finished"] = dict(finished)
    path_dir = os.path.join(args.tp_dir, label)
    forced = json.load(open(os.path.join(path_dir, "forced.json")))
    t0 = time.monotonic()
    logits = tp_forced(ex, forced["prompts"], forced["tokens"])
    out["forced_s"] = time.monotonic() - t0
    out["logits_sha"] = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
    if rank == 0 and pcfg.tp > 1:
        np.save(os.path.join(path_dir, "rank0_logits.npy"), logits.numpy())
    if pcfg.tp > 1:
        out["tp_rank"] = llm.tp_group.rank
        out["shards"] = tp_digests(ex.params)
    out["peak_gib"] = torch.cuda.max_memory_allocated(ex.device) / 2**30
    with open(os.path.join(path_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    leave()
    print(f"hosts rank {rank}: {label} done", flush=True)
    return 0


def hosts_check(rec: dict, args, smi: str, label: str, one: dict, path_dir: str) -> None:
    """A hosts path's multi-process run against its one-process run
    (``one``, hosts_one's): every rank launched what the one-process run
    launched (each TP rank launches what TP=1 does: every kernel once a
    layer a forward) and finished every request with rank 0's tokens, and
    every rank scored the same teacher-forced logits, bit for bit. The
    plane tier's hosts (whole replicas): their greedy tokens and logits
    equal the one-process run's bit for bit. The TP=2 x DP=2 path: replica
    1's shard bit-equal to replica 0's at each TP rank, and rank 0's logits
    held to TP=1's by the teacher-forced rule (tp_compare), its tokens
    likewise. Prints decode tok/s and TTFT beside the one-process run's and
    the plane's cost."""
    cfg = hosts_config(label, args)
    world = HOSTS_PATHS[label]
    ranks = [json.load(open(os.path.join(path_dir, f"rank{r}.json"))) for r in range(world)]
    r0 = ranks[0]
    nccl = args.tp_backend == "nccl"
    if world == 2:
        how = "a GPU a host" if nccl else "both hosts on the one GPU"
    else:
        how = "NCCL, a GPU a rank" if nccl else "gloo, every rank on the one GPU"
    for r in ranks:
        print(f"hosts: {label} rank {r['rank']} of {r['world']} ({r['plane']}, {r['device']}, "
              f"{r['backend'] or 'no process group'}): {r['heads'][0]} / {r['heads'][1]} heads, "
              f"set-up {r['setup_s']:.1f} s, warmup {r['warmup_s']:.1f} s, teacher-forced "
              f"{r['forced_s']:.1f} s, peak {r['peak_gib']:.1f} GiB; launches "
              f"{({k: v for k, v in r['launches'].items() if v})}", flush=True)
        _tp_launches(rec, f"{label}-rank{r['rank']}", r["launches"], cfg.num_layers)
        if r["launches"] != one["launches"]:
            raise AssertionError(f"hosts: {label}: rank {r['rank']} launched {r['launches']}, the "
                                 f"one-process run {one['launches']}")
    if [r["rank"] for r in ranks] != list(range(world)):
        raise AssertionError(f"hosts: {label}: the ranks are {[r['rank'] for r in ranks]}")
    if any(r["finished"] != r0["finished"] for r in ranks) or len(r0["finished"]) != len(
            SERVE_LENS) + 4:
        raise AssertionError(f"hosts: {label}: the ranks finished the requests with other tokens")
    if any(r["logits_sha"] != r0["logits_sha"] for r in ranks):
        raise AssertionError(f"hosts: {label}: the ranks' teacher-forced logits differ")
    if world == 2:
        if r0["greedy"] != one["greedy"] or r0["long"] != one["long"]:
            raise AssertionError(f"hosts: {label}: host 0's greedy tokens differ from the "
                                 f"one-process run's")
        if r0["logits_sha"] != one["logits_sha"]:
            raise AssertionError(f"hosts: {label}: the hosts' teacher-forced logits differ from "
                                 f"the one-process run's")
        print(f"hosts: {label}: both hosts finished {len(r0['finished'])} requests with the same "
              f"tokens, the one-process run's, and scored its teacher-forced logits "
              f"([{len(SERVE_LENS)}, {HOSTS_NEW}, {cfg.vocab_size}]) bit for bit; launches equal "
              f"the one-process run's on each host", flush=True)
    else:
        for r in ranks[2:]:
            twin = ranks[r["rank"] % 2]
            if r["tp_rank"] != twin["tp_rank"] or r["shards"] != twin["shards"]:
                raise AssertionError(f"hosts: {label}: rank {r['rank']}'s shard differs from "
                                     f"replica 0's at TP rank {twin['tp_rank']}")
        if ranks[0]["shards"] == ranks[1]["shards"]:
            raise AssertionError(f"hosts: {label}: the two TP ranks hold the same shard")
        got = torch.from_numpy(np.load(os.path.join(path_dir, "rank0_logits.npy")))
        msg = tp_compare(label, one["want"], got, one["greedy"], r0["greedy"], one["floor"], 2e-2)
        bits = torch.equal(got, one["want"])
        print(f"hosts: {label} TP=2 x DP=2: every rank finished {len(r0['finished'])} requests "
              f"with rank 0's tokens and scored the same teacher-forced logits, bit for bit; "
              f"replica 1's shards bit-equal to replica 0's ({len(r0['shards'])} leaves a rank); "
              f"launches equal the one-process run's on every rank; the logits "
              f"{'equal' if bits else 'differ from'} TP=1's bit for bit; against TP=1, {msg}",
              flush=True)
    plane = "TCP" if r0["plane"] == "TcpPlane" else f"{r0['plane']} across hosts"
    print(f"timing: {label} control plane ({plane}, {how}): {r0['broadcast_ms']:.3f} ms a "
          f"broadcast on rank 0 over {r0['broadcasts']} iterations; an all_min round trip "
          f"{r0['all_min_ms']:.3f} ms (rank 0, mean of {HOSTS_PLANE_ROUNDS}); {smi}", flush=True)
    shape = "2 hosts" if world == 2 else "TP=2 x DP=2 over 2 hosts"
    for what, r in (("one process", one), (f"{shape} ({how})", r0)):
        print(f"timing: {label} {what}: TTFT {r['ttft_ms']:.2f} ms for {SERVE_LENS[3]} tokens "
              f"(median of 3), batch-1 decode {r['decode_tok_s']:.2f} tok/s over {HOSTS_NEW - 1} "
              f"tokens, the 8 requests {r['batch_s']:.1f} s; {smi}", flush=True)


def phase_hosts(rec: dict, args, smi: str) -> None:
    """HOSTS_PATHS, each run in this process (hosts_one), then as its rank
    processes (hosts_launch), then held to the one-process run
    (hosts_check): MiniCPM-2B as two TCP-joined hosts, Qwen2.5-14B at TP=2 x
    DP=2 over two emulated hosts (``--tp-backend nccl``: a GPU a rank, four
    needed)."""
    import shutil
    import tempfile

    if args.tp_backend == "nccl" and torch.cuda.device_count() < 4:
        raise RuntimeError(f"--phases hosts --tp-backend nccl runs a GPU a rank: 4 needed, "
                           f"{torch.cuda.device_count()} visible")
    tmp = tempfile.mkdtemp(prefix="zt-hosts-")
    try:
        for label in HOSTS_PATHS:
            t0 = time.monotonic()
            path_dir = os.path.join(tmp, label)
            os.makedirs(path_dir)
            one = hosts_one(rec, args, label, path_dir)
            hosts_launch(args, label, tmp)
            hosts_check(rec, args, smi, label, one, path_dir)
            print(f"hosts: {label}: {time.monotonic() - t0:.1f} s; {smi}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tp_one(rec: dict, args, label: str, path_dir: str) -> dict:
    """A tp path at TP=1 in this process: the requests (tp_drive; a check
    path: none), launch counters zeroed just before and read just after,
    every kernel of the path launched a multiple of the layer count; then
    the teacher-forced logits along its greedy tokens (a check path: tokens
    from the seed), their routing recorded, and the same one prompt at a
    time (the noise between two computations of one model). Writes what the
    ranks need to ``path_dir``; frees the weights."""
    import gc

    from zhilight_tpu_torch.llm import LLM

    cfg = tp_config(label, args)
    drive = TP_PATHS[label][5]
    prompts = tp_prompts(args.seed, cfg.vocab_size)
    t0 = time.monotonic()
    llm = LLM(model_config=cfg, params=tp_weights(label, args, cfg, "cuda"),
              engine_config=tp_engine_config(1), device="cuda")
    ex = llm.executor
    setup_s = time.monotonic() - t0
    warm_s = ex.warmup()
    n_params = sum(t.numel() for t in _leaves(ex.params))
    print(f"tp: {label}: {cfg.num_layers} layers, {n_params / 1e9:.2f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(ex.params)) / 2**30:.2f} GiB of "
          f"weights at TP=1, set-up {setup_s:.1f} s, warmup {warm_s:.1f} s", flush=True)
    counters = _tp_counters()
    score_routes = [] if label in TP_SCORED and cfg.moe.enabled else None
    score_calls = (tp_score_recorder(llm, counters, routes=score_routes) if label in TP_SCORED
                   else [])
    one = None
    if drive:
        one = tp_drive(llm, prompts, score=label in TP_SCORED)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        print(f"tp: {label} TP=1: requests {one['drive_s']:.1f} s; launches {launches}",
              flush=True)
        # teacher-forced along the TP=1 tokens: the batch's two prompts and
        # the 1500-token request's
        forced = dict(prompts=prompts["greedy"] + [prompts["greedy"][1]],
                      tokens=one["greedy"] + [one["long"]])
    else:
        # teacher-forced alone, along tokens from the seed
        fed = np.random.default_rng(args.seed + 21).integers(3, cfg.vocab_size, (2, TP_NEW))
        forced = dict(prompts=prompts["greedy"], tokens=fed.tolist())
    with open(os.path.join(path_dir, "forced.json"), "w") as f:
        json.dump(forced, f)
    routes = []
    before = {name: fn.launches for name, fn in counters.items()}
    want = tp_forced(ex, forced["prompts"], forced["tokens"], routes=routes)
    torch.cuda.synchronize()
    forced_launches = {name: fn.launches - before[name] for name, fn in counters.items()
                       if fn.launches != before[name]}
    if not drive:
        launches = {name: fn.launches for name, fn in counters.items()}
        print(f"tp: {label} TP=1: teacher-forced launches {launches}", flush=True)
    if routes:
        torch.save(routes, os.path.join(path_dir, "routes.pt"))
    del routes
    floor = torch.cat([tp_forced(ex, [p], [t]) for p, t in zip(forced["prompts"],
                                                                 forced["tokens"])])
    _tp_launches(rec, run_names(label)[0], launches, cfg.num_layers)
    if score_calls:
        # on the caller's thread: the call made while the batch decoded may
        # count the loop's launches too
        kinds = [c["kind"] for c in score_calls]
        short = [c for c in score_calls if any(c["launches"].get(name, 0) < cfg.num_layers
                                               for name in TP_SCORED[label])]
        if kinds != ["hidden", "score", "score", "score"] or short or not score_calls[0][
                "decoding"]:
            raise AssertionError(f"tp: {label} TP=1: the scoring calls {score_calls}")
        print(f"tp: {label} TP=1: scoring calls {kinds}, the first while "
              f"{score_calls[0]['decoding']} requests decoded; launches of the idle ones "
              f"{[c['launches'] for c in score_calls[1:]]}", flush=True)
        if score_routes is not None:
            # the calc_logits call's routing, which the TP=2 scoring calls share
            torch.save(score_routes[1], os.path.join(path_dir, "score_routes.pt"))
        del score_routes
    release_pool(llm)
    ex.params, llm, ex = None, None, None
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tp: {label}: TP=1 weights freed, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    smooth = None
    if TP_PATHS[label][4] == "int8":
        smooth = tp_smooth(args, label, cfg, "cuda", path_dir, forced)
        print(f"tp: {label} TP=1 SmoothQuant: calc_act_scales over {smooth['sites']} sites "
              f"({TP_CALIB[0]} prompts of {TP_CALIB[1]} tokens) {smooth['calib_s']:.1f} s, "
              f"quantized with alpha {TP_ALPHA} ({smooth['smooth_leaves']} smooth vectors), "
              f"{smooth['smooth_s']:.1f} s in all", flush=True)
    return dict(one=one, forced=forced, want=want, floor=floor, smooth=smooth,
                forced_launches=forced_launches)


def tp_launch(args, labels: list, tmp: str, world: int = 2) -> None:
    """The multi-rank run of every path in ``labels``: ``world`` rank
    processes (tp_rank), each path's results under ``tmp``; raises with a
    rank's log where one fails or outlasts TP_TIMEOUT a path."""
    port = _tp_free_port()
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r), "--tp-world",
         str(world), "--tp-port", str(port), "--tp-dir", tmp, "--tp-models", ",".join(labels),
         "--seed", str(args.seed), "--tp-backend", args.tp_backend, "--tp-gptq-layers",
         str(args.tp_gptq_layers)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            left = max(TP_TIMEOUT * len(labels) - (time.monotonic() - t0), 1)
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"tp: rank {r} exited {p.returncode}:\n{log[-6000:]}")
    print(f"tp: the multi-rank run of {len(labels)} paths, one launch of {world} rank "
          f"processes: {time.monotonic() - t0:.1f} s", flush=True)


def tp_check(rec: dict, args, smi: str, label: str, tp1: dict, path_dir: str) -> None:
    """A tp path's TP=2 run against its TP=1 run (``tp1``, tp_one's): both
    ranks' launches (every kernel of the path a multiple of the layer count),
    their collectives a forward (the expected ones), heads, expert stacks and
    latent pool; both finish every request with the same tokens, the sampled
    and the cancelled ones included, route every token to the same experts
    and score the same teacher-forced logits to the bit; rank 1 stops on
    rank 0's sentinel; the TP=2 greedy tokens against TP=1's (where they
    part, the teacher-forced rule, tp_compare); the W8A8 path's row-parallel
    product bit-equal to the unsharded one on both ranks, each planted fault
    caught. Decode tok/s and TTFT of both are printed, the TP=2 ones
    labelled as a gloo run."""
    nccl = args.tp_backend == "nccl"
    cfg = tp_config(label, args)
    drive = TP_PATHS[label][5]
    one, forced, want, floor = tp1["one"], tp1["forced"], tp1["want"], tp1["floor"]
    ranks = [json.load(open(os.path.join(path_dir, f"rank{r}.json"))) for r in range(2)]
    r0, r1 = ranks
    wall = r0["path_s"]
    for r in ranks:
        took = f"requests {r['drive_s']:.1f} s, " if "drive_s" in r else ""
        experts = f"{r['experts'][0]} experts a stack, " if r["experts"] else ""
        print(f"tp: {label} TP=2 rank {r['rank']} ({r['backend']}): {r['heads'][0]} / "
              f"{r['heads'][1]} heads, {experts}pool {r['pool']}, {r['weights_gib']:.2f} GiB "
              f"of weights, set-up {r['setup_s']:.1f} s, warmup {r['warmup_s']:.1f} s, "
              f"{took}teacher-forced {r['forced_s']:.1f} s, peak {r['peak_gib']:.1f} GiB, "
              f"{r['left_gib']:.1f} GiB left after the path; launches {r['launches']}",
              flush=True)
        _tp_launches(rec, f"{label}-TP2-rank{r['rank']}", r["launches"], cfg.num_layers)
    n_reduce = tp_collective_count(cfg)
    per_step = (n_reduce * r0["collectives_ms"]["all_reduce fp32 [4, d]"]
                + r0["collectives_ms"]["all_gather fp32 [4, V / tp]"])
    print(f"timing: {label} TP=2 ({r0['backend']}) one collective, host included, rank 0: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in r0["collectives_ms"].items())
          + f"; {n_reduce} all-reduces and one all-gather a decode step: "
            f"{per_step:.1f} ms; {smi}", flush=True)
    print(f"tp: {label} TP=2: a forward's collectives, rank 0, counted over the "
          f"teacher-forced run: {r0['collectives']}; row-parallel linears kept whole "
          f"(their input all-gathered): {r0['kept_whole']} of {2 * cfg.num_layers}",
          flush=True)
    if r0["collectives"] != r1["collectives"] or r0["kept_whole"] != r1["kept_whole"]:
        raise AssertionError(f"tp: {label}: the ranks' collectives differ: "
                             f"{r0['collectives']} / {r1['collectives']}")
    want_coll = tp_expected_collectives(label, cfg, r0["kept_whole"])
    if want_coll is not None and r0["collectives"] != want_coll:
        raise AssertionError(f"tp: {label}: a forward's collectives {r0['collectives']}, "
                             f"not {want_coll}")
    if r0["heads"] != [cfg.num_heads // 2, cfg.num_kv_heads // 2]:
        raise AssertionError(f"tp: {label}: rank heads {r0['heads']}")
    if cfg.moe.enabled and not r0["experts"] == r1["experts"] == [cfg.moe.num_experts // 2]:
        raise AssertionError(f"tp: {label}: expert stacks of {r0['experts']} / "
                             f"{r1['experts']} experts, not {cfg.moe.num_experts // 2}")
    if cfg.mla.enabled and r0["pool"][-1] != cfg.mla.latent_dim:
        raise AssertionError(f"tp: {label}: the latent pool {r0['pool']} is not whole")
    if drive and (r0["finished"] != r1["finished"] or not r0["finished"]):
        raise AssertionError(f"tp: {label}: the ranks finished the requests with other tokens")
    if r0["logits_sha"] != r1["logits_sha"]:
        raise AssertionError(f"tp: {label}: the ranks' teacher-forced logits differ")
    if cfg.moe.enabled and (r0["routings"] == 0 or r0.get("experts_sha")
                            != r1.get("experts_sha") or r0["routings"] != r1["routings"]):
        raise AssertionError(f"tp: {label}: the ranks routed other experts "
                             f"({r0['routings']} / {r1['routings']} routings)")
    if r1.get("sessions_left"):
        raise AssertionError(f"tp: {label}: rank 1 kept a session")
    if "w8a8_exact" in r0:
        for r in ranks:
            ex8 = r["w8a8_exact"]
            if ex8["equal"] != ex8["cases"] or ex8["cases"] != 2 * len(TP_W8A8_SHAPES) * len(
                    TP_W8A8_ROWS):
                raise AssertionError(f"tp: {label}: rank {r['rank']}: int8_linear's row-parallel "
                                     f"product equals the unsharded one in {ex8['equal']} of "
                                     f"{ex8['cases']} cases")
            if min(ex8["fault_max"] + ex8["fault_int32"]) == 0:
                raise AssertionError(f"tp: {label}: rank {r['rank']}: a planted fault gave the "
                                     f"unsharded product: {ex8}")
        ex8 = r0["w8a8_exact"]
        print(f"tp: {label}: int8_linear row-parallel at TP=2 rank shapes (K "
              f"{[k // 2 for k, _ in TP_W8A8_SHAPES]} of {[k for k, _ in TP_W8A8_SHAPES]}, N "
              f"5120, M {list(TP_W8A8_ROWS)}, with and without smooth): bit-equal to the "
              f"unsharded product in {ex8['equal']}/{ex8['cases']} cases on both ranks; planted "
              f"faults, each caught in every case: a rank-local absmax (no MAX) max rel err "
              f"{min(ex8['fault_max']):.3e} to {max(ex8['fault_max']):.3e}, no int32 sum "
              f"{min(ex8['fault_int32']):.3e} to {max(ex8['fault_int32']):.3e}; {smi}",
              flush=True)
    got = torch.from_numpy(np.load(os.path.join(path_dir, "tp2_logits.npy")))
    if not drive:
        msg = tp_compare(label, want, got, forced["tokens"], forced["tokens"], floor,
                         TP_PATHS[label][3], spread=label in TP_SPREAD_BOUND)
        print(f"tp: {label}: both ranks scored the same teacher-forced logits, bit for bit; "
              f"TP=2 path {wall:.1f} s on rank 0; TP=2 against TP=1, {msg}", flush=True)
        if tp1["smooth"] is not None:
            tp_smooth_check(label, tp1["smooth"], ranks, forced, path_dir, smi)
        return
    if not 2 <= len(r0["cancelled"]) < 4 * TP_NEW:
        raise AssertionError(f"tp: {label}: the cancelled request returned "
                             f"{len(r0['cancelled'])} tokens")
    routed = (f", routed {r0['routings']} times to the same experts" if cfg.moe.enabled
              else "")
    print(f"tp: {label}: both ranks finished {len(r0['finished'])} requests with the same "
          f"tokens (the sampled one: {r0['sampled'][:6]}..., the cancelled one after "
          f"{len(r0['cancelled'])} tokens){routed} and the same teacher-forced logits, bit "
          f"for bit; rank 1 stopped on rank 0's sentinel; TP=2 path {wall:.1f} s on rank 0",
          flush=True)
    same = sum(a == b for w, g in zip(one["greedy"], r0["greedy"]) for a, b in zip(w, g))
    print(f"tp: {label}: TP=2 greedy tokens equal TP=1's on "
          f"{same}/{TP_NEW * len(TP_LENS)} (batch of {len(TP_LENS)}); the 1500-token "
          f"request's on "
          f"{sum(a == b for a, b in zip(one['long'], r0['long']))}/{TP_NEW}", flush=True)
    msg = tp_compare(label, want, got, one["greedy"] + [one["long"]],
                     r0["greedy"] + [r0["long"]], floor, TP_PATHS[label][3])
    if cfg.moe.enabled:
        sr = r0["shared_routing"]
        msg += (f"; MoE routing shared with TP=1's: parted on {sr['parted']}/{sr['routed']} "
                f"token-layers, each a near tie (gap up to {sr['ratio']:.3f} x the "
                f"router-logit difference)")
    print(f"tp: {label}: TP=2 against TP=1, {msg}", flush=True)
    how = ("NCCL, a GPU a rank" if nccl else "gloo on one GPU: every collective goes "
           "through host memory, not an NCCL TP figure")
    if label in TP_SCORED:
        got_scores = {name: np.load(os.path.join(path_dir, f"tp2_score_{name}.npy"))
                      for name in ("logits", "hidden", "log_prob")}
        got_scores["greedy_match"] = r0["greedy_match"]
        msg = tp_score_check(label, cfg, one, got_scores, ranks)
        if "score_routing" in r0:
            sr = r0["score_routing"]
            msg += (f"; MoE routing shared with TP=1's calc_logits call: parted on "
                    f"{sr['parted']}/{sr['routed']} token-layers over the four calls, each a "
                    f"near tie (gap up to {sr['ratio']:.3f} x the router-logit difference)")
        print(f"tp: {label}: scoring through the loop of both ranks ({TP_LENS[1]}-token prompt; "
              f"calc_hidden_states while the greedy batch decoded), each call launching "
              f"{', '.join(TP_SCORED[label])} once a layer on each rank; TP=2 against TP=1, "
              f"{msg}", flush=True)
        print(f"timing: {label} calc_logits of {TP_LENS[1]} tokens, [{TP_LENS[1]}, "
              f"{cfg.vocab_size}] fp32 logits to the host: TP=1 (one process) "
              f"{one['calc_logits_ms']:.2f} ms, TP=2 ({how}) {r0['calc_logits_ms']:.2f} ms; "
              f"the four scoring calls {one['score_s']:.1f} s at TP=1, {r0['score_s']:.1f} s "
              f"at TP=2, of which the executor ran them {sum(c['s'] for c in r0['score_calls']):.1f} "
              f"s on rank 0, {sum(c['collectives_s'] for c in r0['score_calls']):.1f} s in "
              f"collectives; {smi}", flush=True)
    for what, r in (("TP=1 (one process)", one), (f"TP=2 ({how})", r0)):
        print(f"timing: {label} {what}: TTFT {r['ttft_ms']:.2f} ms for {TP_LENS[1]} tokens "
              f"(median of 3), batch-1 decode {r['decode_tok_s']:.2f} tok/s over {TP_NEW - 1} "
              f"tokens; {smi}", flush=True)


def pp_check(rec: dict, args, smi: str, label: str, tp1: dict, path_dir: str) -> None:
    """A pipelined path's multi-rank run (``tp_shape``: PP=2, or TP=2 x
    PP=2) against its one-process run (``tp1``, tp_one's): each rank holds
    its stage's layers, in a pool of those layers only, and its TP heads;
    launched every kernel of the path a multiple of its layers in the
    requests, and in the teacher-forced run each kernel its stage's share:
    the ranks of a column alike, their sum the one-process run's; moved the
    hidden state once a forward (a hand-off down the column, one broadcast
    from the last stage); every rank finished every request with rank 0's
    tokens (the sampled and cancelled ones included) and scored the same
    teacher-forced logits, bit for bit; those logits against the
    one-process run's (bit for bit, else within the path's tolerance by the
    teacher-forced rule, tp_compare), and the greedy tokens likewise; the
    scored path's calls (``calc_logits`` ...) against the one-process run's.
    Prints decode tok/s and TTFT beside the one-process run's and the time
    of a hand-off and a broadcast."""
    from zhilight_tpu_torch.parallel.sharding import stage_range

    tp, pp = tp_shape(label)
    cfg = tp_config(label, args)
    one, forced, want, floor = tp1["one"], tp1["forced"], tp1["want"], tp1["floor"]
    ranks = [json.load(open(os.path.join(path_dir, f"rank{r}.json"))) for r in range(tp * pp)]
    r0 = ranks[0]
    one_name, names = run_names(label)
    shape = f"TP={tp} x PP={pp}" if tp > 1 else f"PP={pp}"
    per_stage = cfg.num_layers // pp
    for r in ranks:
        stage = r["rank"] // tp
        print(f"pp: {label} {shape} rank {r['rank']} (stage {stage}, {r['backend']}): layers "
              f"{r['layers'][0]}-{r['layers'][-1]} ({len(r['layers'])}), a pool of "
              f"{r['pool_layers']} layers {r['pool']}, {r['heads'][0]} / {r['heads'][1]} heads, "
              f"{r['weights_gib']:.2f} GiB of weights, set-up {r['setup_s']:.1f} s, warmup "
              f"{r['warmup_s']:.1f} s, requests {r.get('drive_s', 0.0):.1f} s, teacher-forced "
              f"{r['forced_s']:.1f} s, peak {r['peak_gib']:.1f} GiB; launches {r['launches']}; "
              f"moves a forward {r['moves']}", flush=True)
        _tp_launches(rec, names[r["rank"]], r["launches"], per_stage)
        if (r["layers"] != list(range(*stage_range(cfg, stage, pp)))
                or r["pool_layers"] != per_stage):
            raise AssertionError(f"pp: {label}: rank {r['rank']} holds layers {r['layers']} in a "
                                 f"pool of {r['pool_layers']}")
        if r["heads"] != [cfg.num_heads // tp, cfg.num_kv_heads // tp]:
            raise AssertionError(f"pp: {label}: rank {r['rank']}'s heads {r['heads']}")
        want_moves = {"from_last": 1.0}
        if stage < pp - 1:
            want_moves["send"] = 1.0
        if stage > 0:
            want_moves["recv"] = 1.0
        if r["moves"] != want_moves:
            raise AssertionError(f"pp: {label}: rank {r['rank']} moved {r['moves']} a forward, "
                                 f"not {want_moves}")
    want_launches = tp1["forced_launches"]
    for t in range(tp):
        column = [ranks[s * tp + t] for s in range(pp)]
        summed = {n: sum(c["forced_launches"].get(n, 0) for c in column) for n in want_launches}
        if (summed != want_launches or any(c["forced_launches"] != column[0]["forced_launches"]
                                           for c in column)):
            raise AssertionError(f"pp: {label}: teacher-forced launches "
                                 f"{[c['forced_launches'] for c in column]} of a column, not "
                                 f"{want_launches} between them")
    print(f"pp: {label} {shape}: teacher-forced launches, each rank "
          f"{r0['forced_launches']} ({per_stage} of {cfg.num_layers} layers), a column's sum "
          f"equal to the one-process run's {want_launches}", flush=True)
    if any(r["finished"] != r0["finished"] for r in ranks) or not r0["finished"]:
        raise AssertionError(f"pp: {label}: the ranks finished the requests with other tokens")
    if any(r["logits_sha"] != r0["logits_sha"] for r in ranks):
        raise AssertionError(f"pp: {label}: the ranks' teacher-forced logits differ")
    if any(r.get("sessions_left") for r in ranks):
        raise AssertionError(f"pp: {label}: a rank kept a session")
    if not 2 <= len(r0["cancelled"]) < 4 * TP_NEW:
        raise AssertionError(f"pp: {label}: the cancelled request returned "
                             f"{len(r0['cancelled'])} tokens")
    got = torch.from_numpy(np.load(os.path.join(path_dir, "tp2_logits.npy")))
    bits = torch.equal(got, want)
    msg = tp_compare(label, want, got, one["greedy"] + [one["long"]],
                     r0["greedy"] + [r0["long"]], floor, TP_PATHS[label][3])
    same = sum(a == b for w, g in zip(one["greedy"] + [one["long"]], r0["greedy"] + [r0["long"]])
               for a, b in zip(w, g))
    bits_txt = ("equal the one-process run's bit for bit" if bits
                else "differ from the one-process run's")
    print(f"pp: {label}: every rank finished {len(r0['finished'])} requests with rank 0's "
          f"tokens (the sampled one: {r0['sampled'][:6]}..., the cancelled one after "
          f"{len(r0['cancelled'])} tokens) and scored the same teacher-forced logits, bit for "
          f"bit; {shape} teacher-forced logits {bits_txt}; greedy tokens equal on "
          f"{same}/{TP_NEW * (len(TP_LENS) + 1)}; {shape} against PP=1, {msg}", flush=True)
    if label in TP_SCORED:
        got_scores = {name: np.load(os.path.join(path_dir, f"tp2_score_{name}.npy"))
                      for name in ("logits", "hidden", "log_prob")}
        got_scores["greedy_match"] = r0["greedy_match"]
        smsg = tp_score_check(label, cfg, one, got_scores, ranks, layers=per_stage)
        sbits = all(np.array_equal(got_scores[k], one["scores"][k])
                    for k in ("logits", "hidden", "log_prob"))
        sbits_txt = "equal PP=1's bit for bit" if sbits else "differ from PP=1's"
        print(f"pp: {label}: scoring through the loop of every rank ({TP_LENS[1]}-token prompt), "
              f"each call launching {', '.join(TP_SCORED[label])} once a layer of its stage; "
              f"calc_logits, calc_hidden_states and calc_log_prob {sbits_txt}; {shape} against "
              f"PP=1, {smsg}", flush=True)
        print(f"timing: {label} calc_logits of {TP_LENS[1]} tokens: PP=1 "
              f"{one['calc_logits_ms']:.2f} ms, {shape} {r0['calc_logits_ms']:.2f} ms; {smi}",
              flush=True)
    how = "NCCL, a GPU a rank" if args.tp_backend == "nccl" else "gloo on one GPU"
    moves = r0["moves_ms"]
    step = moves["hand-off bf16 [4, d]"] + moves["from_last bf16 [4, d]"]
    print(f"timing: {label} {shape} ({how}) one move of the hidden state, host included, rank "
          f"0: " + ", ".join(f"{k} {v:.3f} ms" for k, v in moves.items())
          + f"; a decode step's hand-off and broadcast: {step:.3f} ms; {smi}", flush=True)
    for what, r in (("PP=1 (one process)", one), (f"{shape} ({how})", r0)):
        print(f"timing: {label} {what}: TTFT {r['ttft_ms']:.2f} ms for {TP_LENS[1]} tokens "
              f"(median of 3), batch-1 decode {r['decode_tok_s']:.2f} tok/s over {TP_NEW - 1} "
              f"tokens; {smi}", flush=True)


def tp_smooth_check(label: str, one: dict, ranks: list, forced: dict, path_dir: str,
                    smi: str) -> None:
    """SmoothQuant at TP=2 against TP=1 (tp_smooth's results): both ranks'
    ``calc_act_scales`` whole vectors, bit-equal between the ranks, each
    within 2e-2 of TP=1's largest entry; each rank's shard quantized with
    TP=1's scales equal, leaf for leaf, to that rank's shard of TP=1's
    quantized tree; the calibrated model's teacher-forced logits held to
    TP=1's by the path's rule (tp_compare, TP_SPREAD_BOUND), the ranks'
    bit-equal."""
    r0, r1 = (r["smooth"] for r in ranks)
    spread = max(r0["scales_rel"].values())
    if r0["scales_sha"] != r1["scales_sha"] or not (r0["scales_whole"] and r1["scales_whole"]):
        raise AssertionError(f"tp: {label}: the ranks' act scales differ, or are not whole")
    if spread > 2e-2 or len(r0["scales_rel"]) != one["sites"]:
        raise AssertionError(f"tp: {label}: TP=2 act scales {spread:.3e} of the largest entry "
                             f"from TP=1's over {len(r0['scales_rel'])} sites")
    for r, sq in enumerate((r0, r1)):
        if not sq["leaves_equal"] == sq["leaves_want"] == sq["leaves"] or not sq["leaves"]:
            raise AssertionError(f"tp: {label}: rank {r}'s calibrated shard equals TP=1's shard "
                                 f"on {sq['leaves_equal']} of {sq['leaves_want']} leaves")
    if r0["logits_sha"] != r1["logits_sha"]:
        raise AssertionError(f"tp: {label}: the ranks' calibrated teacher-forced logits differ")
    got = torch.from_numpy(np.load(os.path.join(path_dir, "tp2_smooth_logits.npy")))
    msg = tp_compare(f"{label}-SmoothQuant", one["logits"], got, forced["tokens"],
                     forced["tokens"], one["floor"], TP_PATHS[label][3],
                     spread=label in TP_SPREAD_BOUND)
    print(f"tp: {label} SmoothQuant at TP=2: calc_act_scales on both ranks ({TP_CALIB[0]} "
          f"prompts of {TP_CALIB[1]} tokens, {r0['calib_s']:.1f} s), whole vectors bit-equal "
          f"between the ranks, {spread:.3e} of the largest entry from TP=1's at most (tolerance "
          f"2e-2); each rank's shard quantized with TP=1's scales equal to its shard of TP=1's "
          f"quantized tree on {r0['leaves_equal']} / {r1['leaves_equal']} of {r0['leaves']} "
          f"leaves ({r0['smooth_leaves']} smooth vectors a rank); the calibrated model's "
          f"teacher-forced logits, both ranks bit-equal, TP=2 against TP=1: {msg}; {smi}",
          flush=True)


def _tp_launches(rec: dict, label: str, launches: dict, layers: int) -> None:
    """Add a tp run's launches to the record; every kernel of its path
    launched, a multiple of ``layers`` times (once a layer a forward), and
    no other."""
    for name, n in launches.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"][label] = n
    expect = PATHS[label]
    if any(launches[name] == 0 or launches[name] % layers for name in expect):
        raise AssertionError(f"{label}: a kernel of the path never launched, or not once a "
                             f"layer a forward ({layers} layers): {launches}")
    if any(n for name, n in launches.items() if name not in expect):
        raise AssertionError(f"{label}: a kernel of another path launched: {launches}")


def _tp_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def env_switch(name: str, on: bool):
    """``name=1`` in the environment for the enclosed block only (unset when
    ``on`` is false): ZT_FP8_KEEP as the loader reads it, ZT_NO_PACKED_KV as
    ``new_kv_cache`` reads it, ZT_WINDOW_KV and ZT_FUSED_KV as ``ModelExecutor``
    reads them."""
    old = os.environ.pop(name, None)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def load_qwen3_fp8(label: str, seed: int, layers: int, keep: bool):
    """Qwen3-8B-FP8 at ``layers`` layers from HF-format FP8 tensors made from
    ``seed`` on the GPU, converted by the port's map_hf_params one layer at a
    time into ``LLM``: kept in FP8 (ZT_FP8_KEEP=1) or dequantized at load."""
    from zhilight_tpu_torch.config import QuantConfig, adapt_hf_config
    from zhilight_tpu_torch.llm import LLM

    hf = dict(QWEN3_8B_FP8, num_hidden_layers=layers)
    cfg, qcfg = adapt_hf_config(hf), QuantConfig.from_hf_config(hf)
    t0 = time.monotonic()
    with env_switch("ZT_FP8_KEEP", keep):
        params, n_tensors = map_hf_params_by_layer(qwen3_fp8_hf_tensors(hf, seed), cfg, "fp8")
    load_s = time.monotonic() - t0
    llm = LLM(model_config=cfg, quant_config=qcfg, params=params,
              engine_config=qwen_engine_config(), device="cuda")
    gate = llm.executor.params["layers"][str(layers - 1)]["mlp"]["gate_proj"]
    kinds = {k: (str(v.dtype), tuple(v.shape)) for k, v in gate.items()}
    print(f"serve: {label}: {n_tensors} HF tensors made from seed {seed} on the GPU and converted "
          f"by map_hf_params(fp8) layer by layer in {load_s:.1f} s (ZT_FP8_KEEP "
          f"{'1' if keep else 'unset'}); {qcfg.quant_type.name}, qk_norm {cfg.qk_norm}; last "
          f"layer's gate_proj {kinds}", flush=True)
    H, FF = hf["hidden_size"], hf["intermediate_size"]
    want = ({"w_f8": ("torch.float8_e4m3fn", (H, FF)), "block_scale": ("torch.float32", (H // 128, FF // 128))}
            if keep else {"w": ("torch.bfloat16", (H, FF))})
    if kinds != want:
        raise AssertionError(f"{label}: gate_proj is {kinds}, not {want}")
    return llm


def fp8_default_load_path(args) -> None:
    """The loader's two branches against each other on the card, at 4 layers:
    the same FP8 tensors dequantized at load (served by the library's bf16
    product) and kept in FP8 (served by the kernel)."""
    label = "Qwen3-8B-FP8-4-layers"
    kept = load_qwen3_fp8(label + "-kept", args.seed, 4, keep=True)
    release_pool(kept)
    deq = load_qwen3_fp8(label + "-dequantized-at-load", args.seed, 4, keep=False)
    counters = _counters()
    prompt = np.random.default_rng(args.seed).integers(3, deq.model_config.vocab_size, 100).tolist()
    counters["fp8_block_matmul"].launches = 0
    want = _prefill_logits(deq.executor, prompt)
    if counters["fp8_block_matmul"].launches:
        raise AssertionError(f"{label}: the dequantized model launched the FP8 kernel")
    got = _prefill_logits(kept.executor, prompt)
    n = counters["fp8_block_matmul"].launches
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"serve: {label}: first-token logits, weights kept in FP8 ({n} kernel launches) vs "
          f"dequantized at load (torch.matmul): max rel err {rel:.3e} (tolerance {LOGIT_TOL}); "
          f"argmax {int(got.argmax())} vs {int(want.argmax())}", flush=True)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()) or n != 4 * 7:
        raise AssertionError(f"{label}: non-finite logits, or {n} launches instead of 28")
    if rel > LOGIT_TOL or int(got.argmax()) != int(want.argmax()):
        raise AssertionError(f"{label}: the loader's two branches differ: {rel} > {LOGIT_TOL}")
    release_pool(deq)


def w8a8_path(llm, rec: dict, args) -> None:
    """W8A8 on MiniCPM-2B: calibrate the bf16 model's activation scales on four
    seeded 512-token sequences, quantize its linears to int8 with SmoothQuant,
    serve from the int8 tree; then ``int8_linear`` on the card against the
    same call on the CPU at the model's projection shapes."""
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.ops.quant import int8_linear, quantize_int8_weight
    from zhilight_tpu_torch.utils.quant_convert import quantize_int8_params

    label, cfg = "MiniCPM-2B-W8A8", llm.model_config
    rng = np.random.default_rng(args.seed + 5)
    calib = [rng.integers(3, cfg.vocab_size, 512).tolist() for _ in range(4)]
    t0 = time.monotonic()
    scales = llm.calc_act_scales(calib, calib_len=512)
    calib_s = time.monotonic() - t0
    t0 = time.monotonic()
    qparams = quantize_int8_params(llm.executor.params, scales, alpha=0.5)
    torch.cuda.synchronize()
    quant_s = time.monotonic() - t0
    if len(scales) != 7 * cfg.num_layers or not all(np.isfinite(v).all() for v in scales.values()):
        raise AssertionError(f"{label}: {len(scales)} activation scales")
    llm8 = LLM(model_config=cfg, params=qparams, engine_config=llm.engine_config, device="cuda")
    down = llm8.executor.params["layers"]["0"]["mlp"]["down_proj"]
    kinds = {k: (str(v.dtype), tuple(v.shape)) for k, v in down.items()}
    print(f"serve: {label}: calc_act_scales on 4 x 512 tokens in {calib_s:.2f} s "
          f"({len(scales)} sites), quantize_int8_params on the GPU in {quant_s:.2f} s; layer-0 "
          f"down_proj {kinds}", flush=True)
    if kinds != {"w_q": ("torch.int8", (cfg.dim_ff, cfg.dim_model)),
                 "scale": ("torch.float32", (cfg.dim_model,)),
                 "smooth": ("torch.float32", (cfg.dim_ff,))}:
        raise AssertionError(f"{label}: down_proj is {kinds}")
    serve_path(label, llm8, rec, args.seed, compare_plain=False)
    args.llms[label] = llm8
    release_pool(llm8)

    # int8_linear, card against CPU: M = 8 goes through the zero-padded torch._int_mm
    worst = 0.0
    for K, N in ((2304, 2304), (2304, 5760), (5760, 2304)):
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) / np.sqrt(K)
        w_q, scale = quantize_int8_weight(w)
        for smooth in (False, True):
            p = {"w_q": w_q, "scale": scale}
            if smooth:
                p["smooth"] = torch.from_numpy((rng.random(K) + 0.5).astype(np.float32))
            for M in (8, 512):
                x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
                want = int8_linear(p, x).float()
                got = int8_linear({k: v.cuda() for k, v in p.items()}, x.cuda()).float().cpu()
                e = ((got - want).abs().max() / want.abs().max()).item()
                if not (torch.isfinite(got).all() and e <= INT8_TOL):
                    raise AssertionError(f"int8_linear K={K} N={N} M={M} smooth={smooth}: "
                                         f"max rel err {e} > {INT8_TOL}")
                worst = max(worst, e)
    print(f"serve: {label}: int8_linear on the card vs the CPU at 2304 x 2304, 2304 x 5760 and "
          f"5760 x 2304, with and without smooth, M = 8 and 512: max rel err {worst:.3e} "
          f"(tolerance {INT8_TOL})", flush=True)


def phase_serve(rec: dict, args) -> None:
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    lap = lap_timer("serve")
    cfg = minicpm_2b()
    t0 = time.monotonic()
    params = L.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    ecfg = EngineConfig(
        max_model_len=4096,
        cache=CacheConfig(page_size=16),
        scheduler=SchedulerConfig(max_batch=16, chunk_size=512),
    )
    llm = LLM(model_config=cfg, params=params, engine_config=ecfg, device="cuda")
    print(f"serve: MiniCPM-2B set-up {time.monotonic() - t0:.1f} s", flush=True)
    serve_path("MiniCPM-2B", llm, rec, args.seed)
    args.llms["MiniCPM-2B"] = llm
    release_pool(llm)
    lap("MiniCPM-2B")
    window_path("MiniCPM-2B-window", llm, ecfg, rec, args)
    lap("MiniCPM-2B-window")
    w8a8_path(llm, rec, args)
    lap("MiniCPM-2B-W8A8")

    llm = load_qwen(args.seed)
    _, bf16_first = serve_path("Qwen2.5-14B-GPTQ-Int4", llm, rec, args.seed)
    args.llms["Qwen2.5-14B-GPTQ-Int4"] = llm
    release_pool(llm)
    lap("Qwen2.5-14B-GPTQ-Int4 (load included)")

    # the same leaves (making them is most of the load time) behind an int8 pool
    label = "Qwen2.5-14B-GPTQ-Int4-int8kv"
    pool_bytes = lambda c: sum(a.numel() * a.element_size() for arrays in c.arrays() for a in arrays)
    llm8 = LLM(model_config=llm.model_config, quant_config=llm.quant_config,
               params=llm.executor.params, engine_config=qwen_engine_config("int8"),
               device="cuda")
    ex8 = llm8.executor
    print(f"serve: {label}: int8 pool of {ex8.num_pages} pages x {ex8.page_size} = "
          f"{ex8.cache.num_slots} tokens, {pool_bytes(ex8.cache) / 1e9:.3f} GB with its scales "
          f"({ex8._kv_bytes_per_token()} bytes per token; the bf16 pool takes "
          f"{llm.executor._kv_bytes_per_token()})", flush=True)
    prompts, _ = serve_path(label, llm8, rec, args.seed)
    pool_rows_and_scoring(label, llm8, prompts, bf16_first)
    args.llms[label] = llm8
    release_pool(llm8)
    lap(label)
    window_path("Qwen2.5-14B-GPTQ-Int4-int8kv-window", llm, qwen_engine_config("int8"), rec, args)
    lap("Qwen2.5-14B-GPTQ-Int4-int8kv-window")
    fp16_qwen_path(rec, args, llm)
    lap("Qwen2.5-14B-GPTQ-Int4-fp16")

    label = "DeepSeek-V2-Lite-GPTQ-Int4"
    hf = dict(DEEPSEEK_V2_LITE_GPTQ, num_hidden_layers=SERVE_DEEPSEEK_LAYERS)
    llm = load_deepseek(label, hf, args.seed)
    ex = llm.executor
    print(f"serve: {label}: latent pool of {ex.num_pages} pages x {ex.page_size} = "
          f"{ex.cache.num_slots} tokens, {pool_bytes(ex.cache) / 1e9:.3f} GB "
          f"({ex._kv_bytes_per_token()} bytes per token)", flush=True)
    serve_path(label, llm, rec, args.seed, DEEPSEEK_LENS)
    if not ex.cache.is_latent:
        raise AssertionError(f"{label}: the serving pool is not a latent pool")
    # rows the requests wrote are non-zero
    pool_rows(label, ex, ex.cache.latent[0][0].float().abs().sum(-1) != 0, "latent pool")
    args.llms[label] = llm
    release_pool(llm)
    lap(f"{label} (load included)")
    window_path("DeepSeek-V2-Lite-GPTQ-Int4-window", llm, deepseek_engine_config(), rec, args,
                DEEPSEEK_LENS)
    lap("DeepSeek-V2-Lite-GPTQ-Int4-window")
    fused_path("DeepSeek-V2-Lite-GPTQ-Int4-fused", llm, deepseek_engine_config(), rec, args,
               DEEPSEEK_LENS)
    lap("DeepSeek-V2-Lite-GPTQ-Int4-fused")

    dense_expert_path(args)
    lap("DeepSeek-V2-Lite bf16 experts, 4 layers")

    label = "Qwen3-8B-FP8"
    llm = load_qwen3_fp8(label, args.seed, QWEN3_8B_FP8["num_hidden_layers"], keep=True)
    ex = llm.executor
    print(f"serve: {label}: bf16 pool of {ex.num_pages} pages x {ex.page_size} = "
          f"{ex.cache.num_slots} tokens, {pool_bytes(ex.cache) / 1e9:.3f} GB "
          f"({ex._kv_bytes_per_token()} bytes per token)", flush=True)
    serve_path(label, llm, rec, args.seed)
    args.llms[label] = llm
    release_pool(llm)
    lap(f"{label} (load included)")
    fp8_default_load_path(args)
    lap("Qwen3-8B-FP8, 4 layers kept and dequantized")

    danube_paths(rec, args)
    lap("H2O-Danube-1.8B paths")
    no_packed_kv_path(rec, args)
    lap("ZT_NO_PACKED_KV")
    head_dim_256_int8_path(rec, args)
    lap("head_dim 256 int8")


def danube_engine_config(kv_dtype: str = "bfloat16"):
    """Batch 8, max_model_len 4096 (prompts of up to 3712 tokens and their 32
    new ones), 512-token chunks; the pool is sized from the free memory."""
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig

    return EngineConfig(
        max_model_len=4096,
        cache=CacheConfig(page_size=16, kv_dtype=kv_dtype),
        scheduler=SchedulerConfig(max_batch=8, chunk_size=512),
    )


def danube_paths(rec: dict, args) -> None:
    """H2O-Danube-1.8B at full width and depth, random weights from the seed:
    head_dim 80, so slot-major K and V pools, over bf16 and over int8."""
    from zhilight_tpu_torch.config import adapt_hf_config
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    t0 = time.monotonic()
    cfg = adapt_hf_config(DANUBE_1_8B)
    params = L.init_params(cfg, seed=args.seed, device="cuda")
    pool_bytes = lambda c: sum(a.numel() * a.element_size() for arrays in c.arrays() for a in arrays)
    bf16_first = None
    for kv_dtype, label in (("bfloat16", "H2O-Danube-1.8B"), ("int8", "H2O-Danube-1.8B-int8kv")):
        llm = LLM(model_config=cfg, params=params, engine_config=danube_engine_config(kv_dtype),
                  device="cuda")
        ex = llm.executor
        cache = ex.cache
        if cache.packed or tuple(cache.k[0].shape) != (1, cache.num_slots, 8, 80):
            raise AssertionError(f"{label}: the pool is not slot-major [1, N, 8, 80]: "
                                 f"{tuple(cache.k[0].shape)}")
        print(f"serve: {label}: {kv_dtype} slot-major pools of {ex.num_pages} pages x "
              f"{ex.page_size} = {cache.num_slots} tokens, {pool_bytes(cache) / 1e9:.3f} GB "
              f"({ex._kv_bytes_per_token()} bytes per token); sliding window "
              f"{cfg.sliding_window}", flush=True)
        prompts, first = serve_path(label, llm, rec, args.seed)
        if kv_dtype == "int8":
            pool_rows_and_scoring(label, llm, prompts, bf16_first)
        else:
            bf16_first = first
        args.llms[label] = llm
        release_pool(llm)
    fused_path("H2O-Danube-1.8B-fused", args.llms["H2O-Danube-1.8B"], danube_engine_config(),
               rec, args)
    print(f"serve: H2O-Danube-1.8B paths in {time.monotonic() - t0:.1f} s", flush=True)


def no_packed_kv_path(rec: dict, args) -> None:
    """The layout check: rows the reference writes through ``paged_write_rows``
    (Hkv % 8 == 0, D % 128 == 0) reach a slot-major pool only under
    ZT_NO_PACKED_KV=1, where the port writes them through the slot-major
    prologue at head_dim 128. A 4-layer bf16 model at Qwen2.5-14B's attention
    geometry (d 5120, 40 / 8 heads of 128; weights from the seed), the switch
    set while its executor builds its pool, serves four requests; then its
    first-token and decode-step logits over a slot-major cache against the
    same weights over the packed pool."""
    from zhilight_tpu_torch.config import adapt_hf_config
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    t0 = time.monotonic()
    label = "Qwen2.5-14B-geometry-4-layers-ZT_NO_PACKED_KV"
    hf = {k: v for k, v in QWEN14B_GPTQ.items() if k != "quantization_config"}
    cfg = adapt_hf_config(dict(hf, num_hidden_layers=4))
    params = L.init_params(cfg, seed=args.seed, device="cuda")
    with env_switch("ZT_NO_PACKED_KV", True):
        llm = LLM(model_config=cfg, params=params, engine_config=qwen_engine_config(),
                  device="cuda")
    ex = llm.executor
    if ex.cache.packed or tuple(ex.cache.k[0].shape[2:]) != (8, 128):
        raise AssertionError(f"{label}: the pool is not slot-major [1, N, 8, 128]")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in (100, 513, 1500, 16)]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    with DynamicBatchGenerator(llm) as gen:
        results = gen.batch_generate(prompts, GeneratorArg(max_length=8), timeout=300)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"][label] = n
    print(f"serve: {label}: {len(prompts)} requests, "
          f"{[len(r.outputs[0].token_ids) for r in results]} tokens; launches {launches}",
          flush=True)
    expect = ("rope_write_rows_pair", "paged_decode_attention")
    if any(launches[n] == 0 for n in expect) or any(
            n for name, n in launches.items() if name not in expect):
        raise AssertionError(f"{label}: launched {launches}, expected only {expect}")

    # the same forward over a slot-major and over a packed scratch cache
    with env_switch("ZT_NO_PACKED_KV", True):
        first_sm = _prefill_logits(ex, prompts[0])
        step_sm, _ = _decode_step_logits(ex, prompts)
    first_pk = _prefill_logits(ex, prompts[0])
    step_pk, _ = _decode_step_logits(ex, prompts)
    rel_first = ((first_sm - first_pk).abs().max() / first_pk.abs().max()).item()
    scale = step_pk.abs().amax(-1)
    rel_step = ((step_sm - step_pk).abs().amax(-1) / scale).max().item()
    same = int((step_sm.argmax(-1) == step_pk.argmax(-1)).sum())
    print(f"serve: {label}: logits over slot-major vs packed pools: first token max rel err "
          f"{rel_first:.3e}, argmax {int(first_sm.argmax())} vs {int(first_pk.argmax())}; "
          f"decode step (batch {len(prompts)}) max rel err {rel_step:.3e}, argmax same on "
          f"{same}/{len(prompts)} rows (tolerance {LOGIT_TOL}); {time.monotonic() - t0:.1f} s",
          flush=True)
    if not (torch.isfinite(first_sm).all() and torch.isfinite(step_sm).all()):
        raise AssertionError(f"{label}: non-finite logits")
    if (rel_first > LOGIT_TOL or rel_step > LOGIT_TOL or same != len(prompts)
            or int(first_sm.argmax()) != int(first_pk.argmax())):
        raise AssertionError(f"{label}: slot-major and packed pools give other logits")
    release_pool(llm)


def head_dim_256_int8_path(rec: dict, args) -> None:
    """An int8 pool at head_dim 256, which the reference packs head-major: a
    4-layer Llama-family model at Gemma-2-9B's attention geometry (d 3584,
    16 / 8 heads of 256, ff 14336, vocab 256000; weights from the seed),
    ``kv_dtype="int8"``, serves four requests with the launch counters zeroed
    just before and read just after; then its first-token and decode-step
    logits against the plain path."""
    from zhilight_tpu_torch.config import ModelConfig
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    t0 = time.monotonic()
    label = "Gemma-2-9B-geometry-4-layers-int8kv"
    cfg = ModelConfig(model_type="llama", num_layers=4, dim_model=3584, num_heads=16,
                      dim_head=256, num_kv_heads=8, dim_ff=14336, vocab_size=256000,
                      dtype="bfloat16")
    llm = LLM(model_config=cfg, params=L.init_params(cfg, seed=args.seed, device="cuda"),
              engine_config=qwen_engine_config("int8"), device="cuda")
    ex = llm.executor
    if not (ex.cache.packed and ex.cache.quantized and ex.cache.k[0].shape[-1] == 512):
        raise AssertionError(f"{label}: the pool is not an int8 head-major [8, N, 512] pool")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in (100, 513, 1500, 16)]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    with DynamicBatchGenerator(llm) as gen:
        results = gen.batch_generate(prompts, GeneratorArg(max_length=8), timeout=300)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"][label] = n
    print(f"serve: {label}: {len(prompts)} requests, "
          f"{[len(r.outputs[0].token_ids) for r in results]} tokens; launches {launches}",
          flush=True)
    expect = PATHS[label]
    if any(launches[n] == 0 for n in expect) or any(
            n for name, n in launches.items() if name not in expect):
        raise AssertionError(f"{label}: launched {launches}, expected only {expect}")
    if any(len(r.outputs[0].token_ids) != 8 and r.outputs[0].finish_reason != "stop"
           for r in results):
        raise AssertionError(f"{label}: a request ended early")

    got = _prefill_logits(ex, prompts[1])
    with plain_kernels():
        want = _prefill_logits(ex, prompts[1])
    rel_first = ((got - want).abs().max() / want.abs().max()).item()
    step, step_plain = _decode_step_logits(ex, prompts)
    scale = step_plain.abs().amax(-1)
    rel_step = ((step - step_plain).abs().amax(-1) / scale).max().item()
    same = int((step.argmax(-1) == step_plain.argmax(-1)).sum())
    print(f"serve: {label}: logits kernel vs plain: first token max rel err {rel_first:.3e}, "
          f"argmax {int(got.argmax())} vs {int(want.argmax())}; decode step (batch "
          f"{len(prompts)}) max rel err {rel_step:.3e}, argmax same on {same}/{len(prompts)} "
          f"rows (tolerance {LOGIT_TOL}); {time.monotonic() - t0:.1f} s", flush=True)
    if not all(torch.isfinite(t).all() for t in (got, want, step, step_plain)):
        raise AssertionError(f"{label}: non-finite logits")
    if (rel_first > LOGIT_TOL or rel_step > LOGIT_TOL or same != len(prompts)
            or int(got.argmax()) != int(want.argmax())):
        raise AssertionError(f"{label}: kernel and plain logits differ")
    release_pool(llm)
    del llm, ex
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase: timing (bench.py's method)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# http: the OpenAI server (zhilight_tpu_torch.server.openai) over MiniCPM-2B

# the server's and the tokenizer's packages, reported as the card has them
SERVING_PACKAGES = ("aiohttp", "pydantic", "transformers", "tokenizers", "safetensors",
                    "prometheus_client")
HTTP_LENS = [7, 100, 513, 1500, 16, 250, 40, 900]  # characters (= tokens) of 8 prompts
HTTP_MAXLEN = 32
HTTP_PROMPT = "the quick brown"  # under one page: no prefix match on either run
# a prompt of 3 full pages and one that shares its first 2 (page_size 16)
PREFIX_PAIR = ("a" * 7 + " shared system prompt of two pages" + " x" * 7,
               "a" * 7 + " shared system prompt of two pages, then another question")


class CharTokenizer:
    """A character-level tokenizer for the http phase (test scaffolding, as
    tests/test_openai_server.py's ToyTokenizer): a character is one id in
    [3, vocab_size), an id decodes to a letter, chat messages concatenate."""

    def __init__(self, vocab_size: int, eos_token_id: int = 2):
        self.vocab_size, self.eos_token_id = vocab_size, eos_token_id

    def encode(self, text):
        return [3 + ord(c) % (self.vocab_size - 3) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + int(i) % 26) for i in ids if int(i) >= 3)

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True, **kw):
        return self.encode("".join(m["content"] or "" for m in messages))


def _http_prompts(seed: int):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    return ["".join(rng.choice(letters, n)) for n in HTTP_LENS]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _generation_tokens(text: str) -> float:
    for line in text.splitlines():
        if line.startswith("zhilight_generation_tokens_total "):
            return float(line.split()[1])
    raise AssertionError("/metrics has no zhilight_generation_tokens_total")


async def _sse(resp, t0: float):
    """(parsed data chunks, seconds from ``t0`` to the first chunk after the
    role chunk) of a streamed response, holding the ``[DONE]`` sentinel."""
    chunks, first = [], None
    async for raw in resp.content:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            return chunks, first
        chunk = json.loads(data)
        if first is None and not chunk["choices"][0]["delta"].get("role"):
            first = time.monotonic() - t0
        chunks.append(chunk)
    raise AssertionError("a stream ended without data: [DONE]")


async def http_layer(engine, tok, prompts, chats, label: str, smi: str) -> dict:
    """The server in-process on the loopback (aiohttp's TestServer): health
    and models, one greedy completion alone, 8 concurrent completions, 8
    concurrent streamed chats (other prompts, so that no prefix is cached), a
    request sharing 2 pages of prefix with another, and /metrics. Returns the completion's text (to hold against
    ``generate``) and the tokens served."""
    from aiohttp.test_utils import TestClient, TestServer

    from zhilight_tpu_torch.server.openai.api_server import build_app

    client = TestClient(TestServer(build_app(engine, label), host="127.0.0.1"))
    await client.start_server()
    try:
        r = await client.get("/health")
        _require(r.status == 200, f"/health {r.status}")
        r = await client.get("/v1/models")
        _require((await r.json())["data"][0]["id"] == label, "/v1/models")
        r = await client.get("/metrics")
        before = _generation_tokens(await r.text())

        r = await client.post("/v1/completions", json={
            "prompt": HTTP_PROMPT, "max_tokens": HTTP_MAXLEN, "temperature": 0})
        _require(r.status == 200, f"/v1/completions {r.status}: {await r.text()}")
        solo = await r.json()
        served = solo["usage"]["completion_tokens"]

        body = lambda p: {"prompt": p, "max_tokens": HTTP_MAXLEN, "temperature": 0,
                          "ignore_eos": True}

        async def complete(p):
            r = await client.post("/v1/completions", json=body(p))
            _require(r.status == 200, f"/v1/completions {r.status}: {await r.text()}")
            return await r.json()

        t0 = time.monotonic()
        outs = await asyncio.gather(*(complete(p) for p in prompts))
        wall = time.monotonic() - t0
        for p, out in zip(prompts, outs):
            c, u = out["choices"][0], out["usage"]
            _require(c["finish_reason"] == "length", f"finish_reason {c['finish_reason']}")
            _require(u["prompt_tokens"] == len(tok.encode(p)) and
                  u["completion_tokens"] == HTTP_MAXLEN and
                  u["total_tokens"] == u["prompt_tokens"] + HTTP_MAXLEN, f"usage {u}")
            _require(len(c["text"]) <= HTTP_MAXLEN, f"text of {len(c['text'])} characters")
        tokens = sum(o["usage"]["completion_tokens"] for o in outs)
        served += tokens

        async def chat(p):
            t0 = time.monotonic()
            r = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": p}], "max_tokens": HTTP_MAXLEN,
                "temperature": 0, "ignore_eos": True, "stream": True})
            _require(r.status == 200, f"/v1/chat/completions {r.status}")
            chunks, ttft = await _sse(r, t0)
            last = chunks[-1]
            _require(last["choices"][0]["finish_reason"] == "length", f"stream finish {last}")
            _require(last["usage"]["completion_tokens"] == HTTP_MAXLEN, f"stream usage {last}")
            text = "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks)
            _require(len(text) <= HTTP_MAXLEN, f"streamed text of {len(text)} characters")
            return ttft

        t0 = time.monotonic()
        ttfts = await asyncio.gather(*(chat(p) for p in chats))
        chat_wall = time.monotonic() - t0
        served += len(chats) * HTTP_MAXLEN

        for p in PREFIX_PAIR:
            out = await complete(p)
            served += out["usage"]["completion_tokens"]

        r = await client.get("/metrics")
        counted = _generation_tokens(await r.text()) - before
        _require(counted == served, f"/metrics counted {counted} generated tokens, {served} served")
    finally:
        await client.close()
    print(f"http: {label}: 8 concurrent completions (prompts of {min(HTTP_LENS)} to "
          f"{max(HTTP_LENS)} tokens, {HTTP_MAXLEN} new each): {tokens} tokens in {wall:.3f} s "
          f"= {tokens / wall:.1f} tok/s aggregate; 8 concurrent streamed chats in "
          f"{chat_wall:.3f} s, client TTFT median {statistics.median(ttfts) * 1e3:.1f} ms, "
          f"max {max(ttfts) * 1e3:.1f} ms; {smi}", flush=True)
    print(f"http: {label}: /metrics zhilight_generation_tokens_total rose by {counted:.0f} = "
          f"the {served} tokens served", flush=True)
    return dict(text=solo["choices"][0]["text"], finish=solo["choices"][0]["finish_reason"])


def below_http(gen, tok, prompts, label: str) -> dict:
    """The layer under the server on the same path: string prompts through
    ``DynamicBatchGenerator``, a stop string, streaming through
    ``IncrementalDetokenizer`` and the shared-prefix pair."""
    from zhilight_tpu_torch.engine import GeneratorArg

    greedy = lambda **kw: GeneratorArg(max_length=HTTP_MAXLEN, temperature=0.0, **kw)
    solo = gen.generate(HTTP_PROMPT, greedy()).outputs[0]
    results = gen.batch_generate(prompts, greedy(ignore_eos=True))
    for p, r in zip(prompts, results):
        out = r.outputs[0]
        _require(r.input_tokens_num == len(tok.encode(p)), "prompt tokens")
        _require(len(out.token_ids) == HTTP_MAXLEN and out.finish_reason == "length",
              f"{len(out.token_ids)} tokens, {out.finish_reason}")
        _require(out.text == tok.decode(out.token_ids), "text is not the decoded tokens")
    # a stop string: 3 letters of a greedy output of the same prompt alone
    full = gen.generate(HTTP_PROMPT, greedy(ignore_eos=True)).outputs[0].text
    _require(len(full) >= 8, f"a greedy output of {len(full)} characters")
    stop = full[5:8]
    cut = gen.generate(HTTP_PROMPT, greedy(ignore_eos=True, stop_strings=[stop])).outputs[0]
    _require(cut.finish_reason == "stop" and cut.text == full[: full.find(stop)],
          f"stop string {stop!r}: {cut.text!r}, {cut.finish_reason}")
    # streaming: the increments concatenate to the output's text
    parts = list(gen.stream_generate(prompts[2], greedy(ignore_eos=True)))
    streamed, final = "".join(p["text"] for p in parts), parts[-1]["output"]
    _require(streamed == final.text, "streamed text differs from the output's")
    for p in PREFIX_PAIR:
        gen.generate(p, greedy())
    print(f"http: {label}: string prompts, a stop string ({stop!r}: {len(cut.text)} of "
          f"{len(full)} characters, finish stop) and a stream of {len(parts)} increments "
          f"through IncrementalDetokenizer", flush=True)
    return dict(text=solo.text, finish=solo.finish_reason)


def phase_http(rec: dict, args, smi: str) -> None:
    import importlib

    from zhilight_tpu_torch import native
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
    from zhilight_tpu_torch.llm import LLM
    from zhilight_tpu_torch.models import llama as L

    found = {}
    for name in SERVING_PACKAGES:  # the phase's one conditional: what the card has
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "imports")
        except ImportError:
            found[name] = None
    t0 = time.monotonic()
    lib = native.load()
    print("http: packages: " + ", ".join(f"{n} {v or 'does not import'}"
                                         for n, v in found.items())
          + f"; native library built and loaded in {time.monotonic() - t0:.2f} s: {lib._name}",
          flush=True)
    missing = [n for n in ("aiohttp", "pydantic") if found[n] is None]

    label, cfg = "MiniCPM-2B-http", minicpm_2b()
    base = args.llms.get("MiniCPM-2B")
    params = base.executor.params if base else L.init_params(cfg, seed=args.seed, device="cuda")
    tok = CharTokenizer(cfg.vocab_size)
    llm = LLM(model_config=cfg, params=params, tokenizer=tok, device="cuda",
              engine_config=EngineConfig(
                  max_model_len=4096, cache=CacheConfig(page_size=16, enable_prefix_caching=True),
                  scheduler=SchedulerConfig(max_batch=16, chunk_size=512)))
    prompts = _http_prompts(args.seed)
    try:
        warm = llm.executor.warmup()
        gen = DynamicBatchGenerator(llm).start()
        try:
            alloc = gen.scheduler.allocator
            _require(type(alloc) is native.NativePageAllocator, f"the scheduler's allocator is "
                  f"{type(alloc).__name__}, not the native one")
            matched = []  # pages each admission's prefix match returned
            match = alloc.match_prefix

            def spy(tokens):
                pages, n = match(tokens)
                matched.append(len(pages))
                return pages, n

            alloc.match_prefix = spy
            print(f"http: {label}: {cfg.num_layers} layers, d {cfg.dim_model}, vocab "
                  f"{cfg.vocab_size}, {llm.executor.num_pages} KV pages, prefix caching on the "
                  f"native allocator, warmup {warm:.1f} s", flush=True)
            counters = _counters()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.monotonic()
            if missing:
                print(f"http: HTTP layer not run on this machine: {', '.join(missing)} "
                      f"do not import", flush=True)
                got = below_http(gen, tok, prompts, label)
            else:
                from zhilight_tpu_torch.server.openai.serving import AsyncEngine

                got = asyncio.run(http_layer(AsyncEngine(llm, gen), tok, prompts,
                                             _http_prompts(args.seed + 1), label, smi))
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            wall = time.monotonic() - t0
            alloc.match_prefix = match
            hits = matched[-1]  # the pair's second request came last
            _require(hits > 0, f"no prefix hit on the native allocator: pages matched {matched}")
            print(f"http: {label}: the prefix pair's second request matched {hits} cached "
                  f"pages on the native allocator", flush=True)
            # the completion against generate alone on the same LLM
            ref = [gen.generate(HTTP_PROMPT, GeneratorArg(max_length=HTTP_MAXLEN,
                                                          temperature=0.0)).outputs[0]
                   for _ in range(2)]
        finally:
            gen.stop()
    finally:
        release_pool(llm)
    for name, n in launches.items():
        rec[name]["launches"] += n
        rec[name]["launches_by_path"][label] = n
    print(f"http: {label}: drove the path in {wall:.2f} s; launches {launches}", flush=True)
    if any(launches[name] == 0 for name in PATHS[label]):
        raise AssertionError(f"{label}: a kernel of the path never launched: {launches}")
    if any(n for name, n in launches.items() if name not in PATHS[label]):
        raise AssertionError(f"{label}: a kernel of another path launched: {launches}")
    _require(ref[0].text == ref[1].text, "two runs of generate alone differ")
    _require((got["text"], got["finish"]) == (ref[0].text, ref[0].finish_reason),
          f"the completion {got} differs from generate's {ref[0].text!r}, "
          f"{ref[0].finish_reason}")
    print(f"http: {label}: the greedy completion equals generate alone on the same LLM "
          f"({len(ref[0].text)} characters, finish {ref[0].finish_reason}); two runs of "
          f"generate agree", flush=True)


TIMING = {  # path -> (decode batch, context, time sampled decode too, TTFT prompt or 0 for none)
    "MiniCPM-2B": (16, 512, True, 3712),
    "Qwen2.5-14B-GPTQ-Int4": (8, 3712, False, 3712),
    "Qwen2.5-14B-GPTQ-Int4-int8kv": (8, 3712, False, 3712),
    "Qwen2.5-14B-GPTQ-Int4-fp16": (8, 3712, False, 0),  # decode only: its kernels a step
    "DeepSeek-V2-Lite-GPTQ-Int4": (8, 2816, False, 2816),
    "Qwen3-8B-FP8": (8, 3712, False, 3712),
    "MiniCPM-2B-W8A8": (16, 512, False, 0),  # decode only: prefill adds nothing the bf16 path lacks
    "H2O-Danube-1.8B": (8, 3712, False, 3712),
    "H2O-Danube-1.8B-int8kv": (8, 3712, False, 0),  # decode only: the int8 prefill is the gather
    # window side-KV changes decode only
    "MiniCPM-2B-window": (16, 512, False, 0),
    "Qwen2.5-14B-GPTQ-Int4-int8kv-window": (8, 3712, False, 0),
    "DeepSeek-V2-Lite-GPTQ-Int4-window": (8, 2816, False, 0),
    # fused write + attend changes decode only
    "H2O-Danube-1.8B-fused": (8, 3712, False, 0),
    "DeepSeek-V2-Lite-GPTQ-Int4-fused": (8, 2816, False, 0),
}


# prompt length of the traced prefill where it is not the TTFT prompt: a
# DeepSeek-V2-Lite prompt of 2816 tokens is some 101,000 launches, and tracing
# them took about 95 s of the script's 1200; one 512-token chunk shows the same
# breakdown
PROFILED_PREFILL = {"DeepSeek-V2-Lite-GPTQ-Int4": 512}


def phase_timing(args, smi: str) -> None:
    if not args.llms:
        raise RuntimeError("timing needs the serve phase")
    for label, llm in args.llms.items():
        ex = llm.executor
        t0 = time.monotonic()
        ex.cache = ex.new_cache(ex.num_pages)  # the serve phase released it
        timing_path(label, ex, *TIMING[label], smi)
        release_pool(llm)
        print(f"timing: {label}: measured and traced in {time.monotonic() - t0:.1f} s", flush=True)


def timing_path(label: str, ex, BATCH: int, CTX: int, sampled_too: bool, PROMPT: int,
                smi: str) -> None:
    from zhilight_tpu_torch.models.base import PrefillMeta
    from zhilight_tpu_torch.ops.sampling import SamplingParams

    dev = ex.device
    # 5 pipelined windows (10 before the tp phase joined the run, which must
    # stay within its time limit)
    S, WINDOWS, K = ex.page_size, 5, ex.decode_window
    # pages for the context and every step of the timed windows
    MAX_PAGES = min((CTX + (WINDOWS + 1) * K) // S + 1, ex.num_pages // BATCH)
    page_tables = np.stack([b * MAX_PAGES + np.arange(MAX_PAGES) for b in range(BATCH)]).astype(np.int32)
    positions = np.full(BATCH, CTX - 1, np.int32)
    context_lens = np.full(BATCH, CTX, np.int32)
    limits = np.full(BATCH, MAX_PAGES * S - 1, np.int32)
    tokens = np.zeros(BATCH, np.int32)
    greedy = SamplingParams.greedy(BATCH, device=dev)
    sampled = SamplingParams.greedy(BATCH, device=dev)
    sampled.temperature.fill_(0.8)
    sampled.top_p.fill_(0.9)

    def run(sp=greedy, **kw):
        return ex.run_decode_multi(tokens, page_tables, positions, context_lens, limits, sp, K,
                                   greedy_only=sp is greedy, **kw)

    def decode_tok_s(sp):
        run(sp)
        t0 = time.perf_counter()
        pending = None
        for _ in range(WINDOWS):
            handle = run(sp, reuse_carry=True, fetch=False)
            if pending is not None:
                ex.fetch(pending)
            pending = handle
        ex.fetch(pending)
        return BATCH * K * WINDOWS / (time.perf_counter() - t0)

    tok_s = decode_tok_s(greedy)
    sampled_tok_s = decode_tok_s(sampled) if sampled_too else None
    if not PROMPT:
        print(f"timing: {label}: decode {tok_s:.2f} tok/s greedy (batch {BATCH}, context {CTX}, "
              f"window {K}, {WINDOWS} windows); {ex.cfg.num_layers} layers; {smi}", flush=True)
        print(json.dumps({"path": label, "decode_tok_s": tok_s, "sampled_decode_tok_s": None,
                          "ttft_ms": None, "gpu": smi}), flush=True)
        profile(f"{label} decode window", lambda: run(reuse_carry=True), steps=K)
        return

    CHUNK = 512
    n_pages = (PROMPT + 1 + S - 1) // S
    prompt = np.random.RandomState(0).randint(2, 1000, PROMPT).astype(np.int32)
    sp1 = SamplingParams.greedy(1, device=dev)
    pt_np = np.full(ex.max_pages_per_seq, -1, np.int32)
    pt_np[:n_pages] = np.arange(n_pages)
    pt_dev = torch.from_numpy(pt_np).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def prefill_once(length=PROMPT):
        n_chunks = (length + CHUNK - 1) // CHUNK
        c = 0
        while c < n_chunks:
            start = c * CHUNK
            chunk = min(CHUNK, length - start)
            is_last = c + 1 == n_chunks
            chainable = (n_chunks - 1) - c
            if not is_last and chunk == CHUNK and chainable >= 2:
                C = next((x for x in ex.CHAIN_SIZES if x <= chainable), None)
                if C is not None:
                    ex.run_chunk_chain(prompt[start : start + C * CHUNK].reshape(C, CHUNK), pt_dev, start)
                    c += C
                    continue
            bucket = ex.pick_bucket(chunk)
            toks = np.zeros(bucket, np.int32)
            toks[:chunk] = prompt[start : start + chunk]
            if not is_last:
                ex.run_chunk_fused(toks, pt_dev, start, chunk)
                c += 1
                continue
            pos = np.zeros(bucket, np.int32)
            pos[:chunk] = np.arange(start, start + chunk)
            slots = np.full(bucket, -1, np.int32)
            slots[:chunk] = np.arange(start, start + chunk)
            meta = PrefillMeta(
                positions=torch.from_numpy(pos).to(dev),
                slot_mapping=torch.from_numpy(slots).to(dev),
                page_table=pt_dev, cache_len=torch.tensor(start, **i32),
                q_len=torch.tensor(chunk, **i32),
            )
            tok, _, _, _ = ex.run_prefill(toks, meta, sp1, 0, 0)
            c += 1
        return tok

    prefill_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_once()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    sampled_txt = (f", {sampled_tok_s:.2f} tok/s sampled (temperature 0.8, top_p 0.9)"
                   if sampled_too else "")
    print(f"timing: {label}: decode {tok_s:.2f} tok/s greedy{sampled_txt} (batch {BATCH}, "
          f"context {CTX}, window {K}, {WINDOWS} windows); TTFT {ttft_ms:.2f} ms (prompt "
          f"{PROMPT}, chunk {CHUNK}); {ex.cfg.num_layers} layers; {smi}", flush=True)
    print(json.dumps({"path": label, "decode_tok_s": tok_s, "sampled_decode_tok_s": sampled_tok_s,
                      "ttft_ms": ttft_ms, "gpu": smi}), flush=True)

    # where the time goes: one traced decode window and one traced prefill,
    # after the timed runs (the trace does not touch the numbers above)
    profile(f"{label} decode window", lambda: run(reuse_carry=True), steps=K)
    traced = PROFILED_PREFILL.get(label, PROMPT)
    profile(f"{label} prefill {traced}", lambda: prefill_once(traced))


def profile(what: str, fn, steps: int = 0) -> None:
    """Device busy share and the kernels that take most device time in one
    traced call (torch.profiler, CUPTI); with ``steps``, the launches per
    decode step too."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    launches = sum(e.count for e in events)
    per_step = f" ({launches / steps:.1f} per step)" if steps else ""
    print(f"profile: {what}: wall {wall_ms:.2f} ms (traced), device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernels{per_step}", flush=True)
    for e in top:
        print(f"profile: {what}:   {e.self_device_time_total / 1e3:8.3f} ms "
              f"({100 * e.self_device_time_total / 1e3 / busy_ms:4.1f}% of busy)  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,multimodal,tp,serve,http",
                    help="comma-separated, run in order; timing (after serve), pp4 and hosts "
                         "are not in the default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-csrc", default="",
                    help="an earlier tree's zhilight_tpu_torch/csrc: build its kv_write.cu, "
                         "kv_write_2d.cu, kv_write_pair.cu and kv_flush.cu apart and time the "
                         "rope + row-write sequence and the per-layer window flush through "
                         "them beside this tree's prologues and layered flush in the kernels "
                         "phase")
    ap.add_argument("--tp-gptq-layers", type=int, default=TP_GPTQ_LAYERS,
                    help="the tp phase's Qwen2.5-14B GPTQ-Int4 path's depth (full width; 48 "
                         "as it ships)")
    ap.add_argument("--tp-backend", default="gloo", choices=["gloo", "nccl"],
                    help="the tp, pp4 and hosts phases' groups: gloo, every rank on the one "
                         "GPU (the default), or nccl, a GPU a rank (raises with fewer than 2, or "
                         "4 for pp4 and hosts)")
    # one rank of the tp phase's TP=2 run (the phase starts these itself)
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--tp-models", default="", help=argparse.SUPPRESS)
    # one rank process of the hosts phase (the phase starts these itself)
    ap.add_argument("--hosts-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--hosts-path", default="", help=argparse.SUPPRESS)
    ap.add_argument("--hosts-port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.llms = {}
    phases = [p for p in args.phases.split(",") if p]

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here", file=sys.stderr)
        return 1
    if args.tp_rank is not None:
        return tp_rank(args)
    if args.hosts_rank is not None:
        return hosts_rank(args)
    from zhilight_tpu_torch.ops.cuda import _build

    smi = nvidia_smi()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    _build.build_all()
    print(f"build: {len(_build.SOURCES)} CUDA libraries in {time.monotonic() - t0:.1f} s",
          flush=True)
    print("build: seconds to each library's end: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in _build.build_seconds.items()), flush=True)
    for name, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)
    print("kernels: " + ", ".join(f"{k} ({v['source']})" for k, v in KERNELS.items()), flush=True)

    rec = {name: dict(name=name, route="cuda", **meta, launches=0, launches_by_path={},
                      max_abs_err=None,
                      ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                      library_ms=None)
           for name, meta in KERNELS.items()}
    failed = []
    for phase in phases:
        t0 = time.monotonic()
        try:
            if phase == "kernels":
                phase_kernels(rec, args)
            elif phase == "multimodal":
                phase_multimodal(rec, args, smi)
            elif phase == "tp":
                phase_tp(rec, args, smi)
            elif phase == "pp4":
                phase_pp4(rec, args, smi)
            elif phase == "hosts":
                phase_hosts(rec, args, smi)
            elif phase == "serve":
                phase_serve(rec, args)
            elif phase == "http":
                phase_http(rec, args, smi)
            elif phase == "timing":
                phase_timing(args, smi)
            else:
                raise ValueError(f"unknown phase {phase!r}")
        except Exception:
            traceback.print_exc()
            print(f"phase {phase}: FAILED", flush=True)
            failed.append(phase)
        print(f"phase {phase}: {time.monotonic() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
