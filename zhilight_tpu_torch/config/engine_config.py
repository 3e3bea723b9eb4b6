"""Engine / batching / distribution configuration.

Replaces the reference's three config tiers — ``DynBatchConfig``
(src/model/dyn_batch_context.h:29-49, zhilight/dynamic_batch.py:17-86),
``DistConfig`` (zhilight/config/dist_config.py:6-33) and the environment-flag
registry (zhilight/config/dev_config.py:9-55) — with one structured,
TPU-oriented config. All shape-affecting knobs (buckets, pages, slots) are
explicit here because on TPU they determine what gets compiled.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["SchedulerConfig", "CacheConfig", "ParallelConfig", "EngineConfig"]


@dataclass(frozen=True)
class CacheConfig:
    """Paged KV-cache shape/budget configuration.

    The reference grows per-task ragged buffers and defragments
    (3rd/bmengine allocator.cpp, src/kvcache/transformer_buffer.h). TPU needs
    static shapes, so the cache is one preallocated paged pool; capacity is
    expressed in pages up front.
    """

    page_size: int = 16                  # tokens per KV page
    num_pages: int = 0                   # 0 => auto-size from HBM budget
    # fraction of free HBM to use for KV when num_pages == 0
    hbm_utilization: float = 0.9
    reserved_hbm_mb: int = 1024          # analogue of RESERVE_MEM_MB
    kv_dtype: str = "bfloat16"           # "int8" => quantized KV cache
    # prefix cache (token-prefix page reuse)
    enable_prefix_caching: bool = False


@dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching scheduler knobs (reference DynBatchConfig parity)."""

    max_batch: int = 32                  # decode slots
    # KV token budget: caps the paged pool (and so admission control).
    # 0 => auto (size the pool from free HBM; 8192 on CPU). Set explicitly
    # to bound KV memory below what HBM sizing would take.
    max_total_token: int = 0
    max_queue_size: int = 1024
    chunk_size: int = 512                # chunked-prefill chunk (token bucket)
    # prefill length buckets (token counts) for compile-shape control
    prefill_buckets: Tuple[int, ...] = (128, 512, 2048, 8192)
    # packed multi-sequence prefill ("encode groups", reference
    # fill_encode_input): up to this many tasks' chunks fuse into one
    # program when several prompts are waiting. < 2 disables packing.
    prefill_pack: int = 4
    # only chunks up to this many tokens join a pack (longer chunks are
    # already MXU-efficient alone; this bounds the packed program to
    # prefill_pack * pack_chunk_cap tokens)
    pack_chunk_cap: int = 512
    # decode batch buckets; () => always max_batch (single compiled shape)
    decode_buckets: Tuple[int, ...] = ()
    max_beam_size: int = 8
    eos_id: int = 2
    # additional EOS ids (HF generation_config.json eos_token_id lists, e.g.
    # Llama-3 eot_id); () => just eos_id. Any member stops generation.
    eos_ids: Tuple[int, ...] = ()
    bos_id: int = 1
    ignore_eos: bool = False
    keep_eos: bool = False
    seed: int = 0
    # run logits / attention softmax accumulation in fp32
    high_precision: bool = True
    # decode steps fused into one device program (host syncs once per window;
    # tokens feed back on device). 0 => auto: 8 on TPU, 1 elsewhere.
    decode_multi_step: int = 0
    # idle sessions are evicted (KV pages freed) after this many seconds;
    # 0 disables TTL. Under page pressure the LRU idle session is evicted
    # regardless of TTL.
    session_ttl: float = 600.0
    # fraction of a task's max_length counted against the free-KV budget at
    # admission. 1.0 reserves the worst case (no task can ever stall on
    # pages); < 1.0 admits optimistically — most generations stop well before
    # max_length — relying on preemption as the pressure valve (reference
    # SwapBuf flow, batch_generator.cpp:329-358).
    admission_reserve: float = 1.0
    # what preemption does with the victim's KV: "swap" offloads the pages to
    # host RAM and restores them on resume (reference SwapBuf); "recompute"
    # drops them and re-prefills prompt+generated tokens (cheaper than the
    # transfer for short contexts; the only mode on multi-host meshes, where
    # per-host shard offload isn't wired).
    preempt_mode: str = "swap"


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh description.

    Replaces reference DistConfig(tp, dist_init_addr, nnodes, node_rank)
    + the NCCL/thread-per-GPU engine (3rd/bmengine engine.cpp:94-140).
    On TPU this is just a `jax.sharding.Mesh` spec; multi-host via
    jax.distributed.
    """

    tp: int = 1                          # model (tensor-parallel) axis size
    dp: int = 1                          # data-parallel axis size (attention-DP for MLA)
    pp: int = 1                          # pipeline-parallel stages (layer ranges;
                                         # memory-capacity lever — reference
                                         # recommends TP first, so do we)
    ep: int = 0                          # expert-parallel size; 0 => fold into tp
    # multi-host
    num_hosts: int = 1
    host_rank: int = 0
    coordinator_address: Optional[str] = None

    @property
    def num_devices(self) -> int:
        return self.tp * self.dp * self.pp


@dataclass(frozen=True)
class EngineConfig:
    model_path: str = ""
    dtype: str = "bfloat16"
    max_model_len: int = 8192
    cache: CacheConfig = field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
