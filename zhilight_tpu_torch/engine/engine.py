"""Model executor: owns the weights, the paged KV pool and the sampler state,
and runs the model steps the scheduler asks for.

Counterpart of ``zhilight_tpu/engine/engine.py``. Where the reference
compiles one XLA program per step kind and shape, the port runs PyTorch
eagerly on one device: a prefill chunk (cache writes only), a chunk chain
(consecutive full chunks, a Python loop here), a last chunk with first-token
sampling, a packed group of chunks, and decode windows of K steps in which
sampled tokens, positions and context lengths stay on the device, so the
host synchronises once per window (:meth:`fetch`). Host arrays reach the
device through :meth:`upload` (pinned, asynchronous), so dispatching a step
never waits for the device.

The KV pool is in the model's dtype, or int8 with fp32 scales under
``CacheConfig(kv_dtype="int8")``; an MLA model's is a latent pool in the
model's dtype. The pool-row operations (:meth:`copy_slots`
for beam search, :meth:`swap_out_rows` / :meth:`swap_in_rows` for swap
preemption) move rows of every array of the cache, so they serve both kinds;
:meth:`run_score` / :meth:`run_hidden` run a whole sequence on a scratch cache.

With ``ZT_WINDOW_KV=1`` in the environment when the executor is built, decode
windows keep each layer's new rows in side buffers and write the pool once at
the window's end (:meth:`_use_side_window` says when), as the reference's
``ZT_WINDOW_KV=1`` does. With ``ZT_FUSED_KV=1`` there, the decode steps that
take no side buffer write each layer's new rows inside the attention kernel
(``DecodeMeta.fused``; over slot-major model-dtype pools and latent pools
only, as the reference routes it). Both switches are read once, when the
executor is built; the reference reads them when it traces a decode program.

Under tensor parallelism (``ParallelConfig(tp=N)`` and a
``parallel.comm.TPGroup`` of N ranks, one process a rank) the executor holds
its rank's shard of the weights and a pool of its own ``num_kv_heads / tp``
heads, in every layout (an MLA model's latent pool whole on every rank, each
rank writing the same rows into its replica, as the reference replicates it:
``zhilight_tpu/engine/engine.py:264-272``); the model all-reduces and
all-gathers across the ranks, and every rank's scheduler runs in lockstep
through ``plane`` (``parallel.control_plane.DistPlane``). The pool-row
operations move the rank's own rows. Scoring (:meth:`run_score`) runs collectives too, so every
rank must call it together.

Under pipeline parallelism (``ParallelConfig(pp=P)``, alone or with ``tp``, and
the rank's column, a ``parallel.comm.PPGroup`` of P stages) the executor holds
its stage's layers (``parallel.sharding.stage_range``) and a pool of those
layers only, and every model call goes through ``models/pipeline.py``'s
``PPForwards``; every rank of the world runs the scheduler in lockstep and
samples the same logits with the same generators. As the reference gates
them, the fused chunk meta, packed prefill and window side-KV are off under
PP (``ZT_WINDOW_KV=1`` then decodes per step); ``ZT_FUSED_KV=1`` is not
gated, the reference gating it by pool kind only.

Under data parallelism (``ParallelConfig(dp=D)``, alone or with ``tp``) each
of the D replicas holds the same shards and runs the same batch, as the
reference's mesh replicates everything over its ``dp`` axis; over several
hosts (``num_hosts``) each host's ranks are ranks of the same lockstep loop.
The plane (``parallel.control_plane.make_control_plane``) spans them all:
``DistPlane`` where they share one ``torch.distributed`` world, ``TcpPlane``
(relayed within a host by ``RelayPlane``) where the hosts share none. Swap
preemption falls back to recompute over several hosts, as in the reference.

``ZT_STACK=1`` changes nothing here. The reference stacks the layers of a
homogeneous model and scans one layer body over one layer-major pool
(``zhilight_tpu/models/stacked.py``) so that XLA compiles a program whose
size does not grow with depth, and it promises the per-layer loop's tokens.
A PyTorch forward is the per-layer loop whatever the layout, so the port
keeps its per-layer pools and paths and gives those tokens. Under the switch
the reference's pool-row operations move layer 0's rows only
(``zhilight_tpu/engine/engine.py:742-824``); the port's move every layer's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..config.engine_config import SchedulerConfig
from ..kvcache.paged import KVCache, new_kv_cache, new_latent_cache
from ..models import llama as llama_mod
from ..models.base import DecodeMeta, PackedPrefillMeta, PrefillMeta
from ..models.pipeline import PPForwards
from ..ops.sampling import (
    SamplerState,
    SamplingParams,
    new_sampler_state,
    record_tokens,
    sample_step,
)
from ..parallel.control_plane import make_control_plane
from ..parallel.sharding import check_pp, rank_config, stage_range

__all__ = ["ModelExecutor"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class ModelExecutor:
    """Holds device state and runs the model steps for one model."""

    # full chunks run back to back by run_chunk_chain, longest first
    CHAIN_SIZES = (8, 4, 2)

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        engine_cfg: EngineConfig,
        device,
        tp=None,
        pp=None,
    ):
        pcfg = engine_cfg.parallel
        check_pp(cfg, pcfg.pp, pcfg)
        if pcfg.tp != (tp.world if tp is not None else 1):
            raise ValueError(f"tp={pcfg.tp} needs a tensor-parallel group of {pcfg.tp} ranks")
        if pcfg.pp != (pp.stages if pp is not None else 1):
            raise ValueError(f"pp={pcfg.pp} needs a pipeline group of {pcfg.pp} stages")
        if engine_cfg.cache.kv_dtype not in ("bfloat16", "int8", cfg.dtype):
            raise NotImplementedError(f"KV dtype {engine_cfg.cache.kv_dtype} is not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the reference accumulates bf16 products in fp32 and runs fp32
            # products in full fp32: no reduced-precision split-K reductions,
            # no TF32
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # under tensor parallelism (``tp``, a parallel.comm.TPGroup of world
        # > 1) ``params`` is this rank's shard and the model runs on the
        # rank's heads (parallel.sharding.rank_config); every rank runs the
        # scheduler loop in lockstep through the control plane
        self.tp = tp if tp is not None and tp.world > 1 else None
        # under pipeline parallelism (``pp``, the rank's column) the rank
        # holds its stage's layers [lo, hi) and runs the stage's forwards
        self.pp = pp if pp is not None and pp.stages > 1 else None
        self.layers = ((0, cfg.num_layers) if self.pp is None
                       else stage_range(cfg, self.pp.stage, self.pp.stages))
        self.model = llama_mod if self.pp is None else PPForwards(self.pp, self.layers)
        if self.tp is not None:
            cfg = rank_config(cfg, self.tp.world)
        # every rank of the world (and every host) runs the scheduler in
        # lockstep through the plane; one process alone, through a local one
        self.plane = make_control_plane(pcfg)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.sched_cfg = self._trim_buckets(engine_cfg)
        self.cache_cfg = engine_cfg.cache
        self.rope = llama_mod.build_rope(cfg, engine_cfg.max_model_len)
        self.params = params

        self.page_size = self.cache_cfg.page_size
        # one page count for the world, the smallest rank's (over every
        # host, TCP-joined ones too): every rank replays rank 0's admission
        # and preemption against its own allocator, so the allocators must
        # agree (the reference sizes one pool for its whole mesh)
        self.num_pages = self.plane.all_min(self._decide_num_pages())
        self.max_pages_per_seq = _round_up(engine_cfg.max_model_len, self.page_size) // self.page_size
        self.max_batch = self.sched_cfg.max_batch

        self.cache: KVCache = self.new_cache(self.num_pages)
        self.sampler_state: SamplerState = new_sampler_state(
            self.max_batch, cfg.vocab_size, self.device
        )
        # one random stream per slot, seeded when a task takes the slot
        self.generators = [torch.Generator(device=self.device) for _ in range(self.max_batch)]
        for slot, g in enumerate(self.generators):
            g.manual_seed(slot)
        self._scratch_generator = torch.Generator(device=self.device)

        # decode window: steps run per host synchronisation
        ms = self.sched_cfg.decode_multi_step
        self.decode_window = ms if ms > 0 else (8 if self.device.type == "cuda" else 1)
        # device-resident decode window carry (see run_decode_multi)
        self._decode_carry: Optional[tuple] = None
        # window side-KV, read once per executor as the reference reads it
        # once per decode program
        self.window_kv = os.environ.get("ZT_WINDOW_KV") == "1"
        # fused write + attend in decode steps, read once likewise
        self.fused_kv = os.environ.get("ZT_FUSED_KV") == "1"

    # ------------------------------------------------------------------
    # sizing
    # ------------------------------------------------------------------
    @staticmethod
    def _trim_buckets(engine_cfg: EngineConfig) -> SchedulerConfig:
        """Drop prefill buckets no chunk can fill: chunks are capped at
        ``chunk_size`` (and the model length)."""
        sc = engine_cfg.scheduler
        cap = min(sc.chunk_size, _round_up(engine_cfg.max_model_len, 128))
        cover = next((b for b in sc.prefill_buckets if b >= cap), None)
        bks = tuple(b for b in sc.prefill_buckets if cover is None or b <= cover)
        if not bks:
            bks = (_round_up(cap, 128),)
        if bks == sc.prefill_buckets:
            return sc
        return dataclasses.replace(sc, prefill_buckets=bks)

    def _kv_bytes_per_token(self) -> int:
        """Pool bytes one token takes over all layers: K and V elements in
        the pool's dtype and, for an int8 pool, their two fp32 scales; for an
        MLA model one latent row (2 bytes an element) per layer, whole on
        every rank. Under tensor parallelism a KV pool holds the rank's
        ``num_kv_heads / tp`` heads: the reference's bytes divided by tp
        (``zhilight_tpu/engine/engine.py:249-259``, the latent bytes not
        divided), so the page count, and admission with it, match. Under
        pipeline parallelism it still counts every layer, as the reference's
        does, though a stage's pool holds ``num_layers / pp`` of them: the
        page count stays the reference's, and a stage leaves the rest of its
        budget unused."""
        cfg = self.cfg
        if cfg.mla.enabled:
            return cfg.num_layers * cfg.mla.latent_dim * 2
        rows = cfg.num_layers * 2 * cfg.num_kv_heads
        if self.cache_cfg.kv_dtype == "int8":
            return rows * cfg.dim_head + rows * 4
        return rows * cfg.dim_head * torch.empty((), dtype=cfg.torch_dtype).element_size()

    def _decide_num_pages(self) -> int:
        cc = self.cache_cfg
        if cc.num_pages:
            return cc.num_pages
        S = self.page_size
        if self.device.type != "cuda":
            # CPU: budget from max_total_token
            return max(_round_up(self.sched_cfg.max_total_token or 8192, S) // S, 8)
        # size from the device memory left free after the weights (reference
        # free - RESERVE_MEM_MB auto limit)
        free, _ = torch.cuda.mem_get_info(self.device)
        budget = free * cc.hbm_utilization - cc.reserved_hbm_mb * (1 << 20)
        tokens = max(int(budget // self._kv_bytes_per_token()), 0)
        if self.sched_cfg.max_total_token:
            tokens = min(tokens, self.sched_cfg.max_total_token)
        if not cc.enable_prefix_caching:
            # without prefix retention, pages beyond the maximum concurrent
            # context are unusable
            tokens = min(tokens, self.sched_cfg.max_batch * self.engine_cfg.max_model_len)
        return max(tokens // S, 8)

    def new_cache(self, num_pages: int, quantized: Optional[bool] = None) -> KVCache:
        """A zeroed cache of ``num_pages`` pages in the serving pool's
        geometry: int8 with scales under ``kv_dtype="int8"`` (or as
        ``quantized`` says), else in the model's dtype. An MLA model gets a
        latent cache in the model's dtype whatever ``kv_dtype`` says: the
        latent pool has no int8 form, as in the reference."""
        cfg = self.cfg
        layers = self.layers[1] - self.layers[0]  # the stage's, under PP
        if cfg.mla.enabled:
            return new_latent_cache(
                layers, num_pages, self.page_size, cfg.mla.latent_dim,
                cfg.torch_dtype, device=self.device,
            )
        if quantized is None:
            quantized = self.cache_cfg.kv_dtype == "int8"
        return new_kv_cache(
            layers, num_pages, self.page_size, cfg.num_kv_heads, cfg.dim_head,
            cfg.torch_dtype, quantized=quantized, device=self.device,
        )

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    def upload(self, x) -> torch.Tensor:
        """A host array, scalar or CPU tensor as a tensor on the executor's
        device, copied without waiting for the device (pinned staging on CUDA)."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    @staticmethod
    def fetch(handle):
        """Wait for and download a ``fetch=False`` decode result as numpy."""
        return tuple(t.cpu().numpy() for t in handle)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def pick_bucket(self, n: int) -> int:
        for b in self.sched_cfg.prefill_buckets:
            if n <= b:
                return b
        return self.sched_cfg.prefill_buckets[-1]

    def seed_slot(self, slot: int, seed: int):
        """Restart a slot's random stream (a task was admitted to it)."""
        self.generators[slot].manual_seed(int(seed))

    def record_prompt(self, slot: int, tokens: List[int]):
        """Reset a slot's penalty counts to its prompt's tokens."""
        record_tokens(
            self.sampler_state, slot, self.upload(np.asarray(tokens, np.int32)), reset=True
        )

    def _emb_arg(self, embeddings: Optional[np.ndarray], bucket: int) -> Optional[torch.Tensor]:
        """A chunk's multimodal rows [n, d] as the model's input [bucket, d]:
        zero-padded in fp32, cast to the model's dtype on the host (round to
        nearest even, the values of the reference's ``jnp.asarray(pad,
        dtype)``) and uploaded once."""
        if embeddings is None:
            return None
        pad = np.zeros((bucket, self.cfg.dim_model), np.float32)
        pad[: embeddings.shape[0]] = embeddings
        return self.upload(torch.from_numpy(pad).to(self.cfg.torch_dtype))

    def _backbone(self, tokens: torch.Tensor, meta, embeddings: Optional[torch.Tensor] = None):
        with torch.no_grad():
            _, self.cache = self.model.backbone(
                self.params, self.cfg, self.rope, tokens, meta.positions, self.cache,
                meta, "prefill", embeddings, tp=self.tp,
            )

    def run_chunk(self, tokens: np.ndarray, meta: PrefillMeta,
                  embeddings: Optional[np.ndarray] = None):
        """A prefill chunk that only writes the cache; ``embeddings`` [n, d]
        replace the chunk's token embeddings (multimodal)."""
        self._backbone(self.upload(tokens), meta, self._emb_arg(embeddings, tokens.shape[0]))

    def _chunk_meta(self, bucket: int, pages: torch.Tensor, start: int, chunk: int) -> PrefillMeta:
        """A chunk's PrefillMeta built on the device from its page table and
        (start, chunk): no per-chunk uploads besides the tokens."""
        S = self.page_size
        i = torch.arange(bucket, dtype=torch.int32, device=self.device)
        live = i < chunk
        pos = torch.where(live, i + start, 0)
        page = pages[torch.clamp(pos // S, 0, pages.shape[0] - 1).long()]
        slots = torch.where(live & (page >= 0), page * S + pos % S, -1)
        i32 = dict(dtype=torch.int32, device=self.device)
        return PrefillMeta(
            positions=pos,
            slot_mapping=slots.to(torch.int32),
            page_table=pages,
            cache_len=torch.full((), start, **i32),
            q_len=torch.full((), chunk, **i32),
        )

    @property
    def supports_fused_chunk(self) -> bool:
        """Off under PP, as the reference gates it."""
        return self.pp is None

    def run_chunk_fused(self, tokens: np.ndarray, pages_dev: torch.Tensor, start: int, chunk: int):
        """run_chunk with the meta built on the device; ``pages_dev`` is the
        sequence's full padded page table, already on the device."""
        meta = self._chunk_meta(tokens.shape[0], pages_dev, start, chunk)
        self._backbone(self.upload(tokens), meta)

    def run_chunk_chain(self, tokens_c: np.ndarray, pages_dev: torch.Tensor, start0: int):
        """``tokens_c.shape[0]`` consecutive full chunks from ``start0``, with
        one token upload."""
        C, bucket = tokens_c.shape
        toks = self.upload(tokens_c)
        for c in range(C):
            start = start0 + c * bucket
            self._backbone(toks[c], self._chunk_meta(bucket, pages_dev, start, bucket))

    def _pair(self, arr_tok, arr_val):
        if arr_tok is None:
            return None, None
        return self.upload(arr_tok), self.upload(arr_val)

    def run_prefill(
        self,
        tokens: np.ndarray,
        meta: PrefillMeta,
        sparams: SamplingParams,
        slot: int,
        step_index: int,
        num_logprobs: int = 0,
        bias: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        penalties: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        embeddings: Optional[np.ndarray] = None,
    ):
        """A prompt's last chunk and its first token, sampled for ``slot``;
        ``embeddings`` [n, d] replace the chunk's token embeddings.
        Returns (token, logprob, top_logprobs [L], top_tokens [L])."""
        bias_tok, bias_val = self._pair(*(bias or (None, None)))
        pen_tok, pen_val = self._pair(*(penalties or (None, None)))
        emb = self._emb_arg(embeddings, tokens.shape[0])
        st = self.sampler_state
        with torch.no_grad():
            logits, self.cache = self.model.forward_prefill(
                self.params, self.cfg, self.rope, self.upload(tokens), meta, self.cache, emb,
                tp=self.tp,
            )
            rows = torch.full((1,), slot, dtype=torch.long, device=self.device)
            tok, lp, toplp, toptok, st2 = sample_step(
                logits[None], SamplerState(st.token_counts[rows], st.step[rows]),
                sparams.take(rows), generators=[self.generators[slot]],
                logit_bias_tokens=bias_tok, logit_bias_values=bias_val,
                penalty_tokens=pen_tok, penalty_values=pen_val,
                num_logprobs=num_logprobs,
            )
            st.token_counts[slot] = st2.token_counts[0]
            st.step[slot] = st2.step[0]
        tok, lp, toplp, toptok = self.fetch((tok, lp, toplp, toptok))
        return int(tok[0]), float(lp[0]), toplp[0], toptok[0]

    @property
    def supports_packed_prefill(self) -> bool:
        """Off under PP, as the reference gates it."""
        return self.pp is None

    def run_prefill_packed(
        self,
        tokens: np.ndarray,        # [NS * TC]
        meta: PackedPrefillMeta,
        sparams: SamplingParams,
        slots: np.ndarray,         # [NS] slot per segment; -1 = no sample
    ):
        """Packed chunks of NS sequences; segments with a slot sample their
        first token. Returns (tokens [NS], logprobs [NS]); entries of
        segments without a slot are garbage the caller ignores."""
        slots = np.asarray(slots)
        st = self.sampler_state
        with torch.no_grad():
            logits, self.cache = llama_mod.forward_prefill_packed(
                self.params, self.cfg, self.rope, self.upload(tokens), meta, self.cache,
                tp=self.tp,
            )
            rows = self.upload(np.maximum(slots, 0).astype(np.int64))
            gens = [self.generators[s] if s >= 0 else self._scratch_generator for s in slots]
            tok, lp, _, _, st2 = sample_step(
                logits, SamplerState(st.token_counts[rows], st.step[rows]),
                sparams.take(rows), generators=gens,
            )
            live = np.nonzero(slots >= 0)[0]
            if len(live):
                dst = self.upload(slots[live].astype(np.int64))
                src = self.upload(live.astype(np.int64))
                st.token_counts[dst] = st2.token_counts[src]
                st.step[dst] = st2.step[src]
        tok, lp = self.fetch((tok, lp))
        return tok, lp

    # ------------------------------------------------------------------
    # decode windows
    # ------------------------------------------------------------------
    def _use_side_window(self, num_steps: int) -> bool:
        """Window-batched KV writes (``zhilight_tpu/engine/engine.py:589-622``):
        under ``ZT_WINDOW_KV=1``, a window of 2 to ``page_size`` steps (its
        rows then fall in at most two pages a slot) without a sliding window,
        over a latent pool or a packed head-major one (bf16 or int8), not
        under PP. Anything else decodes per step."""
        if not self.window_kv or self.pp is not None or not 2 <= num_steps <= self.page_size:
            return False
        if (self.cfg.sliding_window or 0) > 0:
            return False
        return self.cfg.mla.enabled or self.cache.packed

    def run_decode_multi(
        self,
        tokens: np.ndarray,        # [B] last sampled token per slot
        page_tables: np.ndarray,   # [B, maxp]
        positions: np.ndarray,     # [B] position of the token being written
        context_lens: np.ndarray,  # [B] = positions + 1 for active slots
        limits: np.ndarray,        # [B] max context_len each slot may reach
        sparams: SamplingParams,
        num_steps: int,
        num_logprobs: int = 0,
        bias: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        penalties: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        greedy_only: bool = False,
        reuse_carry: bool = False,
        fetch: bool = True,
    ):
        """K decode steps: sampled tokens feed the next step on the device,
        positions and context lengths advance there, and slots that reach
        their ``limits`` freeze (no writes; their outputs are discarded by
        the host). Returns (tokens [K, B], logprobs [K, B], top_lp [K, B, L],
        top_tok [K, B, L]) as numpy, or with ``fetch=False`` as device
        tensors for :meth:`fetch`, without waiting for the device.

        ``reuse_carry=True`` continues from the previous window's device
        state (tokens, positions, context_lens, page_tables, limits) instead
        of the host arrays; valid when the slot set, pages and limits are
        unchanged and every slot consumed the full window.

        Under :meth:`_use_side_window` the steps write no pool row: each
        layer's rows collect in side buffers (fp32 over an int8 pool, so the
        flush requantizes exactly what the window attended over), attention
        covers the pool as it was at the window's entry plus the side rows,
        and the rows are flushed after the last step, in this call."""
        key = (num_steps, num_logprobs, greedy_only)
        if reuse_carry and self._decode_carry is not None and self._decode_carry[0] == key:
            _, d_tok, d_pos, d_ctx, d_pt, d_lim = self._decode_carry
        else:
            d_tok, d_pos, d_ctx = self.upload(tokens), self.upload(positions), self.upload(context_lens)
            d_pt, d_lim = self.upload(page_tables), self.upload(limits)
        bias_tok, bias_val = self._pair(*(bias or (None, None)))
        pen_tok, pen_val = self._pair(*(penalties or (None, None)))
        S = self.page_size
        maxp = d_pt.shape[1]
        state = self.sampler_state
        outs = []
        side = self._use_side_window(num_steps)
        if side:
            entry_pos, pool_lens = d_pos, (d_ctx - 1).clamp_min(0)
            dtype = torch.float32 if self.cache.quantized else self.cfg.torch_dtype
            side_rows = llama_mod.new_side_rows(self.cfg, d_tok.shape[0], num_steps, dtype,
                                                self.device)
            side_valid = torch.zeros((d_tok.shape[0], num_steps), dtype=torch.bool,
                                     device=self.device)
        with torch.no_grad():
            for k in range(num_steps):
                valid = (d_ctx > 0) & (d_ctx <= d_lim)
                pidx = torch.clamp(d_pos // S, 0, maxp - 1).long()[:, None]
                page = d_pt.gather(1, pidx)[:, 0]
                slot = torch.where(valid, page * S + d_pos % S, -1).to(torch.int32)
                meta = DecodeMeta(
                    positions=d_pos, slot_mapping=slot, page_tables=d_pt, context_lens=d_ctx,
                    fused=self.fused_kv,
                )
                if side:
                    side_valid[:, k] = valid
                    logits, self.cache, side_rows = llama_mod.forward_decode_window(
                        self.params, self.cfg, self.rope, d_tok, meta, self.cache,
                        side_rows, side_valid, pool_lens, k, tp=self.tp,
                    )
                else:
                    logits, self.cache = self.model.forward_decode(
                        self.params, self.cfg, self.rope, d_tok, meta, self.cache, tp=self.tp,
                    )
                tok, lp, toplp, toptok, st2 = sample_step(
                    logits, state, sparams, generators=self.generators,
                    logit_bias_tokens=bias_tok, logit_bias_values=bias_val,
                    penalty_tokens=pen_tok, penalty_values=pen_val,
                    num_logprobs=num_logprobs, greedy_only=greedy_only,
                )
                # frozen slots keep their sampler state (their penalty counts
                # must not absorb the garbage tokens they emit)
                state = SamplerState(
                    token_counts=torch.where(valid[:, None], st2.token_counts, state.token_counts),
                    step=torch.where(valid, st2.step, state.step),
                )
                d_tok = torch.where(valid, tok, d_tok)
                d_pos = torch.where(valid, d_pos + 1, d_pos)
                d_ctx = torch.where(valid, d_ctx + 1, d_ctx)
                outs.append((tok, lp, toplp, toptok))
            if side:
                self.cache = llama_mod.flush_window_rows(
                    self.cfg, self.cache, side_rows, side_valid, entry_pos, d_pt
                )
        self.sampler_state = state
        self._decode_carry = (key, d_tok, d_pos, d_ctx, d_pt, d_lim)
        handle = tuple(torch.stack(x) for x in zip(*outs))
        return self.fetch(handle) if fetch else handle

    # ------------------------------------------------------------------
    # pool rows: beam copies and swap preemption
    # ------------------------------------------------------------------
    def _rows(self, rows: np.ndarray) -> torch.Tensor:
        """Slot indices on the device, without the skipped (negative) ones."""
        rows = np.asarray(rows)
        return self.upload(rows[rows >= 0].astype(np.int64))

    def copy_slots(self, src_rows: np.ndarray, dst_rows: np.ndarray):
        """Copy cache rows src -> dst (slot indices) in every layer: the pool
        and, for an int8 cache, both scale arrays. Pairs with a negative
        destination are skipped."""
        src_rows, dst_rows = np.asarray(src_rows), np.asarray(dst_rows)
        keep = dst_rows >= 0
        src = self.upload(np.maximum(src_rows[keep], 0).astype(np.int64))
        dst = self.upload(dst_rows[keep].astype(np.int64))
        for arrays in self.cache.arrays():
            for arr in arrays:
                arr[:, dst] = arr[:, src]
        self._decode_carry = None  # the pool changed under the carried window

    def swap_out_rows(self, rows: np.ndarray):
        """Download cache rows (slot indices, every layer; pool and scales)
        to the host. Does not change the cache: the caller frees the pages
        afterwards. Returns what :meth:`swap_in_rows` takes."""
        idx = self._rows(rows)
        return [[arr[:, idx].cpu() for arr in arrays] for arrays in self.cache.arrays()]

    def swap_in_rows(self, rows: np.ndarray, data):
        """Upload rows that :meth:`swap_out_rows` returned into (newly
        allocated) slots; the row count must match."""
        idx = self._rows(rows)
        for arrays, saved in zip(self.cache.arrays(), data):
            for arr, host in zip(arrays, saved):
                arr[:, idx] = host.to(self.device)
        self._decode_carry = None  # the pool changed under the carried window

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------
    def run_score(self, tokens: np.ndarray, _kind: str = "score") -> np.ndarray:
        """Full-sequence fp32 logits [T, V] of ``tokens``, through a scratch
        identity-paged cache in the model's dtype: serving state is not
        touched. The sequence runs as one chunk of its own length, whatever
        the prefill buckets are (nothing is compiled per shape here)."""
        n = int(tokens.shape[0])
        S = self.page_size
        maxp = _round_up(n, S) // S
        i32 = dict(dtype=torch.int32, device=self.device)
        rows = torch.arange(n, **i32)
        meta = PrefillMeta(
            positions=rows, slot_mapping=rows, page_table=torch.arange(maxp, **i32),
            cache_len=torch.zeros((), **i32), q_len=torch.full((), n, **i32),
        )
        forward = self.model.forward_score if _kind == "score" else self.model.forward_hidden
        with torch.no_grad():
            out, _ = forward(self.params, self.cfg, self.rope,
                             self.upload(np.asarray(tokens, np.int32)), meta,
                             self.new_cache(maxp, quantized=False), tp=self.tp)
        return out.float().cpu().numpy()

    def run_hidden(self, tokens: np.ndarray) -> np.ndarray:
        """Full-sequence last-layer hidden states [T, d] after the final norm."""
        return self.run_score(tokens, _kind="hidden")

    # ------------------------------------------------------------------
    def warmup(self) -> float:
        """Startup self-test at serving shapes: a chunk of every prefill
        bucket with its first-token sampling, a packed group, and a decode
        window, greedy and sampled. An out-of-memory or a kernel fault
        surfaces here, before the first request. The pool and the sampler
        state hold scratch values before the first admission, which resets
        each slot it uses. Returns the seconds spent."""
        t0 = time.monotonic()
        S, B = self.page_size, self.max_batch
        sparams = SamplingParams.greedy(B, device=self.device)
        for bucket in self.sched_cfg.prefill_buckets:
            maxp = min(_round_up(bucket, S) // S, self.num_pages, self.max_pages_per_seq)
            n = min(bucket, maxp * S)
            pt = np.full(self.max_pages_per_seq, -1, np.int32)
            pt[:maxp] = np.arange(maxp)
            pos = np.zeros(bucket, np.int32)
            pos[:n] = np.arange(n)
            slots = np.full(bucket, -1, np.int32)
            slots[:n] = np.arange(n)
            meta = PrefillMeta(
                positions=self.upload(pos), slot_mapping=self.upload(slots),
                page_table=self.upload(pt), cache_len=self.upload(np.int32(0)),
                q_len=self.upload(np.int32(n)),
            )
            self.run_prefill(np.zeros(bucket, np.int32), meta, sparams, 0, 0)
            if self.sched_cfg.prefill_pack >= 2 and self.supports_packed_prefill:
                ns = 2
                pmeta = PackedPrefillMeta(
                    positions=self.upload(np.tile(pos, ns)),
                    slot_mapping=self.upload(np.full(ns * bucket, -1, np.int32)),
                    page_tables=self.upload(np.tile(pt, (ns, 1))),
                    cache_lens=self.upload(np.zeros(ns, np.int32)),
                    q_lens=self.upload(np.full(ns, n, np.int32)),
                )
                self.run_prefill_packed(
                    np.zeros(ns * bucket, np.int32), pmeta, sparams, np.full(ns, -1, np.int32)
                )
        ctx = np.ones(B, np.int32)
        ptb = np.full((B, self.max_pages_per_seq), -1, np.int32)
        ptb[:, 0] = np.arange(B) % self.num_pages
        for greedy in (True, False):
            self.run_decode_multi(
                np.zeros(B, np.int32), ptb, ctx.copy(), ctx + 1, np.full(B, 2, np.int32),
                sparams, self.decode_window, greedy_only=greedy,
            )
        self._decode_carry = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0
