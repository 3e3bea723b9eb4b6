"""Pipeline-parallel forward (counterpart of ``zhilight_tpu/models/pipeline.py``).

The reference's pipeline is sequential, not micro-batched: for one batch
stage t runs its layers while the other stages wait, and its purpose is
memory capacity (the reference recommends tensor parallelism first). It runs
as one SPMD program: a layer-stacked tree sharded over a ``pp`` mesh axis, a
single layer-major pool, ``lax.cond`` per stage and ``ppermute`` between
them. The port runs one process a rank (``parallel.comm.join``), so a stage
simply holds what it runs:

- its layers ``[lo, hi)`` (``parallel.sharding.stage_range``), under their
  global keys, and a pool of those layers only, indexed from 0 (layer i at
  pool index ``i - lo``; the layer's own configuration is read at i);
- the embedding, the final norm and the head, which the reference
  replicates over the stages too (its ``shard_params_pp``).

A forward: stage 0 embeds the tokens (or takes ``input_embeddings``), every
other stage receives the hidden state from the stage before; the stage runs
its layers and hands the result on. The last stage's hidden state, before
the final norm, is then broadcast to every stage of the column, and every
rank applies the final norm and the head (``llama.get_logits``, with its
tensor-parallel all-gather). The reference moves it back with a masked fp32
``psum`` of one nonzero term, an exact copy; the broadcast gives the same
bits. A ``chunk`` forward only writes the pool: no broadcast, no logits.

Under tensor parallelism within a stage, every rank of the stage holds the
same activations after each layer's all-reduce, so each column carries the
same hidden state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config.model_config import ModelConfig
from ..kvcache.paged import KVCache
from . import llama as L

__all__ = ["PPForwards"]


class PPForwards:
    """The forwards of one pipeline stage, with the signatures of
    ``models/llama.py``'s (``backbone``, ``forward_prefill``,
    ``forward_score``, ``forward_hidden``, ``forward_decode``), so that the
    executor calls either the same way. ``group`` is the rank's column
    (``parallel.comm.PPGroup``), ``layers`` the stage's ``(lo, hi)``."""

    def __init__(self, group, layers: Tuple[int, int]):
        self.group = group
        self.lo, self.hi = layers

    def _stage(self, params, cfg: ModelConfig, rope, tokens: torch.Tensor,
               positions: torch.Tensor, cache: KVCache, meta, mode: str,
               input_embeddings: Optional[torch.Tensor] = None, tp=None):
        """The stage's part of one forward: the pre-norm hidden state [T, d]
        of the last stage, on every stage of the column (None for a
        ``chunk``, whose forward ends at the last stage's layers)."""
        g = self.group
        shape = (tokens.shape[0], cfg.dim_model)
        if g.first:
            x = (L.embed(params, cfg, tokens, tp) if input_embeddings is None
                 else input_embeddings)
        else:
            x = g.recv(shape, cfg.torch_dtype, tokens.device)
        rot = rope.rot_values(positions)
        layer_mode = "decode" if mode == "decode" else "prefill"
        for i in range(self.lo, self.hi):
            x, cache = L.decoder_layer(params["layers"][str(i)], cfg, rope, x, positions, cache,
                                       i, meta, layer_mode, rot=rot, tp=tp, pool_idx=i - self.lo)
        if not g.last:
            g.send(x)
        if mode == "chunk":
            return None, cache
        return g.from_last(x if g.last else None, shape, cfg.torch_dtype, tokens.device), cache

    def backbone(self, params, cfg, rope, tokens, positions, cache, meta, mode,
                 input_embeddings=None, tp=None):
        """A prefill chunk that only writes the cache (the executor's
        ``_backbone``): returns (None, cache)."""
        return self._stage(params, cfg, rope, tokens, positions, cache, meta, "chunk",
                           input_embeddings, tp)

    def forward_prefill(self, params, cfg, rope, tokens, meta, cache, input_embeddings=None,
                        tp=None):
        """One prefill chunk: the fp32 logits [V] of its last valid token."""
        x, cache = self._stage(params, cfg, rope, tokens, meta.positions, cache, meta,
                               "prefill", input_embeddings, tp)
        last = (meta.q_len - 1).clamp_min(0).reshape(1).long()
        hidden = L._norm(params["final_norm"], cfg, x).index_select(0, last)
        return L.get_logits(params, cfg, hidden, tp)[0], cache

    def forward_score(self, params, cfg, rope, tokens, meta, cache, tp=None):
        """Full-sequence fp32 logits [T, V]."""
        x, cache = self._stage(params, cfg, rope, tokens, meta.positions, cache, meta,
                               "score", tp=tp)
        return L.get_logits(params, cfg, L._norm(params["final_norm"], cfg, x), tp), cache

    def forward_hidden(self, params, cfg, rope, tokens, meta, cache, tp=None):
        """Full-sequence last-layer hidden states [T, d] after the final norm."""
        x, cache = self._stage(params, cfg, rope, tokens, meta.positions, cache, meta,
                               "hidden", tp=tp)
        return L._norm(params["final_norm"], cfg, x), cache

    def forward_decode(self, params, cfg, rope, tokens, meta, cache, tp=None):
        """One decode step for all slots: fp32 logits [B, V]."""
        x, cache = self._stage(params, cfg, rope, tokens, meta.positions, cache, meta,
                               "decode", tp=tp)
        return L.get_logits(params, cfg, L._norm(params["final_norm"], cfg, x), tp), cache
