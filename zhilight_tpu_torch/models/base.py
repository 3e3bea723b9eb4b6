"""Model-facing batch metadata (counterpart of ``zhilight_tpu/models/base.py``).

Plain dataclasses of device tensors that the scheduler builds each step: one
sequence's prefill chunk, a packed group of chunks, or one decode step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["PrefillMeta", "PackedPrefillMeta", "DecodeMeta"]


@dataclass
class PrefillMeta:
    """One sequence's prefill chunk of T (bucket) tokens covering global
    positions [cache_len, cache_len + q_len); earlier positions are already
    in the cache."""

    positions: torch.Tensor     # [T] int32 global positions (pad: 0)
    slot_mapping: torch.Tensor  # [T] int32 flat cache slot per token; -1 pad
    page_table: torch.Tensor    # [max_pages] int32 pages of this sequence; -1 pad
    cache_len: torch.Tensor     # 0-d int32
    q_len: torch.Tensor         # 0-d int32 valid tokens in the chunk

    @property
    def num_tokens(self) -> int:
        return self.positions.shape[0]


@dataclass
class PackedPrefillMeta:
    """NS sequences' chunks packed into one token batch of T = NS * TC;
    segment s covers tokens [s*TC, (s+1)*TC) and global positions
    [cache_lens[s], cache_lens[s] + q_lens[s]). Padded segments have
    q_lens == 0."""

    positions: torch.Tensor     # [T] int32
    slot_mapping: torch.Tensor  # [T] int32; -1 pad
    page_tables: torch.Tensor   # [NS, max_pages] int32; -1 pad
    cache_lens: torch.Tensor    # [NS] int32
    q_lens: torch.Tensor        # [NS] int32

    @property
    def num_tokens(self) -> int:
        return self.positions.shape[0]

    @property
    def num_segments(self) -> int:
        return self.page_tables.shape[0]


@dataclass
class DecodeMeta:
    """One decode step over B slots, one new token each; inactive slots have
    context_lens == 0 and slot_mapping == -1."""

    positions: torch.Tensor     # [B] int32 position of the new token
    slot_mapping: torch.Tensor  # [B] int32 flat cache slot; -1 inactive
    page_tables: torch.Tensor   # [B, max_pages] int32; -1 pad
    context_lens: torch.Tensor  # [B] int32, includes the new token

    @property
    def batch(self) -> int:
        return self.positions.shape[0]
