"""Scheduler control plane (counterpart of
``zhilight_tpu/parallel/control_plane.py``).

Every rank of a tensor- or pipeline-parallel model runs the scheduler loop
in lockstep, so that every rank enters the same model steps, and with them the same
collectives, in the same order. Rank 0 is the only source of
nondeterminism (task arrival, cancels, session closes, TTL expiry): once per
scheduler iteration it broadcasts those events and the other ranks replay
them against their identical state, as the reference's hosts do. The
reference ships them over a TCP fan-out between hosts; the port's ranks
share a ``torch.distributed`` job, so :class:`DistPlane` broadcasts them
over a gloo group of their own (object broadcast over NCCL would go through
device tensors). The TCP plane between hosts comes with multi-host serving.
"""

from __future__ import annotations

from typing import Any

from .comm import TIMEOUT

__all__ = ["ControlPlane", "LocalPlane", "DistPlane"]


class ControlPlane:
    """Rank-0-to-all broadcast channel for scheduler lockstep."""

    rank: int = 0
    world: int = 1

    def broadcast(self, obj: Any) -> Any:
        """Rank 0 sends ``obj`` to every worker and returns it; workers
        ignore their argument, block, and return what rank 0 sent.
        Returns None on rank>0 when rank 0 closed the channel (shutdown)."""
        raise NotImplementedError

    def all_min(self, n: int) -> int:
        """The smallest of every rank's ``n`` (a collective call)."""
        raise NotImplementedError

    def close(self):
        pass


class LocalPlane(ControlPlane):
    """Single-process no-op plane."""

    def broadcast(self, obj: Any) -> Any:
        return obj

    def all_min(self, n: int) -> int:
        return n


class DistPlane(ControlPlane):
    """Rank 0's events to every rank of the default ``torch.distributed``
    group, through ``broadcast_object_list`` on a gloo group made for them
    (every rank must build its plane at the same point). A broadcast that
    waits longer than ``comm.TIMEOUT`` raises, so a rank that dropped out
    fails the others. Rank 0's ``None`` is the shutdown sentinel."""

    def __init__(self):
        import torch.distributed as dist

        self.group = dist.new_group(backend="gloo", timeout=TIMEOUT)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def broadcast(self, obj: Any) -> Any:
        import torch.distributed as dist

        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def all_min(self, n: int) -> int:
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(n)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())
