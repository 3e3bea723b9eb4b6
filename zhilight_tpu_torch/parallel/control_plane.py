"""Scheduler control plane (the single-host part of
``zhilight_tpu/parallel/control_plane.py``).

The scheduler talks to a plane that, on a multi-host deployment, broadcasts
rank 0's scheduling events to every host. The port serves on one GPU, so it
carries the interface and the single-host no-op; the TCP plane comes with the
parallelism slice.
"""

from __future__ import annotations

from typing import Any

__all__ = ["ControlPlane", "LocalPlane"]


class ControlPlane:
    """Rank-0-to-all broadcast channel for scheduler lockstep."""

    rank: int = 0
    world: int = 1

    def broadcast(self, obj: Any) -> Any:
        """Rank 0 sends ``obj`` to every worker and returns it; workers
        ignore their argument, block, and return what rank 0 sent.
        Returns None on rank>0 when rank 0 closed the channel (shutdown)."""
        raise NotImplementedError

    def close(self):
        pass


class LocalPlane(ControlPlane):
    """Single-host no-op plane."""

    def broadcast(self, obj: Any) -> Any:
        return obj
