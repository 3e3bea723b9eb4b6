"""The tensor-parallel group: the collectives the model calls.

Under the reference's ``ParallelConfig(tp=N)`` XLA inserts a psum after every
row-parallel product and gathers the vocab-sharded logits. The port runs one
process a rank, joined by ``torch.distributed``, and the model calls these
collectives itself (``models/llama.py``). At world 1 they do nothing.

The group's backend is what the caller or the launch chose: :func:`join`
initialises the default group from torchrun's variables with NCCL for CUDA
devices and gloo for the CPU. A gloo group over CUDA tensors (its collectives
go through host memory) is allowed and is how two ranks share one GPU; NCCL
needs a GPU a rank and raises with fewer. Nothing switches backends on its
own.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

__all__ = ["TPGroup", "join", "leave", "local_device", "require_launch", "LAUNCH_VARS",
           "TIMEOUT"]

# what torchrun gives every rank's process
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# how long a rank waits in a collective, or for rank 0's scheduling events,
# before it fails: the timeout of the groups that join and the control plane
# make (a caller that initialises the default group gives its own)
TIMEOUT = datetime.timedelta(seconds=600)


class TPGroup:
    """``rank``, ``world`` and the collectives of the tensor-parallel group:
    the default ``torch.distributed`` process group. ``TPGroup()`` without an
    initialised process group is the world-1 group."""

    def __init__(self):
        import torch.distributed as dist

        backend = None
        self.rank, self.world = 0, 1
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            backend = dist.get_backend()
        if backend == "nccl" and torch.cuda.device_count() < self.world:
            raise RuntimeError(
                f"an NCCL group of {self.world} ranks needs a GPU a rank; "
                f"{torch.cuda.device_count()} are visible")

    def all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """The sum over the ranks of ``x`` (in place), in ``x``'s dtype; or
        their reduction by ``op``, a ``torch.distributed.ReduceOp``."""
        if self.world == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim``, rank 0's first."""
        if self.world == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)


def join(tp: int, device: torch.device) -> TPGroup:
    """The group of a ``tp``-rank model: the default process group where the
    caller initialised one, otherwise one initialised from torchrun's
    variables (``LAUNCH_VARS``) with NCCL for a CUDA ``device`` and gloo for
    the CPU, its collectives timing out after :data:`TIMEOUT`. Its world
    must be ``tp``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        require_launch(tp)
        dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                                timeout=TIMEOUT)
    group = TPGroup()
    if group.world != tp:
        raise ValueError(f"the process group has {group.world} ranks; tensor parallelism "
                         f"asks for tp={tp}")
    return group


def require_launch(tp: int) -> None:
    """Raise, naming torchrun, unless this process is a rank of a launch (an
    initialised default group, or torchrun's variables)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    missing = [v for v in LAUNCH_VARS if v not in os.environ and v != "LOCAL_RANK"]
    if missing:
        raise RuntimeError(
            f"tensor parallelism over {tp} ranks needs one process a rank: launch with "
            f"torchrun --nproc-per-node {tp} (unset: {', '.join(missing)}), or call "
            "torch.distributed.init_process_group first")


def leave() -> None:
    """A rank's last act: destroy the default process group, which the
    interpreter's exit would otherwise tear down under gloo's threads."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device: Optional[str]) -> torch.device:
    """A rank's device: the one given (every rank may be given the same),
    else, or where it is ``"cuda"`` with no index, ``cuda:LOCAL_RANK`` (the
    rank's place on its host; the global rank where the launch sets no
    LOCAL_RANK)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    import torch.distributed as dist

    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local))
