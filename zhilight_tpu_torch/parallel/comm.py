"""The tensor-parallel and pipeline groups: the collectives the model calls.

Under the reference's ``ParallelConfig(tp=N)`` XLA inserts a psum after every
row-parallel product and gathers the vocab-sharded logits. The port runs one
process a rank, joined by ``torch.distributed``, and the model calls these
collectives itself (``models/llama.py``). At world 1 they do nothing.

Under ``ParallelConfig(tp=T, pp=P)`` the world is ``T * P`` ranks: rank ``r``
is stage ``r // T`` and TP rank ``r % T``, the reference's "pp groups of tp
ranks" (``zhilight_tpu/engine/engine.py:97-102``). A stage's T ranks form its
:class:`TPGroup`; the P ranks of one TP rank, one a stage, form a column,
:class:`PPGroup`, over which the hidden state moves (``models/pipeline.py``).

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
from typing import Optional, Tuple

import torch

__all__ = ["TPGroup", "PPGroup", "join", "leave", "local_device", "require_launch", "LAUNCH_VARS",
           "TIMEOUT"]

# what torchrun gives every rank's process
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# how long a rank waits in a collective, or for rank 0's scheduling events,
# before it fails: the timeout of the groups that join and the control plane
# make (a caller that initialises the default group gives its own)
TIMEOUT = datetime.timedelta(seconds=600)


class TPGroup:
    """``rank``, ``world`` and the collectives of a tensor-parallel group:
    ``group``, a ``torch.distributed`` group this process belongs to (a
    stage's ranks under pipeline parallelism), or the default group where it
    is None. ``TPGroup()`` without an initialised process group is the
    world-1 group."""

    def __init__(self, group=None):
        import torch.distributed as dist

        backend = None
        self.group = group
        self.rank, self.world = 0, 1
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
            backend = dist.get_backend(group)
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
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim``, rank 0's first."""
        if self.world == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)


class PPGroup:
    """A column of pipeline stages: ``stage`` (this rank's) of ``stages``,
    and the three moves of the hidden state between them.

    One transport under either backend, chosen here and nowhere else: every
    move is a ``broadcast``. The hand-off from stage s to s + 1 is a
    broadcast from s over the two-rank group of the pair (``links[s]``;
    gloo's point-to-point ``send`` / ``recv`` take host tensors only, while
    its broadcast takes a CUDA tensor through host memory, as TP's
    collectives do; over NCCL a two-rank broadcast is a send); the last
    stage's hidden state reaches every stage by a broadcast over the
    column's group. A broadcast copies its bits, so a stage receives exactly
    what the one before it computed."""

    def __init__(self, ranks: list, column, links: list):
        import torch.distributed as dist

        self.ranks = list(ranks)  # the global rank of each stage, in order
        self.stages = len(self.ranks)
        self.stage = self.ranks.index(dist.get_rank())
        self.column, self.links = column, list(links)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def send(self, x: torch.Tensor) -> None:
        """Hand ``x`` to the next stage (every stage but the last)."""
        import torch.distributed as dist

        dist.broadcast(x.contiguous(), src=self.ranks[self.stage], group=self.links[self.stage])

    def recv(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        """What the previous stage sent (every stage but the first)."""
        import torch.distributed as dist

        x = torch.empty(shape, dtype=dtype, device=device)
        dist.broadcast(x, src=self.ranks[self.stage - 1], group=self.links[self.stage - 1])
        return x

    def from_last(self, x: Optional[torch.Tensor], shape, dtype: torch.dtype,
                  device) -> torch.Tensor:
        """The last stage's ``x`` on every stage of the column (the others
        pass None)."""
        import torch.distributed as dist

        x = x.contiguous() if self.last else torch.empty(shape, dtype=dtype, device=device)
        dist.broadcast(x, src=self.ranks[-1], group=self.column)
        return x


def join(tp: int, pp: int, device: torch.device) -> Tuple[Optional[TPGroup], Optional[PPGroup]]:
    """The groups of a ``tp * pp``-rank model: the default process group
    where the caller initialised one, otherwise one initialised from
    torchrun's variables (``LAUNCH_VARS``) with NCCL for a CUDA ``device``
    and gloo for the CPU, its collectives timing out after :data:`TIMEOUT`.
    Its world must be ``tp * pp``. Returns (the rank's TP group, None at tp
    1; its column, None at pp 1). At pp 1 the TP group is the default group;
    otherwise every rank makes every stage's TP group, every column's group
    and every adjacent pair's, in one order."""
    import torch.distributed as dist

    if not dist.is_initialized():
        require_launch(tp * pp)
        dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                                timeout=TIMEOUT)
    world = TPGroup()  # the default group; raises where NCCL lacks a GPU a rank
    if world.world != tp * pp:
        asked = f"tp={tp}" if pp == 1 else f"tp={tp} x pp={pp}"
        raise ValueError(f"the process group has {world.world} ranks; {asked} asks for "
                         f"{tp * pp}")
    if pp == 1:
        return (world if tp > 1 else None), None
    stages = [dist.new_group([s * tp + t for t in range(tp)], timeout=TIMEOUT)
              for s in range(pp)] if tp > 1 else None
    columns = [[s * tp + t for s in range(pp)] for t in range(tp)]
    column_groups = [dist.new_group(c, timeout=TIMEOUT) for c in columns]
    # a two-stage column's only pair is the column itself
    links = [[column_groups[t]] if pp == 2 else
             [dist.new_group(c[s:s + 2], timeout=TIMEOUT) for s in range(pp - 1)]
             for t, c in enumerate(columns)]
    stage, t = divmod(world.rank, tp)
    return (TPGroup(stages[stage]) if tp > 1 else None,
            PPGroup(columns[t], column_groups[t], links[t]))


def require_launch(world: int) -> None:
    """Raise, naming torchrun, unless this process is a rank of a launch (an
    initialised default group, or torchrun's variables) of ``world`` ranks."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    missing = [v for v in LAUNCH_VARS if v not in os.environ and v != "LOCAL_RANK"]
    if missing:
        raise RuntimeError(
            f"model parallelism over {world} ranks needs one process a rank: launch with "
            f"torchrun --nproc-per-node {world} (unset: {', '.join(missing)}), or call "
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
