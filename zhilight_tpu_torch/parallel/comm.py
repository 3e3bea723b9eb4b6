"""The tensor-parallel and pipeline groups: the collectives the model calls.

Under the reference's ``ParallelConfig(tp=N)`` XLA inserts a psum after every
row-parallel product and gathers the vocab-sharded logits. The port runs one
process a rank, joined by ``torch.distributed``, and the model calls these
collectives itself (``models/llama.py``). At world 1 they do nothing.

Under ``ParallelConfig(tp=T, pp=P, dp=D)`` the world is ``T * P * D`` ranks,
in the order of the reference mesh's ``(dp, pp, tp)`` axes
(``zhilight_tpu/parallel/mesh.py:42``): rank ``r`` is replica ``r // (T *
P)``; within its replica, at ``i = r % (T * P)``, it is stage ``i // T`` and
TP rank ``i % T``, the reference's "pp groups of tp ranks"
(``zhilight_tpu/engine/engine.py:97-102``). A stage's T ranks form its
:class:`TPGroup`; the P ranks of one TP rank, one a stage, form a column,
:class:`PPGroup`, over which the hidden state moves (``models/pipeline.py``).
A replica's collectives never leave it: ``dp`` shards nothing (no rule of
the reference's sharding names its axis), so every replica holds the same
shards and computes the same batch.

Over several hosts (``num_hosts > 1`` with a ``coordinator_address``, the
reference's "mesh" tier) the world spans them, ``T * P * D / num_hosts``
ranks a host: :func:`join_hosts` initialises it from the coordinator where
no launch did, as the reference's ``ensure_distributed`` joins
``jax.distributed`` (``zhilight_tpu/parallel/mesh.py:54-65``);
:func:`check_hosts` holds the configuration to the launch.

The group's backend is what the caller or the launch chose: :func:`join`
initialises the default group from torchrun's variables with NCCL for CUDA
devices and gloo for the CPU. A gloo group over CUDA tensors (its collectives
go through host memory) is allowed and is how two ranks share one GPU; NCCL
needs a GPU for each rank of a host and raises with fewer. Nothing switches
backends on its own.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

__all__ = ["TPGroup", "PPGroup", "join", "join_hosts", "check_hosts", "mesh_tier", "leave",
           "local_device", "require_launch", "LAUNCH_VARS", "NODE_VARS", "TIMEOUT"]

# what torchrun gives every rank's process
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# what it adds that places a rank's host: the host's index and its rank count
NODE_VARS = ("GROUP_RANK", "LOCAL_WORLD_SIZE")
# how long a rank waits in a collective, or for rank 0's scheduling events,
# before it fails: the timeout of the groups that join and the control plane
# make (a caller that initialises the default group gives its own)
TIMEOUT = datetime.timedelta(seconds=600)


class TPGroup:
    """``rank``, ``world`` and the collectives of a tensor-parallel group:
    ``group``, a ``torch.distributed`` group this process belongs to (a
    stage's ranks under pipeline parallelism, a replica's under data
    parallelism), or the default group where it is None. ``TPGroup()``
    without an initialised process group is the world-1 group."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.rank, self.world = 0, 1
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)

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


def mesh_tier(pcfg) -> bool:
    """Whether the hosts of ``pcfg`` share one ``torch.distributed`` world
    (a ``coordinator_address``), rather than each running a job of its own
    joined to the others by the control plane alone."""
    return pcfg.num_hosts > 1 and bool(pcfg.coordinator_address)


def _torchrun_nodes() -> Optional[Tuple[int, int]]:
    """(hosts, this host's index) of a torchrun launch, where its variables
    say (``WORLD_SIZE / LOCAL_WORLD_SIZE``, ``GROUP_RANK``)."""
    if not all(v in os.environ for v in ("WORLD_SIZE",) + NODE_VARS):
        return None
    return (int(os.environ["WORLD_SIZE"]) // int(os.environ["LOCAL_WORLD_SIZE"]),
            int(os.environ["GROUP_RANK"]))


def check_hosts(pcfg) -> None:
    """The multi-host configuration's raises (``ValueError``), before any
    group is joined: ``host_rank`` below ``num_hosts``; in the mesh tier
    ``num_hosts`` dividing the world of ``tp * pp * dp`` ranks; and a torchrun
    launch over as many nodes as the hosts (one in the plane tier, where
    each host is a job of its own) with this node's index ``host_rank``."""
    if not 0 <= pcfg.host_rank < pcfg.num_hosts:
        raise ValueError(f"host_rank {pcfg.host_rank} is not below num_hosts {pcfg.num_hosts}")
    world = pcfg.tp * pcfg.pp * pcfg.dp
    mesh = mesh_tier(pcfg)
    if mesh and world % pcfg.num_hosts:
        raise ValueError(f"num_hosts={pcfg.num_hosts} does not divide the world of {world} ranks "
                         f"(tp={pcfg.tp} x pp={pcfg.pp} x dp={pcfg.dp}) that the hosts share")
    nodes = _torchrun_nodes()
    if nodes is None:
        return
    want = pcfg.num_hosts if mesh else 1
    if nodes[0] != want:
        tier = ("the hosts share one world" if mesh else
                "each host is a torchrun job of its own (no coordinator_address)")
        raise ValueError(f"torchrun launched {nodes[0]} nodes; num_hosts={pcfg.num_hosts} asks "
                         f"for {want}: {tier}")
    if mesh and nodes[1] != pcfg.host_rank:
        raise ValueError(f"torchrun's GROUP_RANK is {nodes[1]}; host_rank is {pcfg.host_rank}")


def join_hosts(pcfg, device: torch.device) -> None:
    """The mesh tier's world over every host: where no default group is
    initialised and torchrun set no variables, initialise it from
    ``coordinator_address`` (``tcp://``; NCCL for a CUDA ``device``, gloo for
    the CPU), this process rank ``host_rank * (world / num_hosts) +
    LOCAL_RANK`` of ``tp * pp * dp``; where the caller initialised it,
    check that its rank lies on host ``host_rank``. Nothing outside the
    mesh tier."""
    import torch.distributed as dist

    if not mesh_tier(pcfg):
        return
    world = pcfg.tp * pcfg.pp * pcfg.dp
    per_host = world // pcfg.num_hosts
    if dist.is_initialized():
        rank = dist.get_rank()
        if dist.get_world_size() == world and rank // per_host != pcfg.host_rank:
            raise ValueError(f"rank {rank} of {world} lies on host {rank // per_host} of "
                             f"{pcfg.num_hosts}; host_rank is {pcfg.host_rank}")
        return
    if all(v in os.environ for v in LAUNCH_VARS if v != "LOCAL_RANK"):
        return  # torchrun's: join initialises from them
    local = int(os.environ.get("LOCAL_RANK", 0))
    if not 0 <= local < per_host:
        raise ValueError(f"LOCAL_RANK {local}: a host runs {per_host} of the {world} ranks")
    dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{pcfg.coordinator_address}",
                            rank=pcfg.host_rank * per_host + local, world_size=world,
                            timeout=TIMEOUT)


def join(tp: int, pp: int, device: torch.device, dp: int = 1,
         hosts: int = 1) -> Tuple[Optional[TPGroup], Optional[PPGroup]]:
    """The groups of a ``tp * pp * dp``-rank model: the default process
    group where the caller (or :func:`join_hosts`) initialised one, otherwise
    one initialised from torchrun's variables (``LAUNCH_VARS``) with NCCL
    for a CUDA ``device`` and gloo for the CPU, its collectives timing out
    after :data:`TIMEOUT`. Its world must be ``tp * pp * dp``, spread over
    ``hosts`` hosts (NCCL needs a GPU for each of a host's ranks). Returns
    (the rank's TP group, None at tp 1; its column, None at pp 1). With one
    replica at pp 1 the TP group is the default group; otherwise every rank
    makes every replica's TP groups, columns and adjacent pairs, in one
    order (``new_group`` is collective over the default group)."""
    import torch.distributed as dist

    n = tp * pp * dp
    if not dist.is_initialized():
        require_launch(n)
        dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo",
                                timeout=TIMEOUT)
    world = TPGroup()  # the default group
    if world.world != n:
        asked = " x ".join([f"tp={tp}"] + [f"{k}={v}" for k, v in (("pp", pp), ("dp", dp))
                                            if v > 1])
        raise ValueError(f"the process group has {world.world} ranks; {asked} asks for {n}")
    if dist.get_backend() == "nccl" and torch.cuda.device_count() < n // hosts:
        raise RuntimeError(
            f"an NCCL group of {n // hosts} ranks a host needs a GPU a rank; "
            f"{torch.cuda.device_count()} are visible")
    if pp == 1 and dp == 1:
        return (world if tp > 1 else None), None
    size = tp * pp  # a replica's ranks
    replica, i = divmod(world.rank, size)
    stage, t = divmod(i, tp)
    mine_tp = mine_pp = None
    for d in range(dp):
        base = d * size
        stages = [dist.new_group([base + s * tp + k for k in range(tp)], timeout=TIMEOUT)
                  for s in range(pp)] if tp > 1 else None
        if d == replica and tp > 1:
            mine_tp = TPGroup(stages[stage])
        if pp == 1:
            continue
        columns = [[base + s * tp + k for s in range(pp)] for k in range(tp)]
        column_groups = [dist.new_group(c, timeout=TIMEOUT) for c in columns]
        # a two-stage column's only pair is the column itself
        links = [[column_groups[k]] if pp == 2 else
                 [dist.new_group(c[s:s + 2], timeout=TIMEOUT) for s in range(pp - 1)]
                 for k, c in enumerate(columns)]
        if d == replica:
            mine_pp = PPGroup(columns[t], column_groups[t], links[t])
    return mine_tp, mine_pp


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
