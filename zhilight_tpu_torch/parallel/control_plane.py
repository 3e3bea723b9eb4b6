"""Scheduler control plane (counterpart of
``zhilight_tpu/parallel/control_plane.py``).

Every rank of a tensor-, pipeline- or data-parallel model, and every host of
a multi-host one, runs the scheduler loop in lockstep, so that every rank
enters the same model steps, and with them the same collectives, in the same
order. Rank 0 is the only source of nondeterminism (task arrival, cancels,
session closes, TTL expiry): once per scheduler iteration it broadcasts
those events and the other ranks replay them against their identical state,
as the reference's hosts do.

Ranks that share a ``torch.distributed`` job (one host's, or every host's
in the mesh tier, where the hosts share one world) take them from
:class:`DistPlane`, a broadcast over a gloo group of their own (object
broadcast over NCCL would go through device tensors). Hosts that share no
job (the plane tier: ``num_hosts > 1`` and no ``coordinator_address``) are
joined by :class:`TcpPlane`, the reference's length-prefixed-pickle TCP
fan-out; where such a host runs more than one rank, its local rank 0 relays
what it receives to the others (:class:`RelayPlane`).
:func:`make_control_plane` picks the plane for every case.

Like the reference's ZMQ/NCCL ports, the TCP control port must only be
reachable inside the serving pod: its payloads are pickles, which run code
when they are read. :class:`TcpPlane` binds the host it is given.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import time
from typing import Any, List, Optional

from .comm import TIMEOUT, mesh_tier

logger = logging.getLogger(__name__)

__all__ = ["ControlPlane", "LocalPlane", "DistPlane", "TcpPlane", "RelayPlane",
           "control_address", "make_control_plane", "CONTROL_PORT_OFFSET"]

# offset from the coordinator's port of the scheduler channel
CONTROL_PORT_OFFSET = 17


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


def _send_msg(conn: socket.socket, payload: bytes):
    conn.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_msg(conn: socket.socket) -> Optional[bytes]:
    head = _recv_exact(conn, 8)
    if head is None:
        return None
    (n,) = struct.unpack("<Q", head)
    return _recv_exact(conn, n)


class TcpPlane(ControlPlane):
    """Length-prefixed-pickle TCP fan-out between ``world`` hosts (the
    reference's HostCommunicator: host 0 binds ``address``, the others
    connect to it, each naming its ``rank``). A worker whose channel rank 0
    closed takes that as the shutdown sentinel (``broadcast`` returns None).
    ``all_min``: each worker sends its ``n``, rank 0 sends back the least."""

    def __init__(self, rank: int, world: int, address: str,
                 timeout: float = TIMEOUT.total_seconds()):
        assert world > 1
        self.rank = rank
        self.world = world
        host, _, port = address.rpartition(":")
        port = int(port)
        self._conns: List[socket.socket] = []
        self._sock: Optional[socket.socket] = None
        self._closed = False
        if rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host if host not in ("", "0.0.0.0") else "", port))
            srv.listen(world - 1)
            srv.settimeout(timeout)
            ranks = {}
            try:
                for _ in range(world - 1):
                    conn, _addr = srv.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    ranks[pickle.loads(_recv_msg(conn))] = conn
            finally:
                srv.close()
            self._conns = [ranks[r] for r in sorted(ranks)]
            logger.info("control plane: %d workers connected", len(self._conns))
        else:
            deadline = time.monotonic() + timeout
            last_err = None
            while time.monotonic() < deadline:
                try:
                    conn = socket.create_connection((host, port), timeout=5.0)
                    break
                except OSError as e:  # rank 0 not up yet
                    last_err = e
                    time.sleep(0.2)
            else:
                raise TimeoutError(f"control plane connect to {address}: {last_err}")
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(None)  # workers block on the next step broadcast
            _send_msg(conn, pickle.dumps(rank))
            self._sock = conn
            logger.info("control plane: worker %d connected to %s", rank, address)

    def broadcast(self, obj: Any) -> Any:
        if self.rank == 0:
            payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            for conn in self._conns:
                _send_msg(conn, payload)
            return obj
        msg = _recv_msg(self._sock)
        if msg is None:  # rank 0 went away: treated as shutdown
            return None
        return pickle.loads(msg)

    def all_min(self, n: int) -> int:
        if self.rank == 0:
            least = int(n)
            for conn in self._conns:
                msg = _recv_msg(conn)
                if msg is None:
                    raise ConnectionError("control plane: a worker host closed its channel "
                                          "before sending its all_min value")
                least = min(least, pickle.loads(msg))
            for conn in self._conns:
                _send_msg(conn, pickle.dumps(least))
            return least
        _send_msg(self._sock, pickle.dumps(int(n)))
        msg = _recv_msg(self._sock)
        if msg is None:
            raise ConnectionError("control plane: rank 0 closed the channel before "
                                  "answering all_min")
        return pickle.loads(msg)

    def close(self):
        if self._closed:
            return
        self._closed = True
        for conn in self._conns + ([self._sock] if self._sock is not None else []):
            try:
                conn.close()
            except OSError:
                pass


class RelayPlane(ControlPlane):
    """The plane tier with more than one rank a host: ``tcp`` joins the
    hosts' local ranks 0 (None on the other ranks), ``host`` is the host's
    own :class:`DistPlane`. A broadcast goes host 0 -> every host over TCP,
    then each host's local rank 0 -> its ranks over ``host``; the shutdown
    sentinel passes through both. ``all_min`` reduces within each host, then
    across the hosts, and hands the result back down. ``rank`` is global
    (``host_rank * ranks a host + local rank``): 0 only on host 0's local
    rank 0."""

    def __init__(self, tcp: Optional[TcpPlane], host: DistPlane, host_rank: int,
                 num_hosts: int):
        self.tcp, self.host = tcp, host
        self.rank = host_rank * host.world + host.rank
        self.world = num_hosts * host.world

    def broadcast(self, obj: Any) -> Any:
        if self.tcp is not None:
            obj = self.tcp.broadcast(obj)
        return self.host.broadcast(obj)

    def all_min(self, n: int) -> int:
        n = self.host.all_min(n)
        if self.tcp is not None:
            n = self.tcp.all_min(n)
        return self.host.broadcast(n)

    def close(self):
        if self.tcp is not None:
            self.tcp.close()


def control_address(pcfg, address: Optional[str] = None) -> str:
    """The TCP plane's ``host:port``: ``address``, else ``ZT_CONTROL_ADDR``,
    else the coordinator's host at its port + :data:`CONTROL_PORT_OFFSET`,
    as the reference finds it; with none of them, the reference's
    ``ValueError``."""
    address = address or os.environ.get("ZT_CONTROL_ADDR")
    if address is not None:
        return address
    if not pcfg.coordinator_address:
        raise ValueError("multi-host serving needs coordinator_address")
    host, _, port = pcfg.coordinator_address.rpartition(":")
    return f"{host}:{int(port) + CONTROL_PORT_OFFSET}"


def make_control_plane(pcfg, address: Optional[str] = None) -> ControlPlane:
    """The plane of a ``ParallelConfig``: :class:`LocalPlane` for one rank;
    :class:`DistPlane` over the default group where the ranks share one job
    (one host's ``tp * pp * dp`` ranks, or every host's in the mesh tier);
    in the plane tier :class:`TcpPlane` between the hosts at
    :func:`control_address`, relayed within each host of more than one rank
    (:class:`RelayPlane`). Every rank of the world builds it at the same
    point; the address is found, or its ``ValueError`` raised, on every rank
    before any of them waits on another."""
    ranks = pcfg.tp * pcfg.pp * pcfg.dp
    if pcfg.num_hosts <= 1 or mesh_tier(pcfg):
        return DistPlane() if ranks > 1 else LocalPlane()
    address = control_address(pcfg, address)
    if ranks == 1:
        return TcpPlane(pcfg.host_rank, pcfg.num_hosts, address)
    host = DistPlane()
    tcp = TcpPlane(pcfg.host_rank, pcfg.num_hosts, address) if host.rank == 0 else None
    return RelayPlane(tcp, host, pcfg.host_rank, pcfg.num_hosts)
