"""Cross-process synchronization barrier (a copy of
``pagraph_tpu/utils/sync.py``, which the port does not import).

Parity component for the reference's raw-TCP barrier
(reference: PaGraph/utils/sync.py:4-32, parallel/dataloader.py:184-227) used
as sampler flow control.  The port's data-parallel trainer lines its ranks
up with ``torch.distributed.barrier()`` (``parallel/dp_trainer.py``), so a
socket barrier is never on its hot path; a named cross-process barrier is
still useful to line up independently launched host processes (e.g. a
trainer and an external dataset producer).  Both transports are provided:

  * :class:`ProcessBarrier` — multiprocessing-native (single host, preferred);
  * :func:`server` / :func:`trainer` / :func:`barrier` — the reference's
    socket protocol (one ``server`` side accepts N ``trainer`` connections;
    ``barrier()`` blocks until every participant arrives), kept functionally
    compatible for multi-process launch scripts: either package's side
    talks to the other's.
"""
from __future__ import annotations

import multiprocessing as mp
import socket
from typing import List, Optional


class ProcessBarrier:
    """multiprocessing.Barrier wrapper with the reference's call shape."""

    def __init__(self, parties: int):
        self._barrier = mp.get_context("spawn").Barrier(parties)

    def barrier(self, timeout: Optional[float] = None) -> None:
        self._barrier.wait(timeout)


# -- socket transport (reference-compatible protocol) -----------------------

_MSG = b"barrier"


def server(world_size: int, port: int = 8200,
           host: str = "127.0.0.1") -> List[socket.socket]:
    """Accept ``world_size`` trainer connections (reference sync.py:4-14)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(world_size)
    conns = []
    for _ in range(world_size):
        conn, _addr = srv.accept()
        conns.append(conn)
    srv.close()
    return conns


def trainer(port: int = 8200, host: str = "127.0.0.1") -> socket.socket:
    """Connect to the barrier server (reference sync.py:17-22)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.connect((host, port))
    return sock


def barrier(role_sockets, is_server: bool) -> None:
    """One barrier round (reference sync.py:25-32): trainers send, the
    server collects one message from every trainer then acks."""
    if is_server:
        for conn in role_sockets:
            conn.recv(128)
        for conn in role_sockets:
            conn.send(_MSG)
    else:
        role_sockets.send(_MSG)
        role_sockets.recv(128)
