"""Multi-process training over ``torch.distributed``: one process a rank (the
port of ``pagraph_tpu/parallel/multihost.py``).

The JAX package drives every chip from one controller process through a
``jax.sharding.Mesh`` and ``shard_map``; the port follows PyTorch's idiom
and the reference's own topology instead (reference:
examples/profile/pa_gcn.py:18-24,117-157, ``mp.spawn`` + DDP/NCCL): one
process a rank, each owning one partition and its device.  The mesh has no
counterpart beyond the process group, and neither do ``place_dp`` and
``place_replicated``: each rank owns its tensors, and figures that must
agree across ranks come from collectives (``parallel/dp_trainer.py``).

The backend is the caller's choice, never a fallback: ``nccl`` (the
default: one rank a GPU, the rank's device ``cuda:<rank % GPUs>``), or
``gloo`` (the CPU, or several ranks sharing one card).  A world size larger
than the visible GPUs under ``nccl`` is a ``ValueError`` before any process
group exists: NCCL refuses two ranks on one GPU.

The rendezvous is a ``file://`` store by default (a fresh file under the
temporary directory), so no network port is needed.  Independently started
processes (``cli.launch``, or one command a host) meet at rank 0's TCP store
instead: ``init_method="tcp://host:port"``; :func:`spawn_commands` starts
such processes on this host, on a free loopback port.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, world_size: int) -> None:
    """``ValueError`` for an unknown backend, or for ``nccl`` with more
    ranks than visible GPUs (or none)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > gpus:
            raise ValueError(
                f"backend 'nccl' takes one GPU a rank: world size {world_size} > "
                f"{gpus} visible GPUs (NCCL refuses two ranks on one GPU). Use "
                "backend='gloo' for several ranks on one card, or on the CPU")


def fresh_init_method() -> str:
    """A ``file://`` rendezvous on a new, empty file under the temporary
    directory (the store removes it when its last rank is done)."""
    fd, path = tempfile.mkstemp(prefix="pagraph_dist_")
    os.close(fd)
    return "file://" + path


def init_distributed(rank: int, world_size: int, *, backend: str = "nccl",
                     init_method: Optional[str] = None) -> None:
    """Join the process group as ``rank`` of ``world_size`` (the port of
    ``init_distributed``, which joins ``jax.distributed``).  Under ``nccl``
    the rank's device becomes ``cuda:<rank % GPUs>`` first.  All ranks pass
    the same ``init_method`` (default: a ``file://`` store, which only a
    single caller can create: pass it explicitly for more than one rank)."""
    check_backend(backend, world_size)
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already")
    if init_method is None:
        if world_size > 1:
            raise ValueError("init_method is needed for more than one rank: every rank "
                             "passes the same one")
        init_method = fresh_init_method()
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def is_multiprocess() -> bool:
    """More than one rank in the process group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_dp_rows() -> List[int]:
    """The partitions this process owns: its rank's (the port of
    ``local_dp_rows``, one row a process)."""
    return [dist.get_rank() if dist.is_initialized() else 0]


def _run_rank(rank: int, world_size: int, backend: str, init_method: str,
              fn: Callable, args: tuple) -> None:
    """A spawned rank: join the group, run ``fn(rank, world_size, *args)``,
    leave the group.  An exception ends the process with its traceback and
    exit code 1 (``multiprocessing`` prints and sets it)."""
    init_distributed(rank, world_size, backend=backend, init_method=init_method)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, *args, backend: str = "nccl",
                init_method: Optional[str] = None,
                timeout: Optional[float] = None) -> List[int]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes on
    this host, each a rank of one process group (the port of
    ``spawn_local``, torchrun-style).  ``fn`` must be a module-level
    function: the ranks start with the ``spawn`` method (``fork`` after
    CUDA is initialized is broken), so each child imports ``fn``'s module.

    Returns every rank's exit code; raises ``RuntimeError`` if any is not
    0.  When one rank fails, the others are terminated (they would wait in
    a collective for it), and so are all of them at ``timeout`` seconds."""
    check_backend(backend, world_size)
    own_store = init_method is None
    if own_store:
        init_method = fresh_init_method()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run_rank,
                         args=(r, world_size, backend, init_method, fn, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    try:
        _wait_all(procs, timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
        path = init_method[len("file://"):]
        if own_store and os.path.exists(path):
            os.remove(path)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    return codes


def _wait_all(procs, timeout: Optional[float]) -> None:
    """Wait until every process has exited, or one exits non-zero, or
    ``timeout`` seconds pass."""
    deadline = None if timeout is None else time.monotonic() + timeout
    live = list(procs)
    while live:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            return
        multiprocessing.connection.wait([p.sentinel for p in live], left)
        for p in [p for p in live if not p.is_alive()]:
            p.join()
            live.remove(p)
            if p.exitcode != 0:
                return


def spawn_commands(worker: Sequence[str], num_processes: int, *,
                   timeout: Optional[float] = None,
                   stdout_paths: Optional[Sequence[str]] = None) -> List[int]:
    """Run ``num_processes`` copies of a command locally (torchrun-style):
    ``python <worker...> --coordinator 127.0.0.1:<port> --num-processes N
    --process-id i``, ``port`` a loopback port that was free a moment
    before (the port of the JAX package's ``spawn_local`` of a command
    line; :func:`spawn_local` here runs a function).  ``stdout_paths``
    takes each process's standard output.  Waits ``timeout`` seconds a
    process, kills the survivors on the way out (a timeout raises
    ``subprocess.TimeoutExpired``), and returns the exit codes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    outs = [open(stdout_paths[i], "w") if stdout_paths else None
            for i in range(num_processes)]
    procs = []
    try:
        for i in range(num_processes):
            procs.append(subprocess.Popen(
                [sys.executable, *worker, "--coordinator", coord,
                 "--num-processes", str(num_processes), "--process-id", str(i)],
                stdout=outs[i]))
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs:
            if f:
                f.close()
