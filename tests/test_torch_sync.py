"""``pagraph_tpu_torch.utils.sync`` against ``pagraph_tpu.utils.sync``, of
which it is a copy: the same functions with the same signatures;
``ProcessBarrier`` holds spawned processes until the last party arrives and
breaks on a timeout, in both; the reference's socket barrier works across
the packages, a server of either with trainers of the other."""
import inspect
import multiprocessing as mp
import os
import socket
import threading
import time

import pytest

from pagraph_tpu.utils import sync as jsync
from pagraph_tpu_torch.utils import sync as tsync
from tests.sync_worker import arrive

MODULES = {"jax": jsync, "port": tsync}


def test_same_functions_and_signatures():
    for name in ("ProcessBarrier", "server", "trainer", "barrier"):
        assert inspect.signature(getattr(tsync, name)) == inspect.signature(
            getattr(jsync, name)), name
    assert tsync._MSG == jsync._MSG


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_process_barrier_holds_processes(tmp_path, pkg):
    """Two spawned processes wait at a 3-party barrier until this process,
    the last, arrives; none lets go before."""
    barrier = MODULES[pkg].ProcessBarrier(3)
    ctx = mp.get_context("spawn")
    paths = [str(tmp_path / f"p{i}") for i in range(2)]
    procs = [ctx.Process(target=arrive, args=(barrier, 0.05 * i, paths[i])) for i in range(2)]
    for p in procs:
        p.start()
    time.sleep(1.0)
    assert not any(os.path.exists(p) for p in paths)    # both still waiting
    arrived = time.time()
    barrier.barrier(timeout=60)
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    for path in paths:
        with open(path) as f:
            assert float(f.read()) >= arrived


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_process_barrier_breaks_on_timeout(pkg):
    barrier = MODULES[pkg].ProcessBarrier(2)
    with pytest.raises(threading.BrokenBarrierError):
        barrier.barrier(timeout=0.1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("server_pkg,trainer_pkg", [("jax", "port"), ("port", "jax"),
                                                    ("port", "port")])
def test_socket_barrier_across_packages(server_pkg, trainer_pkg):
    """Two rounds of the reference's barrier between a server of one
    package and two trainers of the other: no trainer leaves a round before
    every trainer has entered it."""
    srv_mod, tr_mod = MODULES[server_pkg], MODULES[trainer_pkg]
    port, world, rounds = _free_port(), 2, 2
    entered = [[None] * world for _ in range(rounds)]
    left = [[None] * world for _ in range(rounds)]
    conns = []
    srv = threading.Thread(target=lambda: conns.extend(srv_mod.server(world, port=port)))
    srv.start()

    def trainer(i):
        sock = None
        for _ in range(100):                 # until the server listens
            try:
                sock = tr_mod.trainer(port=port)
                break
            except ConnectionRefusedError:
                time.sleep(0.05)
        for r in range(rounds):
            time.sleep(0.1 * i)
            entered[r][i] = time.monotonic()
            tr_mod.barrier(sock, is_server=False)
            left[r][i] = time.monotonic()
        sock.close()

    trainers = [threading.Thread(target=trainer, args=(i,)) for i in range(world)]
    for t in trainers:
        t.start()
    srv.join(30)
    assert len(conns) == world
    for _ in range(rounds):
        srv_mod.barrier(conns, is_server=True)
    for t in trainers:
        t.join(30)
    for c in conns:
        c.close()
    for r in range(rounds):
        assert min(left[r]) >= max(entered[r]), (r, entered[r], left[r])
