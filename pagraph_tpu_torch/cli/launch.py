"""Local multi-process launcher (torchrun-style; the port of
``pagraph_tpu/cli/launch.py``).

The reference spawns one trainer process per GPU with ``mp.spawn`` plus a
separate store-server process (reference: examples/profile/pa_gcn.py:157,
server/pa_server.py).  Here each process is one rank; this launcher starts
N of them on one machine, each running the worker command with
``--coordinator 127.0.0.1:<port> --num-processes N --process-id i``
appended (rank 0 hosts the TCP store on that port).  On several hosts each
host starts its own processes instead:

    # process i of N:
    python -m pagraph_tpu_torch.cli.train ... \\
        --coordinator host0:1234 --num-processes N --process-id i

Local usage (2 gloo ranks on the CPU; on the card drop --cpu-devices, one
rank a card):

    python -m pagraph_tpu_torch.cli.launch --nprocs 2 -- \\
        python -m pagraph_tpu_torch.cli.train --synthetic 2000 --cpu-devices 1 \\
        --partition 2 --cache-capacity 800 --epochs 4
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="spawn N local pagraph_tpu_torch processes",
        usage="%(prog)s --nprocs N -- python -m pagraph_tpu_torch.cli.train ...",
    )
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--timeout", type=float, default=None,
                   help="per-process wait timeout in seconds")
    p.add_argument("worker", nargs=argparse.REMAINDER,
                   help="worker command after --; '--coordinator/"
                        "--num-processes/--process-id' are appended")
    args = p.parse_args(argv)
    worker = args.worker
    if worker and worker[0] == "--":
        worker = worker[1:]
    if not worker:
        p.error("need a worker command after --")
    if worker[0] == sys.executable or worker[0] == "python":
        worker = worker[1:]

    from ..parallel.multihost import spawn_commands

    codes = spawn_commands(worker, args.nprocs, timeout=args.timeout)
    print(f"exit codes: {codes}", file=sys.stderr)
    return 0 if not any(codes) else 1


if __name__ == "__main__":
    sys.exit(main())
