"""Build the port's native libraries at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled on its own (all nvcc processes started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

and the host library ``csrc/host_native.cpp`` (the sampler and the miss-row
gathers) with g++:

    g++ -O3 -march=native -shared -fPIC -fopenmp -std=c++17
        -o _build/libhost_native-<hash>.so csrc/host_native.cpp

The output goes to ``pagraph_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Builds run under an exclusive
lock on ``_build/.lock`` (``fcntl.flock``, released if the process dies)
and write a temporary file that ``os.replace`` moves into place, so
processes that start at once (test workers) build a library once and never
load a half-written one.  A failed build raises: there is no fallback.  The
compilers' output (nvcc's with ``-Xptxas -v``: registers, shared memory and
spills per kernel) is kept in ``_build/<name>.log``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterator, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SRC = os.path.join(CSRC, "host_native.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# C signature of every entry point, by library.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "gather_kernels": {
        "pg_block_gather_fwd": (_P, _P, _I64, _P, _P, _I64, _I, _P, _P, _I,
                                _I, _I, _I, _P),
        "pg_assemble": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
        "pg_block_gather_bwd": (_P, _P, _P, _I64, _P, _P, _P, _I64, _I, _P, _P,
                                _I64, _I, _I, _I, _I, _P),
        "pg_window_reduce": (_P, _P, _P, _I64, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "pg_scatter_add_rows": (_P, _P, _I64, _P, _P, _I64, _I, _I, _I, _I, _P),
        "pg_dropout_block_fwd": (_P, _P, _I, _F, _P, _I64, _I, _I, _P, _P, _I, _I, _I, _P),
        "pg_dropout_block_bwd": (_P, _P, _P, _I, _F, _P, _I64, _I, _I64, _I, _P, _I, _I, _I,
                                 _P),
        "pg_gat_attention_fwd": (_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P, _I, _P),
        "pg_gat_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I64, _I, _I, _P, _P,
                                 _P, _I, _I, _P),
        "pg_mark": (_I, _P),
        "pg_graph_num_nodes": (_P, _P),
        "pg_graph_find_marks": (_P, _P, _I64, _P),
        "pg_graph_enable_nodes": (_P, _P, _I64, _I),
    },
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled at first use "
        "and need the CUDA toolkit (set CUDA_HOME)")


def _target(src: str, flags: Sequence[str]) -> str:
    """``_build/lib<stem>-<hash of the source and the flags>.so``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock() -> Iterator[None]:
    """Hold the exclusive lock on ``_build/.lock`` (one build at a time
    across processes)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(jobs: Dict[str, tuple]) -> None:
    """Run ``{name: (argv without -o, target)}`` at once, each into a
    temporary file moved into place on success; log each one's output to
    ``_build/<name>.log``.  Raises with the output of those that failed."""
    procs = {}
    for name, (argv, target) in jobs.items():
        tmp = f"{target}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen([*argv, "-o", tmp], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, name + ".log"), "wb") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n" + out.decode(errors="replace"))
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, str]:
    """Compile every CUDA library whose output is missing, in parallel;
    return ``{name: path}``.  Raises with nvcc's output if a build fails."""
    srcs = {name: os.path.join(CSRC, name + ".cu") for name in SIGNATURES}
    targets = {name: _target(src, NVCC_FLAGS) for name, src in srcs.items()}
    with _build_lock():
        todo = {n: t for n, t in targets.items() if not os.path.exists(t)}
        if todo:
            nvcc = _nvcc()
            _compile({n: ([nvcc, *NVCC_FLAGS, srcs[n]], t) for n, t in todo.items()})
    return targets


def build_host() -> str:
    """The host library's path, compiled with g++ first if it is missing.
    Raises ``RuntimeError`` if there is no g++ or the build fails."""
    target = _target(HOST_SRC, CXX_FLAGS)
    with _build_lock():
        if not os.path.exists(target):
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the host library is compiled at first use")
            _compile({"host_native": ([cxx, *CXX_FLAGS, HOST_SRC], target)})
    return target


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` with argtypes/restype set on each entry
    point (builds every library first if needed)."""
    lib = ctypes.CDLL(build_all()[name])
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib
