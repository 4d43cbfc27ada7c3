"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled on its own (all nvcc processes started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The output goes to ``pagraph_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A failed build raises: there is no
fallback.  nvcc's output (with ``-Xptxas -v``: registers, shared memory and
spills per kernel) is kept in ``_build/<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C signature of every entry point, by library.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "gather_kernels": {
        "pg_gather_rows": (_P, _P, _P, _I64, _I, _I, _P),
        "pg_assemble_from_map": (_P, _P, _P, _P, _P, _P, _I64, _I, _I64, _I, _P),
        "pg_scatter_add_rows": (_P, _P, _P, _I64, _I, _P),
        "pg_gather_reduce": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
        "pg_gather_reduce_bwd": (_P, _P, _P, _P, _I64, _I, _I, _I, _P),
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


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, str]:
    """Compile every library whose output is missing, in parallel; return
    ``{name: path}``.  Raises with nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {n: t for n, t in targets.items() if not os.path.exists(t)}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            with open(os.path.join(BUILD_DIR, name + ".log"), "wb") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                              + out.decode(errors="replace"))
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


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
