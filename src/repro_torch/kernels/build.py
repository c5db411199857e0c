"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` into shared
libraries with a plain C interface, and loads them with ``ctypes``.

Each source becomes one library under ``build/kernels/`` at the root of
the checkout, named by a hash of its source and flags, so an edited
source rebuilds and an unchanged one loads as it is. All missing
libraries compile in parallel, one ``nvcc`` per source. Nothing builds at
import time: the first wrapper that launches a kernel (or
:func:`build_all`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# exported C functions: name -> (library, argtypes); each returns the
# cudaError_t of its launch
SIGNATURES = {
    "frontier_ell_launch": ("frontier", [_P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _P]),
    "tail_reduce_launch": ("tail_reduce", [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _P]),
    "segment_sum_launch": ("segment_sum", [_P, _P, _P, _L, _I, _I, _P]),
    "spmv_ell_launch": ("spmv", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "sample_neighbors_launch": ("sampler", [_P, _P, _P, _P, _P, _P, _L, _I,
                                            _I, _I, _P]),
}
LIBRARIES = sorted({lib for lib, _ in SIGNATURES.values()})

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> Dict[str, str]:
    """Compile every library that is not built yet, all at once. Returns
    each library's compiler output (``-Xptxas=-v``: registers, shared
    memory, spills), empty for a library that was already built. Raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBRARIES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in LIBRARIES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)      # atomic: a reader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _target(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, (owner, argtypes) in SIGNATURES.items():
        if owner == name:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib

