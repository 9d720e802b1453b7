"""Build the CUDA sources in `csrc/` with nvcc, load them with ctypes, and
check their launches.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into `build/<name>-<hash>.so` (`-gencode arch=compute_90a,code=sm_90a`), one
nvcc process per source, all started together. No PyTorch header is
included, so a build takes seconds, not minutes. Nothing is built when this
module is imported: `library(name)` builds at first use and caches the
handle for the process. `build/` is git-ignored; the hash of the source and
flags in the file name keeps a stale library from being loaded.

Launches go on PyTorch's current stream and do not synchronise. Temporaries
a wrapper frees right after a launch are safe: PyTorch's caching allocator
hands freed memory out again only to work queued later on the same stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's `-Xptxas -v` report (registers, shared memory, spills)
PTXAS_REPORTS: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"{name}-{digest}.so"


def build(names) -> Dict[str, float]:
    """Compile every source in `names` that is not built yet, in parallel.
    Returns the seconds each compile took (0 for one already built)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS_REPORTS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    return {name: BUILD_SECONDS[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        lib.kdt_error_string.restype = ctypes.c_char_p
        lib.kdt_error_string.argtypes = [ctypes.c_int]
        msg = lib.kdt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels load 8 bf16 at
    a time); a view that starts mid-vector is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
