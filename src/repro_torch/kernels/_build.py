"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of the source and
the flags, so an edited source never loads a stale library.  ``ctypes`` loads
it.  Nothing is built at import: the first launch builds, and
:func:`build` starts several ``nvcc`` processes at once for callers that want
every kernel ready up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "SOURCES", "build", "load"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

SOURCES: Dict[str, Path] = {
    "fragment_gather": _KERNELS / "fragment_gather" / "csrc" / "fragment_gather.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(*names: str) -> Dict[str, float]:
    """Compile the named kernels (all of them when none is named), every
    ``nvcc`` started at once.  Returns the seconds each took; a library
    already built counts 0.  The compiler's report (registers, spills) is
    kept beside each library as ``<name>.log``.  Raises on any failure."""
    names = names or tuple(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            target,
            time.perf_counter(),
        )
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
