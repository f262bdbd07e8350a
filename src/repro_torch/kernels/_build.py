"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of the source and
the flags, so an edited source never loads a stale library.  ``ctypes`` loads
it.  A kernel in ``VARIANTS`` is built once per value of a compile-time
define, each value a library of its own: a call builds and loads only the
one it needs.  Nothing is built at import: the first launch builds, and
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
from typing import Dict, List, Optional, Tuple

__all__ = ["BUILD_DIR", "SOURCES", "VARIANTS", "build", "cuda_tool", "libraries", "load", "target"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

SOURCES: Dict[str, Path] = {
    "fragment_gather": _KERNELS / "fragment_gather" / "csrc" / "fragment_gather.cu",
    "flash_attention": _KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    "mamba2_ssd": _KERNELS / "mamba2_ssd" / "csrc" / "mamba2_ssd.cu",
    "dequant": _KERNELS / "dequant" / "csrc" / "dequant.cu",
}

# kernel -> (define, values): flash_attention is built per head width, so a
# model's first call compiles only its width's forward and backward kernels
# (all six widths took 24 s of nvcc on the H100 host; a training run's set-up
# pays for its one width)
VARIANTS: Dict[str, Tuple[str, Tuple[int, ...]]] = {
    "flash_attention": ("FA_HEAD_DIM", (16, 32, 64, 96, 128, 192)),
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


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program beside ``nvcc`` (``cuobjdump``)."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def libraries(*names: str) -> List[Tuple[str, Optional[int]]]:
    """``(kernel, variant)`` of every library of the named kernels (all of
    them when none is named); ``variant`` is None for a kernel built once."""
    libs: List[Tuple[str, Optional[int]]] = []
    for name in names or tuple(SOURCES):
        libs += [(name, v) for v in VARIANTS[name][1]] if name in VARIANTS else [(name, None)]
    return libs


def _flags(name: str, variant: Optional[int]) -> Tuple[str, ...]:
    if (name in VARIANTS) != (variant is not None) or (variant is not None and variant not in VARIANTS[name][1]):
        raise ValueError(f"kernel {name} has the variants {VARIANTS.get(name, (None, ()))[1]}, not {variant}")
    return NVCC_FLAGS if variant is None else (*NVCC_FLAGS, f"-D{VARIANTS[name][0]}={variant}")


def _label(name: str, variant: Optional[int]) -> str:
    return name if variant is None else f"{name}.{variant}"


def target(name: str, variant: Optional[int] = None) -> Path:
    """The library of kernel ``name`` (of its ``variant``) as its current
    source builds it."""
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(_flags(name, variant)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{_label(name, variant)}-{digest}.so"


def build(*names: str, variant: Optional[int] = None) -> Dict[str, float]:
    """Compile the named kernels (all of them when none is named), each
    variant a library (only ``variant`` where it is given), every ``nvcc``
    started at once.  Returns the seconds each library took, by kernel name
    (``<name>.<variant>`` for a variant); a library already built counts 0.
    The compiler's report (registers, spills) is kept beside each library as
    ``<label>.log``.  Raises on any failure."""
    libs = [(name, variant) for name in names] if variant is not None else libraries(*names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, var in libs:
        path = target(name, var)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name, var), "-o", str(tmp), str(SOURCES[name])]
        procs[_label(name, var)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            path,
            time.perf_counter(),
        )
    seconds = {_label(name, var): 0.0 for name, var in libs}
    failures = []
    for name, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return seconds


def load(name: str, variant: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (of its ``variant``), built on
    first use."""
    label = _label(name, variant)
    with _lock:
        lib = _libs.get(label)
        if lib is None:
            build(name, variant=variant)
            lib = _libs[label] = ctypes.CDLL(str(target(name, variant)))
        return lib
