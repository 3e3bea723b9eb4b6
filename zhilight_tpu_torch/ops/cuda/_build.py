"""Build and load the port's hand-written CUDA kernels.

Each source ``zhilight_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens on first use, into
``zhilight_tpu_torch/build/`` (listed in ``.gitignore``), under a file name
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. All missing libraries are compiled
at once, one ``nvcc`` process each. Nothing here runs at import time: the
package imports on a machine without CUDA, and only a kernel launch on a CUDA
tensor reaches :func:`library`.
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
from typing import Dict, Tuple

__all__ = ["SOURCES", "build_all", "library", "check", "build_logs"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"

SOURCES = ("kv_write", "attn_headmajor", "prefill_attention")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _target(name: str) -> Tuple[Path, Path]:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return src, _BUILD / f"{name}-{digest[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is missing, all ``nvcc`` processes
    started together. Returns the seconds spent (0 when all were built).
    Raises RuntimeError with the compiler's output if any build fails."""
    with _lock:
        t0 = time.monotonic()
        todo = [(n, *_target(n)) for n in SOURCES]
        todo = [t for t in todo if not t[2].exists()]
        if not todo:
            return 0.0
        _BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, src, so in todo:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            procs.append((name, proc, tmp, so))
        errors = []
        for name, proc, tmp, so in procs:
            out, _ = proc.communicate()
            so.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        return time.monotonic() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)[1]))
                _libs[name] = lib
    return lib


def build_logs() -> Dict[str, str]:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) of
    each built library, by source name."""
    logs = {}
    for name in SOURCES:
        log = _target(name)[1].with_suffix(".log")
        if log.exists():
            logs[name] = log.read_text()
    return logs


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
