"""Build and load the port's hand-written CUDA kernels.

Each source ``zhilight_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
loaded with :mod:`ctypes`. The build happens on first use, into
``zhilight_tpu_torch/build/`` (listed in ``.gitignore``), under a file name
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt
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

import torch

__all__ = ["SOURCES", "build_all", "build_seconds", "library", "check", "build_logs",
           "elem_flag"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"

SOURCES = ("kv_write", "attn_headmajor", "attn_headmajor_q", "prefill_attention",
           "prefill_attention_q", "quant_matmul", "kv_write_2d", "mla_decode", "quant_ragged",
           "fp8_matmul", "kv_write_pair", "paged_attention", "paged_attention_q", "kv_flush",
           "paged_attention_fused")
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
    # the headers a source may include are part of its key: an edit there rebuilds
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(_FLAGS).encode()).hexdigest()
    return src, _BUILD / f"{name}-{digest[:16]}.so"


# seconds each library's nvcc took in the last build_all that compiled it
build_seconds: Dict[str, float] = {}


def build_all() -> float:
    """Compile every kernel library that is missing, all ``nvcc`` processes
    started together (each one's wall time into :data:`build_seconds`).
    Returns the seconds spent (0 when all were built). Raises RuntimeError
    with the compiler's output if any build fails."""
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
            log = so.with_suffix(".log")
            with open(log, "w") as out:  # the compiler's output goes to the log
                proc = subprocess.Popen([nvcc, *_FLAGS, "-o", str(tmp), str(src)],
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append((name, proc, tmp, so, log))
        errors = []
        running = list(procs)
        while running:
            for item in list(running):
                name, proc, tmp, so, log = item
                if proc.poll() is None:
                    continue
                running.remove(item)
                build_seconds[name] = time.monotonic() - t0
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exit {proc.returncode}\n{log.read_text()}")
                else:
                    os.replace(tmp, so)
            time.sleep(0.05)
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


# the element types of the kernels' q, rows, outputs and model-dtype pools:
# their C entry points take 0 for bf16 and 1 for fp16
_ELEM_FLAGS = {torch.bfloat16: 0, torch.float16: 1}


def elem_flag(what: str, *tensors: torch.Tensor) -> int:
    """The C entry points' element-type flag of ``tensors``, which must all
    be bf16 or all fp16; raises NotImplementedError for any other dtype or a
    mix of the two."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _ELEM_FLAGS:
        raise NotImplementedError(f"{what}: the kernel takes bf16 or fp16, all of one type, "
                                  f"got {'/'.join(str(t.dtype) for t in tensors)}")
    return _ELEM_FLAGS[tensors[0].dtype]
