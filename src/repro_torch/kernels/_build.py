"""Build the port's CUDA sources into shared libraries at first use.

Each kernel source exposes a plain C entry point (no PyTorch headers), so
``nvcc`` builds it in seconds and no ``ninja`` is needed: this module runs
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` itself and loads
the result with ``ctypes``.  Libraries land in ``build/repro_torch/`` at the
root of the checkout, named by a hash of the source and the flags, so a
source edit rebuilds and an unchanged one is reused.

Nothing here runs at import time: the CPU test suite imports every module
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict

KERNEL_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A CUDA source failed to compile or load."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError("nvcc not found (looked on PATH and under CUDA_HOME)")


def library_path(source: str) -> pathlib.Path:
    """Where the library for ``source`` (a file name in this directory)
    lives once built: keyed by the source's and the flags' hash."""
    text = (KERNEL_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{digest}.so"


def load(source: str) -> ctypes.CDLL:
    """Build ``source`` if its hash has no library yet, then load it.
    Raises :class:`KernelBuildError` with the compiler's output on failure."""
    if source in _LOADED:
        return _LOADED[source]
    path = library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(KERNEL_DIR / source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"could not load {path}: {e}") from e
    _LOADED[source] = lib
    return lib
