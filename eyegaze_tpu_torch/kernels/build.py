"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C entry point, so it compiles in seconds
into a shared library without PyTorch's headers, and ``ctypes`` loads it.
The library lands in ``eyegaze_tpu_torch/_build/``, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
built once per checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns the library's path and nvcc's report (register and shared-memory
    use from ``-Xptxas -v``; empty when the library was already built).
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(str(build(name)[0]))
