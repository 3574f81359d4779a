"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C entry point, so it compiles in seconds
into a shared library without PyTorch's headers, and ``ctypes`` loads it.
The library lands in ``eyegaze_tpu_torch/_build/``, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
built once per checkout.  ``build_all`` starts one nvcc per source, all at
once; ``build_sources`` does the same for sources elsewhere (another
version of a kernel, timed beside this one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

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


def _library(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_sources(sources: Dict[str, Path]) -> Dict[str, Tuple[Path, str]]:
    """Compile each source whose library is missing, one nvcc process per
    source, all started together.

    Returns, per key of ``sources``, the library's path and nvcc's report
    (register and shared-memory use from ``-Xptxas -v``; empty when the
    library was already built).  Waits for every process before raising on a
    failed build.
    """
    results: Dict[str, Tuple[Path, str]] = {}
    jobs = {}
    for name, src in sources.items():
        lib = _library(src)
        if lib.exists():
            results[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        jobs[name] = (src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (src, lib, tmp, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
        results[name] = (lib, out + err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
    """``build_sources`` of ``csrc/<name>.cu`` for each name."""
    return build_sources({name: CSRC / f"{name}.cu" for name in names})


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists (see ``build_all``)."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(str(build(name)[0]))
