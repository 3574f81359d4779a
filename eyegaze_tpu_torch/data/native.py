"""ctypes binding of the native C++ CSV loader, built at first use.

The port's copy of ``eyegaze_tpu/data/native.py``.  ``native/csv_loader.cpp``
(at the repository's root) is compiled with ``g++ -O3 -shared -fPIC`` the
first time a CSV is read, into ``eyegaze_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, never next to the source.  The
pure-numpy parser ``numpy_parse`` is its plain twin: where no compiler is
there, or the build fails, every read goes to it, and ``native_available``
says which path is in use.  Host code only.  ``load_csv_batch_f32`` reads
many files into one block in a single call (the raw converter's path,
``preprocess_eeg_raw``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "csv_loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")


def _build() -> Optional[Path]:
    """The shared library of ``_SRC``, compiled unless it exists; None where
    there is no source or no compiler, or the build fails."""
    if not _SRC.is_file():
        return None
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"csv_loader-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.csv_load_f32.restype = ctypes.c_int
    lib.csv_load_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.csv_load_batch_f32.restype = ctypes.c_int64
    lib.csv_load_batch_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def native_available() -> bool:
    """True where reads go to the compiled loader, False where they go to
    ``numpy_parse``."""
    return _library() is not None


def numpy_parse(path: str | Path, max_rows: int, max_cols: int) -> Tuple[np.ndarray, int, int]:
    """The plain twin: ``load_csv_f32``'s result from Python's float parser
    (an unparsable field reads as 0, blank lines are skipped)."""
    out = np.zeros((max_rows, max_cols), np.float32)
    rows = cols = 0
    with open(path) as f:
        for line in f:
            if rows >= max_rows:
                break
            vals = []
            for tok in line.strip().split(","):
                tok = tok.strip()
                if not tok:
                    continue
                try:
                    vals.append(float(tok))
                except ValueError:
                    vals.append(0.0)
            if not vals:
                continue
            n = min(len(vals), max_cols)
            out[rows, :n] = vals[:n]
            if rows == 0:
                cols = n
            rows += 1
    return out, rows, cols


def load_csv_f32(path: str | Path, max_rows: int = 64,
                 max_cols: int = 8192) -> Tuple[np.ndarray, int, int]:
    """Parse a numeric CSV into a zero-padded (max_rows, max_cols) float32
    array; returns (array, n_rows, n_cols of the first row)."""
    lib = _library()
    if lib is None:
        return numpy_parse(path, max_rows, max_cols)
    out = np.zeros((max_rows, max_cols), np.float32)
    r, c = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.csv_load_f32(str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          max_rows, max_cols, ctypes.byref(r), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"csv_load_f32 failed ({rc}) for {path}")
    return out, r.value, c.value


def load_csv_batch_f32(paths: Sequence[str | Path], max_rows: int = 64, max_cols: int = 8192
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse many CSVs into one zero-padded (n, max_rows, max_cols) float32
    block; returns (block, rows (n,) int64, cols (n,) int64, ok (n,) bool).
    A file that cannot be read leaves its slab zero and ``ok`` False."""
    n = len(paths)
    out = np.zeros((n, max_rows, max_cols), np.float32)
    rows = np.zeros(n, np.int64)
    cols = np.zeros(n, np.int64)
    lib = _library()
    if lib is None:
        ok = np.zeros(n, bool)
        for i, p in enumerate(paths):
            try:
                out[i], rows[i], cols[i] = numpy_parse(p, max_rows, max_cols)
                ok[i] = True
            except OSError:
                pass
        return out, rows, cols, ok
    ok = np.zeros(n, np.uint8)
    buf = b"".join(str(p).encode() + b"\0" for p in paths)
    lib.csv_load_batch_f32(buf, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           max_rows, max_cols,
                           rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, rows, cols, ok.astype(bool)
