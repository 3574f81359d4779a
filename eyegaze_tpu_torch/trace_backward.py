"""Where a block of K4's one-pass backward kernels spends its cycles, on one
CUDA card: ``clock64`` stamps of each warp role at each wait and phase of a
query tile.

    python -m eyegaze_tpu_torch.trace_backward [--case N] [--source FILE]

``csrc/attention.cu`` (or another version of it, ``--source``) is built
once more with ``ATTENTION_TRACE`` defined:
its ``TRACE`` points then write the cycle counter of thread 0 of each role
in block (0, 0, 0) into a ``__device__`` array, read back through the C
entry ``attention_trace_read``.  The case is one of
``attention.BACKWARD_CASES`` (default 0, ART's training shape) and must take
a one-pass path.  Prints each role's phases per tile in cycles.  A
diagnostic: each stamp costs its thread a few cycles, and the numbers are
one block's.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch.kernels import attention, build

TILES, POINTS = 64, 12  # the stamps kept, as in csrc/attention.cu
# Per path, each role's phases: (label, from the first of these points that
# a tile stamps, to point).  Role 1 is the copier (mma.sync kernel) or the
# relay (wgmma kernel); role 2 the reducers.
PHASES = {
    "one_pass": {
        "consumer": (("wait for data", (0,), 1), ("scores", (1,), 2), ("dS barrier", (2,), 3),
                     ("wait for freed", (3,), 4), ("partial dQ", (4,), 5),
                     ("partial barrier", (5,), 6)),
        "copier": (("wait for a stage", (0,), 1), ("copies", (1,), 2)),
        "reducer": (("wait for ready", (0,), 1), ("sum", (1,), 2)),
    },
    "one_pass_wgmma": {
        "consumer": (("wait for data", (0,), 1), ("S and dP", (1,), 2), ("scores", (2,), 3),
                     ("dV, dK issue, dS barrier", (3,), 4), ("wait for freed", (4,), 5),
                     ("dV, dK wait", (5,), 6), ("partial dQ", (6,), 7),
                     ("partial store", (7,), 8), ("end barrier", (8,), 9)),
        "relay": (("wait for the partial", (0,), 1),),
        "reducer": (("wait for ready", (0,), 1), ("sum", (1,), 2)),
    },
}


def phases(stamps: np.ndarray, spec: tuple, tiles: int) -> list:
    """Per tile, each phase's cycles from the raw (TILES, POINTS) stamps;
    None for a phase the tile does not stamp."""
    rows = []
    for j in range(min(tiles, TILES)):
        row = {}
        for label, starts, end in spec:
            start = next((a for a in starts if stamps[j, a]), None)
            row[label] = (int(stamps[j, end] - stamps[j, start])
                          if start is not None and stamps[j, end] else None)
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--case", type=int, default=0,
                        help="index into attention.BACKWARD_CASES (a one-pass case)")
    parser.add_argument("--source", type=Path, default=build.CSRC / "attention.cu",
                        help="the version of attention.cu to trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_backward needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    entry, (b, tq, h, d), tk = attention.BACKWARD_CASES[args.case]
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "attention_trace.cu"
        src.write_text("#define ATTENTION_TRACE\n" + args.source.read_text())
        lib = ctypes.CDLL(str(build.build_sources({"trace": src})["trace"][0]))
    path = attention._PATHS.get(lib.attention_backward_path(tk, d))
    if path not in PHASES:
        raise SystemExit(f"case {args.case} takes the {path} path, not a one-pass one")
    flash = entry == "flash_attention"
    t_dim, h_dim = (2, 1) if flash else (1, 2)
    scale = 1.0 / math.sqrt(d)
    device = torch.device("cuda", 0)
    r = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(r.normal(size=(b, t, h, d)).astype(np.float32)).to(
        device, torch.bfloat16) for t in (tq, tk, tk, tq))
    if flash:
        q, k, v, g = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    o, lse = attention._forward(entry, q, k, v, scale, t_dim, h_dim, with_lse=True)
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    launch = attention.bind_backward(lib)
    for _ in range(3):  # the last launch's stamps stay
        err = launch(*attention.backward_args(q, k, v, o, lse, g, *grads, scale, t_dim, h_dim))
        if err != 0:
            raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * (3 * TILES * POINTS))()
    if lib.attention_trace_read(out) != 0:
        raise RuntimeError("reading the trace failed")
    stamps = np.array(out[:], dtype=np.int64).reshape(3, TILES, POINTS)
    queries = attention._loop_scores(lib, path, d) // 16  # a tile: 16 keys a warp by these
    tiles = -(-tq // queries)
    print(f"{entry} (B {b}, H {h}, Tq {tq}, Tk {tk}, d {d}), the {path} path, block (0, 0, 0)")
    result = {role: phases(stamps[i], spec, tiles)
              for i, (role, spec) in enumerate(PHASES[path].items())}
    for role, rows in result.items():
        print(f"{role}, cycles per tile: " + "; ".join(
            f"tile {j} " + ", ".join(f"{k} {v}" for k, v in row.items())
            for j, row in enumerate(rows)))
    return result


if __name__ == "__main__":
    main()
