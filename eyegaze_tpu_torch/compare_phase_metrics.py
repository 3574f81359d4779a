"""Time the phase-metrics kernels (K1 and K2) against other versions of
their source, in one process on one CUDA card.

    git show <commit>:eyegaze_tpu_torch/csrc/phase_metrics.cu > .archive/old.cu
    python -m eyegaze_tpu_torch.compare_phase_metrics .archive/old.cu [other.cu ...]

Each other source is a version of ``csrc/phase_metrics.cu`` with the same C
entry points ``phase_metrics_launch`` and ``phase_plv_metrics_launch`` (an
earlier commit's, or a variant).  All are built at once with the port's nvcc
flags, and their ptxas lines (registers, spills) for each kernel instance
are printed.  At each shape below, each build is held to the plain version
at the port's tolerances (``phase_metrics.assert_sums_close``), launched
twice to check that it gives the same bits, and timed in turns with the
others: one call between CUDA events, and 20 calls replayed from a CUDA
graph (device time alone).  The shapes are K1's at the EEG serving run's
N = 6 x bucket (6, 48, 192, 768) and K2's at the shootout's N = 64 and at
768, all at C = 32, T = 1024; the split of T that this source's launch picks
is printed at each.  The last line of stdout is one JSON object with the
card and every time.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch.compare_attention import GRAPH_CALLS, ROUNDS, cuda_ms, graph
from eyegaze_tpu_torch.kernels import build, phase_metrics

SHAPES = {"phase_metric_sums": ((6, 32, 1024), (48, 32, 1024), (192, 32, 1024),
                                (768, 32, 1024)),
          "phase_plv_metric_sums": ((64, 32, 1024), (768, 32, 1024))}
REFERENCES = {"phase_metric_sums": phase_metrics.pairwise_phase_metrics_reference,
              "phase_plv_metric_sums": phase_metrics.pairwise_phase_plv_metrics_reference}


def inputs(shape, device, seed):
    """Phases in [-pi, pi) and powers in [0, 1), pair (0, 0) tied."""
    n, c, t = shape
    r = np.random.default_rng(seed)
    ph1 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2[:, 0] = ph1[:, 0]  # exact ties exercise sign(0) = 0
    pw1 = r.random((n, c, t)).astype(np.float32)
    pw2 = r.random((n, c, t)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (ph1, ph2, pw1, pw2)]


def ptxas_lines(report: str) -> list:
    """(kernel instance, registers-and-spills line) for each phase-metrics
    kernel in an nvcc ``-Xptxas -v`` report."""
    lines, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "phase_metrics_kernel" in line else None
        elif name and ("registers" in line or "spill" in line):
            lines.append((name, line.strip()))
    return lines


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", type=Path, help="other versions of phase_metrics.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_phase_metrics needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)

    sources = {"this": build.CSRC / "phase_metrics.cu",
               **{str(s): s.resolve() for s in args.sources}}
    built = build.build_sources(sources)
    launchers, result = {}, {"card": card, "device": torch.cuda.get_device_name(0),
                             "ptxas": {}, "shapes": {}}
    for name, (lib, report) in built.items():
        print(f"{name}: {lib.name}")
        result["ptxas"][name] = []
        for kernel, line in ptxas_lines(report):
            print(f"  ptxas {kernel}: {line}")
            result["ptxas"][name].append(f"{kernel}: {line}")
        cdll = ctypes.CDLL(str(lib))
        launchers[name] = {w: phase_metrics.bind(cdll, *phase_metrics.ENTRIES[w])
                           for w in phase_metrics.ENTRIES}

    device = torch.device("cuda", 0)
    for wrapper, shapes in SHAPES.items():
        outputs = phase_metrics.ENTRIES[wrapper][1]
        for seed, shape in enumerate(shapes):
            x = inputs(shape, device, seed)
            want = REFERENCES[wrapper](*x)
            calls, rows = {}, {}
            for name, fns in launchers.items():
                outs = [torch.empty(shape[:2] + shape[1:2], device=device) for _ in range(outputs)]
                calls[name] = lambda fn=fns[wrapper], outs=outs: _check_err(  # current stream
                    fn(*phase_metrics.launch_args(x, outs)))
                calls[name]()
                torch.cuda.synchronize()
                first = [o.clone() for o in outs]
                calls[name]()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(first, outs))
                if not same:
                    raise RuntimeError(f"{name} {wrapper} {shape}: two launches differ")
                rows[name] = {"max_abs_err": max(phase_metrics.assert_sums_close(
                    outs, want, x[2], x[3])), "same_bits": same}
            graphs = {name: graph(call) for name, call in calls.items()}
            one = {name: [] for name in calls}
            replay = {name: [] for name in calls}
            for i in range(ROUNDS):  # in turns, the order reversed every other round
                names = list(calls) if i % 2 == 0 else list(calls)[::-1]
                for name in names:
                    one[name].append(cuda_ms(calls[name]))
                    replay[name].append(cuda_ms(graphs[name].replay) / GRAPH_CALLS)
            split = phase_metrics.split(*shape)
            key = f"{wrapper} {'x'.join(map(str, shape))}"
            print(f"{key}: this source splits T over {split} block(s) of a cluster, "
                  f"{phase_metrics.grid_blocks(shape[0], shape[1], split)} blocks")
            for name in calls:
                rows[name].update(ms=statistics.median(one[name]),
                                  graph_ms=statistics.median(replay[name]))
                print(f"{key} {name}: max |kernel - plain| {rows[name]['max_abs_err']:.3e}, "
                      f"two launches bit-identical; one call {rows[name]['ms']:.4f} ms, graph "
                      f"{rows[name]['graph_ms']:.4f} ms (medians of {ROUNDS})")
            result["shapes"][key] = {"split": split, **rows}
            del x, want, graphs
    print(json.dumps(result))
    return result


def _check_err(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"phase-metrics kernel launch failed: cudaError {err}")


if __name__ == "__main__":
    main()
