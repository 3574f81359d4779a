"""Connectivity shootout: the phase-metrics kernels against their alternatives.

The counterpart of ``scripts/bench_pallas.py``.  On the same seeded inputs
(uniform phases in [-pi, pi), powers in [0, 1), (B, C, T) float32) it times
three comparisons and prints one JSON line:

1. PLI / wPLI / Phase_Diff: the plain row-chunked broadcast-reduce against
   K1 (``kernels.phase_metrics.pairwise_phase_metrics``).
2. PLV with the other three: the production route, four matrix products on
   cos / sin given as inputs (``_plv_matrix``) plus K1, against the widened
   route, K2 alone (``pairwise_phase_plv_metrics``).
3. Coherence of six bands: six single-band passes (``_coherence_matrix``)
   against the one masked contraction (``_coherence_all_bands``), on seeded
   power spectra in [0.1, 10).

Each pair is timed in turns (first, second, second, first), ``--iters``
calls per turn after a warm-up, with CUDA events on the card, TF32 off for
matrix products and cuDNN.  The JAX script also sweeps the Pallas kernel's
row tile; the CUDA kernels' tile is fixed (32 x 32 pairs per block), so there
is no such sweep here.

    python -m eyegaze_tpu_torch.bench_connectivity [--batch 64 --channels 32
        --time 1024 --iters 30] [--device cuda|cpu]

The device defaults to the card, and the run raises without one unless
``--device cpu`` is given; on the CPU every kernel wrapper runs its plain
version, so the "kernel" times there are the plain version's, timed on the
host clock.  ``main(argv)`` returns the printed dict.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from eyegaze_tpu_torch.kernels import phase_metrics
from eyegaze_tpu_torch.ops.connectivity import (
    _coherence_all_bands,
    _coherence_matrix,
    _plv_matrix,
)
from eyegaze_tpu_torch.ops.spectral import BAND_DEFS_6, band_masks, band_masks_np

EPS = 1e-8
SAMPLING_RATE = 256.0


def _ms_per_call(fn, iters: int, device: torch.device) -> float:
    """Mean ms of ``iters`` calls: CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _time_pair(first, second, iters: int, device: torch.device):
    """(ms of first, ms of second, first's output, second's output), timed in
    turns first, second, second, first after one warm-up call each."""
    out_first, out_second = first(), second()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    a = _ms_per_call(first, iters, device)
    b = _ms_per_call(second, iters, device)
    b += _ms_per_call(second, iters, device)
    a += _ms_per_call(first, iters, device)
    return a / 2, b / 2, out_first, out_second


def _max_abs_diff(xs, ys) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--time", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_connectivity needs a CUDA device; pass --device cpu to run "
                         "the plain versions on the CPU")
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        result = _run(args.batch, args.channels, args.time, args.iters, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(json.dumps(result))
    return result


def _run(b: int, c: int, t: int, iters: int, device: torch.device) -> dict:
    r = np.random.default_rng(0)
    ph1, ph2 = (torch.from_numpy(r.uniform(-np.pi, np.pi, (b, c, t)).astype(np.float32)).to(device)
                for _ in range(2))
    pw1, pw2 = (torch.from_numpy(r.uniform(0, 1, (b, c, t)).astype(np.float32)).to(device)
                for _ in range(2))
    x = (ph1, ph2, pw1, pw2)

    def plain():
        return phase_metrics.assemble_phase_metrics(
            *phase_metrics.pairwise_phase_metrics_reference(*x), pw1, pw2, EPS)

    def kernel():
        return phase_metrics.pairwise_phase_metrics(*x, eps=EPS)

    plain_ms, kernel_ms, out_plain, out_kernel = _time_pair(plain, kernel, iters, device)

    # Production inputs get cos / sin for free from the analytic parts, so
    # the matrix-product route is given them.
    c1, s1, c2, s2 = torch.cos(ph1), torch.sin(ph1), torch.cos(ph2), torch.sin(ph2)

    def plv4():
        return (_plv_matrix(c1, s1, c2, s2), *phase_metrics.pairwise_phase_metrics(*x, eps=EPS))

    def plv5():
        return phase_metrics.pairwise_phase_plv_metrics(*x, eps=EPS)

    plv4_ms, plv5_ms, out_p4, out_p5 = _time_pair(plv4, plv5, iters, device)

    f = t // 2 + 1
    pxx, pyy = (torch.from_numpy(r.uniform(0.1, 10.0, (b, c, f)).astype(np.float32)).to(device)
                for _ in range(2))
    masks = band_masks(t, SAMPLING_RATE, BAND_DEFS_6, device)
    masks_np = band_masks_np(t, SAMPLING_RATE, BAND_DEFS_6)

    def coh_6pass():
        return torch.stack([_coherence_matrix(pxx * m, pyy * m, EPS) for m in masks], dim=1)

    def coh_fused():
        return _coherence_all_bands(pxx, pyy, masks_np, EPS)

    co_ms, cf_ms, out_co, out_cf = _time_pair(coh_6pass, coh_fused, iters, device)

    return {
        "shape": [b, c, t],
        "plain_ms": round(plain_ms, 4),
        "kernel_ms": round(kernel_ms, 4),
        "speedup_kernel_over_plain": round(plain_ms / kernel_ms, 2),
        "max_abs_diff": _max_abs_diff(out_plain, out_kernel),
        "winner": "kernel" if kernel_ms < plain_ms else "plain",
        "plv4_production_ms": round(plv4_ms, 4),
        "plv5_widened_ms": round(plv5_ms, 4),
        "plv_widened_speedup": round(plv4_ms / plv5_ms, 2),
        "plv_max_abs_diff": _max_abs_diff(out_p4[:1], out_p5[:1]),
        "plv_winner": "widened_kernel" if plv5_ms < plv4_ms else "matmul+kernel",
        "coherence_6pass_ms": round(co_ms, 4),
        "coherence_fused_ms": round(cf_ms, 4),
        "coherence_speedup": round(co_ms / cf_ms, 2),
        "coherence_max_abs_diff": _max_abs_diff([out_co], [out_cf]),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


if __name__ == "__main__":
    main()
