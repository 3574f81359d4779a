"""Smoke run of the PyTorch port (eyegaze_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``eyegaze_tpu_torch/csrc`` with nvcc,
holds it against its plain PyTorch version on the card at the shapes the
serving run launches it with (and at a ragged one), then drives the
flagship EEG serving path at full width (DualEEGTransformer d_model 256,
6 layers, 8 heads, random weights from a seed): raw (trials, 32, 3250)
pairs -> ``preprocess_eeg`` -> ``sliding_windows`` -> ``Predictor.predict``
for requests of 1, 3 and 16 trials.  It checks the outputs, that every
forward launched the kernel, and that the card's logits for one trial match
the same weights run on the CPU.  Every check raises on failure, and there is
no CPU fallback: without a CUDA device the script exits non-zero and prints
no result.

The second-to-last line of stdout is a JSON object with the kernel's
launches, error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

SAMPLING_RATE = 256.0
WINDOW, STRIDE = 1024, 512
CHANNELS, RAW_SAMPLES, TRIALS = 32, 3250, 16
WINDOWS_PER_TRIAL = (RAW_SAMPLES - WINDOW) // STRIDE + 1  # 5
REQUESTS = (1, 3, 16)  # trials per request: 5, 15 and 80 windows
REPEATS = 5
BUCKETS = (1, 8, 32, 128)
GEOMETRY = dict(in_channels=CHANNELS, num_classes=3, d_model=256, num_layers=6, num_heads=8,
                d_ff=1024, max_len=256, sampling_rate=SAMPLING_RATE)
RAGGED_SHAPE = (7, 30, 1000)
LOGIT_TOL = 2e-3  # the repo's cross-framework tolerance for this model (tests/test_torch_port.py)


def path_kernel_shapes() -> tuple:
    """The (N, C, T) at which the serving run launches K1, one per request size.

    ``Predictor`` zero-pads each request's windows up to its bucket, and
    ``connectivity_matrices`` stacks the six bands, so N = 6 * bucket:
    5, 15 and 80 windows run at buckets 8, 32 and 128.
    """
    from eyegaze_tpu_torch.serving import _bucket

    return tuple((6 * _bucket(trials * WINDOWS_PER_TRIAL, BUCKETS), CHANNELS, WINDOW)
                 for trials in REQUESTS)


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times of ``fn`` in ms, from CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase_inputs(shape, device, seed):
    n, c, t = shape
    r = np.random.default_rng(seed)
    ph1 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2[:, 0] = ph1[:, 0]  # exact ties exercise sign(0) = 0
    pw1 = r.random((n, c, t)).astype(np.float32)
    pw2 = r.random((n, c, t)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (ph1, ph2, pw1, pw2)]


def kernel_phase(device) -> dict:
    """K1 against its plain version at the serving run's shapes and a ragged one.

    Both are timed at each of the serving run's shapes; the returned times
    are those at the largest, the 16-trial request's.
    """
    from eyegaze_tpu_torch.kernels import phase_metrics

    path_shapes = path_kernel_shapes()
    max_err = 0.0
    for seed, shape in enumerate(path_shapes + (RAGGED_SHAPE,)):
        x = phase_inputs(shape, device, seed)
        got = phase_metrics.phase_metric_sums(*x)
        torch.cuda.synchronize()
        want = phase_metrics.pairwise_phase_metrics_reference(*x)
        den = (x[2].sum(-1)[:, :, None] + x[3].sum(-1)[:, None, :]) * 0.5
        # mean sign: sums of +-1 are exact in f32.  pdiff and wnum: summation
        # order differs; wnum is a signed sum whose rounding error scales with
        # the sum of its terms' magnitudes (den), not with |wnum|.
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6 * float(den.max()))
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        max_err = max(max_err, *errs)
        print(f"K1 {shape}: max |kernel - plain| mean_sign {errs[0]:.3e} "
              f"wnum {errs[1]:.3e} (|wnum| max {float(want[1].abs().max()):.1f}) "
              f"pdiff {errs[2]:.3e}: within tolerance")

    for seed, shape in enumerate(path_shapes):
        x = phase_inputs(shape, device, seed)
        for _ in range(3):  # warm both
            phase_metrics.phase_metric_sums(*x)
            phase_metrics.pairwise_phase_metrics_reference(*x)
        kernel, plain = [], []
        for _ in range(10):  # in turns, so drift in clocks hits both alike
            kernel += cuda_ms(lambda: phase_metrics.phase_metric_sums(*x), 2)
            plain += cuda_ms(lambda: phase_metrics.pairwise_phase_metrics_reference(*x), 2)
        ms, plain_ms = statistics.median(kernel), statistics.median(plain)
        print(f"K1 {shape}: kernel median {ms:.4f} ms, plain median {plain_ms:.4f} ms "
              f"over {len(kernel)} calls each (CUDA events)")
        del x
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "shape": list(shape)}


def windows(raw: np.ndarray, device) -> torch.Tensor:
    from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows

    x = preprocess_eeg(torch.from_numpy(raw).to(device), sampling_rate=SAMPLING_RATE)
    return sliding_windows(x, WINDOW, STRIDE).reshape(-1, CHANNELS, WINDOW)


def slice_phase(device):
    """Drive raw trials -> windows -> Predictor on ``device``.

    Returns the kernel launches of the run, the raw pair of the first
    request, its logits and the model's state_dict.
    """
    from eyegaze_tpu_torch.kernels import phase_metrics
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    model = DualEEGTransformer(**GEOMETRY, device=device,
                               generator=torch.Generator().manual_seed(0))
    print(f"DualEEGTransformer: {sum(p.numel() for p in model.parameters()):,} parameters "
          f"on {device}")
    rng = np.random.default_rng(0)
    raw1 = rng.normal(size=(TRIALS, CHANNELS, RAW_SAMPLES)).astype(np.float32)
    raw2 = rng.normal(size=(TRIALS, CHANNELS, RAW_SAMPLES)).astype(np.float32)
    pred = Predictor(model, device=device, batch_buckets=BUCKETS, preprocess=False)
    t0 = time.perf_counter()
    pred.warmup(CHANNELS, WINDOW)
    print(f"warmup of buckets {BUCKETS}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    windows(raw1[:1], device)  # the filter's constants are made once per signal length
    print(f"first preprocess call: {time.perf_counter() - t0:.2f} s")

    first = None
    phase_metrics.launch_count = 0
    for trials in REQUESTS:
        walls = []
        for _ in range(REPEATS):
            before = phase_metrics.launch_count
            t0 = time.perf_counter()
            out = pred.predict(windows(raw1[:trials], device), windows(raw2[:trials], device))
            walls.append((time.perf_counter() - t0) * 1e3)
            n = trials * WINDOWS_PER_TRIAL
            forwards = math.ceil(n / BUCKETS[-1])
            launched = phase_metrics.launch_count - before
            if launched != forwards:
                raise RuntimeError(f"{forwards} forwards launched K1 {launched} times")
            logits = out["logits"]
            if logits.shape != (n, 3) or not np.isfinite(logits).all():
                raise RuntimeError(f"bad logits: shape {logits.shape}, finite "
                                   f"{np.isfinite(logits).all()}")
            if not np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5):
                raise RuntimeError("probs do not sum to 1")
            if first is None:
                first = logits
        print(f"request of {trials} trial(s) = {n} windows: wall ms "
              f"{[round(w, 3) for w in walls]}, median {statistics.median(walls):.3f} "
              f"(preprocess + windows + predict; logits back on the host)")
    launches = phase_metrics.launch_count
    if launches == 0:
        raise RuntimeError("the serving path never launched K1")
    print(f"K1 launches during the serving run: {launches}")
    return launches, raw1[:1], raw2[:1], first, model.state_dict()


def cpu_parity(raw1, raw2, logits, state) -> None:
    """The first request's card logits against the same weights on the CPU."""
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    cpu = torch.device("cpu")
    model = DualEEGTransformer(**GEOMETRY, device=cpu, generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    out = Predictor(model, device=cpu, batch_buckets=BUCKETS, preprocess=False).predict(
        windows(raw1, cpu), windows(raw2, cpu))
    torch.testing.assert_close(torch.from_numpy(logits), torch.from_numpy(out["logits"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    err = float(np.abs(logits - out["logits"]).max())
    print(f"1-trial logits, card vs CPU (plain kernel twin): max |diff| {err:.3e}, "
          f"|logits| max {float(np.abs(logits).max()):.3f}, tolerance {LOGIT_TOL}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; it has no CPU mode")
    from eyegaze_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions: every phase runs in full float32")

    t0 = time.perf_counter()
    lib, report = build.build("phase_metrics")
    print(f"K1 built in {time.perf_counter() - t0:.2f} s: {lib.name}")
    for line in report.splitlines():
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}")

    timing = kernel_phase(device)
    launches, raw1, raw2, logits, state = slice_phase(device)
    cpu_parity(raw1, raw2, logits, state)

    print(json.dumps({"kernels": [{
        "name": "pairwise_phase_metrics",
        "route": "cuda",
        "source": "eyegaze_tpu_torch/csrc/phase_metrics.cu",
        "replaces": "eyegaze_tpu/ops/pallas_kernels.py:74",
        "launches": launches,
        **timing,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
