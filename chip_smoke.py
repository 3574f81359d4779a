"""Smoke run of the PyTorch port (eyegaze_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``eyegaze_tpu_torch/csrc`` with nvcc,
one process per source, all at once, and prints each kernel's registers and
spills.  Then, each phase raising on any failure:

1. K1 (phase metrics) against its plain PyTorch version on the card at the
   shapes the EEG serving run launches it with, and at a ragged one, timed
   in turns with CUDA events.
2. K2 (the widened phase metrics, K1's sums plus mean cos and sin of the
   phase difference) against its plain version at the shootout's
   (64, 32, 1024), at (768, 32, 1024), the largest N of the EEG serving run,
   and at the ragged (7, 30, 1000), whose tied pair (0, 0) must give mean
   sign and Phase_Diff 0 and mean cos 1: padded samples add nothing.
3. The attention kernel (K3 and K4) against its plain twin: the head-packed
   entry point at ART's serving shapes (B, 1024, 8, 16) for B = 1, 8, 32 and
   at a ragged (3, 200, 8, 16), the flash entry point at (2, 8, 1024, 128),
   in f32 and bf16, timed in turns at the serving shapes beside
   ``F.scaled_dot_product_attention``, a yardstick no path of the port calls.
4. The flagship EEG serving path at full width (DualEEGTransformer d_model
   256, 6 layers, 8 heads, random weights from a seed): raw (trials, 32,
   3250) pairs -> ``preprocess_eeg`` -> ``sliding_windows`` ->
   ``Predictor.predict`` for requests of 1, 3 and 16 trials.  Every forward
   launches K1; its 139-token attention stays on the plain path; the card's
   logits for one trial match the same weights run on the CPU.
5. ART serving at full width (``ArtConfig()``: 6 + 6 layers, embed 128, ff
   2048, 8 heads, random weights from a seed): ``ArtDenoiser.predict`` on
   (N, 32, 1024) windows for N = 1, 5 and 16.  Every one of the 18 attention
   calls of each forward launches the head-packed entry point; the card's
   output for one window matches the same weights run on the CPU.
6. The flash route: a bf16 ``MultiHeadAttention`` with d_k 128, the
   counterpart of the JAX call site of the stock flash kernel, launches the
   flash entry point on every forward and matches its own plain path.
7. The connectivity shootout, ``eyegaze_tpu_torch.bench_connectivity.main``
   at its defaults: K1 against its plain version, PLV by four matrix
   products plus K1 against K2 alone, six coherence passes against one; its
   JSON line is printed and every difference held to its bound.  It is the
   path that launches K2.
8. The legacy IBS configuration at full width (``use_robust_ibs=False``):
   3-trial requests through ``Predictor``, no phase-metrics launch, logits
   within the flagship's tolerance of the same weights on the CPU.

Every phase runs in float32 (TF32 off) unless it says bf16.  There is no
CPU fallback: without a CUDA device the script exits non-zero and prints no
result.  For each kernel it prints the least time the card could take for
the same work (``bound_ms``, set by bytes or by operations) and its launches
per request.  The second-to-last line of stdout is a JSON object with each
kernel entry point's launches, error, times and bound; the last line is
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
import torch.nn.functional as F

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
SOURCES = ("phase_metrics", "attention")
LOGIT_TOL = 2e-3  # the repo's cross-framework tolerance for this model (tests/test_torch_port.py)

ART_REQUESTS = (1, 5, 16)  # windows per request: buckets 1, 8 and 32
ART_BUCKETS = (1, 8, 32)
ART_ATTENTION_CALLS = 18  # 6 encoder self + 6 decoder self + 6 decoder cross, per forward
ART_TOL = 2e-3  # card vs CPU, float32 both (the flagship's cross-device tolerance)
ATTN_HEADS, ATTN_DK = 8, 16  # ART's attention geometry at T = 1024
ATTN_RAGGED = (3, 200, 8, 16)
FLASH_SHAPE = (2, 8, 1024, 128)  # (B, H, T, d)
FLASH_CALLS = 3
# f32: the kernel and the twin sum the same products in another order; an
# output near zero is a sum that cancels, whose error scales with its O(1)
# terms, hence the absolute part.
ATTN_F32_TOL = dict(rtol=1e-5, atol=1e-5)

# K2 at the shootout's default shape and at the largest N the EEG serving run
# launches K1 with (6 bands x bucket 128), where the widened route would run.
PLV_SHAPES = ((64, 32, 1024), (768, 32, 1024))
# Mean cos and sin: the kernel forms cos(a - b) as cos a cos b + sin a sin b
# from sincosf of each sample, the plain version takes cos of the rounded
# difference; the terms agree to a few ulps of 1, and summing T of them in
# another order moves a mean by a few 2^-24 more (tests/test_pallas.py's
# bound, far above both).
PLV_TOL = dict(rtol=1e-4, atol=1e-5)
# The shootout's bounds: PLV and coherence 1e-5; PLI, wPLI and Phase_Diff K1's
# tolerances at the metrics' largest values (PLI atol 1e-6; wPLI <= 1 with
# rtol 1e-4; Phase_Diff <= 2 pi with rtol 1e-5), so at most 1.1e-4.
SHOOTOUT_BOUNDS = {"max_abs_diff": 1.1e-4, "plv_max_abs_diff": 1e-5,
                   "coherence_max_abs_diff": 1e-5}
LEGACY_TRIALS = 3

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# HBM bytes per second and dense operations per second by type.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # float32 on the CUDA cores
BF16_OPS_PER_S = 989e12   # bf16 on the tensor cores


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bound(shape, plv: bool) -> tuple[float, str]:
    """K1 / K2 at (N, C, T): four inputs read once, three or five (N, C, C)
    outputs written once.  Per pair and sample K1 does 7 operations (the
    difference, its sign, the sign sum, the |dphi| sum, pw1 + pw2 and an
    FMA); K2 four FMAs more (8), plus a sin and a cos of each phase sample."""
    n, c, t = shape
    outs = 5 if plv else 3
    ops = (15 if plv else 7) * n * c * c * t + (4 * n * c * t if plv else 0)
    return bound(4 * (4 * n * c * t + outs * n * c * c), ops, F32_OPS_PER_S)


def attention_bound(b, h, t, d, dtype) -> tuple[float, str]:
    """(B, H, T, d) attention: Q, K, V read once and O written once;
    4 * B * H * T^2 * d matmul operations (the softmax's exponentials, about
    1/(4d) of that, not counted), at the f32 CUDA-core or the bf16
    tensor-core peak."""
    size = 4 if dtype == torch.float32 else 2
    rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    return bound(4 * b * h * t * d * size, 4 * b * h * t * t * d, rate)


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
        bound_ms, bound_by = phase_bound(shape, plv=False)
        print(f"K1 {shape}: kernel median {ms:.4f} ms, plain median {plain_ms:.4f} ms "
              f"over {len(kernel)} calls each (CUDA events); bound {bound_ms:.4f} ms ({bound_by})")
        del x
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": list(shape)}


def plv_kernel_phase(device) -> dict:
    """K2 against its plain version at PLV_SHAPES and the ragged shape.

    Both are timed at PLV_SHAPES; the returned times are those at
    (768, 32, 1024).
    """
    from eyegaze_tpu_torch.kernels import phase_metrics

    max_err = 0.0
    for seed, shape in enumerate(PLV_SHAPES + (RAGGED_SHAPE,)):
        x = phase_inputs(shape, device, seed)
        got = phase_metrics.phase_plv_metric_sums(*x)
        torch.cuda.synchronize()
        want = phase_metrics.pairwise_phase_plv_metrics_reference(*x)
        den = (x[2].sum(-1)[:, :, None] + x[3].sum(-1)[:, None, :]) * 0.5
        # K1's three sums at K1's tolerances (see kernel_phase).
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6 * float(den.max()))
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[3], want[3], **PLV_TOL)
        torch.testing.assert_close(got[4], want[4], **PLV_TOL)
        # Pair (0, 0) has equal phases: every real sample adds sign 0, |dphi|
        # 0 and cos 1, and a padded sample past a ragged T must add nothing.
        tie_cos = float((got[3][:, 0, 0] - 1.0).abs().max())
        if got[0][:, 0, 0].any() or got[2][:, 0, 0].any() or tie_cos > PLV_TOL["atol"]:
            raise RuntimeError(f"K2 {shape}: tied pair (0, 0) gives mean sign "
                               f"{got[0][:, 0, 0].tolist()}, pdiff {got[2][:, 0, 0].tolist()}, "
                               f"|mean cos - 1| {tie_cos:.3e}")
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        max_err = max(max_err, *errs)
        print(f"K2 {shape}: max |kernel - plain| mean_sign {errs[0]:.3e} wnum {errs[1]:.3e} "
              f"pdiff {errs[2]:.3e} mean_cos {errs[3]:.3e} mean_sin {errs[4]:.3e}; tied pair: "
              f"|mean cos - 1| {tie_cos:.3e}: within tolerance")
        del x, got, want

    for seed, shape in enumerate(PLV_SHAPES):
        x = phase_inputs(shape, device, seed)
        ms, plain_ms = alternate_ms(
            lambda: phase_metrics.phase_plv_metric_sums(*x),
            lambda: phase_metrics.pairwise_phase_plv_metrics_reference(*x))
        bound_ms, bound_by = phase_bound(shape, plv=True)
        print(f"K2 {shape}: kernel median {ms:.4f} ms, plain median {plain_ms:.4f} ms over 20 "
              f"calls each (CUDA events); bound {bound_ms:.4f} ms ({bound_by}); "
              f"{shape[0] * math.ceil(shape[1] / 32) ** 2} blocks on 132 SMs")
        del x
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": list(shape)}


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
    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)
    for trials in REQUESTS:
        walls = []
        for _ in range(REPEATS):
            before = phase_metrics.launch_count["phase_metric_sums"]
            t0 = time.perf_counter()
            out = pred.predict(windows(raw1[:trials], device), windows(raw2[:trials], device))
            walls.append((time.perf_counter() - t0) * 1e3)
            n = trials * WINDOWS_PER_TRIAL
            forwards = math.ceil(n / BUCKETS[-1])
            launched = phase_metrics.launch_count["phase_metric_sums"] - before
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
    launches = phase_metrics.launch_count["phase_metric_sums"]
    if launches == 0 or phase_metrics.launch_count["phase_plv_metric_sums"] != 0:
        raise RuntimeError(f"the serving path's phase-metrics launches: "
                           f"{phase_metrics.launch_count}")
    print(f"K1 launches during the serving run: {launches}")
    return launches, raw1[:1], raw2[:1], first, model.state_dict()


def cpu_parity(raw1, raw2, logits, state, **flags) -> None:
    """The first request's card logits against the same weights on the CPU."""
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    cpu = torch.device("cpu")
    model = DualEEGTransformer(**GEOMETRY, **flags, device=cpu,
                               generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    out = Predictor(model, device=cpu, batch_buckets=BUCKETS, preprocess=False).predict(
        windows(raw1, cpu), windows(raw2, cpu))
    torch.testing.assert_close(torch.from_numpy(logits), torch.from_numpy(out["logits"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    err = float(np.abs(logits - out["logits"]).max())
    print(f"{len(raw1)}-trial logits {flags or ''}, card vs CPU (plain kernel twin): max |diff| "
          f"{err:.3e}, |logits| max {float(np.abs(logits).max()):.3f}, tolerance {LOGIT_TOL}")


def attention_inputs(shape, dtype, device, seed):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


def assert_within_bf16_bound(got, want, terms) -> float:
    """bf16: each side rounds every probability to bf16 (2**-9 relative), the
    kernel unnormalised and the twin normalised, and its output once more
    (2**-8 relative: 8 significant bits).  So |got - want| <= 2**-8 *
    sum_j p_j |v_j| + 2**-7 |want|, where ``terms``, the sum, is the twin run
    on |v|.  Returns the largest share of the bound used."""
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -8 * terms.float() + 2.0 ** -7 * want.float().abs() + 1e-6
    share = float((err / bound).max())
    if share > 1.0:
        raise AssertionError(f"bf16 attention off by {float(err.max()):.3e}: {share:.2f}x "
                             "its rounding bound")
    return share


def alternate_ms(*fns, rounds: int = 10) -> list[float]:
    """Median CUDA-event ms of each function, timed in turns after a warm-up."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(rounds):  # in turns, so drift in clocks hits all alike
        for fn, acc in zip(fns, times):
            acc += cuda_ms(fn, 2)
    return [statistics.median(t) for t in times]


def attention_phase(device) -> dict:
    """Both attention entry points against the twin; timings at ART's
    serving shapes.  Returns the JSON fields of each entry point."""
    from eyegaze_tpu_torch.kernels import attention

    serving = [(b, WINDOW, ATTN_HEADS, ATTN_DK) for b in ART_BUCKETS]
    err = {}  # (entry, dtype) -> max |kernel - twin|
    cases = [("headpacked_attention", shape, dt) for shape in serving + [ATTN_RAGGED]
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(("flash_attention", FLASH_SHAPE, torch.bfloat16))
    for seed, (entry, shape, dt) in enumerate(cases):
        q, k, v = attention_inputs(shape, dt, device, seed)
        scale = 1.0 / math.sqrt(shape[-1])
        if entry == "headpacked_attention":  # compare in (B, H, T, d)
            got = attention.headpacked_attention(q, k, v, scale).transpose(1, 2)
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        else:
            got = attention.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = attention.attention_reference(q, k, v, scale)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, **ATTN_F32_TOL)
            bound = f"tolerance {ATTN_F32_TOL}"
        else:
            share = assert_within_bf16_bound(got, want,
                                             attention.attention_reference(q, k, v.abs(), scale))
            bound = f"{share:.2f} of the bf16 bound"
        e = float((got.float() - want.float()).abs().max())
        err[entry, dt] = max(err.get((entry, dt), 0.0), e)
        print(f"{entry} {shape} {str(dt)[6:]}: max |kernel - twin| {e:.3e} "
              f"(|out| max {float(want.float().abs().max()):.3f}), {bound}")
        del q, k, v, got, want

    times = {}
    for seed, (entry, shape, dt) in enumerate(cases):
        if shape == ATTN_RAGGED:
            continue
        q, k, v = attention_inputs(shape, dt, device, seed)
        scale = 1.0 / math.sqrt(shape[-1])
        if entry == "headpacked_attention":
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel = lambda: attention.headpacked_attention(q, k, v, scale)  # noqa: E731
        else:
            qt, kt, vt = q, k, v
            kernel = lambda: attention.flash_attention(q, k, v, scale)  # noqa: E731
        ms, plain_ms, library_ms = alternate_ms(
            kernel, lambda: attention.attention_reference(qt, kt, vt, scale),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        bound_ms, bound_by = attention_bound(*qt.shape, dt)
        times[(entry, shape, dt)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "library_ms": library_ms}
        print(f"{entry} {shape} {str(dt)[6:]}: kernel median {ms:.4f} ms, twin median "
              f"{plain_ms:.4f} ms, F.scaled_dot_product_attention median {library_ms:.4f} ms "
              f"over 20 calls each (CUDA events); bound {bound_ms:.4f} ms ({bound_by})")
        del q, k, v, qt, kt, vt
    largest = serving[-1]  # the 16-window request's bucket
    fields = {}
    for entry, shape, dt in (("headpacked_attention", largest, torch.float32),
                             ("flash_attention", FLASH_SHAPE, torch.bfloat16)):
        errs = {str(d)[6:]: e for (name, d), e in err.items() if name == entry}
        fields[entry] = {"max_abs_err": max(errs.values()), **times[(entry, shape, dt)],
                         "shape": list(shape), "dtype": str(dt)[6:],
                         "max_abs_err_by_dtype": errs}
    return fields


def art_phase(device):
    """Serve (N, 32, 1024) windows through ArtDenoiser at full width.

    Returns the head-packed launches of the run, the first request's input
    and output, and the model's state_dict.
    """
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    model = ArtifactRemovalTransformer(ArtConfig(), device=device,
                                       generator=torch.Generator().manual_seed(0))
    print(f"ArtifactRemovalTransformer {ArtConfig()}: "
          f"{sum(p.numel() for p in model.parameters()):,} parameters on {device}")
    den = ArtDenoiser(model, device=device, batch_buckets=ART_BUCKETS)
    t0 = time.perf_counter()
    den.warmup(CHANNELS, WINDOW)
    print(f"warmup of buckets {ART_BUCKETS}: {time.perf_counter() - t0:.2f} s")
    noisy = np.random.default_rng(1).normal(
        size=(max(ART_REQUESTS), CHANNELS, WINDOW)).astype(np.float32)

    first = None
    attention.launch_count.update(headpacked_attention=0, flash_attention=0)
    for n in ART_REQUESTS:
        walls = []
        for _ in range(REPEATS):
            before = attention.launch_count["headpacked_attention"]
            t0 = time.perf_counter()
            out = den.predict(noisy[:n])["denoised"]
            walls.append((time.perf_counter() - t0) * 1e3)
            forwards = math.ceil(n / ART_BUCKETS[-1])
            launched = attention.launch_count["headpacked_attention"] - before
            if launched != ART_ATTENTION_CALLS * forwards:
                raise RuntimeError(f"{forwards} forwards launched the attention kernel "
                                   f"{launched} times, not {ART_ATTENTION_CALLS * forwards}")
            if out.shape != (n, CHANNELS, WINDOW) or not np.isfinite(out).all():
                raise RuntimeError(f"bad output: shape {out.shape}, finite "
                                   f"{np.isfinite(out).all()}")
            if first is None:
                first = out
        print(f"ART request of {n} window(s): wall ms {[round(w, 3) for w in walls]}, "
              f"median {statistics.median(walls):.3f} (predict; output back on the host)")
    launches = attention.launch_count["headpacked_attention"]
    if launches == 0 or attention.launch_count["flash_attention"] != 0:
        raise RuntimeError(f"ART's attention launches: {attention.launch_count}")
    print(f"head-packed attention launches during the ART run: {launches}")
    return launches, noisy[:ART_REQUESTS[0]], first, model.state_dict()


def art_cpu_parity(noisy, denoised, state) -> None:
    """The first request's card output against the same weights on the CPU."""
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    cpu = torch.device("cpu")
    model = ArtifactRemovalTransformer(ArtConfig(), device=cpu,
                                       generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    want = ArtDenoiser(model, device=cpu, batch_buckets=ART_BUCKETS).predict(noisy)["denoised"]
    torch.testing.assert_close(torch.from_numpy(denoised), torch.from_numpy(want),
                               rtol=ART_TOL, atol=ART_TOL)
    print(f"1-window ART output, card vs CPU (plain attention twin): max |diff| "
          f"{float(np.abs(denoised - want).max()):.3e}, |out| max "
          f"{float(np.abs(want).max()):.3f}, tolerance {ART_TOL}")


def flash_route_phase(device) -> int:
    """A bf16 MultiHeadAttention with d_k 128 takes the flash route on every
    forward and matches its own plain path (forced by returning weights)."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.transformer import MultiHeadAttention, init_weights_

    b, h, t, d = FLASH_SHAPE
    mha = MultiHeadAttention(h * d, h, device=device)
    init_weights_(mha, torch.Generator().manual_seed(2))
    mha = mha.to(torch.bfloat16).eval()
    x = torch.randn(b, t, h * d, generator=torch.Generator().manual_seed(3)).to(
        device, torch.bfloat16)
    attention.launch_count.update(headpacked_attention=0, flash_attention=0)
    with torch.inference_mode():
        outs = [mha(x, x, x) for _ in range(FLASH_CALLS)]
        launches = dict(attention.launch_count)
        plain = mha(x, x, x, return_weights=True)[0]
    torch.cuda.synchronize()
    if launches != {"headpacked_attention": 0, "flash_attention": FLASH_CALLS}:
        raise RuntimeError(f"{FLASH_CALLS} bf16 d_k-128 forwards: {launches}")
    # The contexts agree to the bf16 bound of the attention phase; out_proj
    # sums 1024 of them with weights of std 1/32 and rounds once more to bf16.
    torch.testing.assert_close(outs[0].float(), plain.float(), rtol=2.0 ** -7, atol=2.0 ** -6)
    print(f"flash route, bf16 MultiHeadAttention (B {b}, T {t}, H {h}, d_k {d}): "
          f"{launches['flash_attention']} launches for {FLASH_CALLS} forwards, "
          f"max |kernel route - plain route| {float((outs[0].float() - plain.float()).abs().max()):.3e}")
    return launches["flash_attention"]


def shootout_phase() -> tuple[dict, dict]:
    """The connectivity shootout at its defaults on the card.

    Returns its result and the phase-metrics launches of the run, counted
    from 0: the run is the path that launches K2.
    """
    from eyegaze_tpu_torch import bench_connectivity
    from eyegaze_tpu_torch.kernels import phase_metrics

    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)
    result = bench_connectivity.main([])  # prints its JSON line
    launches = dict(phase_metrics.launch_count)
    if result["device"] != torch.cuda.get_device_name(0) or not all(launches.values()):
        raise RuntimeError(f"shootout on {result['device']!r} launched {launches}")
    for key, limit in SHOOTOUT_BOUNDS.items():
        if not result[key] <= limit:
            raise RuntimeError(f"shootout {key} {result[key]:.3e} over its bound {limit:.1e}")
    print(f"shootout: differences within {SHOOTOUT_BOUNDS}; launches {launches}")
    return result, launches


def legacy_phase(device):
    """Serve 3-trial requests through the legacy IBS configuration
    (``use_robust_ibs=False``) at full width; it launches no phase-metrics
    kernel.  Returns the raw pair of the request, its logits and the state."""
    from eyegaze_tpu_torch.kernels import phase_metrics
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    model = DualEEGTransformer(**GEOMETRY, use_robust_ibs=False, device=device,
                               generator=torch.Generator().manual_seed(0))
    print(f"DualEEGTransformer(use_robust_ibs=False): "
          f"{sum(p.numel() for p in model.parameters()):,} parameters on {device}")
    pred = Predictor(model, device=device, batch_buckets=BUCKETS, preprocess=False)
    pred.warmup(CHANNELS, WINDOW)
    rng = np.random.default_rng(2)
    raw1, raw2 = (rng.normal(size=(LEGACY_TRIALS, CHANNELS, RAW_SAMPLES)).astype(np.float32)
                  for _ in range(2))
    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = pred.predict(windows(raw1, device), windows(raw2, device))
        walls.append((time.perf_counter() - t0) * 1e3)
    n = LEGACY_TRIALS * WINDOWS_PER_TRIAL
    logits = out["logits"]
    if logits.shape != (n, 3) or not np.isfinite(logits).all():
        raise RuntimeError(f"bad logits: shape {logits.shape}, finite {np.isfinite(logits).all()}")
    if any(phase_metrics.launch_count.values()):
        raise RuntimeError(f"the legacy IBS token launched {phase_metrics.launch_count}")
    print(f"legacy IBS request of {LEGACY_TRIALS} trials = {n} windows: wall ms "
          f"{[round(w, 3) for w in walls]}, median {statistics.median(walls):.3f}; "
          f"phase-metrics launches {phase_metrics.launch_count}")
    return raw1, raw2, logits, model.state_dict()


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
    built = build.build_all(SOURCES)
    print(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s (one nvcc each, "
          "in parallel)")
    for name, (lib, report) in built.items():
        print(f"{name}: {lib.name}")
        for line in report.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    from eyegaze_tpu_torch.kernels import attention

    k1_timing = kernel_phase(device)
    k2_timing = plv_kernel_phase(device)
    attn_timing = attention_phase(device)

    attention.launch_count.update(headpacked_attention=0, flash_attention=0)
    k1_launches, raw1, raw2, logits, state = slice_phase(device)
    if any(attention.launch_count.values()):
        raise RuntimeError("the flagship's 139-token attention launched the attention kernel")
    cpu_parity(raw1, raw2, logits, state)

    art_launches, noisy, denoised, art_state = art_phase(device)
    art_cpu_parity(noisy, denoised, art_state)
    flash_launches = flash_route_phase(device)

    _, shootout_launches = shootout_phase()
    legacy_raw1, legacy_raw2, legacy_logits, legacy_state = legacy_phase(device)
    cpu_parity(legacy_raw1, legacy_raw2, legacy_logits, legacy_state, use_robust_ibs=False)

    phase_source = "eyegaze_tpu_torch/csrc/phase_metrics.cu"
    source = "eyegaze_tpu_torch/csrc/attention.cu"
    kernels = [
        {"name": "pairwise_phase_metrics", "route": "cuda", "source": phase_source,
         "replaces": "eyegaze_tpu/ops/pallas_kernels.py:74", "launches": k1_launches,
         "path": "EEG serving", "launches_per_request": k1_launches / (len(REQUESTS) * REPEATS),
         **k1_timing},
        {"name": "pairwise_phase_plv_metrics", "route": "cuda", "source": phase_source,
         "replaces": "eyegaze_tpu/ops/pallas_kernels.py:151",
         "launches": shootout_launches["phase_plv_metric_sums"],
         "path": "connectivity shootout (bench_connectivity)",
         "launches_per_request": shootout_launches["phase_plv_metric_sums"], **k2_timing},
        {"name": "headpacked_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/ops/attn_kernels.py:78", "launches": art_launches,
         "path": "ART serving",
         "launches_per_request": art_launches / (len(ART_REQUESTS) * REPEATS),
         **attn_timing["headpacked_attention"]},
        {"name": "flash_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/models/transformer.py:232", "launches": flash_launches,
         "path": "bf16 MultiHeadAttention, d_k 128",
         "launches_per_request": flash_launches / FLASH_CALLS, **attn_timing["flash_attention"]},
    ]
    for k in kernels:
        library = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"(set by {k['bound_by']}), plain {k['plain_ms']:.4f} ms, library call {library}; "
              f"{k['launches_per_request']:g} launches per request of its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
