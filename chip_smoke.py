"""Smoke run of the PyTorch port (eyegaze_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``eyegaze_tpu_torch/csrc`` with nvcc,
one process per source, all at once, and prints each kernel's registers and
spills, the tensor-core instructions (``HMMA``) in the SASS of each
instance of the attention kernel, and the arithmetic, LDS and other instructions
per pair and sample in the main loop of each phase-metrics instance: a
phase-metrics or f32 attention instance that spills, an f32 attention
instance with any ``HMMA`` (a TF32 product in the f32 path), or a bf16
instance with none, fails the run.  Then, each phase raising on any failure:

1. K1 (phase metrics) against its plain PyTorch version on the card at the
   shapes the EEG serving run launches it with, at a ragged one and at one
   whose T is not a multiple of 4 (rows staged element by element), timed
   in turns with CUDA events at the serving shapes, one call between the
   events and 20 calls replayed from a CUDA graph, with the split of T over
   a block cluster and the block count at each.
2. K2 (the widened phase metrics, K1's sums plus mean cos and sin of the
   phase difference) the same way at the shootout's (64, 32, 1024) and at
   (768, 32, 1024), the largest N of the EEG serving run.  In both, the
   tied pair (0, 0) must give mean sign and Phase_Diff 0 (K2: mean cos 1):
   padded samples add nothing.
3. The attention kernel (K3 and K4) against its plain twin: the head-packed
   entry point at ART's serving shapes (B, 1024, 8, 16) for B = 1, 8, 32 and
   at a ragged (3, 200, 8, 16), in f32 and bf16, the flash entry point at
   (2, 8, 1024, 128) bf16, timed in turns at the serving shapes beside
   ``F.scaled_dot_product_attention``, a yardstick no path of the port calls
   (f32 with the query rows per thread the launch picked at each shape):
   one call between CUDA events, 20 back-to-back calls between one pair
   (where the host's enqueue time hides behind the device's work, if the
   device's is longer), and 20 calls captured in a CUDA graph and replayed
   (device time alone).
4. The flagship EEG serving path at full width (DualEEGTransformer d_model
   256, 6 layers, 8 heads, random weights from a seed): raw (trials, 32,
   3250) pairs -> ``preprocess_eeg`` -> ``sliding_windows`` ->
   ``Predictor.predict`` for requests of 1, 3 and 16 trials.  Every forward
   launches K1; its 139-token attention stays on the plain path; the card's
   logits for one trial match the same weights run on the CPU.
5. The flagship as the JAX package serves it: the same weights saved as a
   state_dict plus ``.meta.json`` in a temporary directory, loaded by
   ``Predictor.from_checkpoint`` (bf16 compute) and served the same
   requests.  K1 launches once per forward; the card's logits for one trial
   are within 2**-5 of the largest |logit| of the same bf16 model on the
   CPU, printed beside the gap between bf16 and f32 on the card, and each
   request's median wall time beside the f32 path's.
6. The same checkpoint behind ``python -m eyegaze_tpu_torch.serve
   --dynamic-batch`` (its ``main`` in a thread, 127.0.0.1, port 0, one
   bucket of 128): 16 concurrent single-trial requests (5 windows each) over
   HTTP.  Each answer equals, to the bit, a direct ``predict`` of its rows
   at the same bucket, labels included; the requests take fewer dispatches
   than there are requests, and K1 launches once per dispatch.  Prints the
   p50 and p99 of the request wall times.
7. ART serving at full width (``ArtConfig()``: 6 + 6 layers, embed 128, ff
   2048, 8 heads, random weights from a seed): ``ArtDenoiser.predict`` on
   (N, 32, 1024) windows for N = 1, 5 and 16.  Every one of the 18 attention
   calls of each forward launches the head-packed entry point, with the
   query rows per thread printed for each bucket; the card's output for one
   window matches the same weights run on the CPU.
8. ART served in bf16 compute (``ArtifactRemovalTransformer(dtype=
   torch.bfloat16)``, the JAX ``from_checkpoint`` default), the same weights
   and requests as phase 5: 18 launches of the head-packed entry point's
   bf16 instance per forward and no flash launch; the card's output for one
   window matches the same weights served in bf16 on the CPU.
9. ART from a checkpoint: phase 8's weights saved as a state_dict plus
   meta, loaded by ``ArtDenoiser.from_checkpoint`` (bf16) and served the
   16-window request at bucket 32: 18 launches of the bf16 instance, and the
   output equal to the bit to phase 8's for the same windows.
10. The flash route: a bf16 ``MultiHeadAttention`` with d_k 128, the
   counterpart of the JAX call site of the stock flash kernel, launches the
   flash entry point on every forward and matches its own plain path.
11. The connectivity shootout, ``eyegaze_tpu_torch.bench_connectivity.main``
   at its defaults: K1 against its plain version, PLV by four matrix
   products plus K1 against K2 alone, six coherence passes against one; its
   JSON line is printed and every difference held to its bound.  It is the
   path that launches K2.
12. The legacy IBS configuration at full width (``use_robust_ibs=False``):
   3-trial requests through ``Predictor``, no phase-metrics launch, logits
   within the flagship's tolerance of the same weights on the CPU.

Every phase runs in float32 (TF32 off) unless it says bf16.  There is no
CPU fallback: without a CUDA device the script exits non-zero and prints no
result.  For each kernel it prints the least time the card could take for
the same work (``bound_ms``, set by bytes or by operations at the card's
peak rate for their type; for attention the operations are the matmuls)
and its launches per request; for attention also the time its
exponentials take on the SFU alone (``sfu_ex2_ms``, not a floor).  The
second-to-last line of stdout is a JSON object with each kernel entry
point's launches, error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
UNALIGNED_SHAPE = (7, 30, 1001)  # T % 4 != 0: K1 and K2 stage rows element by element
SUM_NAMES = ("mean_sign", "wnum", "pdiff", "mean_cos", "mean_sin")
SOURCES = ("phase_metrics", "attention")
LOGIT_TOL = 2e-3  # the repo's cross-framework tolerance for this model (tests/test_torch_port.py)
# bf16 compute, card vs CPU: a share of the largest |logit|, the bound that
# tests/test_torch_dual_eeg_bf16.py holds the port to against Flax's bf16
# model on the CPU (single bf16 roundings flip and spread).
LOGIT_BF16_TOL_SHARE = 2.0 ** -5
# What the JAX package's trainer writes beside an orbax checkpoint, for the
# seeded flagship at GEOMETRY (max_len comes from the positional table).
FLAGSHIP_META = {"config": {
    "model": {"in_channels": CHANNELS, "num_labels": 3, "d_model": 256, "num_layers": 6,
              "num_heads": 8, "d_ff": 1024},
    "ablation": {"use_spectrogram": True, "use_ibs": True, "ibs_mode": "robust",
                 "use_cross_attention": True, "ibs_instance_norm": True,
                 "ibs_feature_type": "all"},
    "data": {"sampling_rate": SAMPLING_RATE, "enable_preprocessing": False}}}
HTTP_REQUESTS = 16  # concurrent single-trial requests, 5 windows each
# One bucket for the HTTP run: every dispatch, coalesced or not, and every
# direct predict it is held against pad to the same shape, so the rows
# must agree to the bit.
HTTP_BUCKET = 128

ART_REQUESTS = (1, 5, 16)  # windows per request: buckets 1, 8 and 32
ART_BUCKETS = (1, 8, 32)
ART_ATTENTION_CALLS = 18  # 6 encoder self + 6 decoder self + 6 decoder cross, per forward
ART_TOL = 2e-3  # card vs CPU, float32 both (the flagship's cross-device tolerance)
# Card vs CPU, bf16 compute both: a share of the largest output, 8 bf16 steps
# there.  The two sum in another order and the kernel rounds unnormalised
# probabilities, so single bf16 roundings flip, and each post-LN block
# spreads a flip over its row: tests/test_torch_art.py holds the port to the
# JAX bf16 model by the same bound on the CPU.
ART_BF16_TOL_SHARE = 2.0 ** -5
ATTN_HEADS, ATTN_DK = 8, 16  # ART's attention geometry at T = 1024
ATTN_RAGGED = (3, 200, 8, 16)
FLASH_SHAPE = (2, 8, 1024, 128)  # (B, H, T, d)
FLASH_CALLS = 3
# f32: the kernel and the twin sum the same products in another order; an
# output near zero is a sum that cancels, whose error scales with its O(1)
# terms, hence the absolute part.
ATTN_F32_TOL = dict(rtol=1e-5, atol=1e-5)
BACK_TO_BACK = 20  # calls between one pair of CUDA events

# K2 at the shootout's default shape and at the largest N the EEG serving run
# launches K1 with (6 bands x bucket 128), where the widened route would run.
PLV_SHAPES = ((64, 32, 1024), (768, 32, 1024))
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
SMS = 132                 # streaming multiprocessors
SFU_EX2_PER_CLOCK = 16    # exponentials per clock per SM (the SFU)


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bound(shape, plv: bool) -> tuple[float, str]:
    """K1 / K2 at (N, C, T): four inputs read once, three or five (N, C, C)
    outputs written once.  Per pair and sample K1 issues 7 FP32 instructions
    (the difference, the sign as a compare and a sign-bit OR, the sign sum,
    the |dphi| sum, two FMAs for sign * pw1 and sign * pw2), K2 four FMAs
    more (11), plus a sin and a cos of each phase sample.  Each instruction
    takes one lane-cycle of the SM's FP32 lanes, as an FMA does, and the
    peak counts an FMA as two operations: so 2 operations per instruction,
    14 (K1) or 22 (K2) per pair and sample, against ``F32_OPS_PER_S``."""
    n, c, t = shape
    outs = 5 if plv else 3
    ops = 2 * (11 if plv else 7) * n * c * c * t + (4 * n * c * t if plv else 0)
    return bound(4 * (4 * n * c * t + outs * n * c * c), ops, F32_OPS_PER_S)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def attention_bound(b, h, t, d, dtype) -> tuple[float, str]:
    """(B, H, T, d) attention: Q, K, V read once and O written once, against
    4 * B * H * T^2 * d matmul operations at the f32 CUDA-core or the bf16
    tensor-core peak."""
    size = 4 if dtype == torch.float32 else 2
    rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    return bound(4 * b * h * t * d * size, 4 * b * h * t * t * d, rate)


def sfu_ex2_ms(b, h, t, clock_hz) -> float:
    """ms for one exponential per score, B * H * T^2, on the SFU alone (16 a
    clock per SM on 132 SMs at ``clock_hz``).  A diagnostic, not a floor:
    the FMA pipes can compute exp2 as a polynomial too."""
    return b * h * t * t / (SFU_EX2_PER_CLOCK * SMS * clock_hz) * 1e3


def path_kernel_shapes() -> tuple:
    """The (N, C, T) at which the serving run launches K1, one per request size.

    ``Predictor`` zero-pads each request's windows up to its bucket, and
    ``connectivity_matrices`` stacks the six bands, so N = 6 * bucket:
    5, 15 and 80 windows run at buckets 8, 32 and 128.
    """
    from eyegaze_tpu_torch.serving import _bucket

    return tuple((6 * _bucket(trials * WINDOWS_PER_TRIAL, BUCKETS), CHANNELS, WINDOW)
                 for trials in REQUESTS)


def cuda_ms(fn, reps: int, calls: int = 1) -> list[float]:
    """Per-call device times of ``fn`` in ms, from CUDA events around
    ``calls`` calls in a row."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def phase_kernel_phase(device, plv: bool) -> dict:
    """K1 (K2 with ``plv``) against its plain version at its timed shapes,
    at RAGGED_SHAPE and at UNALIGNED_SHAPE, whose rows the kernel stages
    element by element.  The tied pair (0, 0) must give mean sign and
    Phase_Diff 0 (and mean cos 1): padded samples add nothing.

    Timed shapes: K1 the serving run's (``path_kernel_shapes``), K2
    PLV_SHAPES.  Kernel and plain version are timed in turns, one call
    between CUDA events, and the kernel again as 20 calls replayed from a
    CUDA graph (device time alone).  Returns the JSON fields at the largest
    timed shape.
    """
    from eyegaze_tpu_torch.kernels import phase_metrics

    name = "K2" if plv else "K1"
    kernel = phase_metrics.phase_plv_metric_sums if plv else phase_metrics.phase_metric_sums
    plain = (phase_metrics.pairwise_phase_plv_metrics_reference if plv
             else phase_metrics.pairwise_phase_metrics_reference)
    timed = PLV_SHAPES if plv else path_kernel_shapes()
    max_err = 0.0
    for seed, shape in enumerate(timed + (RAGGED_SHAPE, UNALIGNED_SHAPE)):
        x = phase_inputs(shape, device, seed)
        got = kernel(*x)
        torch.cuda.synchronize()
        errs = phase_metrics.assert_sums_close(got, plain(*x), x[2], x[3])
        max_err = max(max_err, *errs)
        tie_cos = float((got[3][:, 0, 0] - 1.0).abs().max()) if plv else 0.0
        if (got[0][:, 0, 0].any() or got[2][:, 0, 0].any()
                or tie_cos > phase_metrics.PLV_TOL["atol"]):
            raise RuntimeError(f"{name} {shape}: tied pair (0, 0) gives mean sign "
                               f"{got[0][:, 0, 0].tolist()}, pdiff {got[2][:, 0, 0].tolist()}, "
                               f"|mean cos - 1| {tie_cos:.3e}")
        print(f"{name} {shape}: max |kernel - plain| "
              + ", ".join(f"{k} {e:.3e}" for k, e in zip(SUM_NAMES, errs))
              + f" (|wnum| max {float(got[1].abs().max()):.1f}); tied pair (0, 0) mean sign and "
              + "pdiff 0" + (f", |mean cos - 1| {tie_cos:.3e}" if plv else "")
              + ": within tolerance")
        del x, got

    for seed, shape in enumerate(timed):
        x = phase_inputs(shape, device, seed)
        ms, plain_ms = alternate_ms(lambda: kernel(*x), lambda: plain(*x))
        ms_graph = graph_ms(lambda: kernel(*x))
        split = phase_metrics.split(*shape)
        blocks = phase_metrics.grid_blocks(shape[0], shape[1], split)
        bound_ms, bound_by = phase_bound(shape, plv)
        print(f"{name} {shape}: kernel median {ms:.4f} ms, plain median {plain_ms:.4f} ms over "
              f"20 calls each (CUDA events, one call between them); replayed from a CUDA graph "
              f"of {BACK_TO_BACK} calls {ms_graph:.4f} ms, {bound_ms / ms_graph:.0%} of the "
              f"bound {bound_ms:.4f} ms ({bound_by}); T split over {split} block(s) of a "
              f"cluster, {blocks} blocks on {SMS} SMs")
        del x
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "ms_graph": ms_graph, "split": split,
            "shape": list(shape)}


def windows(raw: np.ndarray, device) -> torch.Tensor:
    from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows

    x = preprocess_eeg(torch.from_numpy(raw).to(device), sampling_rate=SAMPLING_RATE)
    return sliding_windows(x, WINDOW, STRIDE).reshape(-1, CHANNELS, WINDOW)


def flagship_raw() -> tuple[np.ndarray, np.ndarray]:
    """The raw (TRIALS, 32, 3250) pairs every flagship phase serves."""
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(TRIALS, CHANNELS, RAW_SAMPLES)).astype(np.float32)
                 for _ in range(2))


def serve_flagship(pred, device, name: str):
    """Warm ``pred`` up and drive raw trials -> windows -> ``pred.predict``
    for each request size of REQUESTS, REPEATS times.  Every forward must
    launch K1 once.  Returns the K1 launches of the run (counted from 0),
    the median wall ms of each request size and the first request's logits."""
    from eyegaze_tpu_torch.kernels import phase_metrics

    raw1, raw2 = flagship_raw()
    t0 = time.perf_counter()
    pred.warmup(CHANNELS, WINDOW)
    print(f"{name}: warmup of buckets {BUCKETS}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    windows(raw1[:1], device)  # the filter's constants are made once per signal length
    print(f"{name}: first preprocess call: {time.perf_counter() - t0:.2f} s")

    first, medians = None, {}
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
        medians[trials] = statistics.median(walls)
        print(f"{name}: request of {trials} trial(s) = {n} windows: wall ms "
              f"{[round(w, 3) for w in walls]}, median {medians[trials]:.3f} "
              f"(preprocess + windows + predict; logits back on the host)")
    launches = phase_metrics.launch_count["phase_metric_sums"]
    if launches == 0 or phase_metrics.launch_count["phase_plv_metric_sums"] != 0:
        raise RuntimeError(f"the serving path's phase-metrics launches: "
                           f"{phase_metrics.launch_count}")
    print(f"K1 launches during the {name} run: {launches}")
    return launches, medians, first


def slice_phase(device):
    """Drive raw trials -> windows -> Predictor on ``device`` (float32).

    Returns the kernel launches of the run, the median wall ms of each
    request size, the raw pair of the first request, its logits and the
    model's state_dict.
    """
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    model = DualEEGTransformer(**GEOMETRY, device=device,
                               generator=torch.Generator().manual_seed(0))
    print(f"DualEEGTransformer: {sum(p.numel() for p in model.parameters()):,} parameters "
          f"on {device}")
    pred = Predictor(model, device=device, batch_buckets=BUCKETS, preprocess=False)
    launches, medians, first = serve_flagship(pred, device, "flagship (f32)")
    raw1, raw2 = flagship_raw()
    return launches, medians, raw1[:1], raw2[:1], first, model.state_dict()


def save_checkpoint(state, meta: dict, path: Path) -> Path:
    """``state`` as the export script writes it (a CPU state_dict saved with
    ``torch.save``) and ``meta`` beside it as ``.meta.json``."""
    torch.save({k: v.cpu() for k, v in state.items()}, path)
    path.with_suffix(".meta.json").write_text(json.dumps(meta))
    return path


def flagship_bf16_phase(device, tmp: Path, state, f32_medians, f32_logits):
    """Serve the f32 phase's weights as the JAX package serves them: from a
    checkpoint, in bf16 compute.  Returns the K1 launches of the run and the
    checkpoint's path."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.serving import Predictor

    path = save_checkpoint(state, FLAGSHIP_META, tmp / "flagship.pt")
    pred = Predictor.from_checkpoint(path, device=device, batch_buckets=BUCKETS)
    if pred.model.dtype != torch.bfloat16 or pred.preprocess:
        raise RuntimeError(f"from_checkpoint built dtype {pred.model.dtype}, preprocess "
                           f"{pred.preprocess}")
    reset_attention_counts()
    launches, medians, logits = serve_flagship(pred, device, "flagship (bf16, from a checkpoint)")
    if any(attention.launch_count.values()):
        raise RuntimeError("the flagship's 139-token attention launched the attention kernel")
    for trials in REQUESTS:
        print(f"flagship request of {trials} trial(s), median wall ms: bf16 {medians[trials]:.3f}, "
              f"f32 {f32_medians[trials]:.3f}")
    cpu = torch.device("cpu")
    raw1, raw2 = flagship_raw()
    want = Predictor.from_checkpoint(path, device=cpu, batch_buckets=BUCKETS).predict(
        windows(raw1[:1], cpu), windows(raw2[:1], cpu))["logits"]
    gap = float(np.abs(logits - want).max())
    tol = LOGIT_BF16_TOL_SHARE * float(np.abs(want).max())
    print(f"1-trial logits, bf16 compute: card vs CPU max |diff| {gap:.3e} (tolerance {tol:.3e}, "
          f"2**-5 of the largest |logit| {float(np.abs(want).max()):.3f}); bf16 vs f32 on the "
          f"card {float(np.abs(logits - f32_logits).max()):.3e}")
    if not gap <= tol:
        raise RuntimeError(f"bf16 flagship, card vs CPU: {gap:.3e} over {tol:.3e}")
    return launches, path


def http_phase(device, path: Path) -> None:
    """``eyegaze_tpu_torch.serve --dynamic-batch`` on the bf16 checkpoint, in
    a thread: HTTP_REQUESTS concurrent single-trial requests, each answer
    held to a direct ``predict`` of its rows."""
    from eyegaze_tpu_torch import serve
    from eyegaze_tpu_torch.kernels import phase_metrics
    from eyegaze_tpu_torch.serving import Predictor

    raw1, raw2 = flagship_raw()
    w1, w2 = (windows(r[:HTTP_REQUESTS], device).cpu().numpy() for r in (raw1, raw2))
    rows = [slice(i * WINDOWS_PER_TRIAL, (i + 1) * WINDOWS_PER_TRIAL)
            for i in range(HTTP_REQUESTS)]
    direct = Predictor.from_checkpoint(path, device=device, batch_buckets=(HTTP_BUCKET,))
    want = [direct.predict(w1[r], w2[r]) for r in rows]
    del direct

    bound = []
    argv = ["--checkpoint", str(path), "--device", str(device), "--host", "127.0.0.1",
            "--port", "0", "--buckets", str(HTTP_BUCKET), "--dynamic-batch"]
    thread = threading.Thread(target=serve.main, args=(argv, bound.append), daemon=True)
    thread.start()
    for _ in range(600):
        if bound or not thread.is_alive():
            break
        thread.join(0.5)
    if not bound:
        raise RuntimeError("eyegaze_tpu_torch.serve did not start")
    server = bound[0]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)

        def post(r):
            buf = io.BytesIO()
            np.savez(buf, eeg1=w1[r], eeg2=w2[r])
            req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                out = json.load(resp)
            return out, (time.perf_counter() - t0) * 1e3

        with ThreadPoolExecutor(HTTP_REQUESTS) as pool:
            answers = list(pool.map(post, rows))
        launches = phase_metrics.launch_count["phase_metric_sums"]
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
            metrics = json.load(resp)
    finally:
        server.shutdown()
        thread.join(60)
    for i, ((got, _), ref) in enumerate(zip(answers, want)):
        logits = np.asarray(got["logits"], np.float32)
        if not np.array_equal(logits, ref["logits"]) or got["labels"] != ref["labels"]:
            raise RuntimeError(f"request {i}: answer {got['labels']} / max |diff| "
                               f"{float(np.abs(logits - ref['logits']).max()):.3e} is not the "
                               f"direct predict's {ref['labels']}")
    batch = metrics["dynamic_batch"]
    if batch["requests"] != HTTP_REQUESTS or not batch["dispatches"] < HTTP_REQUESTS:
        raise RuntimeError(f"{HTTP_REQUESTS} requests took {batch['dispatches']} dispatches")
    if launches != batch["dispatches"]:
        raise RuntimeError(f"{batch['dispatches']} dispatches launched K1 {launches} times")
    walls = np.array([ms for _, ms in answers])
    print(f"HTTP, {HTTP_REQUESTS} concurrent single-trial requests ({WINDOWS_PER_TRIAL} windows "
          f"each) through eyegaze_tpu_torch.serve --dynamic-batch, bucket {HTTP_BUCKET}: every "
          f"answer equals the direct predict of its rows, labels included; "
          f"{batch['dispatches']} dispatches of {batch['max_coalesced']} requests at most, "
          f"{launches} K1 launches; request wall ms p50 {np.percentile(walls, 50):.3f}, "
          f"p99 {np.percentile(walls, 99):.3f}, all {sorted(round(float(w), 3) for w in walls)}; "
          f"server phases {batch['phase_breakdown']}")


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


def graph_ms(fn, calls: int = BACK_TO_BACK, reps: int = 10) -> float:
    """Median device ms per call of ``fn``, ``calls`` calls captured in one
    CUDA graph and replayed between CUDA events: no host enqueue time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return statistics.median(cuda_ms(graph.replay, reps)) / calls


def alternate_ms(*fns, rounds: int = 10, calls: int = 1) -> list[float]:
    """Median CUDA-event ms per call of each function, timed in turns after
    a warm-up, ``calls`` calls between one pair of events."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(rounds):  # in turns, so drift in clocks hits all alike
        for fn, acc in zip(fns, times):
            acc += cuda_ms(fn, 2, calls)
    return [statistics.median(t) for t in times]


def attention_phase(device, clock_hz) -> dict:
    """Both attention entry points against the twin; timings at ART's
    serving shapes and K4's, one call and ``BACK_TO_BACK`` calls between
    events.  Returns the JSON fields of each (entry point, dtype) the paths
    launch."""
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
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)  # noqa: E731
        ms, plain_ms, library_ms = alternate_ms(
            kernel, lambda: attention.attention_reference(qt, kt, vt, scale), library)
        ms_b2b, library_ms_b2b = alternate_ms(kernel, library, calls=BACK_TO_BACK)
        ms_graph, library_ms_graph = graph_ms(kernel), graph_ms(library)
        bound_ms, bound_by = attention_bound(*qt.shape, dt)
        sfu_ms = sfu_ex2_ms(*qt.shape[:3], clock_hz)
        times[(entry, shape, dt)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "sfu_ex2_ms": sfu_ms,
                                     "library_ms": library_ms, "ms_back_to_back": ms_b2b,
                                     "library_ms_back_to_back": library_ms_b2b,
                                     "ms_graph": ms_graph, "library_ms_graph": library_ms_graph}
        tiling = ""
        if dt == torch.float32:
            rows = attention.f32_rows_per_thread(shape[0], shape[2], shape[1], shape[3])
            times[(entry, shape, dt)]["rows_per_thread"] = rows
            tiling = f" ({rows} query rows per thread)"
        print(f"{entry} {shape} {str(dt)[6:]}{tiling}: kernel median {ms:.4f} ms, twin median "
              f"{plain_ms:.4f} ms, F.scaled_dot_product_attention median {library_ms:.4f} ms "
              f"over 20 calls each (CUDA events, one call between them); back to back "
              f"({BACK_TO_BACK} calls between events) kernel {ms_b2b:.4f} ms, library "
              f"{library_ms_b2b:.4f} ms; replayed from a CUDA graph of {BACK_TO_BACK} calls "
              f"kernel {ms_graph:.4f} ms, library {library_ms_graph:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_by}); exponentials on the SFU alone "
              f"{sfu_ms:.4f} ms (not a floor)")
        del q, k, v, qt, kt, vt
    largest = serving[-1]  # the 16-window request's bucket
    fields = {}
    for entry, shape, dt in (("headpacked_attention", largest, torch.float32),
                             ("headpacked_attention", largest, torch.bfloat16),
                             ("flash_attention", FLASH_SHAPE, torch.bfloat16)):
        fields[entry, dt] = {"max_abs_err": err[entry, dt], **times[(entry, shape, dt)],
                             "shape": list(shape), "dtype": str(dt)[6:]}
    return fields


def reset_attention_counts() -> None:
    from eyegaze_tpu_torch.kernels import attention

    for counts in (attention.launch_count, attention.bf16_launch_count):
        counts.update(headpacked_attention=0, flash_attention=0)


def art_phase(device, dtype=torch.float32):
    """Serve (N, 32, 1024) windows through ArtDenoiser at full width, in
    ``dtype`` compute.

    Every launch must be of the head-packed entry point's instance for
    ``dtype``.  Returns those launches, the median wall ms of each request
    size, the windows served, each request size's output (its last repeat)
    and the model's state_dict.
    """
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    name = f"ART ({str(dtype)[6:]} compute)"
    model = ArtifactRemovalTransformer(ArtConfig(), device=device, dtype=dtype,
                                       generator=torch.Generator().manual_seed(0))
    print(f"{name} {ArtConfig()}: "
          f"{sum(p.numel() for p in model.parameters()):,} parameters on {device}")
    den = ArtDenoiser(model, device=device, batch_buckets=ART_BUCKETS)
    t0 = time.perf_counter()
    den.warmup(CHANNELS, WINDOW)
    print(f"warmup of buckets {ART_BUCKETS}: {time.perf_counter() - t0:.2f} s")
    noisy = np.random.default_rng(1).normal(
        size=(max(ART_REQUESTS), CHANNELS, WINDOW)).astype(np.float32)

    def instance_launches() -> int:  # head-packed launches of the dtype's instance
        bf16 = attention.bf16_launch_count["headpacked_attention"]
        return bf16 if dtype == torch.bfloat16 else (
            attention.launch_count["headpacked_attention"] - bf16)

    if dtype == torch.float32:
        rows = {b: attention.f32_rows_per_thread(b, ATTN_HEADS, WINDOW, ATTN_DK)
                for b in ART_BUCKETS}
        print(f"{name}: the f32 attention instance's query rows per thread at each bucket: "
              f"{rows}")
    outs, medians = {}, {}
    reset_attention_counts()
    for n in ART_REQUESTS:
        walls = []
        for _ in range(REPEATS):
            before = instance_launches()
            t0 = time.perf_counter()
            out = den.predict(noisy[:n])["denoised"]
            walls.append((time.perf_counter() - t0) * 1e3)
            forwards = math.ceil(n / ART_BUCKETS[-1])
            launched = instance_launches() - before
            if launched != ART_ATTENTION_CALLS * forwards:
                raise RuntimeError(f"{forwards} forwards launched the attention kernel's "
                                   f"{str(dtype)[6:]} instance {launched} times, not "
                                   f"{ART_ATTENTION_CALLS * forwards}")
            if out.shape != (n, CHANNELS, WINDOW) or not np.isfinite(out).all():
                raise RuntimeError(f"bad output: shape {out.shape}, finite "
                                   f"{np.isfinite(out).all()}")
        outs[n] = out
        medians[n] = statistics.median(walls)
        print(f"{name} request of {n} window(s): wall ms {[round(w, 3) for w in walls]}, "
              f"median {medians[n]:.3f} (predict; output back on the host)")
    launches = instance_launches()
    if (launches == 0 or launches != attention.launch_count["headpacked_attention"]
            or attention.launch_count["flash_attention"] != 0):
        raise RuntimeError(f"{name}'s attention launches: {attention.launch_count}, of them "
                           f"bf16 {attention.bf16_launch_count}")
    print(f"head-packed attention launches ({str(dtype)[6:]} instance) during the {name} "
          f"run: {launches}")
    return launches, medians, noisy, outs, model.state_dict()


def art_cpu_parity(noisy, denoised, state, dtype=torch.float32) -> np.ndarray:
    """The first request's card output against the same weights, served in
    the same compute type on the CPU; returns the CPU's output."""
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    cpu = torch.device("cpu")
    model = ArtifactRemovalTransformer(ArtConfig(), device=cpu, dtype=dtype,
                                       generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    want = ArtDenoiser(model, device=cpu, batch_buckets=ART_BUCKETS).predict(noisy)["denoised"]
    if dtype == torch.float32:
        tol = dict(rtol=ART_TOL, atol=ART_TOL)
    else:
        tol = dict(rtol=0, atol=ART_BF16_TOL_SHARE * float(np.abs(want).max()))
    torch.testing.assert_close(torch.from_numpy(denoised), torch.from_numpy(want), **tol)
    print(f"1-window ART output ({str(dtype)[6:]} compute), card vs CPU (plain attention "
          f"twin): max |diff| {float(np.abs(denoised - want).max()):.3e}, |out| max "
          f"{float(np.abs(want).max()):.3f}, tolerance {tol}")
    return want


def art_bf16_phase(device, f32_medians, f32_denoised):
    """ART served in bf16 compute: the same weights and requests as the f32
    phase, 18 bf16 head-packed launches per forward, the 1-window output
    against the CPU's bf16 run.  Returns the launches of the run, the
    windows, the outputs of each request size and the state_dict."""
    launches, medians, noisy, outs, state = art_phase(device, torch.bfloat16)
    for n in ART_REQUESTS:
        print(f"ART request of {n} window(s), median wall ms: bf16 {medians[n]:.3f}, "
              f"f32 {f32_medians[n]:.3f} ({f32_medians[n] / medians[n]:.2f}x)")
    n = ART_REQUESTS[0]
    want = art_cpu_parity(noisy[:n], outs[n], state, torch.bfloat16)
    print(f"1-window ART output, bf16 vs f32 compute, same weights: max |diff| on the card "
          f"{float(np.abs(outs[n] - f32_denoised).max()):.3e}, on the CPU's bf16 against "
          f"the card's f32 {float(np.abs(want - f32_denoised).max()):.3e}")
    return launches, noisy, outs, state


def art_checkpoint_phase(device, tmp: Path, state, noisy, outs) -> int:
    """``ArtDenoiser.from_checkpoint`` (bf16) on the bf16 phase's weights,
    saved as a state_dict plus meta: the 16-window request at bucket 32
    launches the bf16 instance 18 times and gives, to the bit, the bf16
    phase's output for the same windows.  Returns the launches."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.art import ArtConfig
    from eyegaze_tpu_torch.serving import ArtDenoiser

    meta = {"config": {"model": dataclasses.asdict(ArtConfig())}}
    den = ArtDenoiser.from_checkpoint(save_checkpoint(state, meta, tmp / "art.pt"),
                                      device=device, batch_buckets=ART_BUCKETS)
    den.warmup(CHANNELS, WINDOW)
    n = ART_REQUESTS[-1]
    reset_attention_counts()
    out = den.predict(noisy[:n])["denoised"]
    launches, bf16 = dict(attention.launch_count), dict(attention.bf16_launch_count)
    if den.model.dtype != torch.bfloat16 or launches != bf16 or launches != {
            "headpacked_attention": ART_ATTENTION_CALLS, "flash_attention": 0}:
        raise RuntimeError(f"ArtDenoiser.from_checkpoint ({den.model.dtype}), one forward at "
                           f"bucket {ART_BUCKETS[-1]}: {launches}, of them bf16 {bf16}")
    if not np.array_equal(out, outs[n]):
        raise RuntimeError(f"ART from a checkpoint differs from the bf16 phase's output for the "
                           f"same weights: max |diff| {float(np.abs(out - outs[n]).max()):.3e}")
    print(f"ART from a checkpoint (bf16), {n} windows at bucket {ART_BUCKETS[-1]}: "
          f"{bf16['headpacked_attention']} bf16 head-packed launches, output equal to the bit "
          "to the bf16 phase's")
    return bf16["headpacked_attention"]


def flash_route_phase(device) -> int:
    """A bf16 MultiHeadAttention with d_k 128 takes the flash route on every
    forward and matches its own plain path (forced by returning weights)."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.transformer import MultiHeadAttention, init_weights_

    b, h, t, d = FLASH_SHAPE
    mha = MultiHeadAttention(h * d, h, device=device, dtype=torch.bfloat16)
    init_weights_(mha, torch.Generator().manual_seed(2))
    mha.eval()
    x = torch.randn(b, t, h * d, generator=torch.Generator().manual_seed(3)).to(
        device, torch.bfloat16)
    reset_attention_counts()
    with torch.inference_mode():
        outs = [mha(x, x, x) for _ in range(FLASH_CALLS)]
        launches, bf16 = dict(attention.launch_count), dict(attention.bf16_launch_count)
        plain = mha(x, x, x, return_weights=True)[0]
    torch.cuda.synchronize()
    if launches != bf16 or launches != {"headpacked_attention": 0,
                                        "flash_attention": FLASH_CALLS}:
        raise RuntimeError(f"{FLASH_CALLS} bf16 d_k-128 forwards: {launches}, of them "
                           f"bf16 {bf16}")
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


F32_INSTANCES = {(16, 4), (16, 1), (32, 2), (32, 1), (64, 1), (128, 1)}  # (d, rows per thread)
BF16_HEAD_DIMS = {16, 32, 64, 128}


def assert_no_spill(report: str, kernel: str) -> None:
    """Raises if nvcc's ptxas report shows a spill in an instance of a
    kernel whose name holds ``kernel`` (an empty report, from a library
    built earlier, shows none)."""
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
            raise RuntimeError(f"ptxas spills in {name}: {line.strip()}")


def dump_sass(lib) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cuobjdump = Path(CUDA_HOME) / "bin" / "cuobjdump"
    return subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


# The arithmetic of the work: FP32 instructions and LOP3, the bit OR that
# gives the sign its sign bit (address arithmetic uses LOP3 too).
WORK_OPCODES = {"FADD", "FMUL", "FFMA", "FSET", "FSETP", "FSEL", "FMNMX", "LOP3"}
# Pairs per thread x samples per thread in one chunk of the main loop.
PAIR_SAMPLES_PER_ITERATION = 8 * 16


def phase_loop_counts(lib) -> dict:
    """Arithmetic (``WORK_OPCODES``), LDS and other instructions per pair and
    sample in the main loop
    of K1's and K2's instances, from the SASS: the body of the backward
    branch whose range holds the most arithmetic (one chunk: its
    staging, K2's sincos pass and the unrolled arithmetic).  Static counts:
    the code of both staging paths counts once, K2's sincos loop once."""
    code, name = {}, None
    for line in dump_sass(lib).splitlines():
        head = re.search(r"Function : \S*phase_metrics_kernelILb([01])E", line)
        if head:
            name = "K2" if head.group(1) == "1" else "K1"
            code[name] = []
        elif "Function : " in line:
            name = None
        elif name:
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);",
                           line)
            if ins:
                code[name].append((int(ins.group(1), 16), ins.group(2).split(".")[0],
                                   ins.group(3)))
    counts = {}
    for name, ins in sorted(code.items()):
        best = None
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr]
                fp32 = sum(o in WORK_OPCODES for o in body)
                if best is None or fp32 > best[0]:
                    best = (fp32, sum(o == "LDS" for o in body), len(body))
        if best is None:
            raise RuntimeError(f"no loop found in the SASS of {name}")
        per = PAIR_SAMPLES_PER_ITERATION
        counts[name] = {"arithmetic": best[0] / per, "lds": best[1] / per,
                        "other": (best[2] - best[0] - best[1]) / per}
    if set(counts) != {"K1", "K2"}:
        raise RuntimeError(f"phase-metrics instances in the SASS: {sorted(counts)}")
    print("main-loop instructions per pair and sample (static SASS counts): "
          + "; ".join(f"{k} arithmetic {v['arithmetic']:.2f}, LDS {v['lds']:.2f}, "
                      f"other {v['other']:.2f}"
                      for k, v in counts.items()))
    return counts


def tensor_core_proof(lib) -> dict:
    """HMMA (tensor-core) instructions in the SASS of each instance of the
    attention kernel, from ``cuobjdump --dump-sass`` of the built library.
    Raises unless every f32 instance has none (no TF32 product in the f32
    path) and every bf16 instance has some."""
    counts, name = {}, None
    for line in dump_sass(lib).splitlines():
        header = re.search(r"Function : \S*attention_kernel_(f32|bf16)ILi(\d+)E(?:Li(\d+)E)?", line)
        if header:
            kind, d, rows = header.groups()
            name = (kind, int(d), int(rows)) if kind == "f32" else (kind, int(d))
            counts[name] = 0
        elif "Function : " in line:
            name = None
        elif name and "HMMA" in line:
            counts[name] += 1
    printable = {(f"f32 d={k[1]} R={k[2]}" if k[0] == "f32" else f"bf16 d={k[1]}"): n
                 for k, n in counts.items()}
    print(f"HMMA instructions per attention kernel instance: {printable}")
    f32 = {k[1:]: n for k, n in counts.items() if k[0] == "f32"}
    bf16 = {k[1]: n for k, n in counts.items() if k[0] == "bf16"}
    if set(f32) != F32_INSTANCES or any(f32.values()):
        raise RuntimeError(f"the f32 attention instances are not the {sorted(F32_INSTANCES)} "
                           f"without tensor-core instructions: {printable}")
    if set(bf16) != BF16_HEAD_DIMS or not all(bf16.values()):
        raise RuntimeError(f"a bf16 attention instance runs no tensor-core instruction: "
                           f"{printable}")
    return printable


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; it has no CPU mode")
    from eyegaze_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    clock_hz = sm_clock_hz()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"max SM clock {clock_hz / 1e6:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions: every phase runs in full float32 "
          "unless it says bf16")

    t0 = time.perf_counter()
    built = build.build_all(SOURCES)
    print(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s (one nvcc each, "
          "in parallel)")
    for name, (lib, report) in built.items():
        print(f"{name}: {lib.name}")
        for line in report.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    assert_no_spill(built["attention"][1], "attention_kernel_f32")
    assert_no_spill(built["phase_metrics"][1], "phase_metrics_kernel")
    tensor_core_proof(built["attention"][0])
    loop_counts = phase_loop_counts(built["phase_metrics"][0])

    from eyegaze_tpu_torch.kernels import attention

    k1_timing = phase_kernel_phase(device, plv=False)
    k2_timing = phase_kernel_phase(device, plv=True)
    attn_timing = attention_phase(device, clock_hz)

    reset_attention_counts()
    k1_launches, medians, raw1, raw2, logits, state = slice_phase(device)
    if any(attention.launch_count.values()):
        raise RuntimeError("the flagship's 139-token attention launched the attention kernel")
    cpu_parity(raw1, raw2, logits, state)

    with tempfile.TemporaryDirectory() as tmp:
        k1_bf16_launches, checkpoint = flagship_bf16_phase(device, Path(tmp), state, medians,
                                                           logits)
        http_phase(device, checkpoint)

        art_launches, art_medians, noisy, outs, art_state = art_phase(device)
        n = ART_REQUESTS[0]
        art_cpu_parity(noisy[:n], outs[n], art_state)
        art_bf16_launches, noisy, outs, art_state = art_bf16_phase(device, art_medians, outs[n])
        art_ckpt_launches = art_checkpoint_phase(device, Path(tmp), art_state, noisy, outs)
    flash_launches = flash_route_phase(device)

    _, shootout_launches = shootout_phase()
    legacy_raw1, legacy_raw2, legacy_logits, legacy_state = legacy_phase(device)
    cpu_parity(legacy_raw1, legacy_raw2, legacy_logits, legacy_state, use_robust_ibs=False)

    phase_source = "eyegaze_tpu_torch/csrc/phase_metrics.cu"
    source = "eyegaze_tpu_torch/csrc/attention.cu"
    art_forwards = len(ART_REQUESTS) * REPEATS
    k1_all = k1_launches + k1_bf16_launches
    art_bf16_all = art_bf16_launches + art_ckpt_launches
    kernels = [
        {"name": "pairwise_phase_metrics", "route": "cuda", "source": phase_source,
         "replaces": "eyegaze_tpu/ops/pallas_kernels.py:74", "launches": k1_all,
         "path": "EEG serving, f32 and bf16 from a checkpoint",
         "launches_per_request": k1_all / (2 * len(REQUESTS) * REPEATS),
         "sass_per_pair_sample": loop_counts["K1"], **k1_timing},
        {"name": "pairwise_phase_plv_metrics", "route": "cuda", "source": phase_source,
         "replaces": "eyegaze_tpu/ops/pallas_kernels.py:151",
         "launches": shootout_launches["phase_plv_metric_sums"],
         "path": "connectivity shootout (bench_connectivity)",
         "launches_per_request": shootout_launches["phase_plv_metric_sums"],
         "sass_per_pair_sample": loop_counts["K2"], **k2_timing},
        {"name": "headpacked_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/ops/attn_kernels.py:78", "launches": art_launches,
         "path": "ART serving", "launches_per_request": art_launches / art_forwards,
         **attn_timing["headpacked_attention", torch.float32]},
        {"name": "flash_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/models/transformer.py:232", "launches": flash_launches,
         "path": "bf16 MultiHeadAttention, d_k 128",
         "launches_per_request": flash_launches / FLASH_CALLS,
         **attn_timing["flash_attention", torch.bfloat16]},
        {"name": "headpacked_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/ops/attn_kernels.py:78", "launches": art_bf16_all,
         "path": "ART serving, bf16, and from a checkpoint",
         "launches_per_request": art_bf16_all / (art_forwards + 1),
         **attn_timing["headpacked_attention", torch.bfloat16]},
    ]
    for k in kernels:
        library = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        print(f"{k['name']} ({k['path']}) at {k['shape']}: {k['ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms (set by {k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library call {library}; "
              f"{k['launches_per_request']:g} launches per request of its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
