"""K1: pairwise phase metrics, a CUDA kernel for Hopper and its plain twin.

Replaces the Pallas TPU kernel
``eyegaze_tpu/ops/pallas_kernels.py::pairwise_phase_metrics_pallas``.  For
(N, C, T) phases and band powers of two players it returns three (N, C, C)
float32 sums over every channel pair (i, j), with dphi = ph1_i(t) - ph2_j(t):
the mean of sign(dphi), the sum of sign(dphi) * (pw1_i + pw2_j) / 2, and the
mean of |dphi|.  The CUDA source is ``csrc/phase_metrics.cu``.

What bounds it on an H100: the kernel reads its four inputs once,
4 * N * C * T * 4 bytes (about 403 MB at N = 768, C = 32, T = 1024: six bands
of a 128-window serving bucket), and does about N * C^2 * T sign/abs/FMA steps on the CUDA cores,
with no tensor-core work.  Its measured time sits in PERF.md beside the
plain version's.

``phase_metric_sums`` is the wrapper: a CPU tensor goes to the plain version
``pairwise_phase_metrics_reference``; a CUDA tensor launches the kernel, or
raises.  ``launch_count`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eyegaze_tpu_torch.kernels import build

launch_count = 0  # kernel launches since import (or since a caller reset it)


def pairwise_phase_metrics_reference(phase1, phase2, power1, power2, row_chunk: int = 8):
    """Plain PyTorch version of the kernel: (mean_sign, wnum, pdiff).

    The row-chunked broadcast-reduce of
    ``eyegaze_tpu/ops/connectivity.py::_pairwise_phase_metrics_xla``: only a
    (N, row_chunk, C, T) difference tensor is live at a time.
    """
    c = phase1.shape[1]
    mean_sgn, wnum, pdiff = [], [], []
    for r0 in range(0, c, row_chunk):
        dphi = phase1[:, r0:r0 + row_chunk, None, :] - phase2[:, None, :, :]
        sgn = torch.sign(dphi)
        mean_sgn.append(sgn.mean(dim=-1))
        pdiff.append(dphi.abs().mean(dim=-1))
        w = (power1[:, r0:r0 + row_chunk, None, :] + power2[:, None, :, :]) * 0.5
        wnum.append((sgn * w).sum(dim=-1))
    return torch.cat(mean_sgn, dim=1), torch.cat(wnum, dim=1), torch.cat(pdiff, dim=1)


@functools.cache
def _launcher():
    fn = build.load("phase_metrics").phase_metrics_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(tensors) -> None:
    ref = tensors[0]
    if ref.dim() != 3:
        raise ValueError(f"expected (N, C, T) tensors, got shape {tuple(ref.shape)}")
    for x in tensors:
        if x.shape != ref.shape:
            raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(ref.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32, got {x.dtype}")
        if x.device != ref.device:
            raise ValueError(f"device mismatch: {x.device} vs {ref.device}")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def phase_metric_sums(phase1, phase2, power1, power2):
    """(N, C, T) float32 x4 -> (mean_sign, wnum, pdiff), each (N, C, C).

    On a CUDA tensor this launches the kernel on the current stream; on a CPU
    tensor it runs the plain version.  Any other device raises.
    """
    global launch_count
    tensors = (phase1, phase2, power1, power2)
    _check(tensors)
    device = phase1.device
    if device.type == "cpu":
        return pairwise_phase_metrics_reference(*tensors)
    if device.type != "cuda":
        raise RuntimeError(f"no phase-metrics kernel for device {device}")
    n, c, t = phase1.shape
    outs = [torch.empty((n, c, c), dtype=torch.float32, device=device) for _ in range(3)]
    if n == 0 or c == 0:
        return tuple(outs)
    if max(n, c, t) >= 2**31:
        raise ValueError(f"shape {tuple(phase1.shape)} exceeds the kernel's int indexing")
    launch = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(*(x.data_ptr() for x in tensors), *(o.data_ptr() for o in outs),
                     n, c, t, stream)
    if err != 0:
        raise RuntimeError(f"phase_metrics kernel launch failed: cudaError {err}")
    launch_count += 1
    return tuple(outs)


def pairwise_phase_metrics(phase1, phase2, power1, power2, eps: float = 1e-8):
    """(pli, wpli, pdiff), each (N, C, C), from the kernel's sums.

    The assembly of ``eyegaze_tpu/ops/pallas_kernels.py::pairwise_phase_metrics``:
    PLI = |mean sign|, wPLI = |wnum / (separable denominator + eps)|.
    """
    mean_sgn, wnum, pdiff = phase_metric_sums(phase1, phase2, power1, power2)
    den = (power1.sum(dim=-1)[:, :, None] + power2.sum(dim=-1)[:, None, :]) * 0.5
    return mean_sgn.abs(), (wnum / (den + eps)).abs(), pdiff
