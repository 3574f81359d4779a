"""K1 and K2: pairwise phase metrics, CUDA kernels for Hopper and their plain twins.

K1 replaces the Pallas TPU kernel
``eyegaze_tpu/ops/pallas_kernels.py::pairwise_phase_metrics_pallas``.  For
(N, C, T) phases and band powers of two players it returns three (N, C, C)
float32 sums over every channel pair (i, j), with dphi = ph1_i(t) - ph2_j(t):
the mean of sign(dphi), the sum of sign(dphi) * (pw1_i + pw2_j) / 2, and the
mean of |dphi|.

K2 replaces the widened ``pairwise_phase_plv_metrics_pallas`` of the same
file: K1's three sums plus the means of cos(dphi) and sin(dphi), whose
modulus is the PLV.  Both are instances of one template in
``csrc/phase_metrics.cu``, with one C entry point each.

What bounds them on an H100: each kernel reads its four inputs once,
4 * N * C * T * 4 bytes (about 403 MB at N = 768, C = 32, T = 1024: six bands
of a 128-window serving bucket), and does about N * C^2 * T sign/abs/FMA steps
on the CUDA cores (K2 four FMAs more per pair and sample, from cos and sin
taken once per staged sample), with no tensor-core work.  Their measured
times sit in PERF.md beside the plain versions'.

``phase_metric_sums`` (K1) and ``phase_plv_metric_sums`` (K2) are the
wrappers: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel, or raises.  ``launch_count`` counts kernel launches and nothing else,
one count for each wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eyegaze_tpu_torch.kernels import build

# Kernel launches since import (or since a caller reset them), by wrapper.
launch_count = {"phase_metric_sums": 0, "phase_plv_metric_sums": 0}


def pairwise_phase_metrics_reference(phase1, phase2, power1, power2, row_chunk: int = 8):
    """Plain PyTorch version of K1: (mean_sign, wnum, pdiff).

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


def pairwise_phase_plv_metrics_reference(phase1, phase2, power1, power2,
                                         row_chunk: int = 8):
    """Plain PyTorch version of K2: (mean_sign, wnum, pdiff, plv_re, plv_im).

    K1's plain version plus the literal means of cos(dphi) and sin(dphi) over
    the same (N, row_chunk, C, T) difference tensors, as ``_kernel5`` of the
    Pallas kernel computes them.
    """
    c = phase1.shape[1]
    sums = [[] for _ in range(5)]
    for r0 in range(0, c, row_chunk):
        dphi = phase1[:, r0:r0 + row_chunk, None, :] - phase2[:, None, :, :]
        sgn = torch.sign(dphi)
        w = (power1[:, r0:r0 + row_chunk, None, :] + power2[:, None, :, :]) * 0.5
        for out, s in zip(sums, (sgn.mean(dim=-1), (sgn * w).sum(dim=-1),
                                 dphi.abs().mean(dim=-1), torch.cos(dphi).mean(dim=-1),
                                 torch.sin(dphi).mean(dim=-1))):
            out.append(s)
    return tuple(torch.cat(s, dim=1) for s in sums)


@functools.cache
def _launcher(entry: str, outputs: int):
    fn = getattr(build.load("phase_metrics"), entry)
    fn.argtypes = [ctypes.c_void_p] * (4 + outputs) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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


def _sums(wrapper: str, entry: str, outputs: int, reference, tensors):
    """Checks the inputs, then runs ``reference`` on a CPU tensor or launches
    the C entry point ``entry`` with ``outputs`` (N, C, C) outputs on a CUDA
    tensor.  Any other device raises."""
    _check(tensors)
    device = tensors[0].device
    if device.type == "cpu":
        return reference(*tensors)
    if device.type != "cuda":
        raise RuntimeError(f"no phase-metrics kernel for device {device}")
    n, c, t = tensors[0].shape
    outs = [torch.empty((n, c, c), dtype=torch.float32, device=device) for _ in range(outputs)]
    if n == 0 or c == 0:
        return tuple(outs)
    if max(n, c, t) >= 2**31:
        raise ValueError(f"shape {tuple(tensors[0].shape)} exceeds the kernel's int indexing")
    launch = _launcher(entry, outputs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(*(x.data_ptr() for x in tensors), *(o.data_ptr() for o in outs),
                     n, c, t, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    launch_count[wrapper] += 1
    return tuple(outs)


def phase_metric_sums(phase1, phase2, power1, power2):
    """K1: (N, C, T) float32 x4 -> (mean_sign, wnum, pdiff), each (N, C, C).

    On a CUDA tensor this launches the kernel on the current stream; on a CPU
    tensor it runs the plain version.  Any other device raises.
    """
    return _sums("phase_metric_sums", "phase_metrics_launch", 3,
                 pairwise_phase_metrics_reference, (phase1, phase2, power1, power2))


def phase_plv_metric_sums(phase1, phase2, power1, power2):
    """K2: (N, C, T) float32 x4 -> (mean_sign, wnum, pdiff, plv_re, plv_im),
    each (N, C, C).

    On a CUDA tensor this launches the kernel on the current stream; on a CPU
    tensor it runs the plain version.  Any other device raises.
    """
    return _sums("phase_plv_metric_sums", "phase_plv_metrics_launch", 5,
                 pairwise_phase_plv_metrics_reference, (phase1, phase2, power1, power2))


def assemble_phase_metrics(mean_sgn, wnum, pdiff, power1, power2, eps: float = 1e-8):
    """(pli, wpli, pdiff) from the sums: PLI = |mean sign|, wPLI = |wnum /
    (separable denominator + eps)|."""
    den = (power1.sum(dim=-1)[:, :, None] + power2.sum(dim=-1)[:, None, :]) * 0.5
    return mean_sgn.abs(), (wnum / (den + eps)).abs(), pdiff


def pairwise_phase_metrics(phase1, phase2, power1, power2, eps: float = 1e-8):
    """(pli, wpli, pdiff), each (N, C, C), from K1's sums.

    The assembly of ``eyegaze_tpu/ops/pallas_kernels.py::pairwise_phase_metrics``.
    """
    sums = phase_metric_sums(phase1, phase2, power1, power2)
    return assemble_phase_metrics(*sums, power1, power2, eps)


def pairwise_phase_plv_metrics(phase1, phase2, power1, power2, eps: float = 1e-8):
    """(plv, pli, wpli, pdiff), each (N, C, C), from K2's sums alone.

    The assembly of ``eyegaze_tpu/ops/pallas_kernels.py::pairwise_phase_plv_metrics``:
    PLV = sqrt(plv_re^2 + plv_im^2).
    """
    mean_sgn, wnum, pdiff, re, im = phase_plv_metric_sums(phase1, phase2, power1, power2)
    return (torch.sqrt(re ** 2 + im ** 2),
            *assemble_phase_metrics(mean_sgn, wnum, pdiff, power1, power2, eps))
