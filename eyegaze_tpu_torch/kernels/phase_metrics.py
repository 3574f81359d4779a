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
of a 128-window serving bucket), and issues 7 FP32 instructions per pair and
sample on the CUDA cores (K2 11, from cos and sin taken once per staged
sample), with no tensor-core work.  At N = 768 the instructions bound K1,
the bytes close behind.  Where the grid would leave SMs idle (small N), a
launch splits T over the blocks of a thread-block cluster; ``split`` says
over how many.  Their measured times sit in PERF.md beside the plain
versions'.

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


# C entry point and (N, C, C) outputs of each wrapper.
ENTRIES = {"phase_metric_sums": ("phase_metrics_launch", 3),
           "phase_plv_metric_sums": ("phase_plv_metrics_launch", 5)}
TILE = 32  # channel pairs per block side


def bind(lib: ctypes.CDLL, entry: str, outputs: int):
    """The C entry point ``entry`` of a built phase-metrics library, with
    ``outputs`` (N, C, C) outputs."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * (4 + outputs) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _library() -> ctypes.CDLL:
    return build.load("phase_metrics")


@functools.cache
def _launcher(entry: str, outputs: int):
    return bind(_library(), entry, outputs)


def split(n: int, c: int, t: int) -> int:
    """Blocks of one cluster (1, 2, 4 or 8) over which K1 and K2 split the T
    axis at (N, C, T) on the current CUDA device: the launch's own choice,
    read from the library."""
    if min(n, c, t) < 1 or max(n, c, t) >= 2**31:
        raise ValueError(f"no launch at shape {(n, c, t)}")
    s = _library().phase_metrics_split(n, c, t)
    if s < 1:
        raise RuntimeError("phase_metrics_split could not read the device")
    return s


def grid_blocks(n: int, c: int, split: int) -> int:
    """Blocks of a launch at N, C whose T axis is split ``split`` ways: one
    per n, 32 x 32 tile of pairs and share of T."""
    if min(n, c, split) < 1:
        raise ValueError(f"no launch with n={n}, c={c}, split={split}")
    return n * split * ((c + TILE - 1) // TILE) ** 2


def launch_args(tensors, outs) -> tuple:
    """A C entry point's arguments for a launch on the current stream of the
    tensors' device: four (N, C, T) inputs, then the (N, C, C) outputs."""
    n, c, t = tensors[0].shape
    return (*(x.data_ptr() for x in tensors), *(o.data_ptr() for o in outs), n, c, t,
            torch.cuda.current_stream(tensors[0].device).cuda_stream)


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


def _sums(wrapper: str, reference, tensors):
    """Checks the inputs, then runs ``reference`` on a CPU tensor or launches
    the wrapper's C entry point (``ENTRIES``) on a CUDA tensor.  Any other
    device raises."""
    _check(tensors)
    entry, outputs = ENTRIES[wrapper]
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
        err = launch(*launch_args(tensors, outs))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    launch_count[wrapper] += 1
    return tuple(outs)


def phase_metric_sums(phase1, phase2, power1, power2):
    """K1: (N, C, T) float32 x4 -> (mean_sign, wnum, pdiff), each (N, C, C).

    On a CUDA tensor this launches the kernel on the current stream; on a CPU
    tensor it runs the plain version.  Any other device raises.
    """
    return _sums("phase_metric_sums", pairwise_phase_metrics_reference,
                 (phase1, phase2, power1, power2))


def phase_plv_metric_sums(phase1, phase2, power1, power2):
    """K2: (N, C, T) float32 x4 -> (mean_sign, wnum, pdiff, plv_re, plv_im),
    each (N, C, C).

    On a CUDA tensor this launches the kernel on the current stream; on a CPU
    tensor it runs the plain version.  Any other device raises.
    """
    return _sums("phase_plv_metric_sums", pairwise_phase_plv_metrics_reference,
                 (phase1, phase2, power1, power2))


# Mean cos and sin: the kernel forms cos(a - b) as cos a cos b + sin a sin b
# from sincosf of each sample, the plain version takes cos of the rounded
# difference; the terms agree to a few ulps of 1, and summing T of them in
# another order moves a mean by a few 2^-24 more (tests/test_pallas.py's
# bound, far above both).
PLV_TOL = dict(rtol=1e-4, atol=1e-5)


def assert_sums_close(got, want, power1, power2) -> list:
    """Holds a kernel's sums (K1's three or K2's five) to the plain
    version's; returns the largest |got - want| of each.

    Mean sign: sums of +-1 are exact in float32.  pdiff: the two sum in
    another order.  wnum is a signed sum whose rounding error scales with the
    sum of its terms' magnitudes (the wPLI denominator), not with |wnum|.
    """
    den = (power1.sum(-1)[:, :, None] + power2.sum(-1)[:, None, :]) * 0.5
    tols = (dict(rtol=0, atol=1e-6), dict(rtol=1e-4, atol=1e-6 * float(den.max())),
            dict(rtol=1e-5, atol=1e-6), PLV_TOL, PLV_TOL)
    for g, w, tol in zip(got, want, tols):
        torch.testing.assert_close(g, w, **tol)
    return [float((g - w).abs().max()) for g, w in zip(got, want)]


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
