"""EEG preprocessing on tensors: bandpass -> CAR -> z-score -> windowing.

Port of ``eyegaze_tpu/ops/preprocess.py``.  The zero-phase Butterworth
bandpass reproduces ``scipy.signal.filtfilt`` (odd padding, padlen
3 * (2 * order + 1), ``sosfilt_zi`` initial conditions scaled by the first
sample) with the blocked recurrence: the SOS cascade is solved exactly per
block of 128 samples as one matrix product against host-made constants, and
the block-boundary states come from closed-form f64 powers.  The f64 host
constants are cast to float32 once per device and kept there.
``bandpass_filtfilt_bands`` runs several bands' filters in one recurrence,
their constants stacked on a leading filter axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 128  # samples per block of the blocked recurrence


@functools.lru_cache(maxsize=32)
def _butter_sos(order: int, low: float, high: float, fs: float):
    """Butterworth bandpass as second-order sections + sosfilt_zi (host, f64).

    The SOS cascade is needed for float32 stability: the direct-form (b, a)
    of an order-4 bandpass with a normalized low cutoff near 0.004 is
    ill-conditioned in f32.
    """
    from scipy import signal as sps

    nyq = fs / 2.0
    lo = low / nyq
    hi = min(high / nyq, 0.99)
    sos = sps.butter(order, [lo, hi], btype="band", output="sos")
    zi = sps.sosfilt_zi(sos)  # (n_sections, 2)
    return np.asarray(sos, np.float64), np.asarray(zi, np.float64)


@functools.lru_cache(maxsize=64)
def _carry_kernel(sos_key: tuple, block: int, nb: int):
    """Closed-form block-carry constants (f64 host math, cast to f32 once).

    Block-boundary states obey starts[n] = AB starts[n-1] + ends[n-1] with
    AB = A^block, so starts[n] = AB^n s0 + sum_{k<n} AB^(n-1-k) ends[k]:

      Pn[n]    = AB^n                (nb, 2, 2)
      Kc[k, n] = AB^(n-1-k), k < n   (nb, nb, 2, 2), else 0
    """
    sos = np.asarray(sos_key, np.float64).reshape(-1, 6)
    out = []
    for _, _, _, _, a1, a2 in sos:
        a_mat = np.array([[-a1, 1.0], [-a2, 0.0]])
        ab = np.linalg.matrix_power(a_mat, block)
        p = [np.eye(2)]
        for _ in range(nb):
            p.append(ab @ p[-1])
        pn = np.stack(p[:nb]).astype(np.float32)
        kc = np.zeros((nb, nb, 2, 2))
        for k in range(nb - 1):
            kc[k, k + 1:] = np.stack(p[: nb - 1 - k])
        out.append((pn, kc.astype(np.float32)))
    return out


@functools.lru_cache(maxsize=32)
def _blocked_consts(sos_key: tuple, block: int):
    """Per-section f64 constants: b0, Apow[j] = A^(j+1) (block, 2, 2) and the
    causal within-block kernel Ktri[k, j] = A^(j-k) c for j >= k (block, block, 2)."""
    sos = np.asarray(sos_key, np.float64).reshape(-1, 6)
    out = []
    for b0, b1, b2, _, a1, a2 in sos:
        a_mat = np.array([[-a1, 1.0], [-a2, 0.0]])
        c_vec = np.array([b1 - a1 * b0, b2 - a2 * b0])
        powers = [np.eye(2)]
        for _ in range(block):
            powers.append(a_mat @ powers[-1])
        apow = np.stack(powers[1:], axis=0)
        ktri = np.zeros((block, block, 2))
        for k in range(block):
            ktri[k, k:] = np.stack([powers[j - k] @ c_vec for j in range(k, block)])
        out.append((float(b0), apow.astype(np.float32), ktri.astype(np.float32)))
    return out


@functools.lru_cache(maxsize=64)
def _device_consts(filters: tuple, block: int, nb: int, device: torch.device):
    """The constants of F filters of as many sections each, float32 on
    ``device`` and made once, stacked on a leading filter axis: zi (F, S, 2)
    and per section (b0 (F, 1, 1), A^(j+1)[0, 0] and [0, 1] (F, block),
    Ktri (F, block, 2 block), Pn (F, nb, 2, 2), Kc (F, nb, nb, 2, 2))."""
    def put(arrays):
        return torch.as_tensor(np.stack(arrays), dtype=torch.float32, device=device)

    zi = put([np.asarray(zi_key).reshape(-1, 2) for _, zi_key in filters])
    per_filter = [list(zip(_blocked_consts(sos_key, block), _carry_kernel(sos_key, block, nb)))
                  for sos_key, _ in filters]
    sections = []
    for parts in zip(*per_filter):  # one section of every filter
        b0, apow, ktri = zip(*(blocked for blocked, _ in parts))
        pn, kc = zip(*(carry for _, carry in parts))
        apow = put(apow)
        sections.append((put(b0).reshape(-1, 1, 1), apow[:, :, 0, 0], apow[:, :, 0, 1],
                         put(ktri).reshape(len(filters), block, block * 2), put(pn), put(kc)))
    return zi, sections


def _sosfilt_blocked(u: torch.Tensor, filters: tuple) -> torch.Tensor:
    """F SOS cascades along the last axis of (F, L, T) float32, filter f on
    u[f]: scipy sosfilt with zi scaled by the first sample; y_t = b0 u_t +
    s_{t-1}[0]."""
    block = BLOCK
    n_filters, lanes, t = u.shape
    nb = -(-t // block)
    zi, sections = _device_consts(filters, block, nb, u.device)
    x0 = u[..., :1]
    for sidx, (b0, a00, a01, ktri, pn, kc) in enumerate(sections):
        ub = F.pad(u, (0, nb * block - t)).reshape(n_filters, lanes * nb, block)  # end pad unused
        s_local = torch.bmm(ub, ktri).reshape(n_filters, lanes, nb, block, 2)  # zero-state
        s0 = zi[:, sidx, None, :] * x0  # (F, L, 2) initial state s_{-1}
        ends = s_local[:, :, :, block - 1, :]  # (F, L, nb, 2)
        starts = (torch.einsum("fnts,fls->flnt", pn, s0)
                  + torch.einsum("flks,fknts->flnt", ends, kc))  # (F, L, nb, 2)
        # State component 0 at every sample: (A^(j+1) s_start)[0] + s_local[j][0].
        s0c = (a00[:, None, None, :] * starts[..., None, 0]
               + a01[:, None, None, :] * starts[..., None, 1]) + s_local[..., 0]
        s_flat = s0c.reshape(n_filters, lanes, nb * block)[..., :t]
        s_prev0 = torch.cat([s0[..., :1], s_flat[..., :-1]], dim=-1)
        u = b0 * u + s_prev0
    return u


def bandpass_filtfilt_bands(
    x: torch.Tensor,
    bands,
    sampling_rate: float = 250.0,
    order: int = 4,
) -> torch.Tensor:
    """Zero-phase Butterworth bandpasses of (..., T) float32, filtfilt
    parity, one per (name, low, high) of ``bands``, all in one blocked
    recurrence: (len(bands), ..., T).

    The block products must run in full float32: with TF32's short mantissa
    the block carries of a low-edge band diverge (the JAX package saw 1e26),
    so a CUDA tensor raises while TF32 matmuls are enabled.
    """
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("bandpass_filtfilt_blocked needs full-f32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    filters = []
    for _, low, high in bands:
        sos, zi = _butter_sos(order, float(low), float(high), float(sampling_rate))
        filters.append((tuple(sos.ravel()), tuple(zi.ravel())))
    filters = tuple(filters)
    padlen = 3 * (2 * order + 1)
    t = x.shape[-1]
    if t <= padlen:
        raise ValueError(f"signal length {t} must exceed padlen {padlen}")
    x = x.to(torch.float32)
    # Odd extension at both ends (scipy padtype='odd').
    left = 2.0 * x[..., :1] - torch.flip(x[..., 1:padlen + 1], dims=(-1,))
    right = 2.0 * x[..., -1:] - torch.flip(x[..., -padlen - 1:-1], dims=(-1,))
    ext = torch.cat([left, x, right], dim=-1)
    flat = ext.reshape(1, -1, ext.shape[-1]).expand(len(filters), -1, -1)
    y = _sosfilt_blocked(flat, filters)
    y = _sosfilt_blocked(torch.flip(y, dims=(-1,)), filters)
    y = torch.flip(y, dims=(-1,)).reshape((len(filters),) + ext.shape)
    return y[..., padlen:padlen + t]


def bandpass_filtfilt_blocked(
    x: torch.Tensor,
    low: float = 0.5,
    high: float = 50.0,
    sampling_rate: float = 250.0,
    order: int = 4,
) -> torch.Tensor:
    """Zero-phase Butterworth bandpass of (..., T) float32, filtfilt parity
    (``bandpass_filtfilt_bands`` of one band)."""
    return bandpass_filtfilt_bands(x, (("band", low, high),), sampling_rate, order)[0]


def common_average_reference(x: torch.Tensor, channel_axis: int = -2) -> torch.Tensor:
    """Subtract the across-channel mean at each timepoint (CAR)."""
    return x - x.mean(dim=channel_axis, keepdim=True)


def zscore(x: torch.Tensor, axis: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """Per-channel z-score: (x - mean) / (biased std + eps)."""
    mean = x.mean(dim=axis, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=axis, keepdim=True))
    return (x - mean) / (std + eps)


def sliding_windows(x: torch.Tensor, window_size: int = 1024, stride: int = 512) -> torch.Tensor:
    """(..., C, T) -> (..., num_windows, C, window_size), a strided view;
    num_windows = (T - window_size) // stride + 1."""
    t = x.shape[-1]
    if t < window_size:
        raise ValueError(f"T={t} < window_size={window_size}")
    return x.unfold(-1, window_size, stride).movedim(-2, -3)


def preprocess_eeg(
    x: torch.Tensor,
    sampling_rate: float = 250.0,
    low: float = 0.5,
    high: float = 50.0,
    order: int = 4,
) -> torch.Tensor:
    """Zero-phase Butterworth bandpass -> CAR -> z-score on (..., C, T)."""
    x = bandpass_filtfilt_blocked(x, low, high, sampling_rate, order)
    x = common_average_reference(x)
    return zscore(x, axis=-1)
