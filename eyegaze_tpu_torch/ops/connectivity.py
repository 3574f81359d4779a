"""Inter-brain connectivity features on tensors.

Port of ``eyegaze_tpu/ops/connectivity.py``: ``connectivity_matrices`` and
``connectivity_scalars`` with their helpers.

``connectivity_matrices`` gives seven features per band and channel pair:
PLV as four matrix products, PLI / wPLI / Phase_Diff from the phase-metrics
kernel (K1), coherence as one masked contraction over all bands, and Pearson
correlations of band power and band signal.  Reference quirks kept as the
JAX package keeps them: raw (unwrapped) phase differences, Phase_Diff as
mean |dphi|, unbiased std in the correlations, and wPLI weights
(p1_i + p2_j) / 2 normalized per pair.  The JAX path calls its kernel once
per band; here the six bands are stacked and K1 runs once, on N = 6 * B.

``connectivity_scalars`` gives the same seven features as global scalars per
band, for the legacy IBS token, with its own reference quirks: phase
differences of aligned channels only, Phase_Diff as |mean dphi|, coherence
from spectra averaged over channels before the ratio, the power correlation
over the flattened (C * T) band power, and the time correlation of
channel-averaged signals.  It is elementwise work and reductions, with no
kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from eyegaze_tpu_torch.kernels.phase_metrics import pairwise_phase_metrics
from eyegaze_tpu_torch.ops.spectral import (
    BAND_DEFS_4,
    BAND_DEFS_6,
    analytic_band_parts,
    band_masks,
    band_masks_np,
    power_spectrum,
)

FEATURE_NAMES = ("PLV", "PLI", "wPLI", "Coherence", "Power_Corr", "Phase_Diff", "Time_Corr")

# Ablation feature subsets.
_FEATURE_INDICES = {
    "all": (0, 1, 2, 3, 4, 5, 6),
    "phase": (0, 1, 2, 5),  # PLV, PLI, wPLI, Phase_Diff
    "amplitude": (3, 4, 6),  # Coherence, Power_Corr, Time_Corr
}


def feature_indices_for(feature_type: str) -> tuple:
    if feature_type not in _FEATURE_INDICES:
        raise ValueError(
            f"feature_type must be one of {list(_FEATURE_INDICES)}, got {feature_type!r}")
    return _FEATURE_INDICES[feature_type]


def _zscore_rows(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Zero mean, unit unbiased std over the last axis, eps added to the std."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return (x - mean) / (torch.sqrt(var) + eps)


def _corr_matrix(x1: torch.Tensor, x2: torch.Tensor, eps: float) -> torch.Tensor:
    """Pearson correlation of every row of x1 with every row of x2:
    (B, C, T) x2 -> (B, C, C)."""
    z1 = _zscore_rows(x1, eps)
    z2 = _zscore_rows(x2, eps)
    return torch.matmul(z1, z2.transpose(-1, -2)) / x1.shape[-1]


def _phase_parts(band: torch.Tensor, quad: torch.Tensor):
    """(phase, cos phase, sin phase) from analytic parts; r == 0 maps to
    (cos, sin) = (1, 0) and phase atan2(0, 0) = 0."""
    r = torch.sqrt(band ** 2 + quad ** 2)
    safe = r > 0
    r_safe = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, band / r_safe, torch.ones_like(r))
    s = torch.where(safe, quad / r_safe, torch.zeros_like(r))
    return torch.atan2(quad, band), c, s


def _plv_matrix(c1, s1, c2, s2) -> torch.Tensor:
    """|mean_t exp(i(phi1_i - phi2_j))| as four real matrix products."""
    t = c1.shape[-1]
    c2t, s2t = c2.transpose(-1, -2), s2.transpose(-1, -2)
    re = torch.matmul(c1, c2t) + torch.matmul(s1, s2t)
    im = torch.matmul(s1, c2t) - torch.matmul(c1, s2t)
    return torch.sqrt(re ** 2 + im ** 2) / t


def _coherence_matrix(pxx: torch.Tensor, pyy: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-pair magnitude-squared coherence of one band, averaged over bins.

    With single-window FFTs |X_i conj(Y_j)|^2 == P_i P_j, so
    coh_ij = mean_f [P_i P_j / (P_i P_j + eps)]; (B, C, F) x2 -> (B, C, C).
    The single-band form, which ``_coherence_all_bands`` replaces on the path.
    """
    prod = pxx[:, :, None, :] * pyy[:, None, :, :]  # (B, C, C, F)
    return (prod / (prod + eps)).mean(dim=-1)


def _coherence_all_bands(pxx: torch.Tensor, pyy: torch.Tensor, masks_np: np.ndarray,
                         eps: float) -> torch.Tensor:
    """All bands' coherence matrices in one pass: (B, nb, C, C).

    coh[b, n, i, j] = (1/F) sum_f mask[n, f] h(P1[b, i, f] P2[b, j, f]) with
    h(x) = x / (x + eps), over the union of the bands' bins only; the masks
    are divided by the full bin count F.
    """
    f_total = masks_np.shape[1]
    nz = np.nonzero(masks_np.any(axis=0))[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1  # union of band bins (contiguous)
    m = torch.as_tensor(masks_np[:, lo:hi] / f_total, dtype=torch.float32, device=pxx.device)
    p1 = pxx[..., lo:hi]
    p2 = pyy[..., lo:hi]
    prod = p1[:, :, None, :] * p2[:, None, :, :]  # (B, C, C, F_u)
    h = prod / (prod + eps)
    return torch.matmul(h, m.T).permute(0, 3, 1, 2)  # (B, nb, C, C)


def connectivity_matrices(
    eeg1: torch.Tensor,
    eeg2: torch.Tensor,
    sampling_rate: float = 256.0,
    bands: Sequence = BAND_DEFS_6,
    feature_type: str = "all",
    eps: float = 1e-8,
) -> torch.Tensor:
    """(B, C, T) pairs -> (B, num_bands, num_features, C, C) float32.

    Features in FEATURE_NAMES order, filtered by ``feature_type`` ('all' ->
    7, 'phase' -> 4, 'amplitude' -> 3).
    """
    b, c, t = eeg1.shape
    nb = len(bands)
    eeg1 = eeg1.to(torch.float32)
    eeg2 = eeg2.to(torch.float32)
    re1, im1 = power_spectrum(eeg1)  # (B, C, F)
    re2, im2 = power_spectrum(eeg2)
    coh = _coherence_all_bands(re1 ** 2 + im1 ** 2, re2 ** 2 + im2 ** 2,
                               band_masks_np(t, sampling_rate, bands), eps)  # (B, nb, C, C)
    band1, quad1 = analytic_band_parts(eeg1, sampling_rate, bands)  # (nb, B, C, T)
    band2, quad2 = analytic_band_parts(eeg2, sampling_rate, bands)
    # All bands at once: (nb * B, C, T).
    b1, q1 = band1.reshape(nb * b, c, t), quad1.reshape(nb * b, c, t)
    b2, q2 = band2.reshape(nb * b, c, t), quad2.reshape(nb * b, c, t)
    p1, p2 = b1 ** 2, b2 ** 2
    ph1, c1, s1 = _phase_parts(b1, q1)
    ph2, c2, s2 = _phase_parts(b2, q2)
    pli, wpli, pdiff = pairwise_phase_metrics(ph1, ph2, p1, p2, eps)  # one K1 launch

    def per_band(m):  # (nb * B, C, C) -> (B, nb, C, C)
        return m.reshape(nb, b, c, c).transpose(0, 1)

    out = torch.stack([
        per_band(_plv_matrix(c1, s1, c2, s2)), per_band(pli), per_band(wpli), coh,
        per_band(_corr_matrix(p1, p2, eps)), per_band(pdiff),
        per_band(_corr_matrix(b1, b2, eps)),
    ], dim=2)  # (B, nb, 7, C, C)
    idx = feature_indices_for(feature_type)
    if len(idx) != len(FEATURE_NAMES):
        out = out[:, :, list(idx)]
    return out


def connectivity_scalars(
    eeg1: torch.Tensor,
    eeg2: torch.Tensor,
    sampling_rate: float = 256.0,
    bands: Sequence = BAND_DEFS_4,
    eps: float = 1e-8,
) -> torch.Tensor:
    """(B, C, T) pairs -> (B, num_bands * 7) globally averaged IBS features.

    Per band, in FEATURE_NAMES order: PLV, PLI, wPLI, Coherence, Power_Corr,
    Phase_Diff, Time_Corr; bands in the order given (default theta, alpha,
    beta, gamma).  All bands are computed at once on (nb, B, C, T).
    """
    b, _, t = eeg1.shape
    nb = len(bands)
    eeg1 = eeg1.to(torch.float32)
    eeg2 = eeg2.to(torch.float32)
    mask = band_masks(t, sampling_rate, bands, eeg1.device)[:, None, None, :]  # (nb, 1, 1, F)
    re1, im1 = power_spectrum(eeg1)  # (B, C, F)
    re2, im2 = power_spectrum(eeg2)
    b1, q1 = analytic_band_parts(eeg1, sampling_rate, bands)  # (nb, B, C, T)
    b2, q2 = analytic_band_parts(eeg2, sampling_rate, bands)
    p1, p2 = b1 ** 2, b2 ** 2
    ph1, c1, s1 = _phase_parts(b1, q1)
    ph2, c2, s2 = _phase_parts(b2, q2)
    ct = (2, 3)  # the (C, T) axes
    dphi = ph1 - ph2  # aligned channels only
    # exp(i dphi) = (c1 c2 + s1 s2) + i (s1 c2 - c1 s2)
    plv = torch.sqrt((c1 * c2 + s1 * s2).mean(dim=ct) ** 2
                     + (s1 * c2 - c1 * s2).mean(dim=ct) ** 2)
    sgn = torch.sign(dphi)
    pli = sgn.mean(dim=ct).abs()
    w = (p1 + p2) * 0.5
    wpli = (sgn * (w / (w.sum(dim=ct, keepdim=True) + eps))).sum(dim=ct).abs()
    # Coherence from masked spectra averaged over channels before the ratio.
    mre1, mim1, mre2, mim2 = re1 * mask, im1 * mask, re2 * mask, im2 * mask  # (nb, B, C, F)
    pxy_re = (mre1 * mre2 + mim1 * mim2).mean(dim=2)  # (nb, B, F)
    pxy_im = (mim1 * mre2 - mre1 * mim2).mean(dim=2)
    pxx = (mre1 ** 2 + mim1 ** 2).mean(dim=2)
    pyy = (mre2 ** 2 + mim2 ** 2).mean(dim=2)
    coh = ((pxy_re ** 2 + pxy_im ** 2) / (pxx * pyy + eps)).mean(dim=-1)
    # Power correlation over the flattened (C * T) band power, unbiased std.
    pcorr = (_zscore_rows(p1.reshape(nb, b, -1), eps)
             * _zscore_rows(p2.reshape(nb, b, -1), eps)).mean(dim=-1)
    pdiff = dphi.mean(dim=ct).abs()  # |mean dphi|, not mean |dphi|
    # Time correlation of channel-averaged band signals.
    tcorr = (_zscore_rows(b1.mean(dim=2), eps) * _zscore_rows(b2.mean(dim=2), eps)).mean(dim=-1)
    out = torch.stack([plv, pli, wpli, coh, pcorr, pdiff, tcorr], dim=-1)  # (nb, B, 7)
    return out.transpose(0, 1).reshape(b, nb * len(FEATURE_NAMES))
