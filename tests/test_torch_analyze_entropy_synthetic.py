"""``python -m eyegaze_tpu_torch.analyze_entropy`` against the JAX script on
the default synthetic path (``--trials 12``: gaze heatmaps of 112 x 112,
EEG of (32, 1024)), held as tests/test_torch_analyze_entropy_paths.py holds
the file path; and the float32 gap behind its ``ENTROPY_TOL``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyegaze_tpu.ops import entropy as jax_entropy
from eyegaze_tpu_torch.ops import entropy
from tests.test_torch_analyze_entropy_paths import ENTROPY_TOL, run_both


def test_synthetic_path_matches(tmp_path):
    print(f"largest gaps {run_both(tmp_path, ['--trials', '12'])}")


def float64_spectral_entropy(x: np.ndarray, fs: float) -> np.ndarray:
    """``spectral_entropy`` in float64 with scipy (chip_smoke.py's twin)."""
    from scipy import signal

    b, a = signal.butter(4, [0.5, 50.0], btype="band", fs=fs)
    _, psd = signal.welch(signal.filtfilt(b, a, x.astype(np.float64), axis=-1), fs=fs,
                          nperseg=256, axis=-1)
    p = np.abs(psd) + 1e-10
    p = p / p.sum(-1, keepdims=True)
    return -(p * np.log(p)).sum(-1) / np.log(2)


@pytest.mark.parametrize("t,bound", [(512, 3e-4), (1024, 1.5e-4), (3250, 5e-5)])
def test_spectral_entropy_gap_from_float64(t, bound):
    """Each framework's float32 spectral entropies against float64, on
    normal (4, 32, T) trials at fs 256: within ``bound`` (six seeds gave at
    most 2.6e-4, 1.4e-4 and 2.4e-5), half of ``ENTROPY_TOL`` or less, so
    the two frameworks stand within it; chip_smoke.py holds the card
    against the CPU at twice the bound: 1e-4 at T = 3250, 3e-4 at 1024."""
    x = np.random.default_rng(t).normal(size=(4, 32, t)).astype(np.float32)
    want = float64_spectral_entropy(x, 256.0)
    port = entropy.spectral_entropy(torch.from_numpy(x), 256.0).numpy()
    ref = np.asarray(jax_entropy.spectral_entropy(jnp.asarray(x), 256.0))
    gaps = float(np.abs(port - want).max()), float(np.abs(ref - want).max())
    print(f"T = {t}: port {gaps[0]:.3e}, JAX {gaps[1]:.3e} from float64")
    assert max(gaps) <= bound <= ENTROPY_TOL / 2
