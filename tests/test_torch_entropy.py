"""The port's entropy ops against the JAX package's on the CPU.

Same numpy inputs through ``eyegaze_tpu.ops.entropy`` and the port.  Both
compute in float32: spatial entropy within 1e-5 relative (a float32 sum over
every pixel), spectral entropy within 1e-4 bits absolute (the filtfilt
bandpass agrees to 1e-3 of the signal, ``tests/test_torch_ops.py``, and the
entropy of a normalised PSD moves far less).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eyegaze_tpu.ops import entropy as jent
from eyegaze_tpu_torch.ops import entropy

SPATIAL_RTOL = 1e-5
SPECTRAL_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def heatmaps(shape, seed: int = 0, dtype=np.float32) -> np.ndarray:
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return r.integers(0, 256, size=shape, dtype=np.uint8)
    return (r.random(shape) ** 3).astype(dtype)


@pytest.mark.parametrize("shape", [(40, 50), (40, 50, 3), (3, 40, 50), (2, 40, 50, 3),
                                   (2, 3, 40, 50), (2, 5, 40, 50), (3, 40, 3)],
                         ids=["hw", "hw3", "3hw", "batch-hw3", "batch-3hw", "batch-hw",
                              "channels-last-first"])
@pytest.mark.parametrize("normalize_input", [True, False], ids=["minmax", "raw"])
def test_spatial_entropy_matches_jax(shape, normalize_input):
    """Every layout; (3, 40, 3) is read channels-last, as the JAX package reads it."""
    x = heatmaps(shape)
    got = entropy.spatial_entropy(torch.from_numpy(x), normalize_input=normalize_input)
    want = np.asarray(jent.spatial_entropy(jnp.asarray(x), normalize_input=normalize_input))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SPATIAL_RTOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.float64], ids=["uint8", "float64"])
def test_spatial_entropy_of_other_dtypes_matches_jax(dtype):
    x = heatmaps((2, 40, 50, 3), seed=1, dtype=dtype)
    got = entropy.spatial_entropy(torch.from_numpy(x))
    want = np.asarray(jent.spatial_entropy(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SPATIAL_RTOL)


def test_uniform_image_has_maximal_entropy():
    """Without min-max normalisation a constant image is the uniform
    distribution over its pixels: log2(H W) bits."""
    got = entropy.spatial_entropy(torch.ones(16, 32), normalize_input=False)
    np.testing.assert_allclose(float(got), np.log2(16 * 32), rtol=1e-6)


@pytest.mark.parametrize("apply_filter", [True, False], ids=["filtered", "unfiltered"])
@pytest.mark.parametrize("shape", [(4, 700), (2, 4, 700)], ids=["trial", "batch"])
def test_spectral_entropy_matches_jax(apply_filter, shape):
    x = (np.random.default_rng(2).normal(size=shape) * 10.0).astype(np.float32)
    got = entropy.spectral_entropy(torch.from_numpy(x), 250.0, apply_filter=apply_filter)
    want = np.asarray(jent.spectral_entropy(jnp.asarray(x), 250.0, apply_filter=apply_filter))
    assert got.shape == shape[:-1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SPECTRAL_ATOL)


def test_spectral_entropy_options_match_jax():
    """Another band, filter order and segment length."""
    x = np.random.default_rng(3).normal(size=(3, 900)).astype(np.float32)
    kw = dict(sampling_rate=256.0, filter_low=4.0, filter_high=30.0, filter_order=2, nperseg=128)
    got = entropy.spectral_entropy(torch.from_numpy(x), **kw)
    want = np.asarray(jent.spectral_entropy(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SPECTRAL_ATOL)


def test_shannon_entropy_from_probs_matches_jax():
    p = np.random.default_rng(4).random((3, 10)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    for base in (2.0, np.e):
        np.testing.assert_allclose(
            entropy.shannon_entropy_from_probs(torch.from_numpy(p), base=base).numpy(),
            np.asarray(jent.shannon_entropy_from_probs(jnp.asarray(p), base=base)), rtol=1e-6)
