"""The PyTorch port's ART denoiser and its serving against the JAX package.

At a small geometry (8 channels, embed 32, 2 + 2 layers, 4 heads, ff 64,
T = 256): JAX parameters from ``model.init`` are converted with
``art_state_dict_from_flax``, loaded with ``strict=True``, and both forwards
must agree at 1e-4, the tolerance of tests/test_torch_port.py's ART parity
(f32 on both sides; sums in another order through 4 post-LN blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.torch_port import export_art_state_dict
from eyegaze_tpu.serving import ArtDenoiser as JaxArtDenoiser
from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.convert import art_state_dict_from_flax
from eyegaze_tpu_torch.serving import ArtDenoiser

C, T = 8, 256
GEOMETRY = dict(in_channels=C, out_channels=C, embedding_size=32, num_encoder_layers=2,
                num_decoder_layers=2, num_heads=4, feedforward_size=64, max_len=T)
TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """JAX parameters per position mode; the head's options add none."""
    z = jnp.zeros((1, C, T), jnp.float32)
    return {mode: jax.tree_util.tree_map(
        np.asarray, jax.jit(JaxArt(JaxArtConfig(**GEOMETRY, pos_mode=mode)).init)(
            jax.random.PRNGKey(0), z)["params"])
        for mode in ("sinusoidal", "learned")}


def _pair(params, **options):
    """(JAX model, its params, port model loaded with the same weights)."""
    options.setdefault("pos_mode", "sinusoidal")
    p = params[options["pos_mode"]]
    tm = ArtifactRemovalTransformer(ArtConfig(**GEOMETRY, **options), device=CPU,
                                    generator=torch.Generator().manual_seed(1))
    tm.load_state_dict({k: torch.tensor(v) for k, v in art_state_dict_from_flax(p).items()},
                       strict=True)
    return JaxArt(JaxArtConfig(**GEOMETRY, **options)), p, tm.eval()


def _noisy(n, seed):
    return np.random.default_rng(seed).normal(size=(n, C, T)).astype(np.float32)


@pytest.mark.parametrize("mode", ["sinusoidal", "learned"])
def test_state_dict_matches_reference_exporter_and_loads_strictly(params, mode):
    got = art_state_dict_from_flax(params[mode])
    want = export_art_state_dict(params[mode])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["src_embed.0.conv.weight"].shape == (32, C, 1)
    _, _, tm = _pair(params, pos_mode=mode)  # strict load inside
    assert ("src_embed.1.pos_embed.weight" in tm.state_dict()) == (mode == "learned")
    assert not any(k.endswith(".pe") for k in tm.state_dict())


OPTIONS = {
    "sinusoidal": dict(),
    "learned": dict(pos_mode="learned"),
    "zscore_batch": dict(recon_zscore="batch"),
    "zscore_time": dict(recon_zscore="time"),
    "log_softmax": dict(recon_log_softmax=True),
    "log_softmax_zscore_time_learned": dict(recon_log_softmax=True, recon_zscore="time",
                                            pos_mode="learned"),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_forward_matches_jax(params, case):
    jm, p, tm = _pair(params, **OPTIONS[case])
    src = _noisy(3, seed=2)
    tgt = _noisy(3, seed=3)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, src, tgt))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert got.shape == (3, C, T) and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2  # non-degenerate fixture
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_masked_forward_matches_jax(params):
    """src_mask (B, T) and a (B, T, T) tgt_mask, True = masked out, with the
    JAX package's inversion; without tgt the decoder reads src."""
    jm, p, tm = _pair(params)
    src = _noisy(2, seed=4)
    r = np.random.default_rng(5)
    src_mask = r.random((2, T)) < 0.25
    tgt_mask = np.triu(np.ones((T, T), bool), k=1)[None].repeat(2, axis=0)  # causal
    want = np.asarray(jax.jit(jm.apply)({"params": p}, src, None, src_mask, tgt_mask))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), None, torch.from_numpy(src_mask),
                 torch.from_numpy(tgt_mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.inference_mode():
        unmasked = tm(torch.from_numpy(src)).numpy()
    assert np.abs(unmasked - got).max() > 1e-2  # the masks took effect


@pytest.mark.parametrize("zscore", [None, "batch"])
def test_denoiser_matches_jax(params, zscore):
    """Buckets (2, 4): 3 windows pad to 4, 9 run as chunks of 4, 4 and 1 -> 2.
    With the batch z-score both sides serve one sample at a time."""
    jm, p, tm = _pair(params, recon_zscore=zscore)
    jden = JaxArtDenoiser(jm, p, batch_buckets=(2, 4))
    den = ArtDenoiser(tm, device=CPU, batch_buckets=(2, 4))
    assert den.buckets == jden.buckets == ((1,) if zscore == "batch" else (2, 4))
    den.warmup()
    noisy = _noisy(9, seed=6)
    before = dict(attention.launch_count)
    for n in (3, 9):
        want = jden.predict(noisy[:n])["denoised"]
        got = den.predict(noisy[:n])["denoised"]
        assert got.shape == (n, C, T) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert attention.launch_count == before  # the CPU path never launches the kernel
    if zscore == "batch":  # per sample: a row's output ignores the other rows
        np.testing.assert_allclose(den.predict(noisy[1:2])["denoised"][0], got[1],
                                   rtol=1e-6, atol=1e-6)

