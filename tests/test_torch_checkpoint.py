"""``from_checkpoint`` across frameworks: one orbax checkpoint served by the
JAX package and, exported with ``scripts/export_torch_checkpoint.py`` and
its ``.meta.json`` copied beside the export, by the port.

Both sides serve bf16 compute.  Logits (the flagship) and denoised windows
(ART) agree within ``2**-5`` of their largest value, the end-to-end bf16
bound of tests/test_torch_dual_eeg_bf16.py and tests/test_torch_art.py, and
the flagship's ``preds`` and ``labels`` agree wherever JAX's top-two margin
exceeds that bound.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu.serving import ArtDenoiser as JaxArtDenoiser
from eyegaze_tpu.serving import Predictor as JaxPredictor
from eyegaze_tpu.train.checkpoint import CheckpointManager
from eyegaze_tpu.train.optim import make_optimizer
from eyegaze_tpu.train.state import create_train_state
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.serving import ArtDenoiser, Predictor

ROOT = Path(__file__).resolve().parent.parent
C, T = 8, 256
SHARE = 2.0 ** -5
CPU = torch.device("cpu")
EEG_MODEL = {"in_channels": C, "num_labels": 3, "d_model": 32, "num_layers": 1, "num_heads": 4,
             "d_ff": 64, "conv_kernel_size": 7, "conv_stride": 4, "conv_layers": 2}
EEG_CONFIG = {
    "model": EEG_MODEL,
    "ablation": {"use_spectrogram": True, "use_ibs": True, "ibs_mode": "robust",
                 "use_cross_attention": True, "ibs_instance_norm": True,
                 "ibs_feature_type": "all"},
    "data": {"window_size": T, "sampling_rate": 256.0, "enable_preprocessing": True},
}
ART_MODEL = {"in_channels": C, "out_channels": C, "embedding_size": 32, "num_encoder_layers": 2,
             "num_decoder_layers": 2, "num_heads": 4, "feedforward_size": 64, "max_len": T}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _export(tmp_path: Path, model, sample, config) -> tuple[Path, Path]:
    """Saves ``model``'s init as an orbax checkpoint with the JAX
    ``CheckpointManager``, exports it with the export script's ``main`` and
    copies its meta beside the export.  Returns (orbax dir, state_dict path)."""
    variables = model.init(jax.random.PRNGKey(0), *sample)
    state = create_train_state(model, variables, make_optimizer(1e-3))
    CheckpointManager(tmp_path / "ckpt").save_if_best(0.9, state, config=config)
    ckpt = tmp_path / "ckpt" / "best_model"
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", ROOT / "scripts" / "export_torch_checkpoint.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    out = tmp_path / "model.pt"
    assert export.main([str(ckpt), "--out", str(out)]) == 0
    shutil.copy(ckpt.parent / "best_model.meta.json", out.with_suffix(".meta.json"))
    return ckpt, out


@pytest.fixture(scope="module")
def eeg_checkpoint(tmp_path_factory):
    model = JaxDualEEG(**{k: v for k, v in EEG_MODEL.items() if k != "num_labels"},
                       max_len=128)
    e = jnp.zeros((1, C, T), jnp.float32)
    return _export(tmp_path_factory.mktemp("eeg"), model, (e, e), EEG_CONFIG)


def _eeg_request(seed, n=5):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, C, T)) * 20.0 + 5.0).astype(np.float32) for _ in range(2)]


def test_predictor_from_checkpoint_matches_jax(eeg_checkpoint):
    ckpt, state_path = eeg_checkpoint
    jpred = JaxPredictor.from_checkpoint(ckpt, batch_buckets=(2, 4))
    pred = Predictor.from_checkpoint(state_path, device=CPU, batch_buckets=(2, 4))
    model = pred.model
    assert model.dtype == torch.bfloat16 and pred.preprocess and jpred.preprocess
    assert model.pos_embed.pos_embed.weight.shape[0] == 128  # max_len from the table
    assert model.temporal_conv.convs[0].kernel_size == (7,)  # geometry from the meta
    e1, e2 = _eeg_request(21)  # 5 trials: a chunk of 4 and one padded to 2
    want, got = jpred.predict(e1, e2), pred.predict(e1, e2)
    logits = want["logits"]
    tol = SHARE * np.abs(logits).max()
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=tol)
    top2 = np.sort(logits, axis=-1)
    clear = top2[:, -1] - top2[:, -2] > tol
    assert clear.any()
    np.testing.assert_array_equal(got["preds"][clear], want["preds"][clear])
    assert [g for g, c in zip(got["labels"], clear) if c] == \
        [w for w, c in zip(want["labels"], clear) if c]


def test_explicit_meta_path_and_preprocess(eeg_checkpoint, tmp_path):
    """``meta_path`` names a meta elsewhere; ``preprocess`` passed by the
    caller wins over the meta's."""
    _, state_path = eeg_checkpoint
    moved = tmp_path / "meta.json"
    shutil.copy(state_path.with_suffix(".meta.json"), moved)
    bare = tmp_path / "bare.pt"
    shutil.copy(state_path, bare)  # no meta beside it
    pred = Predictor.from_checkpoint(bare, device=CPU, meta_path=moved, preprocess=False)
    assert not pred.preprocess and pred.model.in_channels == C


def test_forward_after_load_uses_the_loaded_weights(eeg_checkpoint):
    """A served bf16 forward keeps its weight casts; a later
    ``load_state_dict`` must replace them, not serve the stale ones."""
    _, state_path = eeg_checkpoint
    pred = Predictor.from_checkpoint(state_path, device=CPU, batch_buckets=(2, 4))
    e1, e2 = _eeg_request(22, n=2)
    first = pred.predict(e1, e2)["logits"]
    other = DualEEGTransformer(**{k: v for k, v in EEG_MODEL.items() if k != "num_labels"},
                               max_len=128, device=CPU, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(5)).eval()
    pred.model.load_state_dict(other.state_dict(), strict=True)
    got = pred.predict(e1, e2)["logits"]
    want = Predictor(other, device=CPU, batch_buckets=(2, 4)).predict(e1, e2)["logits"]
    assert np.abs(first - want).max() > 1e-2  # the two weights differ in what they serve
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("zscore", [None, "batch"])
def test_art_denoiser_from_checkpoint_matches_jax(tmp_path, zscore):
    """bf16 ART from one checkpoint on both sides; a ``recon_zscore='batch'``
    model is served per sample whatever ``batch_buckets`` says."""
    cfg = {**ART_MODEL, "recon_zscore": zscore}
    model = JaxArt(JaxArtConfig(**cfg))
    ckpt, state_path = _export(tmp_path, model, (jnp.zeros((1, C, T), jnp.float32),),
                               {"model": cfg})
    jden = JaxArtDenoiser.from_checkpoint(ckpt, batch_buckets=(2, 4))
    den = ArtDenoiser.from_checkpoint(state_path, device=CPU, batch_buckets=(2, 4))
    assert den.model.dtype == torch.bfloat16
    assert den.model.config.recon_zscore == zscore
    assert den.buckets == jden.buckets == ((1,) if zscore == "batch" else (2, 4))
    noisy = np.random.default_rng(23).normal(size=(3, C, T)).astype(np.float32)
    want, got = jden.predict(noisy)["denoised"], den.predict(noisy)["denoised"]
    assert got.shape == (3, C, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())
