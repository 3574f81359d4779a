"""The PyTorch port's DualEEGTransformer and serving path against the JAX package.

At the small geometry of tests/test_torch_port.py: JAX parameters from
``model.init`` are converted to a state_dict, loaded with ``strict=True``,
and both forwards must agree at 2e-3, the repo's cross-framework tolerance
for this model.  Then the raw -> preprocess -> windows -> Predictor path runs
on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu.models.torch_port import export_dual_eeg_state_dict
from eyegaze_tpu.ops.preprocess import preprocess_eeg as jax_preprocess_eeg
from eyegaze_tpu.ops.preprocess import sliding_windows as jax_sliding_windows
from eyegaze_tpu.serving import Predictor as JaxPredictor
from eyegaze_tpu_torch.kernels import phase_metrics
from eyegaze_tpu_torch.models.convert import dual_eeg_state_dict_from_flax
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows
from eyegaze_tpu_torch.serving import Predictor

C, T = 8, 512
GEOMETRY = dict(in_channels=C, num_classes=3, d_model=32, num_layers=2, num_heads=4, d_ff=64,
                max_len=128, conv_kernel_size=7, conv_stride=4, conv_layers=2,
                sampling_rate=256.0)
ABLATIONS = {
    "full": {},
    "phase_no_cross_no_norm": dict(ibs_feature_type="phase", use_cross_attention=False,
                                   ibs_instance_norm=False),
    "no_ibs_no_spec": dict(use_ibs=False, use_spectrogram=False),
    "legacy_ibs": dict(use_robust_ibs=False),
    "mask_band_2": dict(mask_band=2),
}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(flags):
    """(JAX model, its params, port model loaded with the same weights)."""
    jm = JaxDualEEG(**GEOMETRY, **flags)
    z = jnp.zeros((1, C, T), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)["params"])
    tm = DualEEGTransformer(**GEOMETRY, **flags, device=CPU, generator=torch.Generator().manual_seed(1))
    state = dual_eeg_state_dict_from_flax(params)
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def full_pair():
    return _pair(ABLATIONS["full"])


def test_state_dict_matches_reference_exporter(full_pair):
    _, params, _ = full_pair
    got = dual_eeg_state_dict_from_flax(params)
    want = export_dual_eeg_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("ablation", list(ABLATIONS))
def test_forward_matches_jax(ablation, full_pair):
    jm, params, tm = full_pair if ablation == "full" else _pair(ABLATIONS[ablation])
    r = np.random.default_rng(7)
    e1 = r.normal(size=(2, C, T)).astype(np.float32)
    e2 = r.normal(size=(2, C, T)).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, e1, e2)
    with torch.inference_mode():
        got = tm(torch.from_numpy(e1), torch.from_numpy(e2))
    assert set(got) == set(want)
    assert np.abs(np.asarray(want["logits"])).max() > 1e-3  # non-degenerate fixture
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-3, atol=2e-3,
                                   err_msg=k)


def test_seeded_init_is_device_independent_and_flax_scaled():
    a = DualEEGTransformer(**GEOMETRY, device=CPU, generator=torch.Generator().manual_seed(3))
    b = DualEEGTransformer(**GEOMETRY, device=CPU, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    w = a.encoder.layers[0].ffn.linear1.weight  # (d_ff, d_model): std ~ 1/sqrt(d_model)
    assert abs(float(w.detach().std()) * np.sqrt(32) - 1.0) < 0.15
    assert float(a.encoder.layers[0].ffn.linear1.bias.detach().abs().max()) == 0.0
    assert "spectrogram_generator.window" not in a.state_dict()


def test_serving_path_matches_jax(full_pair):
    """raw -> preprocess_eeg -> sliding_windows -> Predictor.predict, both sides,
    with buckets (2, 4) and a ragged request of 3 trials' windows."""
    jm, params, tm = full_pair
    raw1 = np.random.default_rng(11).normal(size=(3, C, 1300)).astype(np.float32)
    raw2 = np.random.default_rng(12).normal(size=(3, C, 1300)).astype(np.float32)

    @jax.jit
    def jax_windows(raw):
        w = jax_sliding_windows(jax_preprocess_eeg(raw, sampling_rate=256.0), T, 256)
        return w.reshape(-1, C, T)

    def port_windows(raw):
        w = sliding_windows(preprocess_eeg(torch.from_numpy(raw), sampling_rate=256.0), T, 256)
        return w.reshape(-1, C, T)

    _assert_predictors_agree(jm, params, tm, port_windows(raw1), port_windows(raw2),
                             np.asarray(jax_windows(raw1)), np.asarray(jax_windows(raw2)),
                             preprocess=False)


def test_serving_path_with_predictor_preprocess_matches_jax(full_pair):
    """Raw windows -> Predictor(preprocess=True), which applies CAR + z-score
    per window, both sides, with buckets (2, 4) and a ragged request."""
    jm, params, tm = full_pair
    raw1 = np.random.default_rng(13).normal(size=(3, C, 1300)).astype(np.float32) * 20.0 + 5.0
    raw2 = np.random.default_rng(14).normal(size=(3, C, 1300)).astype(np.float32) * 20.0 - 5.0

    def windows(raw):
        return np.asarray(jax_sliding_windows(jnp.asarray(raw), T, 256)).reshape(-1, C, T)

    w1 = sliding_windows(torch.from_numpy(raw1), T, 256).reshape(-1, C, T)
    w2 = sliding_windows(torch.from_numpy(raw2), T, 256).reshape(-1, C, T)
    _assert_predictors_agree(jm, params, tm, w1, w2, windows(raw1), windows(raw2),
                             preprocess=True)


def _assert_predictors_agree(jm, params, tm, w1, w2, jw1, jw2, *, preprocess):
    """Both Predictors, buckets (2, 4): 3 windows pad up to bucket 4, and 12
    windows run as three chunks of the largest bucket."""
    jpred = JaxPredictor(jm, params, batch_buckets=(2, 4), preprocess=preprocess)
    pred = Predictor(tm, device=CPU, batch_buckets=(2, 4), preprocess=preprocess)
    pred.warmup(C, T)
    assert w1.shape == (12, C, T)
    before = dict(phase_metrics.launch_count)
    for n in (3, 12):
        want = jpred.predict(jw1[:n], jw2[:n])
        got = pred.predict(w1[:n], w2[:n])
        assert got["logits"].shape == (n, 3)
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(got["preds"], want["preds"])
        assert got["labels"] == want["labels"]
    assert phase_metrics.launch_count == before  # the CPU path never launches the kernel


@pytest.mark.parametrize("preprocess", [False, True])
def test_predictor_serves_float64_as_float32(full_pair, preprocess):
    """A float64 numpy request is served in float32, as the JAX Predictor
    places it (``jnp.asarray``): its outputs are those of the same request
    given as float32."""
    _, _, tm = full_pair
    r = np.random.default_rng(17)
    w1, w2 = (r.normal(size=(3, C, T)) * 20.0 + 5.0 for _ in range(2))
    assert w1.dtype == np.float64
    pred = Predictor(tm, device=CPU, batch_buckets=(2, 4), preprocess=preprocess)
    got = pred.predict(w1, w2)
    want = pred.predict(w1.astype(np.float32), w2.astype(np.float32))
    assert got["logits"].dtype == np.float32 and got["logits"].shape == (3, 3)
    for key in ("logits", "probs", "preds"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_legacy_state_dict_matches_reference_exporter():
    _, params, _ = _pair(ABLATIONS["legacy_ibs"])
    got = dual_eeg_state_dict_from_flax(params)
    want = export_dual_eeg_state_dict(params)
    assert set(got) == set(want) and "ibs_generator.proj.0.weight" in got
    assert not any(k.startswith("ibs_tokenizer") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mask_band_zeroes_one_band(full_pair):
    """Masking a band changes the output of the same weights, and an index
    past the six bands is refused."""
    _, _, tm = full_pair
    masked = DualEEGTransformer(**GEOMETRY, mask_band=2, device=CPU,
                                generator=torch.Generator().manual_seed(1)).eval()
    masked.load_state_dict(tm.state_dict(), strict=True)
    r = np.random.default_rng(8)
    e1, e2 = (torch.from_numpy(r.normal(size=(2, C, T)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        assert (tm(e1, e2)["ibs_token"] - masked(e1, e2)["ibs_token"]).abs().max() > 1e-4
    with pytest.raises(ValueError, match="mask_band"):
        DualEEGTransformer(**GEOMETRY, mask_band=6, device=CPU, generator=torch.Generator())


def test_legacy_serving_path_matches_jax():
    """The legacy IBS configuration through both Predictors; it launches no
    phase-metrics kernel."""
    jm, params, tm = _pair(ABLATIONS["legacy_ibs"])
    assert tm.num_ibs_tokens == 1 and tm.ibs_tokenizer is None
    r = np.random.default_rng(15)
    w1, w2 = (r.normal(size=(12, C, T)).astype(np.float32) for _ in range(2))
    _assert_predictors_agree(jm, params, tm, torch.from_numpy(w1), torch.from_numpy(w2), w1, w2,
                             preprocess=False)


def test_ibs_token_generator_layernorm_matches_jax():
    """The legacy token's optional LayerNorm (which the model leaves off):
    JAX module and port on the same weights, through the converter's
    ``ibs_generator/norm`` names."""
    from eyegaze_tpu.models.dual_eeg import IBSTokenGenerator as JaxIBSTokenGenerator
    from eyegaze_tpu_torch.models.dual_eeg import IBSTokenGenerator

    r = np.random.default_rng(16)
    e1, e2 = (r.normal(size=(2, C, T)).astype(np.float32) for _ in range(2))
    jm = JaxIBSTokenGenerator(32, 256.0, use_layernorm=True)
    ibs = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), e1, e2)["params"])
    ibs["norm"] = {"scale": r.normal(size=32).astype(np.float32),
                   "bias": r.normal(size=32).astype(np.float32)}
    _, params, _ = _pair(ABLATIONS["legacy_ibs"])
    state = dual_eeg_state_dict_from_flax({**params, "ibs_generator": ibs})
    want_state = export_dual_eeg_state_dict({**params, "ibs_generator": ibs})
    assert set(state) == set(want_state) and "ibs_generator.norm.weight" in state
    tm = IBSTokenGenerator(32, 256.0, use_layernorm=True, device=CPU).eval()
    tm.load_state_dict({k[len("ibs_generator."):]: torch.tensor(v) for k, v in state.items()
                        if k.startswith("ibs_generator.")}, strict=True)
    want = np.asarray(jm.apply({"params": ibs}, e1, e2))
    with torch.inference_mode():
        got = tm(torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
