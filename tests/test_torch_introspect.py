"""The port's EEG introspection (``eyegaze_tpu_torch/analysis/eeg_introspect.py``
and ``DualEEGTransformer(..., capture=True)``) against the JAX package's on
the same weights: the JAX model's ``init`` converted to a state_dict, the
same windows made from a seed with numpy, at C = 8, d_model 32, 2 layers.
The frequency-sensitivity and Grad-CAM tests use these fixtures from files
of their own (tests/test_torch_introspect_{frequency,gradcam}.py), which
spreads the JAX compiles over the lane's workers.

Forwards and their means are held at 2e-3, the repo's cross-framework
tolerance for this model (tests/test_torch_dual_eeg.py).  The Grad-CAM maps
are held at ``CAM_SHARE`` of each map's largest entry (see there).  The
resize is held against ``jax.image.resize`` where it grows and where it
shrinks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.analysis import eeg_introspect as jax_introspect
from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu_torch.analysis import eeg_introspect
from eyegaze_tpu_torch.data.image_fusion import resize_bilinear
from eyegaze_tpu_torch.models.convert import dual_eeg_state_dict_from_flax
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer

C, T = 8, 512
GEOMETRY = dict(in_channels=C, num_classes=3, d_model=32, num_layers=2, num_heads=4, d_ff=64,
                max_len=128, conv_kernel_size=7, conv_stride=4, conv_layers=2,
                sampling_rate=256.0)
TOL = 2e-3
# A CAM is relu(sum_k w_k act_k) with w_k a gradient summed over the whole
# network; each framework's float32 rounding moves it by a few 1e-4 of the
# map's scale (entries near zero that the ReLU clips included), so each map
# is held at this share of its own largest entry.
CAM_SHARE = 5e-3
CPU = torch.device("cpu")
LABELS = np.array([0, 1, 2, 1, 2, 0, 1, 2])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, port model on the same weights)."""
    jm = JaxDualEEG(**GEOMETRY)
    z = jnp.zeros((1, C, T), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)["params"])
    tm = DualEEGTransformer(**GEOMETRY, device=CPU, generator=torch.Generator().manual_seed(1))
    tm.load_state_dict({k: torch.tensor(v) for k, v in dual_eeg_state_dict_from_flax(params).items()},
                       strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def batches():
    """Two batches of 4 windows, every class in each."""
    r = np.random.default_rng(5)
    e1 = r.normal(size=(8, C, T)).astype(np.float32)
    e2 = (0.5 * e1 + r.normal(size=(8, C, T))).astype(np.float32)
    return [{"eeg1": e1[i:i + 4], "eeg2": e2[i:i + 4], "label": LABELS[i:i + 4]}
            for i in (0, 4)]


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("mask_band", [-1, 2])
def test_capture_matches_jax_intermediates(pair, batches, mask_band):
    jm, params, tm = pair
    b = batches[0]
    jmodel = JaxDualEEG(**GEOMETRY, mask_band=mask_band, enable_perturb=True)
    want, state = jax.jit(lambda p, e1, e2: jmodel.apply(
        {"params": p}, e1, e2, capture=True, mutable=["intermediates"]))(params, b["eeg1"],
                                                                         b["eeg2"])
    inter = state["intermediates"]
    model = tm.with_mask_band(mask_band) if mask_band >= 0 else tm
    with torch.inference_mode():
        got = model(torch.from_numpy(b["eeg1"]), torch.from_numpy(b["eeg2"]), capture=True)
        plain = model(torch.from_numpy(b["eeg1"]), torch.from_numpy(b["eeg2"]))
    cap = got.pop("intermediates")
    assert "intermediates" not in plain and set(plain) == set(got)
    for k in plain:  # capturing changes no output
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
        _close(got[k], want[k], k)
    assert set(cap) == {"ibs_matrices", "attn_weights_1to2", "attn_weights_2to1",
                        "spec1_conv2_act", "spec2_conv2_act"}
    _close(cap["ibs_matrices"], inter["ibs_matrices"][0], "ibs_matrices")
    if mask_band >= 0:
        assert float(cap["ibs_matrices"][:, mask_band].abs().max()) == 0.0
    for k in ("attn_weights_1to2", "attn_weights_2to1"):
        assert cap[k].shape == inter["cross_attn"][k][0].shape
        _close(cap[k], inter["cross_attn"][k][0], k)
    for k in ("spec1_conv2_act", "spec2_conv2_act"):
        want_act = inter["spectrogram_generator"][k][0]
        assert cap[k].shape == want_act.shape  # (B*C, F', T', 64), JAX's layout
        _close(cap[k], want_act, k)
    assert not np.allclose(cap["spec1_conv2_act"].numpy(), cap["spec2_conv2_act"].numpy())


def test_with_mask_band_shares_the_weights(pair):
    _, _, tm = pair
    masked = tm.with_mask_band(4)
    assert masked.mask_band == 4 and tm.mask_band == -1
    for (k, a), b in zip(tm.state_dict().items(), masked.state_dict().values()):
        assert a.data_ptr() == b.data_ptr(), k
    fresh = DualEEGTransformer(**GEOMETRY, mask_band=4, device=CPU,
                               generator=torch.Generator().manual_seed(9)).eval()
    fresh.load_state_dict(tm.state_dict())
    e = torch.from_numpy(np.random.default_rng(2).normal(size=(2, C, T)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(masked(e, e)["logits"], fresh(e, e)["logits"], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm.with_mask_band(6)


def test_run_inference_matches_jax(pair, batches):
    jm, params, tm = pair
    want = jax_introspect.run_inference(jm, params, iter(batches))
    got = eeg_introspect.run_inference(tm, iter(batches))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        _close(got[k], want[k], k)


def test_extract_ibs_matrices_matches_jax(pair, batches):
    jm, params, tm = pair
    want = jax_introspect.extract_ibs_matrices(jm, params, iter(batches))
    got = eeg_introspect.extract_ibs_matrices(tm, iter(batches))
    assert got["class_means"].shape == (3, 6, 7, C, C)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for k in ("class_means", "diff_coop_vs_comp"):
        assert got[k].dtype == np.float32
        _close(got[k], want[k], k)


def test_extract_attention_maps_matches_jax(pair, batches):
    jm, params, tm = pair
    want = jax_introspect.extract_attention_maps(jm, params, iter(batches))
    got = eeg_introspect.extract_attention_maps(tm, iter(batches))
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for k in ("mean_map", "class_means"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        _close(got[k], want[k], k)
    for c in range(3):
        _close(got["diagonals"][c], want["diagonals"][c])


def test_extract_embeddings_matches_jax(pair, batches):
    jm, params, tm = pair
    inference = eeg_introspect.run_inference(tm, iter(batches))
    got = eeg_introspect.extract_embeddings(inference)
    want = jax_introspect.extract_embeddings(inference)
    assert list(got) == list(want) == ["z_fuse", "ibs_token"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("src,dst", [((32, 8), (64, 64)), ((14, 14), (224, 224)),
                                     ((64, 64), (14, 14)), ((33, 17), (16, 8))],
                         ids=["conv2-grid-grows", "vit-grid-grows", "shrinks", "shrinks-odd"])
def test_resize_matches_jax_image_resize(src, dst):
    """``jax.image.resize(..., 'bilinear')``: half-pixel centres, and a
    triangle kernel widened by the scale where an axis shrinks."""
    x = np.random.default_rng(1).random((3,) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3,) + dst, "bilinear"))
    got = resize_bilinear(torch.from_numpy(x)[:, None], *dst)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
