"""The port's gaze introspection (``eyegaze_tpu_torch/analysis/gaze_introspect.py``
and ``return_tokens``) against the JAX package's on the same weights: a
tiny early-fusion ViT (img 64, embed 64, depth 2, 4 heads; 'concat', 6
channels) and a late-fusion one, the JAX ``init`` converted by
``convert.gaze_{early,late}_state_dict_from_flax``, the same normalized
images made from a seed with numpy, float32 on both sides.

The CLS features and the last block's tokens are held at 2e-3 (the
cross-framework tolerance of the repo's f32 models).  The saliency maps are
gradients taken through the whole network: each map is held at
``MAP_SHARE`` of its own largest entry, above the float32 rounding of the
two frameworks' sums and well below the maps' own structure.  The ViT
Grad-CAM maps are zero on both sides (``test_vit_gradcam_matches_jax``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.analysis import gaze_introspect as jax_gaze
from eyegaze_tpu.models import vit as jax_vit
from eyegaze_tpu_torch.analysis import gaze_introspect
from eyegaze_tpu_torch.models import convert, vit

CPU = torch.device("cpu")
SMALL = dict(num_classes=3, img_size=64, embed_dim=64, depth=2, num_heads=4)
TOL = 2e-3
MAP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def early():
    jm = jax_vit.EarlyFusionViT(fusion_mode="concat", **SMALL)
    z = jnp.zeros((1, 3, 64, 64), jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)["params"]
    tm = vit.EarlyFusionViT(fusion_mode="concat", **SMALL, device=CPU,
                            generator=torch.Generator().manual_seed(1))
    state = convert.gaze_early_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return params, tm.eval()


@pytest.fixture(scope="module")
def late():
    jm = jax_vit.LateFusionViT(fusion_mode="full", **SMALL)
    z = jnp.zeros((1, 3, 64, 64), jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), z, z)["params"]
    tm = vit.LateFusionViT(fusion_mode="full", **SMALL, device=CPU,
                           generator=torch.Generator().manual_seed(1))
    state = convert.gaze_late_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return jm, params, tm.eval()


def _maps_close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.float32, what
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(w).max())
        assert scale > 0, (what, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=MAP_SHARE * scale, err_msg=f"{what} {i}")


def test_return_tokens_matches_jax_last_block(early):
    params, tm = early
    i1, i2 = _images(2, 1), _images(2, 2)
    jm = jax_vit.EarlyFusionViT(fusion_mode="concat", enable_perturb=True, **SMALL)
    want, state = jm.apply({"params": params}, i1, i2, mutable=["intermediates"])
    tokens_want = state["intermediates"]["backbone"]["last_block_tokens"][0]
    with torch.inference_mode():
        logits, tokens = tm(torch.from_numpy(i1), torch.from_numpy(i2), return_tokens=True)
        plain = tm(torch.from_numpy(i1), torch.from_numpy(i2))
    assert tokens.shape == (2, 1 + 16, 64)
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(tokens_want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("class_idx", [None, 1])
def test_input_saliency_matches_jax(early, class_idx):
    params, tm = early
    i1, i2 = _images(3, 3), _images(3, 4)
    jm = jax_vit.EarlyFusionViT(fusion_mode="concat", **SMALL)
    want = jax_gaze.input_saliency(jm, params, i1, i2, class_idx)
    got = gaze_introspect.input_saliency(tm, i1, i2, class_idx)
    for g, w, name in zip(got, want, ("img1", "img2")):
        assert g.shape == (3, 64, 64)
        _maps_close(g, w, name)


@pytest.mark.parametrize("class_idx,upsample_to", [(None, None), (2, 64), (None, 224)],
                         ids=["grid", "class2-up64", "up224"])
def test_vit_gradcam_matches_jax(early, class_idx, upsample_to):
    """The target is the last block's output tokens (the JAX package's, and
    the reference's hook on ``blocks[-1]``).  Only the CLS token of that
    output reaches the logits (the final LayerNorm and the head read token
    0 alone), so every patch token's gradient is zero and so is every CAM,
    on both sides: a reference-side fault (ROADMAP.md section 3) that the
    port keeps for parity.  The maps are held equal, the token gradient's
    CLS row is held nonzero (the gradient does flow), and its patch rows
    zero."""
    params, tm = early
    i1, i2 = _images(2, 5), _images(2, 6)
    jm = jax_vit.EarlyFusionViT(fusion_mode="concat", enable_perturb=True, **SMALL)
    want = jax_gaze.vit_gradcam(jm, params, i1, i2, class_idx, upsample_to)
    got = gaze_introspect.vit_gradcam(tm, i1, i2, class_idx, upsample_to)
    size = upsample_to or 4
    assert got.shape == want.shape == (2, size, size) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    x1, x2 = torch.from_numpy(i1), torch.from_numpy(i2)
    logits, tokens = tm(x1, x2, return_tokens=True)
    (g,) = torch.autograd.grad(logits[:, 1].sum(), tokens)
    assert float(g[:, 0].abs().max()) > 0 and float(g[:, 1:].abs().max()) == 0.0


def test_extract_cls_features_matches_jax(early, late):
    params, tm = early
    r = np.random.default_rng(7)
    batches = [{"img1": _images(3, 8), "img2": _images(3, 9), "label": r.integers(0, 3, 3)},
               {"img1": _images(2, 10), "img2": _images(2, 11), "label": r.integers(0, 3, 2)}]
    jm = jax_vit.EarlyFusionViT(fusion_mode="concat", **SMALL)
    want = jax_gaze.extract_cls_features(jm, params, iter(batches))
    got = gaze_introspect.extract_cls_features(tm, iter(batches))
    assert set(got) == set(want) == {"features", "labels"}
    assert got["features"].shape == (5, 64)
    np.testing.assert_allclose(got["features"], want["features"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["labels"], want["labels"])

    jm, params, tm = late
    want = jax_gaze.extract_cls_features(jm, params, iter(batches))
    got = gaze_introspect.extract_cls_features(tm, iter(batches))
    assert set(got) == set(want) == {"features", "labels", "cls1", "cls2"}
    assert got["features"].shape == (5, 4 * 64)
    for k in ("features", "cls1", "cls2"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def test_denormalize_image_matches_jax():
    img = np.random.default_rng(12).normal(size=(3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(gaze_introspect.denormalize_image(img),
                                  jax_gaze.denormalize_image(img))
