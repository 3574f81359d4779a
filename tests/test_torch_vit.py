"""The gaze ViTs of the port and their image preprocessing against the JAX
package.

At a small geometry (embed 64, depth 2, 4 heads; the bare ViT at img 32 and
patch 8, the fusion models, whose patch is fixed at 16, at img 64), the JAX
parameters from ``model.init`` go through ``convert.gaze_{early,late}_
state_dict_from_flax`` (equal to the JAX exporter's state_dicts) into the
port with ``strict=True``, and both forwards see the same numpy images:

- f32: within 1e-5 of the largest |logit| (the same float32 math summed in
  another order through two blocks).
- bf16 (the served compute type) against the Flax model built with
  ``dtype=bf16``, run eagerly: within 2**-5 of the largest |logit|, the
  bound of the port's other bf16 models, and the port's largest gap to
  Flax bf16 below Flax f32's.  The port rounds where Flax rounds (q scaled
  in bf16 before the product, scores, softmax and weights in bf16, GELU op
  by op), and in 9 of the 11 models the logits come out equal to the bit;
  in early 'add' one patch-embed sum lies on a rounding boundary and rounds
  the other way in XLA's convolution order, and the residual stream
  carries that on (there the port's gap is 0.76 of f32's).
- Block by block in bf16: the patch embed and each ViT block, fed the
  eager Flax model's own input to it, within one bf16 step of its largest
  output (2**-8), and with a mean gap to Flax at most a tenth of the same
  block's in float32 on that input: bf16 rounding is in effect, at Flax's
  points.  The attention module alone, fed the same bf16 input as Flax's
  ``MultiHeadDotProductAttention``, agrees to 2**-8 as well.
- The image ops in f32: to_unit_float and both normalizations to 1e-6, the
  five data-fusion modes and the antialiased resize of the pastes (the
  trap: ``jax.image.resize`` antialiases when it shrinks) to 1e-6, against
  ``jax.image.resize``'s 2e-7 gap measured.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from eyegaze_tpu.data import image_fusion as jax_fusion
from eyegaze_tpu.models import vit as jax_vit
from eyegaze_tpu.models.torch_port import (
    export_gaze_early_state_dict,
    export_gaze_late_state_dict,
)
from eyegaze_tpu_torch.data import image_fusion
from eyegaze_tpu_torch.models import convert, vit

CPU = torch.device("cpu")
SMALL = dict(embed_dim=64, depth=2, num_heads=4)
SHARE = 2.0 ** -5
F32_SHARE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(n, size, seed, channels=3):
    return np.random.default_rng(seed).normal(size=(n, channels, size, size)).astype(np.float32)


def _load(model, state):
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model.eval()


def _check(got, want, want_f32, dtype):
    """``want`` is Flax's output in ``dtype``, ``want_f32`` Flax's in f32."""
    assert got.dtype == np.float32 and got.shape == want.shape
    share = F32_SHARE if dtype == "float32" else SHARE
    np.testing.assert_allclose(got, want, rtol=0, atol=share * np.abs(want_f32).max())
    if dtype == "bfloat16":
        port_gap, f32_gap = np.abs(got - want).max(), np.abs(want_f32 - want).max()
        assert port_gap < f32_gap, (port_gap, f32_gap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_transformer_matches_flax(dtype):
    geometry = dict(img_size=32, patch_size=8, **SMALL)
    x = _images(3, 32, 0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_vit.VisionTransformer(**geometry).init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    w = convert._Writer(params)
    convert._vit(w, "")
    assert w.state["patch_embed.proj.weight"].shape == (64, 3, 8, 8)
    assert w.state["pos_embed"].shape == (1, 17, 64)
    model = _load(vit.VisionTransformer(**geometry, device=CPU, dtype=getattr(torch, dtype),
                                        generator=torch.Generator().manual_seed(1)), w.state)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        features = model(torch.from_numpy(x), return_features=True).numpy()
    jm = jax_vit.VisionTransformer(**geometry, dtype=jnp.dtype(dtype))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    want_f32 = np.asarray(jax_vit.VisionTransformer(**geometry).apply({"params": params},
                                                                      jnp.asarray(x)))
    _check(got, want, want_f32, dtype)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), return_features=True))
    want_f32 = np.asarray(jax_vit.VisionTransformer(**geometry).apply(
        {"params": params}, jnp.asarray(x), return_features=True))
    assert features.shape == (3, 64)
    _check(features, want, want_f32, dtype)


@pytest.mark.parametrize("kind,mode", [("early", m) for m in vit.EARLY_FUSION_MODES]
                         + [("late", m) for m in vit.LATE_FUSION_MODES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_vits_match_flax(kind, mode, dtype):
    jax_cls = jax_vit.EarlyFusionViT if kind == "early" else jax_vit.LateFusionViT
    a, b = _images(2, 64, 1), _images(2, 64, 2)
    geometry = dict(img_size=64, fusion_mode=mode, **SMALL)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_cls(**geometry).init)(
        jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))["params"])
    to_port = (convert.gaze_early_state_dict_from_flax if kind == "early"
               else convert.gaze_late_state_dict_from_flax)
    state = to_port(params)
    exported = (export_gaze_early_state_dict if kind == "early"
                else export_gaze_late_state_dict)(params)
    assert state.keys() == exported.keys()
    for k in state:
        np.testing.assert_array_equal(state[k], exported[k], err_msg=k)
    port_cls = vit.EarlyFusionViT if kind == "early" else vit.LateFusionViT
    model = _load(port_cls(**geometry, device=CPU, dtype=getattr(torch, dtype),
                           generator=torch.Generator().manual_seed(1)), state)
    with torch.inference_mode():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_cls(**geometry, dtype=jnp.dtype(dtype)).apply(
        {"params": params}, jnp.asarray(a), jnp.asarray(b)))
    want_f32 = np.asarray(jax_cls(**geometry).apply({"params": params}, jnp.asarray(a),
                                                    jnp.asarray(b)))
    assert got.shape == (2, 3)
    _check(got, want, want_f32, dtype)


@pytest.mark.parametrize("kind,mode", [("early", "concat"), ("early", "subtract_abs"),
                                       ("late", "full")])
def test_bf16_blocks_round_where_flax_rounds(kind, mode):
    jax_cls = jax_vit.EarlyFusionViT if kind == "early" else jax_vit.LateFusionViT
    a, b = (jnp.asarray(_images(2, 64, s)) for s in (1, 2))
    geometry = dict(img_size=64, fusion_mode=mode, **SMALL)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_cls(**geometry).init)(
        jax.random.PRNGKey(0), a, b)["params"])
    state = (convert.gaze_early_state_dict_from_flax if kind == "early"
             else convert.gaze_late_state_dict_from_flax)(params)
    port_cls = vit.EarlyFusionViT if kind == "early" else vit.LateFusionViT
    port = {dtype: _load(port_cls(**geometry, device=CPU, dtype=dtype,
                                  generator=torch.Generator().manual_seed(1)), state)
            for dtype in (torch.bfloat16, torch.float32)}
    prefix = "backbone" if kind == "early" else "encoder"
    _, seen = jax_cls(**geometry, dtype=jnp.bfloat16).apply(
        {"params": params}, a, b, capture_intermediates=True, mutable=["intermediates"])
    seen = seen["intermediates"][prefix]

    def out(name):
        return np.array(seen[name]["__call__"][0].astype(jnp.float32))

    image = np.array(jax_vit.fuse_images(a, b, mode) if kind == "early" else a)
    blocks = [("patch_embed", lambda m: m.patch_embed(torch.from_numpy(image)),
               out("patch_embed").reshape(2, -1, SMALL["embed_dim"]))]
    x = out("Dropout_0")  # the block input: the tokens after the positions
    for i in range(SMALL["depth"]):
        blocks.append((f"block_{i}", lambda m, x=x, i=i: m.blocks[i](
            torch.from_numpy(x).to(m.dtype)), out(f"block_{i}")))
        x = out(f"block_{i}")
    with torch.inference_mode():
        for name, run, want in blocks:
            got16, got32 = (run(getattr(port[d], prefix)).float().numpy()
                            for d in (torch.bfloat16, torch.float32))
            np.testing.assert_allclose(got16, want, rtol=0,
                                       atol=2.0 ** -8 * np.abs(want).max(), err_msg=name)
            gap16, gap32 = np.abs(got16 - want).mean(), np.abs(got32 - want).mean()
            assert gap16 <= gap32 / 10, (name, gap16, gap32)


def test_late_fusion_features():
    model = vit.LateFusionViT(img_size=32, **SMALL, device=CPU,
                              generator=torch.Generator().manual_seed(0)).eval()
    a, b = (torch.from_numpy(_images(2, 32, s)) for s in (3, 4))
    with torch.inference_mode():
        out = model(a, b, return_features=True)
    torch.testing.assert_close(out["fused"], torch.cat(
        [out["cls1"], out["cls2"], out["cls1"] - out["cls2"], out["cls1"] * out["cls2"]], 1))
    assert model.classifier.weight.shape == (3, 4 * 64)
    with pytest.raises(ValueError, match="fusion_mode"):
        vit.LateFusionViT(fusion_mode="subtract_abs", device=CPU,
                          generator=torch.Generator())
    with pytest.raises(ValueError, match="fusion_mode"):
        vit.EarlyFusionViT(fusion_mode="full", device=CPU, generator=torch.Generator())
    with pytest.raises(ValueError, match="compute dtype"):
        vit.VisionTransformer(device=CPU, generator=torch.Generator(), dtype=torch.float16)


def test_bf16_attention_rounds_where_flax_rounds():
    """The port's ``Attention`` against Flax's ``MultiHeadDotProductAttention``
    in bf16 on the same bf16 input and weights."""
    dim, heads = 64, 4
    x = jnp.asarray(_images(2, 1, 5, channels=17 * dim).reshape(2, 17, dim), jnp.bfloat16)
    fm = nn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=dim, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, fm.init(jax.random.PRNGKey(1), x, x)["params"])
    want = np.asarray(fm.apply({"params": params}, x, x).astype(jnp.float32))
    names = ("query", "key", "value")
    state = {
        "qkv.weight": np.concatenate([params[n]["kernel"].reshape(dim, dim).T for n in names]),
        "qkv.bias": np.concatenate([params[n]["bias"].reshape(dim) for n in names]),
        "proj.weight": params["out"]["kernel"].reshape(dim, dim).T,
        "proj.bias": params["out"]["bias"],
    }
    attn = vit.Attention(dim, heads, device=CPU, dtype=torch.bfloat16)
    attn.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in state.items()},
                         strict=True)
    with torch.inference_mode():
        got = attn(torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("mode", vit.EARLY_FUSION_MODES)
def test_fuse_images_matches_jax(mode):
    a, b = _images(2, 16, 6), _images(2, 16, 7)
    want = np.asarray(jax_vit.fuse_images(jnp.asarray(a), jnp.asarray(b), mode))
    got = vit.fuse_images(torch.from_numpy(a), torch.from_numpy(b), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="fusion_mode"):
        vit.fuse_images(torch.from_numpy(a), torch.from_numpy(b), "full")


@pytest.mark.parametrize("mode", image_fusion.DATA_FUSION_MODES)
def test_fuse_image_pair_and_resize_match_jax(mode):
    r = np.random.default_rng(8)
    a, b = (r.integers(0, 256, size=(2, 3, 32, 32), dtype=np.uint8) for _ in range(2))
    ja, jb = (jax_fusion.to_unit_float(jnp.asarray(x)) for x in (a, b))
    ta, tb = (image_fusion.to_unit_float(torch.from_numpy(x)) for x in (a, b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    want = jax_fusion.fuse_image_pair(ja, jb, mode)
    got = image_fusion.fuse_image_pair(ta, tb, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    want = np.asarray(jax_fusion.resize_bilinear(want, 32, 32))
    got = image_fusion.resize_bilinear(got, 32, 32)
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for norm in ("imagenet_normalize", "vit_processor_normalize"):
        np.testing.assert_allclose(getattr(image_fusion, norm)(got).numpy(),
                                   np.asarray(getattr(jax_fusion, norm)(jnp.asarray(want))),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(20, 20), (48, 40), (16, 64)])
def test_resize_antialiases_as_jax(size):
    x = _images(1, 32, 9)
    want = np.asarray(jax_fusion.resize_bilinear(jnp.asarray(x), *size))
    got = image_fusion.resize_bilinear(torch.from_numpy(x), *size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=size, mode="bilinear",
                                            align_corners=False).numpy()
    if size[0] < 32 or size[1] < 32:  # without the antialiasing filter a shrink misses JAX
        assert np.abs(plain - want).max() > 1e-2
    with pytest.raises(ValueError, match="mode"):
        image_fusion.fuse_image_pair(torch.from_numpy(x), torch.from_numpy(x), "concat")
