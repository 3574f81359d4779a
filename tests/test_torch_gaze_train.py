"""Gaze training in the port against the JAX package, and its entry point.

- The synthetic gaze fixtures (one heatmap, the pair dataset, the mock
  metadata) are equal to the bit to JAX's for the same seed.
- The augment's apply equals JAX's ``random_horizontal_flip`` and
  ``color_jitter`` for the same draws, taken with JAX's own key splits
  (``gaze_augment.py:63`` and ``:41``): within 1e-6, the same float32 ops
  (the grayscale mean sums in another order).
- The augment's draw: the flip rate and the factors' ranges over 4,000
  pairs, and both images of a pair getting the one draw.
- One dropout-free train step of each kind (early 'concat', late 'full',
  datafusion 'horizontal' with the antialiased resize) at the tiny size
  (img 64, embed 64, depth 2, 4 heads), float32, on the same weights and
  the same pre-augmented uint8 batch as ``jax.value_and_grad`` of the JAX
  script's loss: the class-weighted CE within TOL = 2e-3, every gradient
  tensor, put through the converter to the torch names, within GRAD_SHARE
  = 1e-4 of its largest |value| (the bounds of tests/test_torch_trainer.py).
- The class weights and weighted CE against JAX's, and the per-step LR of a
  ``train_gaze`` run against JAX's ``warmup_cosine_schedule`` built as
  ``scripts/train_gaze.py`` builds it.
- ``load_timm_state_dict`` against JAX's on a seeded timm-named
  state_dict, under both widen rules, early (6-channel) and late.
- ``train_gaze --tiny --epochs 1 --device cpu`` for each kind, its
  checkpoint served back by ``GazePredictor.from_checkpoint`` within 2**-5
  of the largest |logit| of the trainer's own eval logits (bf16 both) and
  by ``serve``'s ``gaze`` kind, ``--pretrained`` reading a local timm
  ``.npz``, ``--resume`` going on from the saved epoch, and
  ``serve.sniff_kind`` on a bare datafusion state_dict.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.data import gaze_augment as jax_aug
from eyegaze_tpu.data import image_fusion as jax_fusion
from eyegaze_tpu.data import synthetic as jax_synthetic
from eyegaze_tpu.data.metadata import class_weights as jax_class_weights
from eyegaze_tpu.models import vit as jax_vit
from eyegaze_tpu.train.losses import weighted_cross_entropy as jax_weighted_ce
from eyegaze_tpu.train.optim import warmup_cosine_schedule as jax_warmup_cosine
from eyegaze_tpu_torch import serve, train_gaze
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.data import gaze_augment, synthetic
from eyegaze_tpu_torch.data.metadata import class_weights
from eyegaze_tpu_torch.models import convert, vit
from eyegaze_tpu_torch.serving import GazePredictor
from eyegaze_tpu_torch.train.losses import weighted_cross_entropy

CPU = torch.device("cpu")
IMG = 64
SMALL = dict(embed_dim=64, depth=2, num_heads=4)
TOL = 2e-3
GRAD_SHARE = 1e-4
SHARE = 2.0 ** -5
MODES = {"early": "concat", "late": "full", "datafusion": None}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_synthetic_gaze_fixtures_equal_jax():
    for label in range(3):
        np.testing.assert_array_equal(
            synthetic.synthetic_gaze_heatmap(label, 24, 40, np.random.default_rng(label)),
            jax_synthetic.synthetic_gaze_heatmap(label, 24, 40, np.random.default_rng(label)))
    got = synthetic.synthetic_gaze_pair_dataset(n=7, H=20, W=28, seed=3)
    want = jax_synthetic.synthetic_gaze_pair_dataset(n=7, H=20, W=28, seed=3)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert synthetic.synthetic_metadata(40, seed=5) == jax_synthetic.synthetic_metadata(40, seed=5)


def _unit_images(n, seed, size=16):
    r = np.random.default_rng(seed)
    return [r.random((n, 3, size, size), dtype=np.float32) for _ in range(2)]


def test_augment_apply_matches_jax_for_jax_draws():
    b = 8
    img1, img2 = _unit_images(b, 0)
    key = jax.random.PRNGKey(7)
    want1, want2 = jax_aug.augment_gaze_pair(key, jnp.asarray(img1), jnp.asarray(img2))
    k_flip, k_jit = jax.random.split(key)  # gaze_augment.py:63
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (b, 1, 1, 1))).reshape(b)
    factors = np.stack([np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=0.8,
                                                      maxval=1.2)).reshape(b)
                        for k in jax.random.split(k_jit, 3)])  # gaze_augment.py:41
    assert 0 < flip.sum() < b
    flip_t, factors_t = torch.from_numpy(flip), torch.from_numpy(factors)
    for img, want in ((img1, want1), (img2, want2)):
        flipped = gaze_augment.random_horizontal_flip(torch.from_numpy(img), flip_t)
        np.testing.assert_array_equal(flipped.numpy(), np.asarray(jax_aug.random_horizontal_flip(
            k_flip, jnp.asarray(img), 0.5)))
        got = gaze_augment.color_jitter(flipped, factors_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            gaze_augment.color_jitter(torch.from_numpy(img), factors_t).numpy(),
            np.asarray(jax_aug.color_jitter(k_jit, jnp.asarray(img))), rtol=0, atol=1e-6)


def test_augment_draw_rates_ranges_and_one_draw_per_pair():
    g = torch.Generator().manual_seed(0)
    n = 4000
    flip = gaze_augment.draw_flip(n, g)
    assert flip.dtype == torch.bool and abs(flip.float().mean().item() - 0.5) < 0.03
    factors = gaze_augment.draw_jitter(n, g, 0.2, 0.1, 0.3)
    for f, x in zip(factors, (0.2, 0.1, 0.3)):
        assert 1 - x <= f.min().item() < 1 - 0.95 * x and 1 + 0.95 * x < f.max().item() <= 1 + x
        assert abs(f.mean().item() - 1.0) < 0.02 * x / 0.1
    img1, img2 = (torch.from_numpy(x) for x in _unit_images(6, 1))
    state = g.get_state()
    out1, out2 = gaze_augment.augment_gaze_pair(g, img1, img2)
    g.set_state(state)  # the same draws again, applied by hand
    flip, factors = gaze_augment.draw_flip(6, g), gaze_augment.draw_jitter(6, g)
    for img, out in ((img1, out1), (img2, out2)):
        want = gaze_augment.color_jitter(gaze_augment.random_horizontal_flip(img, flip), factors)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    same1, same2 = gaze_augment.augment_gaze_pair(g, img1, img1.clone())
    torch.testing.assert_close(same1, same2, rtol=0, atol=0)


def test_class_weights_and_weighted_ce_match_jax():
    labels = [0, 0, 1, 2, 2, 2, 1, 0, 0]
    np.testing.assert_array_equal(class_weights(labels), jax_class_weights(labels))
    r = np.random.default_rng(2)
    logits = r.normal(size=(9, 3)).astype(np.float32)
    w = class_weights(labels)
    got = weighted_cross_entropy(torch.from_numpy(logits), torch.tensor(labels),
                                 torch.from_numpy(w))
    want = jax_weighted_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _cfg(tmp_path, **training):
    return {"model": {"fusion_mode": "concat", "img_size": IMG},
            "data": {"synthetic_trials": 30, "random_seed": 42},
            "training": {"output_dir": str(tmp_path / "run"), "num_train_epochs": 1,
                         "per_device_train_batch_size": 4, "per_device_eval_batch_size": 4,
                         "learning_rate": 1e-3, "warmup_epochs": 1, "bf16": True,
                         "use_class_weights": True, "save_every_n_epochs": 1, **training},
            "system": {"seed": 0, "device": "cpu"}}


def _jax_model(kind):
    kw = dict(num_classes=3, img_size=IMG, dropout=0.0, **SMALL)
    if kind == "early":
        return jax_vit.EarlyFusionViT(fusion_mode="concat", **kw)
    if kind == "late":
        return jax_vit.LateFusionViT(fusion_mode="full", **kw)
    return jax_vit.VisionTransformer(**kw)


def _to_torch_names(kind, tree):
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if kind == "early":
        return convert.gaze_early_state_dict_from_flax(tree)
    if kind == "late":
        return convert.gaze_late_state_dict_from_flax(tree)
    w = convert._Writer(tree)
    convert._vit(w, "")
    return w.state


@pytest.mark.parametrize("kind", list(MODES))
def test_one_train_step_matches_jax(kind):
    r = np.random.default_rng(4)
    img1, img2 = (r.integers(0, 256, (6, 3, IMG, IMG), dtype=np.uint8) for _ in range(2))
    labels = np.array([0, 1, 2, 0, 0, 1], np.int32)
    w = class_weights(labels.tolist())
    jm = _jax_model(kind)
    unit = [jax_fusion.to_unit_float(jnp.asarray(x)) for x in (img1, img2)]

    def jax_forward(params, a, b):  # scripts/train_gaze.py's _forward
        if kind == "datafusion":
            fused = jax_fusion.resize_bilinear(jax_fusion.fuse_image_pair(a, b, "horizontal"),
                                               IMG, IMG)
            return jm.apply({"params": params}, jax_fusion.imagenet_normalize(fused))
        return jm.apply({"params": params}, jax_fusion.imagenet_normalize(a),
                        jax_fusion.imagenet_normalize(b))

    init_args = unit[:1] if kind == "datafusion" else unit
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                                 *init_args)["params"])

    def jax_loss(p):
        return jax_weighted_ce(jax_forward(p, *unit), jnp.asarray(labels), jnp.asarray(w))

    want_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = _to_torch_names(kind, grads)

    cfg = config_from_dict({"model": {"fusion_mode": MODES[kind] or "concat", "img_size": IMG},
                            "training": {"dropout": 0.0, "bf16": False},
                            "system": {"seed": 1}})
    model = train_gaze.build_model(cfg, kind, tiny=True, device=CPU)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           _to_torch_names(kind, params).items()}, strict=True)
    _, forward = train_gaze.make_objective(kind, img_size=IMG, generator=torch.Generator())
    batch = {"img1": torch.from_numpy(img1), "img2": torch.from_numpy(img2),
             "label": torch.from_numpy(labels)}
    loss = weighted_cross_entropy(forward(model.train(), batch), batch["label"],
                                  torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    largest = max(np.abs(g).max() for g in want.values())
    for k, g in got.items():
        atol = GRAD_SHARE * (largest if k.endswith("qkv.bias") else np.abs(want[k]).max())
        np.testing.assert_allclose(g, want[k], rtol=0, atol=atol, err_msg=k)


def _timm_state(seed, in_channels=3, num_classes=1000):
    """A timm-named ViT state_dict of the small geometry, values from a seed."""
    model = vit.VisionTransformer(img_size=IMG, in_channels=in_channels, num_classes=num_classes,
                                  **SMALL, device=CPU, generator=torch.Generator().manual_seed(seed))
    return {k: (v.numpy() + np.random.default_rng(seed).normal(0, 0.01, v.shape)).astype(np.float32)
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind,strategy,classes", [("early", "duplicate", 1000),
                                                   ("early", "average", 3),
                                                   ("late", "duplicate", 1000)])
def test_load_timm_state_dict_matches_jax(kind, strategy, classes):
    state = _timm_state(3, num_classes=classes)
    jm = _jax_model(kind)
    z = jnp.zeros((1, 3, IMG, IMG), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)[
        "params"])
    key = "backbone" if kind == "early" else "encoder"
    want = _to_torch_names(kind, jax_vit.load_timm_state_dict(params, state, backbone_key=key,
                                                              weight_init_strategy=strategy))
    cfg = config_from_dict({"model": {"fusion_mode": MODES[kind], "img_size": IMG},
                            "training": {"bf16": False}})
    model = train_gaze.build_model(cfg, kind, tiny=True, device=CPU)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    vit.load_timm_state_dict(model.get_submodule(key), state, strategy)
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    for k, g in got.items():
        if k.startswith(f"{key}.head.") and classes != 3 or k.startswith("classifier."):
            # Not in the timm file at this shape: each framework keeps its own init.
            np.testing.assert_array_equal(g, before[k].numpy(), err_msg=k)
        else:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
    patch = got[f"{key}.patch_embed.proj.weight"]
    if kind == "early":
        second = state["patch_embed.proj.weight"] if strategy == "duplicate" else \
            state["patch_embed.proj.weight"].mean(axis=1, keepdims=True).repeat(3, axis=1)
        np.testing.assert_array_equal(patch[:, 3:], second)
    with pytest.raises(ValueError, match="weight_init_strategy"):
        vit.load_timm_state_dict(model.get_submodule(key), state, "zeros")
    del state["blocks.1.mlp.fc2.bias"]
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        vit.load_timm_state_dict(model.get_submodule(key), state)


def _write_config(tmp_path, **training):
    import yaml

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path, **training)))
    return str(path)


@pytest.mark.parametrize("kind", list(MODES))
def test_train_gaze_entry_point_then_serve(tmp_path, kind):
    argv = ["--config", _write_config(tmp_path), "--model", kind, "--tiny", "--epochs", "1",
            "--device", "cpu"]
    if kind == "datafusion":
        argv += ["--data-fusion-mode", "vertical", "--image-norm", "vit"]
    result = train_gaze.main(argv)
    trainer, val = result["trainer"], result["val"]
    ckpt = tmp_path / "run" / "checkpoints"
    mc = json.loads((ckpt / "best_model.meta.json").read_text())["config"]["model"]
    assert mc["kind"] == kind and mc["vit_num_heads"] == 4 and mc["img_size"] == IMG
    if kind == "datafusion":
        assert (mc["data_fusion_mode"], mc["image_norm"]) == ("vertical", "vit")
    assert trainer.optimizer.count == 22 // 4  # 22 train pairs, drop remainder
    pred = GazePredictor.from_checkpoint(ckpt / "best_model.pt", device=CPU,
                                         batch_buckets=(8,))
    if kind == "datafusion":
        assert isinstance(pred.model, vit.VisionTransformer)
        assert pred.data_fusion_mode == "vertical"
    got = pred.predict(val.arrays["img1"], val.arrays["img2"])["logits"]
    want = trainer.eval_logits
    assert got.shape == want.shape == (8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())
    assert serve.sniff_kind(ckpt / "best_model.pt") == "gaze"
    served = serve.build_predictor("gaze", ckpt / "best_model.pt", (8,), CPU)  # serve --kind gaze
    np.testing.assert_array_equal(served.predict(val.arrays["img1"], val.arrays["img2"])[
        "logits"], got)


def test_pretrained_flag_reads_a_local_timm_file(tmp_path, capsys):
    state = _timm_state(6)
    path = tmp_path / "vit_timm.npz"
    np.savez(path, **state)
    result = train_gaze.main(["--config", _write_config(tmp_path), "--model", "early",
                              "--tiny", "--epochs", "0", "--device", "cpu",
                              "--pretrained", str(path)])
    assert f"loaded pretrained weights from {path}" in capsys.readouterr().out
    got = result["trainer"].model.backbone.state_dict()
    for k, v in state.items():
        if k == "patch_embed.proj.weight":  # 'duplicate' widened to the pair's 6 channels
            v = np.concatenate([v, v], axis=1)
        if not k.startswith("head."):  # 1000 classes: not loaded
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_per_step_lr_follows_the_jax_schedule(tmp_path):
    cfg = config_from_dict(_cfg(tmp_path, num_train_epochs=3, bf16=False))
    result = train_gaze.run(cfg, "late", device=CPU, tiny=True)
    opt = result["trainer"].optimizer
    steps_per_epoch = 22 // 4
    assert opt.count == 3 * steps_per_epoch
    schedule = jax_warmup_cosine(1e-3, steps_per_epoch, 3 * steps_per_epoch)
    for k in range(opt.count):
        np.testing.assert_allclose(opt._lr(opt.lrs[0], k), float(schedule(k)), rtol=1e-5,
                                   atol=1e-9)
    assert opt.adamw.param_groups[0]["lr"] == pytest.approx(float(schedule(opt.count - 1)),
                                                            rel=1e-5)


def test_resume_continues_from_the_saved_epoch(tmp_path):
    config = _write_config(tmp_path)
    argv = ["--config", config, "--model", "early", "--tiny", "--device", "cpu"]
    first = train_gaze.main(argv + ["--epochs", "1"])
    steps = first["trainer"].optimizer.count
    resumed = train_gaze.main(argv + ["--epochs", "2", "--resume"])
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["trainer"].optimizer.count == 2 * steps
    # A tensor-parallel spec trains: two gloo ranks, 2 of the 4 heads each.
    (tmp_path / "tp").mkdir()
    tp = train_gaze.main(["--config", _write_config(tmp_path / "tp"), "--model", "early",
                          "--tiny", "--device", "cpu", "--epochs", "1", "--mesh", "dp1,tp2"])
    assert len(tp["history"]) == 1 and np.isfinite(tp["history"][0]["train/loss"])
    with pytest.raises(SystemExit):
        train_gaze.main(argv + ["--image-root", str(tmp_path)])  # needs --metadata


def test_sniff_kind_reads_a_bare_datafusion_state_dict(tmp_path):
    model = vit.VisionTransformer(img_size=32, **SMALL, device=CPU,
                                  generator=torch.Generator().manual_seed(0))
    path = tmp_path / "datafusion.pt"
    torch.save(model.state_dict(), path)  # no meta: only the keys tell
    assert serve.sniff_kind(path) == "gaze"
    meta = tmp_path / "datafusion.meta.json"
    meta.write_text(json.dumps({"config": {"model": {"img_size": 32, "vit_num_heads": 4,
                                                     "data_fusion_mode": "add"}}}))
    pred = GazePredictor.from_checkpoint(path, device=CPU, batch_buckets=(2,))
    assert isinstance(pred.model, vit.VisionTransformer) and pred.data_fusion_mode == "add"
    a = np.zeros((3, 3, 32, 32), np.uint8)
    assert pred.predict(a, a)["logits"].shape == (3, 3)
    Path(meta).write_text(json.dumps({"config": {"model": {"kind": "early"}}}))
    with pytest.raises(ValueError, match="no backbone.cls_token"):
        GazePredictor.from_checkpoint(path, device=CPU)
