"""Multimodal training in the port against the JAX package: the data, the
loss and the optimizer's groups.

- ``MultimodalArrays``: every batch equal to the bit to JAX's for the same
  arrays (uint8 images, pair IDs), shuffle seed and epoch, with and without
  the tail.
- The loss of ``train_multimodal.make_objective`` on the tiny composite
  (``--tiny``'s sizes) against ``scripts/train_multimodal.py``'s
  ``loss_fn`` (``:198-224``) on the same weights (the port's seeded ones,
  through the JAX package's importer) and uint8 batch, float32, dropout 0: the total and every term (``loss_fused``,
  ``loss_img``, ``loss_eeg``, ``loss_alpha_mean``) within rtol = atol =
  2e-3, the composite's float32 bound (tests/test_torch_multimodal.py).
- The two learning-rate groups over one AdamW step: with
  ``encoder_learning_rate: 0.0`` or ``freeze_encoders`` no encoder tensor
  moves (to the bit) while the gate does; otherwise the largest encoder
  change is the encoder rate and the gate's the fusion rate (Adam's first
  step moves each entry by lr * g / (|g| + eps), plus lr * wd * p: within
  1% below and 5% above).

The entry point (pretrained encoders, ``--resume``, the checkpoint served
back) is in tests/test_torch_multimodal_run.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.data import image_fusion as jax_fusion
from eyegaze_tpu.data.loader import MultimodalArrays as JaxMultimodalArrays
from eyegaze_tpu.models.multimodal import MultimodalFusionModel as JaxMultimodal
from eyegaze_tpu.models.torch_port import port_multimodal_state_dict
from eyegaze_tpu.train.losses import cross_entropy as jax_cross_entropy
from eyegaze_tpu_torch import train_multimodal
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.data.loader import MultimodalArrays

CPU = torch.device("cpu")
TOL = 2e-3
LAMBDAS = dict(lambda_img=0.5, lambda_eeg=0.2, lambda_temp_reg=0.7)
T = 512


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, trials=5, t=300, size=8):
    r = np.random.default_rng(seed)
    return dict(img1=r.integers(0, 256, (trials, 3, size, size), dtype=np.uint8),
                img2=r.integers(0, 256, (trials, 3, size, size), dtype=np.uint8),
                eeg1=r.normal(size=(trials, 4, t)).astype(np.float32),
                eeg2=r.normal(size=(trials, 4, t)).astype(np.float32),
                labels=(np.arange(trials) % 3).astype(np.int32),
                pairs=(12 + np.arange(trials)).astype(np.int32))


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_multimodal_arrays_batches_equal_jax(drop_remainder):
    a = _arrays(0)
    got = MultimodalArrays(**a, window_size=128, stride=64)
    want = JaxMultimodalArrays(**a, window_size=128, stride=64)
    assert len(got) == len(want) == 5 * 3
    for epoch in (0, 2):
        batches = list(zip(got.iter_batches(4, shuffle=True, seed=3, epoch=epoch,
                                            drop_remainder=drop_remainder),
                           want.iter_batches(4, shuffle=True, seed=3, epoch=epoch,
                                             drop_remainder=drop_remainder)))
        assert len(batches) == (3 if drop_remainder else 4)
        for g, w in batches:
            assert g.keys() == w.keys() == {"img1", "img2", "eeg1", "eeg2", "label", "pair"}
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    a["labels"] = a["labels"][:4]
    with pytest.raises(ValueError, match="trial counts differ"):
        MultimodalArrays(**a)


def _tiny_cfg(**training):
    return config_from_dict({"training": {"dropout": 0.0, "bf16": False, **LAMBDAS, **training},
                             "system": {"seed": 1}})


def _batch(n, seed):
    r = np.random.default_rng(seed)
    img1, img2 = (r.integers(0, 256, (n, 3, 64, 64), dtype=np.uint8) for _ in range(2))
    e1, e2 = (r.normal(size=(n, 32, T)).astype(np.float32) for _ in range(2))
    return {"img1": img1, "img2": img2, "eeg1": e1, "eeg2": e2,
            "label": (np.arange(n) % 3).astype(np.int32)}


def test_loss_matches_the_jax_script_term_by_term():
    cfg = _tiny_cfg()
    model = train_multimodal.build_model(cfg, tiny=True, device=CPU)
    batch = _batch(3, 5)
    jm = JaxMultimodal(**train_multimodal.TINY, eeg_in_channels=32, dropout=0.0)

    def prep(x):
        return jax_fusion.imagenet_normalize(jax_fusion.to_unit_float(jnp.asarray(x)))

    x = (prep(batch["img1"]), prep(batch["img2"]), batch["eeg1"], batch["eeg2"])
    # The port's seeded weights into JAX's tree by the JAX package's importer
    # (the tree's structure from a trace, not a compiled init).
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), *x)["params"])
    params = port_multimodal_state_dict(template, {k: v.numpy()
                                                   for k, v in model.state_dict().items()})
    out = jax.jit(lambda p: jm.apply({"params": p}, *x, deterministic=False,
                                     rngs={"dropout": jax.random.PRNGKey(1)}))(params)
    labels = jnp.asarray(batch["label"])
    temps = out["aux_info"]["temperatures"]
    want = {"loss_fused": jax_cross_entropy(out["logits"], labels),
            "loss_img": jax_cross_entropy(out["img_logits"] / temps["img"], labels),
            "loss_eeg": jax_cross_entropy(out["eeg_logits"] / temps["eeg"], labels),
            "loss_alpha_mean": jnp.mean(out["alpha"])}
    want["loss"] = (want["loss_fused"] + LAMBDAS["lambda_img"] * want["loss_img"]
                    + LAMBDAS["lambda_eeg"] * want["loss_eeg"]
                    + LAMBDAS["lambda_temp_reg"] * out["temp_reg"])

    loss_fn, _ = train_multimodal.make_objective(cfg)
    loss, aux = loss_fn(model.train(), {k: torch.from_numpy(v) for k, v in batch.items()})
    got = {"loss": loss, **{k: v for k, v in aux.items() if k.startswith("loss_")}}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=TOL, atol=TOL, err_msg=k)
    assert float(temps["img"]) != 1.0  # the calibration divides by a real temperature


@pytest.mark.parametrize("case", ["zero_rate", "frozen", "encoder_rate"])
def test_encoder_and_fusion_groups(case):
    lr, encoder_lr = 1e-2, 1e-3
    training = {"learning_rate": lr,
                "encoder_learning_rate": {"zero_rate": 0.0, "frozen": encoder_lr,
                                          "encoder_rate": None}[case],
                "freeze_encoders": case == "frozen"}
    cfg = _tiny_cfg(**training)
    model = train_multimodal.build_model(cfg, tiny=True, device=CPU)
    opt = train_multimodal.make_multimodal_optimizer(model, cfg)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss_fn, _ = train_multimodal.make_objective(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 6).items()}
    loss_fn(model.train(), batch)[0].backward()
    opt.step()
    moved = {}
    for k, p in model.named_parameters():
        group = "encoder" if k.split(".")[0] in train_multimodal.ENCODERS else "fusion"
        moved[group] = max(moved.get(group, 0.0), float((p.detach() - before[k]).abs().max()))
    assert 0.99 * lr <= moved["fusion"] <= 1.05 * lr
    if case == "encoder_rate":  # None: a tenth of learning_rate
        assert 0.99 * encoder_lr <= moved["encoder"] <= 1.05 * encoder_lr
    else:
        assert moved["encoder"] == 0.0
    groups = [len(g["params"]) for g in opt.adamw.param_groups]
    assert len(groups) == (1 if case == "frozen" else 2)
