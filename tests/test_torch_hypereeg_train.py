"""HyperEEG training in the port: the EEG augment, the loss against the JAX
script's, and ``python -m eyegaze_tpu_torch.train_hypereeg`` on the CPU.

- ``augment_eeg`` and its parts, drawn from a ``torch.Generator``: time
  masks of 1 to 50 samples, the inclusive start range [0, T - 50] (the last
  start is drawn, the last sample masked), channel drops at a rate within
  0.015 of 0.2 over 16,000 channels (4.7 standard deviations), noise of
  std within 1% of 0.05 and mean within 1e-3 of 0 over 524,288 samples,
  the same draw for the same seed, and ``augment_eeg`` the three in JAX's
  order.
- The loss of ``train_hypereeg.make_objective`` with the augment off on the
  ``--tiny`` model (8 channels, dropout 0, float32) against
  ``jax.value_and_grad`` of ``scripts/train_hypereeg.py``'s loss on the
  same converted weights and batch: the loss within 1e-5 relative, every
  gradient tensor within 1e-4 of its largest |entry| (the bounds of
  tests/test_torch_trainer.py); the key projections' and ``logvar``'s
  biases, zero in exact arithmetic (a shift of a row's scores, a common
  scale of both variances), within 1e-4 of the largest gradient entry.
- One ``--tiny`` epoch: the split (pairs 33-40 held out), the
  ``model.hypereeg`` stamp, best_model.pt served back by
  ``HyperEEGPredictor.from_checkpoint`` (bf16) within 2**-5 of the largest
  |logit| of the trainer's float32 eval logits, ``serve --kind hypereeg``'s
  predictor equal to it; the per-step LR of a 3-epoch run against JAX's
  ``warmup_cosine_schedule``; a tensor-parallel ``--mesh`` refused.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models import hypereeg as jax_hypereeg
from eyegaze_tpu.train.losses import cross_entropy as jax_cross_entropy
from eyegaze_tpu.train.optim import warmup_cosine_schedule as jax_warmup_cosine
from eyegaze_tpu_torch import serve, train_hypereeg
from eyegaze_tpu_torch.data import augment
from eyegaze_tpu_torch.models import convert, hypereeg
from eyegaze_tpu_torch.serving import HyperEEGPredictor

CPU = torch.device("cpu")
SHARE = 2.0 ** -5
GRAD_SHARE = 1e-4
# Zero in exact arithmetic: the softmax ignores a shift of a row's scores,
# the fusion weight a common scale of both variances.
ZERO_GRADS = ("key.bias", "logvar.bias")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _spans(masked: torch.Tensor):
    """(first masked index, masked count) per row of a (B, T) bool tensor."""
    return masked.float().argmax(dim=1), masked.sum(dim=1)


def test_time_mask_spans_and_the_inclusive_start_range():
    x = torch.ones(4000, 2, 60)
    masked = augment.time_masking(_gen(0), x, max_length=50, num_masks=1)[:, 0] == 0
    first, count = _spans(masked)
    assert count.min() >= 1 and count.max() <= 50
    last = first + count - 1
    assert (masked.float().cumsum(1).gather(1, last[:, None])[:, 0] == count).all()  # contiguous
    assert first.min() == 0 and first.max() == 60 - 50  # the last start is drawn
    assert masked[:, -1].any()
    two = augment.time_masking(_gen(1), torch.ones(500, 1, 1024))[:, 0] == 0  # 2 masks of <= 50
    assert two.sum(dim=1).min() >= 1 and two.sum(dim=1).max() <= 100


def test_channel_drop_rate_and_noise_std():
    kept = augment.channel_dropout(_gen(2), torch.ones(500, 32, 4))
    assert ((kept == 0).all(dim=2) | (kept == 1).all(dim=2)).all()  # whole channels
    assert abs(float((kept[..., 0] == 0).float().mean()) - 0.2) < 0.015
    noise = augment.gaussian_noise(_gen(3), torch.zeros(64, 32, 256))
    assert abs(float(noise.std()) / 0.05 - 1) < 0.01 and abs(float(noise.mean())) < 1e-3


def test_same_seed_same_draw_and_jax_order():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 4, 200)).astype(np.float32))
    a, b = augment.augment_eeg(_gen(5), x), augment.augment_eeg(_gen(5), x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(a, augment.augment_eeg(_gen(6), x))
    g = _gen(5)
    replay = augment.gaussian_noise(g, augment.channel_dropout(g, augment.time_masking(g, x)))
    np.testing.assert_array_equal(a.numpy(), replay.numpy())


def test_loss_and_gradients_match_the_jax_script():
    args = train_hypereeg.parse_args(["--tiny", "--channels", "8", "--device", "cpu"])
    r = np.random.default_rng(7)
    e1, e2 = (r.normal(size=(4, 8, 256)).astype(np.float32) for _ in range(2))
    labels = np.array([0, 1, 2, 1], np.int32)
    jm = jax_hypereeg.create_hypereeg_model("full", in_channels=8, dropout=0.0,
                                            **train_hypereeg.TINY)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), e1, e2)[
        "params"])

    def jax_loss(p):  # scripts/train_hypereeg.py's loss_fn, the augment off
        out = jm.apply({"params": p}, e1, e2, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_cross_entropy(out["logits"], jnp.asarray(labels))

    want_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = convert.hypereeg_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))

    model = train_hypereeg.build_model(args, device=CPU, dropout=0.0)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           convert.hypereeg_state_dict_from_flax(params).items()}, strict=True)
    loss_fn, _ = train_hypereeg.make_objective(augment=False, generator=_gen(0))
    loss, aux = loss_fn(model.train(), {"eeg1": torch.from_numpy(e1),
                                        "eeg2": torch.from_numpy(e2),
                                        "label": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert aux["loss_ce"] is loss
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    largest = max(np.abs(g).max() for g in want.values())
    for k, g in got.items():
        atol = GRAD_SHARE * (largest if k.endswith(ZERO_GRADS) else np.abs(want[k]).max())
        np.testing.assert_allclose(g, want[k], rtol=0, atol=atol, err_msg=k)


def test_one_tiny_epoch_served_back(tmp_path):
    out = tmp_path / "run"
    result = train_hypereeg.main(["--tiny", "--epochs", "1", "--channels", "8", "--device",
                                  "cpu", "--output-dir", str(out)])
    trainer, val = result["trainer"], result["val"]
    assert len(val) == 8 and trainer.optimizer.count == 1  # 40 train windows, one batch
    assert set(np.unique(val.pairs)) <= set(range(33, 41))
    path = out / "checkpoints" / "best_model.pt"
    stamp = json.loads(path.with_suffix(".meta.json").read_text())["config"]["model"]["hypereeg"]
    assert stamp == {f: getattr(trainer.model, f) for f in hypereeg.FIELDS}
    assert serve.sniff_kind(path) == "hypereeg"
    pred = HyperEEGPredictor.from_checkpoint(path, device=CPU, batch_buckets=(8,))
    rows = val.batch(list(range(len(val))))
    got = pred.predict(rows["eeg1"], rows["eeg2"])["logits"]
    want = trainer.eval_logits
    assert got.shape == want.shape == (8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())
    served = serve.build_predictor("hypereeg", path, (8,), CPU)
    np.testing.assert_array_equal(served.predict(rows["eeg1"], rows["eeg2"])["logits"], got)
    # A tensor-parallel spec trains: two gloo ranks, the graph block's
    # attention 2 of its 4 heads each.
    tp = train_hypereeg.main(["--tiny", "--epochs", "1", "--channels", "8", "--mesh", "dp1,tp2",
                              "--device", "cpu", "--output-dir", str(out / "tp")])
    assert len(tp["history"]) == 1 and np.isfinite(tp["history"][0]["train/loss"])


def test_per_step_lr_follows_the_jax_schedule(tmp_path):
    result = train_hypereeg.main(["--tiny", "--epochs", "3", "--warmup-epochs", "1",
                                  "--no-augment", "--channels", "8", "--device", "cpu",
                                  "--output-dir", str(tmp_path)])
    opt = result["trainer"].optimizer
    assert opt.count == 3  # one step an epoch
    schedule = jax_warmup_cosine(5e-4, 1, 3)
    for k in range(opt.count):
        np.testing.assert_allclose(opt._lr(opt.lrs[0], k), float(schedule(k)), rtol=1e-5,
                                   atol=1e-9)
