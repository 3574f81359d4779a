"""Flagship training in the port against the JAX package, and its entry points.

At a small geometry (C 8, T 256, d_model 32, 1 layer): JAX parameters from
``model.init`` are carried into the port with ``dual_eeg_state_dict_from_flax``
and both sides run the bench's objective (CE + 0.1 symmetry + 0.1 IBS
alignment + 0.3 IBS-CE + 0.1 IBS contrastive), float32, without dropout
(the JAX model deterministic, every port ``nn.Dropout`` at p = 0: dropout
masks cannot match across frameworks, docs/PARITY.md).

- One step: the loss within the forward's 2e-3; every gradient tensor, put
  through the same converter to the torch names, within 1e-4 of its largest
  |value| (the same float32 math summed in another order: about 1e-6 seen,
  1.1e-5 at most).  The key projections' biases are the exception: softmax
  is invariant under a shift of a row's scores, so their gradient is zero
  in exact arithmetic and rounding noise in both frameworks; they are held
  to 1e-6 of the largest gradient of the model.
- Three ``Trainer`` steps on one batch: each loss within 2e-3 of JAX's
  ``Trainer``.  Adam divides by the gradient's running RMS, so a gradient
  entry that is rounding noise can move its parameter by up to the LR in
  either framework; at LR 1e-3 over two updates the losses drift far less
  than the forward's tolerance.
- A checkpoint the port's trainer writes is served by
  ``Predictor.from_checkpoint`` and, imported by
  ``scripts/import_torch_checkpoint.py``, by JAX's ``Predictor``: bf16 on
  both sides, logits within 2**-5 of the largest |logit|, the bound of
  tests/test_torch_checkpoint.py.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu.serving import Predictor as JaxPredictor
from eyegaze_tpu.train import losses as jax_losses
from eyegaze_tpu.train.optim import make_optimizer as jax_make_optimizer
from eyegaze_tpu.train.state import create_train_state
from eyegaze_tpu.train.trainer import Trainer as JaxTrainer
from eyegaze_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from eyegaze_tpu_torch import train_dual_eeg
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.kernels import phase_metrics
from eyegaze_tpu_torch.models.convert import dual_eeg_state_dict_from_flax
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.serving import Predictor
from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
C, T, B = 8, 256, 6
CPU = torch.device("cpu")
MODEL = {"in_channels": C, "num_labels": 3, "d_model": 32, "num_layers": 1, "num_heads": 4,
         "d_ff": 64, "conv_kernel_size": 7, "conv_stride": 4, "conv_layers": 2}
GEOMETRY = dict(in_channels=C, num_classes=3, d_model=32, num_layers=1, num_heads=4, d_ff=64,
                max_len=128, conv_kernel_size=7, conv_stride=4, conv_layers=2)
TOL = 2e-3
GRAD_SHARE = 1e-4
SHARE = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, n=B):
    r = np.random.default_rng(seed)
    e1, e2 = (r.normal(size=(n, C, T)).astype(np.float32) for _ in range(2))
    return {"eeg1": e1, "eeg2": e2, "label": (np.arange(n) % 3).astype(np.int32)}


def _jax_loss(jm):
    def loss_fn(params, batch):
        out = jm.apply({"params": params}, jnp.asarray(batch["eeg1"]),
                       jnp.asarray(batch["eeg2"]), deterministic=True)
        labels = jnp.asarray(batch["label"])
        loss = jax_losses.cross_entropy(out["logits"], labels)
        loss += 0.1 * jax_losses.symmetry_loss(out["cls1"], out["cls2"])
        loss += 0.1 * jax_losses.ibs_alignment_loss(out["ibs_token"], out["cls1"], out["cls2"])
        loss += 0.3 * jax_losses.cross_entropy(out["ibs_logits"], labels)
        loss += 0.1 * jax_losses.ibs_contrastive_loss(out["ibs_token"], labels)
        return loss, {"logits": out["logits"]}
    return loss_fn


def _without_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _port_model(params, dtype=torch.float32):
    model = DualEEGTransformer(**GEOMETRY, dropout=0.0, device=CPU, dtype=dtype,
                               generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           dual_eeg_state_dict_from_flax(params).items()}, strict=True)
    return _without_dropout(model)


def _objective():
    return train_dual_eeg.make_objective(config_from_dict({"training": BENCH_LOSSES}))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_pair():
    jm = JaxDualEEG(**GEOMETRY, dropout=0.0)
    z = jnp.zeros((1, C, T), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)
    return jm, variables, jax.tree_util.tree_map(np.asarray, variables["params"])


def test_one_train_step_matches_jax(jax_pair):
    jm, _, params = jax_pair
    batch = _batch(3)
    (want_loss, _), grads = jax.jit(jax.value_and_grad(_jax_loss(jm), has_aux=True))(
        params, batch)
    want = dual_eeg_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))

    model = _port_model(params).train()
    loss_fn, _ = _objective()
    loss, aux = loss_fn(model, _tensors(batch))
    assert set(aux) == {"logits", "loss_ce", "loss_sym", "loss_ibs_align", "loss_ibs_cls",
                        "loss_contrastive"}
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        if k.endswith("k_proj.bias"):  # zero in exact arithmetic (module docstring)
            np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-6 * largest, err_msg=k)
        else:
            np.testing.assert_allclose(g, want[k], rtol=0, atol=GRAD_SHARE * np.abs(want[k]).max(),
                                       err_msg=k)


def test_k1_outputs_carry_no_graph_in_a_train_step(jax_pair, monkeypatch):
    """K1 reads only the EEG windows: in a train-mode forward with
    autograd on, its outputs have no grad_fn, so it needs no backward."""
    _, _, params = jax_pair
    seen = []
    launch = phase_metrics.phase_metric_sums

    def recording(*args):
        out = launch(*args)
        seen.extend(out)
        return out

    monkeypatch.setattr(phase_metrics, "phase_metric_sums", recording)
    model = _port_model(params).train()
    loss, _ = _objective()[0](model, _tensors(_batch(4)))
    assert loss.requires_grad and len(seen) == 3
    assert all(t.grad_fn is None and not t.requires_grad for t in seen)


def test_trainer_steps_track_jax_trainer(jax_pair):
    jm, variables, params = jax_pair
    batch = _batch(5)
    jax_loss = _jax_loss(jm)
    jtrainer = JaxTrainer(
        create_train_state(jm, variables, jax_make_optimizer(1e-3, 0.01, grad_clip=1.0)),
        lambda p, b, rng, step: jax_loss(p, b), None, JaxTrainerConfig(prefetch=0))
    model = _port_model(params)
    loss_fn, eval_fn = _objective()
    trainer = Trainer(model, make_optimizer(model, 1e-3, 0.01, grad_clip=1.0), loss_fn,
                      eval_fn, TrainerConfig(prefetch=0), device=CPU)
    got, want = [], []
    for step in range(3):
        want.append(jtrainer.train_epoch(iter([batch]), step))
        got.append(trainer.train_epoch(iter([batch]), step))
    assert trainer.optimizer.count == 3
    for g, w in zip(got, want):
        for k in ("train/loss", "train/grad_norm", "train/accuracy"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=k)
    assert got[2]["train/loss"] < got[0]["train/loss"]  # it trains


def test_eval_after_a_step_serves_the_new_weights(jax_pair):
    """bf16 layers keep their weight casts between inference-mode forwards
    (``cast_params``); after an optimizer step an evaluation must use the
    new weights: its logits equal a fresh model's loaded from the new
    state_dict."""
    _, _, params = jax_pair
    model = _port_model(params, torch.bfloat16)
    loss_fn, eval_fn = _objective()
    trainer = Trainer(model, make_optimizer(model, 1e-2), loss_fn, eval_fn, TrainerConfig(),
                      device=CPU)
    batch = _batch(6)
    trainer.evaluate([batch])
    before = trainer.eval_logits
    trainer.train_step(_tensors(batch))
    trainer.evaluate([batch])
    after = trainer.eval_logits
    fresh = DualEEGTransformer(**GEOMETRY, device=CPU, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(2)).eval()
    fresh.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        want = eval_fn(fresh, _tensors(batch)).numpy()
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_array_equal(after, want)
    assert model.training  # evaluate puts train mode back


def _tiny_config(tmp_path, **training):
    return {"model": MODEL,
            "data": {"window_size": T, "stride": T, "synthetic": True, "synthetic_trials": 9},
            "training": {"output_dir": str(tmp_path / "run"), "num_train_epochs": 2,
                         "per_device_train_batch_size": 8, "per_device_eval_batch_size": 8,
                         "learning_rate": 1e-3, "bf16": True, "save_every_n_epochs": 1,
                         **BENCH_LOSSES, **training},
            "system": {"seed": 0, "device": "cpu"}}


def test_fit_writes_a_checkpoint_both_frameworks_serve(tmp_path):
    cfg = config_from_dict(_tiny_config(tmp_path))
    result = train_dual_eeg.run(cfg, device=CPU)
    trainer = result["trainer"]
    ckpt = tmp_path / "run" / "checkpoints"
    assert (ckpt / "best_model.pt").exists() and (ckpt / "best_metric.json").exists()
    assert trainer.ckpt.load_meta("best_model")["config"]["model"]["d_model"] == 32
    assert trainer.ckpt.latest_epoch() == 1
    steps = trainer.optimizer.count
    assert steps == 2 * (24 // 8)  # 6 train trials x 4 windows, drop remainder

    _, val = train_dual_eeg.prepare_datasets(cfg)
    windows = val.batch(list(range(len(val))))
    pred = Predictor.from_checkpoint(ckpt / "best_model.pt", device=CPU, batch_buckets=(16,))
    got = pred.predict(windows["eeg1"], windows["eeg2"])["logits"]
    assert got.shape == (12, 3) and np.isfinite(got).all()
    best_epoch = trainer.ckpt.load_meta("best_model")["epoch"]
    if best_epoch == 1:  # the last evaluation's model is the served one
        np.testing.assert_allclose(got, trainer.eval_logits, rtol=0,
                                   atol=SHARE * np.abs(trainer.eval_logits).max())

    spec = importlib.util.spec_from_file_location(
        "import_torch_checkpoint", ROOT / "scripts" / "import_torch_checkpoint.py")
    importer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(importer)
    assert importer.main([str(ckpt / "best_model.pt"), "--out", str(tmp_path / "jax"),
                          "--num-heads", "4", "--conv-stride", "4"]) == 0
    want = JaxPredictor.from_checkpoint(tmp_path / "jax" / "best_model",
                                        batch_buckets=(16,)).predict(
        windows["eeg1"], windows["eeg2"])["logits"]
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())

    cfg.training.num_train_epochs = 3
    resumed = train_dual_eeg.run(cfg, device=CPU, resume=True)
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert resumed["trainer"].optimizer.count == steps + steps // 2


def _run(*args, timeout=300):
    # One intra-op thread, as the in-process tests pin: torch's default
    # thread count oversubscribes the test lane's workers.
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_train_entry_point_on_the_cpu(tmp_path):
    import yaml

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(_tiny_config(tmp_path, num_train_epochs=5)))
    r = _run("eyegaze_tpu_torch.train_dual_eeg", "--config", str(path), "--device", "cpu",
             "--epochs", "1", "--batch-size", "4", "--synthetic-trials", "9")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[done] best f1:" in r.stdout and "[model] " in r.stdout
    assert (tmp_path / "run" / "checkpoints" / "best_model.pt").exists()
    # A tensor-parallel spec trains (two gloo ranks: the config's device is
    # the CPU), in bf16.
    r = _run("eyegaze_tpu_torch.train_dual_eeg", "--config", str(path), "--mesh", "dp1,tp2",
             "--epochs", "1")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("[done] best f1:") == 1


def test_run_experiments_lists_and_dry_runs():
    r = _run("eyegaze_tpu_torch.run_experiments", "--list")
    assert r.returncode == 0 and r.stdout.count("\n") == 13
    r = _run("eyegaze_tpu_torch.run_experiments", "--dry-run", "--experiments", "A", "--yes")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("eyegaze_tpu_torch.train_dual_eeg --config") == 5
    assert "PASS  A5_full_model" in r.stdout
