"""ART training in the port against the JAX package, and its data.

- K3's backward: ``attention_backward_reference`` against ``jax.vjp`` of
  the JAX ``headpacked_attention`` (its forward the Pallas kernel in
  interpret mode, its backward the ``custom_vjp``'s einsum), on the same
  numpy operands and output gradient.  f32: the same float32 math summed
  in another order, 1e-5 of each gradient's largest |value|.  bf16: both
  compute in f32 from the same bf16 operands and round each gradient once
  to bf16, so they differ by at most one bf16 step (2**-8 relative) where
  the f32 sums straddle a rounding boundary: 2**-7 of the largest |value|.
- The autograd Function on the CPU (its forward the plain twin) against
  autograd through the twin: 1e-5 relative, f32.
- One dropout-free step of the ``--tiny`` geometry (8 channels, T 256)
  against ``jax.value_and_grad`` of the JAX ``art_loss``, for both
  ``loss_zscore`` values, at tests/test_torch_trainer.py's bounds: the loss
  within 2e-3, every gradient tensor within 1e-4 of its largest |value|
  (those zero in exact arithmetic, the key projections' biases and under
  the z-scored loss the final norm's and the head's biases, to 1e-6 of the
  largest gradient).  The same step with the attention calls sent through
  the Function gives the plain path's gradients to 1e-5.
- The Trainer's ``eval_metrics_fn``: the plain mean over batches of each
  per-batch value, and the best checkpoint by the lowest loss.
- ``data/art_data.py`` and ``data/native.py`` against the JAX modules: equal
  to the bit, a real Brain/noise tree of ``.npy`` and ``.csv`` files included.
- ``python -m eyegaze_tpu_torch.train_art --tiny`` trains on the CPU and
  writes a checkpoint that ``ArtDenoiser.from_checkpoint`` serves (bf16):
  within 2**-5 of the largest output of the trained model in f32.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.data import art_data as jax_art_data
from eyegaze_tpu.data import native as jax_native
from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.art import art_loss as jax_art_loss
from eyegaze_tpu.ops.attn_kernels import headpacked_attention as jax_headpacked
from eyegaze_tpu_torch import train_art
from eyegaze_tpu_torch.data import art_data, native
from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models import transformer
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer, art_loss
from eyegaze_tpu_torch.models.convert import art_state_dict_from_flax
from eyegaze_tpu_torch.serving import ArtDenoiser
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
C, T, B = 8, 256, 4
TINY = dict(in_channels=C, out_channels=C, embedding_size=32, num_encoder_layers=1,
            num_decoder_layers=1, num_heads=4, feedforward_size=64, max_len=T)
TOL = 2e-3
GRAD_SHARE = 1e-4
SHARE = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_reference_matches_jax_vjp(dtype):
    shape, scale = (2, 128, 4, 16), 0.25
    q, k, v, g = (_normal(shape, seed) for seed in range(4))
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, b, c: jax_headpacked(a, b, c, scale, True),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g, jdt))]
    tdt = getattr(torch, dtype)
    got = attention.attention_backward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, g)), scale)
    share = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == tdt and a.shape == shape
        np.testing.assert_allclose(a.float().numpy(), w, rtol=0,
                                   atol=share * np.abs(w).max(), err_msg=f"d{name}")


def test_function_on_cpu_matches_autograd_of_the_twin():
    q, k, v = (torch.from_numpy(_normal((2, 64, 2, 16), seed)).requires_grad_()
               for seed in range(3))
    g = torch.from_numpy(_normal((2, 64, 2, 16), 3))
    before = dict(attention.backward_count)
    out = attention.headpacked_attention(q, k, v, 0.25)
    assert type(out.grad_fn).__name__ == "_HeadpackedAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), g)
    assert attention.backward_count["headpacked_attention"] == (
        before["headpacked_attention"] + 1)
    ref = attention.attention_reference(*(x.transpose(1, 2) for x in (q, k, v)),
                                        0.25).transpose(1, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    with torch.no_grad():  # no graph, no Function
        assert attention.headpacked_attention(q, k, v, 0.25).grad_fn is None


@pytest.fixture(scope="module")
def tiny_params():
    z = jnp.zeros((1, C, T), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(JaxArt(JaxArtConfig(**TINY)).init)(
        jax.random.PRNGKey(0), z, z)["params"])


def _port(params, **cfg):
    model = ArtifactRemovalTransformer(ArtConfig(**TINY, **cfg), device=CPU,
                                       generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           art_state_dict_from_flax(params).items()}, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model.train()


def _art_batch(seed):
    ds = train_art.build_dataset(B, C, T, seed=seed)
    return ds.arrays


def _grads(model, batch, loss_zscore):
    loss_fn, _ = train_art.make_objective(loss_zscore)
    loss, aux = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux == {}
    loss.backward()
    return loss.item(), {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("loss_zscore", [False, True])
def test_one_tiny_step_matches_jax(tiny_params, loss_zscore):
    batch = _art_batch(3)
    jm = JaxArt(JaxArtConfig(**TINY))

    def jax_loss(params):
        recon = jm.apply({"params": params}, jnp.asarray(batch["input_values"]),
                         jnp.asarray(batch["labels"]), deterministic=True)
        return jax_art_loss(recon, jnp.asarray(batch["labels"]), loss_zscore=loss_zscore)

    want_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(tiny_params)
    want = art_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    loss, got = _grads(_port(tiny_params), batch, loss_zscore)
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL, atol=TOL)
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    # Zero in exact arithmetic: the key biases (softmax ignores a shift of a
    # row's scores) and, under the z-scored loss, every parameter that only
    # shifts each output channel by a constant over time.
    zero = ("k_proj.bias",) + (("decoder.norm.bias", "reconstructor.proj.bias")
                               if loss_zscore else ())
    for k, g in got.items():
        share = 1e-6 * largest if k.endswith(zero) else GRAD_SHARE * np.abs(want[k]).max()
        np.testing.assert_allclose(g, want[k], rtol=0, atol=share, err_msg=k)


def test_tiny_step_through_the_function_matches_the_plain_path(tiny_params, monkeypatch):
    """The attention calls of a train step sent through the autograd
    Function (as the route does on the card) give the plain path's loss and
    gradients; each of the 3 calls runs one backward."""
    batch = _art_batch(4)
    want_loss, want = _grads(_port(tiny_params), batch, False)

    def headpacked(*args, has_mask, dropout_active, return_weights):
        return "plain" if has_mask or dropout_active or return_weights else "headpacked"

    monkeypatch.setattr(transformer, "attention_route", headpacked)
    before = attention.backward_count["headpacked_attention"]
    loss, got = _grads(_port(tiny_params), batch, False)
    assert attention.backward_count["headpacked_attention"] == before + 3
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    largest = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        share = 1e-6 * largest if k.endswith("k_proj.bias") else 1e-5 * np.abs(want[k]).max()
        np.testing.assert_allclose(g, want[k], rtol=0, atol=share, err_msg=k)


def test_eval_metrics_are_the_plain_mean_over_batches(tiny_params):
    """Batches of 4 and 2 rows: a metric that is each batch's row count
    averages to 3 (weighted by rows it would be 10 / 3), and the loss and
    SNR metrics are the means of the per-batch values of the objective's
    ``eval_metrics_fn``, which match the JAX script's formulas."""
    model = _port(tiny_params)
    loss_fn, metrics_fn = train_art.make_objective(False)

    def with_rows(m, batch):
        return {**metrics_fn(m, batch), "rows": torch.tensor(float(len(batch["labels"])))}

    trainer = Trainer(model, make_optimizer(model, 1e-3), loss_fn, None,
                      TrainerConfig(prefetch=0), device=CPU, eval_metrics_fn=with_rows)
    data = train_art.build_dataset(6, C, T, seed=5).arrays
    batches = [{k: v[:4] for k, v in data.items()}, {k: v[4:6] for k, v in data.items()}]
    got = trainer.evaluate(batches)
    assert model.training  # evaluate puts train mode back
    assert got["val/rows"] == 3.0

    jm = JaxArt(JaxArtConfig(**TINY))
    want = {"loss": [], "snr_in_db": [], "snr_out_db": []}
    for b in batches:
        x, y = jnp.asarray(b["input_values"]), jnp.asarray(b["labels"])
        recon = jm.apply({"params": tiny_params}, x, y)
        want["loss"].append(float(jax_art_loss(recon, y)))
        sig = jnp.sum(y ** 2)
        for name, est in (("snr_in_db", x), ("snr_out_db", recon)):
            want[name].append(float(10.0 * jnp.log10(sig / (jnp.sum((est - y) ** 2) + 1e-12))))
    for name, values in want.items():
        np.testing.assert_allclose(got[f"val/{name}"], np.mean(values), rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got["val/snr_improvement_db"],
                               got["val/snr_out_db"] - got["val/snr_in_db"], atol=1e-5)


def test_best_checkpoint_is_the_lowest_loss(tiny_params, tmp_path):
    losses = iter([2.0, 1.0, 1.5])
    model = _port(tiny_params)
    loss_fn, _ = train_art.make_objective(False)
    trainer = Trainer(
        model, make_optimizer(model, 1e-3), loss_fn, None,
        TrainerConfig(num_epochs=3, metric_for_best="loss", greater_is_better=False,
                      checkpoint_dir=str(tmp_path), prefetch=0),
        device=CPU, eval_metrics_fn=lambda m, b: {"loss": torch.tensor(next(losses))})
    batch = {k: v[:2] for k, v in _art_batch(6).items()}
    result = trainer.fit(lambda epoch: [batch], lambda: [batch], config_dict={"model": TINY})
    assert result["best_metric"] == 1.0
    assert trainer.ckpt.load_meta("best_model")["epoch"] == 1
    assert [h["val/loss"] for h in result["history"]] == [2.0, 1.0, 1.5]
    with pytest.raises(ValueError, match="not both"):
        Trainer(model, make_optimizer(model, 1e-3), loss_fn, lambda m, b: None, TrainerConfig(),
                device=CPU, eval_metrics_fn=lambda m, b: {})


@pytest.mark.parametrize("loss_zscore", [False, True])
def test_art_loss_matches_jax(loss_zscore):
    a, b = _normal((3, C, 64), 7), _normal((3, C, 64), 8)
    want = float(jax_art_loss(jnp.asarray(a), jnp.asarray(b), loss_zscore=loss_zscore))
    got = art_loss(torch.from_numpy(a), torch.from_numpy(b), loss_zscore=loss_zscore).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_art", ROOT / "scripts" / "train_art.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_art_data_equal_to_the_bit():
    want = _jax_script().build_dataset(5, C, T, seed=3).arrays
    got = train_art.build_dataset(5, C, T, seed=3).arrays
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for seed in (42, None):
        a = jax_art_data.synthetic_art_split(3, C=4, T=64, seed=seed, attr={"mode": "mixed"},
                                             target={"mode": "sine"})
        b = art_data.synthetic_art_split(3, C=4, T=64, seed=seed, attr={"mode": "mixed"},
                                         target={"mode": "sine"})
        if seed is not None:
            for k in a.arrays:
                np.testing.assert_array_equal(b.arrays[k], a.arrays[k])
    config = {"data": {"C": 4, "T": 64, "splits": {"train": {"length": 3},
                                                   "val": {"length": 2, "T": 32}}}}
    want = jax_art_data.build_art_datasets(config, seed=1)
    got = art_data.build_art_datasets(config, seed=1)
    for split in ("train", "val", "test"):
        assert len(got[split]) == len(want[split])
        for k in want[split].arrays:
            np.testing.assert_array_equal(got[split].arrays[k], want[split].arrays[k])
    assert art_data.NOISE_CATEGORIES == jax_art_data.NOISE_CATEGORIES


def _write_csv(path, arr):
    path.write_text("\n".join(",".join(f"{v:.6f}" for v in row) for row in arr) + "\n")


def test_real_art_split_equal_to_the_bit(tmp_path):
    r = np.random.default_rng(9)
    for split, names in (("train", ["a.npy", "b.csv", "c.npy", "d.csv"]), ("val", ["e.npy"])):
        brain = tmp_path / split / "Brain"
        brain.mkdir(parents=True)
        for i, name in enumerate(names):
            for cat in art_data.NOISE_CATEGORIES[: 3 + i]:  # some noise variants missing
                arr = r.normal(size=(4, 40)).astype(np.float32)
                if name == "c.npy":
                    arr = arr.T  # stored (T, C)
                d = tmp_path / split / cat
                d.mkdir(exist_ok=True)
                if name.endswith(".npy"):
                    np.save(d / name, arr)
                else:
                    _write_csv(d / name, arr)
    for seed in (42, 7):
        want = jax_art_data.real_art_split(tmp_path, "train", seed=seed)
        got = art_data.real_art_split(tmp_path, "train", seed=seed)
        assert got.arrays["labels"].shape == (4, 4, 40)
        for k in want.arrays:
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k], err_msg=k)
    got = art_data.real_art_split(tmp_path, "train", max_files=2)
    assert len(got) == 2
    with pytest.raises(ValueError, match="extension"):
        art_data.read_eeg(tmp_path / "x.txt")
    np.save(tmp_path / "square.npy", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="C < T"):
        art_data.read_eeg(tmp_path / "square.npy")


def test_native_csv_loader_matches_the_jax_module_and_its_twin(tmp_path):
    arr = np.random.default_rng(10).normal(size=(6, 50)).astype(np.float32)
    path = tmp_path / "trial.csv"
    _write_csv(path, arr)
    assert native.native_available() == jax_native.native_available()
    got, rows, cols = native.load_csv_f32(path, max_rows=8, max_cols=64)
    want, w_rows, w_cols = jax_native.load_csv_f32(path, max_rows=8, max_cols=64)
    assert (rows, cols) == (w_rows, w_cols) == (6, 50)
    np.testing.assert_array_equal(got, want)
    twin, t_rows, t_cols = native.numpy_parse(path, 8, 64)
    assert (t_rows, t_cols) == (6, 50)
    np.testing.assert_allclose(got, twin, rtol=1e-5)  # %.6f parsed by two float scanners
    np.testing.assert_allclose(got[:6, :50], arr, atol=1e-6)
    assert not got[6:].any() and not got[:, 50:].any()
    if native.native_available():  # built into the port's build directory, not beside the source
        assert list((ROOT / "eyegaze_tpu_torch" / "_build").glob("csv_loader-*.so"))


def test_train_art_writes_a_checkpoint_art_denoiser_serves(tmp_path):
    args = train_art.parse_args(["--tiny", "--epochs", "2", "--trials", "10", "--length",
                                 str(T), "--channels", str(C), "--batch-size", "4",
                                 "--attn-dropout", "0.0", "--output-dir", str(tmp_path / "art")])
    result = train_art.run(args, device=CPU)
    trainer, val = result["trainer"], result["val"]
    assert trainer.optimizer.count == 2 * 2 and len(val) == 2
    history = result["history"]
    assert {"val/loss", "val/snr_in_db", "val/snr_out_db", "val/snr_improvement_db",
            "train/loss", "train/grad_norm"} <= set(history[0])
    assert result["best_metric"] == min(h["val/loss"] for h in history)
    ckpt = tmp_path / "art" / "checkpoints"
    meta = json.loads((ckpt / "best_model.meta.json").read_text())
    assert meta["config"]["model"]["attn_dropout"] == 0.0
    assert meta["config"]["model"]["embedding_size"] == 32

    den = ArtDenoiser.from_checkpoint(ckpt / "best_model.pt", device=CPU, batch_buckets=(2,))
    assert den.model.dtype == torch.bfloat16
    got = den.predict(val.arrays["input_values"])["denoised"]
    model = ArtifactRemovalTransformer(ArtConfig(**meta["config"]["model"]), device=CPU,
                                       generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(torch.load(ckpt / "best_model.pt", weights_only=True), strict=True)
    with torch.inference_mode():
        want = model(torch.from_numpy(val.arrays["input_values"])).numpy()
    assert got.shape == want.shape == (2, C, T)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_train_art_entry_point_on_the_cpu(tmp_path):
    r = _run("eyegaze_tpu_torch.train_art", "--tiny", "--epochs", "1", "--trials", "8",
             "--length", "256", "--device", "cpu", "--output-dir", str(tmp_path / "art"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[model] ART: " in r.stdout and "[done] best val loss:" in r.stdout
    assert "val/snr_improvement_db=" in r.stdout
    assert (tmp_path / "art" / "checkpoints" / "best_model.pt").exists()
    # A tensor-parallel spec trains (two gloo ranks, 2 of the 4 heads each).
    r = _run("eyegaze_tpu_torch.train_art", "--tiny", "--epochs", "1", "--trials", "8",
             "--length", "256", "--device", "cpu", "--mesh", "dp1,tp2", "--output-dir",
             str(tmp_path / "art_tp"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("[done] best val loss:") == 1
    assert (tmp_path / "art_tp" / "checkpoints" / "best_model.pt").exists()
