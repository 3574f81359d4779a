"""``python -m eyegaze_tpu_torch.train_multimodal`` on the CPU, at the
``--tiny`` sizes.

- ``--gaze-checkpoint`` / ``--eeg-checkpoint`` on the checkpoints of tiny
  port ``train_gaze --model early`` and ``train_dual_eeg`` runs: the
  matched counts printed (every gaze-encoder tensor; every EEG-encoder
  tensor but the positional table, 256 rows there and 512 here) and the
  matched tensors copied.
- ``--images`` / ``--eeg`` join converted gaze arrays to EEG splits by
  ``metadata_indices``, as the JAX script's ``build`` does.
- One epoch, its ``model.multimodal`` stamp, and its best_model.pt served
  back by ``MultimodalPredictor.from_checkpoint`` at the eval batch's size:
  logits equal to the bit to the trainer's own eval logits (bf16 both, the
  same ops on the same rows).  ``serve.sniff_kind`` reads the stamp.
- ``--resume`` continues from the saved epoch and train step; a
  tensor-parallel ``--mesh`` and ``--images`` without ``--eeg`` are refused.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from eyegaze_tpu.data.images import load_converted_gaze as jax_load_converted_gaze
from eyegaze_tpu.data.loader import MultimodalArrays as JaxMultimodalArrays
from eyegaze_tpu_torch import serve, train_dual_eeg, train_gaze, train_multimodal
from eyegaze_tpu_torch.config import config_from_dict, load_yaml_config
from eyegaze_tpu_torch.models.multimodal import FIELDS
from eyegaze_tpu_torch.serving import MultimodalPredictor

CPU = torch.device("cpu")
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "multimodal_fuzzy_fusion.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, **training):
    """The YAML at a small scale: 10 trials of 512 samples (8 train, 2
    validation windows), a periodic checkpoint every epoch."""
    raw = yaml.safe_load(open(CONFIG))
    raw["data"].update(synthetic_trials=10, window_size=512)
    raw["training"].update(output_dir=str(tmp_path / "run"), save_every_n_epochs=1, **training)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mm")
    config = _config(tmp)
    result = train_multimodal.main(["--config", config, "--tiny", "--epochs", "1",
                                    "--device", "cpu"])
    return tmp, config, result


def test_one_epoch_served_back_equals_the_eval(first_run):
    tmp, _, result = first_run
    trainer, val = result["trainer"], result["val"]
    assert len(val) == 2 and trainer.optimizer.count == 1  # 8 train windows, batch 8
    path = tmp / "run" / "checkpoints" / "best_model.pt"
    stamp = json.loads(path.with_suffix(".meta.json").read_text())["config"]["model"]["multimodal"]
    assert set(stamp) == set(FIELDS) and stamp["img_size"] == 64 and stamp["eeg_max_len"] == 512
    assert serve.sniff_kind(path) == "multimodal"
    pred = MultimodalPredictor.from_checkpoint(path, device=CPU, batch_buckets=(len(val),))
    for name in FIELDS:
        assert getattr(pred.model, name) == getattr(trainer.model, name), name
    rows = val.batch(list(range(len(val))))
    got = pred.predict(rows["img1"], rows["img2"], rows["eeg1"], rows["eeg2"])["logits"]
    np.testing.assert_array_equal(got, trainer.eval_logits)


def test_resume_continues_from_the_saved_epoch(first_run, tmp_path):
    _, config, first = first_run
    steps = first["trainer"].optimizer.count
    argv = ["--config", config, "--tiny", "--device", "cpu"]
    resumed = train_multimodal.main(argv + ["--epochs", "2", "--resume"])
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["trainer"].optimizer.count == 2 * steps
    # A tensor-parallel spec trains: two gloo ranks, half of each encoder's
    # heads and hidden units a rank.
    tp = train_multimodal.main(["--config", _config(tmp_path), "--tiny", "--device", "cpu",
                                "--epochs", "1", "--mesh", "dp1,tp2"])
    assert len(tp["history"]) == 1 and np.isfinite(tp["history"][0]["train/loss"])
    with pytest.raises(SystemExit):
        train_multimodal.main(argv + ["--images", "converted"])  # needs --eeg


@pytest.fixture(scope="module")
def encoder_checkpoints(tmp_path_factory):
    """Checkpoint dirs of a tiny train_gaze (early, concat) run and of a
    train_dual_eeg run at the composite's --tiny EEG widths."""
    tmp = tmp_path_factory.mktemp("encoders")
    gaze = config_from_dict({
        "model": {"fusion_mode": "concat", "img_size": 64},
        "data": {"synthetic_trials": 9, "val_pairs": [12, 13]},
        "training": {"output_dir": str(tmp / "gaze"), "num_train_epochs": 1,
                     "per_device_train_batch_size": 4, "bf16": False},
        "system": {"seed": 3}})
    train_gaze.run(gaze, "early", device=CPU, tiny=True)
    eeg = config_from_dict({
        "model": {"d_model": 64, "num_layers": 1, "num_heads": 4, "d_ff": 128},
        "data": {"synthetic_trials": 9},
        "training": {"output_dir": str(tmp / "eeg"), "num_train_epochs": 1,
                     "per_device_train_batch_size": 4, "bf16": False},
        "system": {"seed": 4}})
    train_dual_eeg.run(eeg, device=CPU)
    return tmp / "gaze" / "checkpoints", tmp / "eeg" / "checkpoints"


def test_pretrained_encoders_load_by_name_and_shape(encoder_checkpoints, tmp_path, capsys):
    gaze_dir, eeg_dir = encoder_checkpoints
    result = train_multimodal.main(["--config", _config(tmp_path), "--tiny", "--epochs", "0",
                                    "--device", "cpu", "--gaze-checkpoint", str(gaze_dir),
                                    "--eeg-checkpoint", str(eeg_dir)])
    model = result["trainer"].model
    out = capsys.readouterr().out
    for scope, ckpt, unmatched in (("gaze_encoder", gaze_dir, set()),
                                   ("eeg_encoder", eeg_dir, {"pos_embed.pos_embed.weight"})):
        own = model.get_submodule(scope).state_dict()
        n = len(own)
        assert f"[pretrained] {scope}: matched {n - len(unmatched)}/{n} params" in out
        src = torch.load(ckpt / "best_model.pt", weights_only=True)
        for k, v in own.items():
            if k in unmatched:
                assert src[k].shape != v.shape, k
            else:
                np.testing.assert_array_equal(v.numpy(), src[k].numpy(), err_msg=f"{scope}.{k}")


def test_converted_directories_join_by_metadata_indices(tmp_path):
    r = np.random.default_rng(7)
    images, eeg = tmp_path / "gaze", tmp_path / "eeg"
    images.mkdir()
    eeg.mkdir()
    n = 6
    for name, arr in (("img1", r.integers(0, 256, (n, 3, 8, 8), dtype=np.uint8)),
                      ("img2", r.integers(0, 256, (n, 3, 8, 8), dtype=np.uint8)),
                      ("label", (np.arange(n) % 3).astype(np.int32)),
                      ("pair", (12 + np.arange(n)).astype(np.int32))):
        np.save(images / f"{name}.npy", arr)
    for split, idx in (("train", [4, 0, 2, 5]), ("val", [3, 1])):
        k = len(idx)
        np.save(eeg / f"{split}_eeg1.npy", r.normal(size=(k, 4, 300)).astype(np.float32))
        np.save(eeg / f"{split}_eeg2.npy", r.normal(size=(k, 4, 300)).astype(np.float32))
        np.save(eeg / f"{split}_labels.npy", (np.asarray(idx) % 3).astype(np.int32))
        np.save(eeg / f"{split}_pairs.npy", (12 + np.asarray(idx)).astype(np.int32))
        (eeg / f"{split}_metadata.json").write_text(json.dumps({"metadata_indices": idx}))
    cfg = load_yaml_config(CONFIG)
    cfg.data.window_size, cfg.data.stride = 128, 64
    got = train_multimodal.prepare_data(cfg, str(images), str(eeg))
    for split, ds in zip(("train", "val"), got):
        meta = json.loads((eeg / f"{split}_metadata.json").read_text())
        gaze = jax_load_converted_gaze(str(images),
                                       indices=np.asarray(meta["metadata_indices"], np.int64))
        want = JaxMultimodalArrays(
            img1=gaze.img1, img2=gaze.img2, eeg1=np.load(eeg / f"{split}_eeg1.npy"),
            eeg2=np.load(eeg / f"{split}_eeg2.npy"), labels=np.load(eeg / f"{split}_labels.npy"),
            pairs=np.load(eeg / f"{split}_pairs.npy"), window_size=128, stride=64)
        items = list(range(len(want)))
        assert len(ds) == len(want)
        g, w = ds.batch(items), want.batch(items)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split} {k}")
