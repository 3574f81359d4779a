"""The training entry points under ``--mesh`` and ``--multihost`` on the CPU.

- ``train_dual_eeg --mesh dp2`` (two gloo ranks, spawned by the entry
  point) trains one epoch as the port's single-device run and the JAX
  script's ``--mesh`` run (its 8-device virtual mesh) do, from the same
  weights (the port's seeded initialization, carried into the JAX script
  by ``eyegaze_tpu.models.torch_port``): the last epoch's val accuracy at
  atol 1e-6 and train loss at rtol 1e-3, the bounds of
  tests/test_parallel.py:344-352.  The config is that test's at dropout 0
  with the bench's objective less the IBS cross entropy: the IBS head's
  fixed dropout of 0.3 draws other masks on each rank and in each
  framework, and the coupled alignment and contrastive terms are the ones
  the ranks must agree on.
- ``--multihost`` without torchrun's variables trains in one process, as
  ``--mesh dp1`` (one rank, DDP) does; with ``RANK`` set and
  ``MASTER_ADDR`` missing it raises; under ``torchrun`` each of two
  processes trains its shard and rank 0 alone writes.  ``dp2`` on a host without two cards
  raises; ``--mesh dp1,tp2`` (two gloo ranks, the Megatron layers of
  ``parallel/tensor.py``) trains one epoch as one device and as the JAX
  script's ``--mesh dp1,tp2`` run do, at the same bounds.
- Two ranks for gaze early fusion (its class-weighted cross entropy
  divides by the global batch's weights), the multimodal composite and
  HyperEEG at their ``--tiny`` sizes, dropout and augment off: one epoch's
  losses within rtol 1e-3 of one process's, its val metrics equal.  The
  composite runs its CLI with ``--mesh dp2``; gaze and HyperEEG have no
  flag that turns their augment or dropout off, so each rank runs their
  ``run`` with it patched out (``tests/_torch_parallel_ranks.py``).
- ``run_experiments --mesh`` passes the spec to every run.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import _torch_parallel_ranks as ranks
from eyegaze_tpu.models.torch_port import port_dual_eeg_state_dict
from eyegaze_tpu_torch import (
    parallel,
    train_dual_eeg,
    train_gaze,
    train_hypereeg,
    train_multimodal,
)
from eyegaze_tpu_torch.config import config_from_dict, load_yaml_config
from eyegaze_tpu_torch.parallel.multihost import TORCHRUN_VARS
from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LOSS_RTOL = 1e-3
ACC_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_torchrun(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)


def _flagship_config(tmp_path, tag):
    """tests/test_parallel.py:186-196 at dropout 0, CE + symmetry +
    alignment + contrastive (module docstring)."""
    cfg = {"model": {"in_channels": 8, "d_model": 32, "num_layers": 1, "num_heads": 4,
                     "d_ff": 64},
           "ablation": {"use_spectrogram": False, "use_ibs": True, "ibs_mode": "robust",
                        "use_cross_attention": False},
           "data": {"synthetic": True, "synthetic_trials": 9, "window_size": 256,
                    "stride": 384, "sampling_rate": 256.0},
           "training": {"num_train_epochs": 1, "per_device_train_batch_size": 8,
                        "per_device_eval_batch_size": 8, "bf16": False, "dropout": 0.0,
                        "output_dir": str(tmp_path / tag),
                        **{**BENCH_LOSSES, "use_ibs_cls_loss": False}},
           "system": {"seed": 42, "device": "cpu"}}
    path = tmp_path / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def _jax_mesh_run(tmp_path, cfg, mesh=None):
    """The JAX script's ``--mesh [mesh]`` run from the port's initial
    weights."""
    spec = importlib.util.spec_from_file_location("jax_train_dual_eeg_mesh",
                                                  ROOT / "scripts" / "train_dual_eeg.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    state = {k: v.numpy() for k, v in train_dual_eeg.build_model(
        config_from_dict(cfg), device=CPU).state_dict().items()}
    create = script.create_train_state

    def from_port_weights(model, variables, tx):
        return create(model, {"params": port_dual_eeg_state_dict(variables["params"], state)},
                      tx)

    script.create_train_state = from_port_weights
    _, path = _flagship_config(tmp_path, "jax_mesh" if mesh is None else f"jax_{mesh}")
    return script.main(["--config", path, "--mesh", *([mesh] if mesh else [])])


def _assert_same_epoch(got, want, keys=("train/loss",)):
    np.testing.assert_allclose(got["val/accuracy"], want["val/accuracy"], atol=ACC_ATOL)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_train_dual_eeg_mesh_dp2_matches_one_device_and_jax_mesh(tmp_path):
    cfg, single = _flagship_config(tmp_path, "single")
    one = train_dual_eeg.main(["--config", single, "--device", "cpu"])["history"][-1]
    _, path = _flagship_config(tmp_path, "dp2")
    two = train_dual_eeg.main(["--config", path, "--device", "cpu", "--mesh", "dp2"])
    assert len(two["history"]) == 1 and two["best_metric"] is not None
    assert (tmp_path / "dp2" / "checkpoints" / "best_model.pt").exists()
    two = two["history"][-1]
    losses = [k for k in one if k.startswith("train/loss")]
    assert {"train/loss_ibs_align", "train/loss_contrastive"} <= set(losses)
    _assert_same_epoch(two, one, losses)
    jax_mesh = _jax_mesh_run(tmp_path, cfg)["history"][-1]
    _assert_same_epoch(two, jax_mesh)
    _assert_same_epoch(one, jax_mesh)


def test_multihost_without_torchrun_is_mesh_dp1(tmp_path, monkeypatch):
    _, path = _flagship_config(tmp_path, "multihost")
    alone = train_dual_eeg.main(["--config", path, "--device", "cpu", "--multihost"])
    _, path1 = _flagship_config(tmp_path, "dp1")
    dp1 = train_dual_eeg.main(["--config", path1, "--device", "cpu", "--mesh", "dp1"])
    assert not parallel.active()
    got, want = alone["history"][-1], dp1["history"][-1]
    np.testing.assert_allclose(got["val/accuracy"], want["val/accuracy"], atol=ACC_ATOL)
    np.testing.assert_allclose(got["train/loss"], want["train/loss"], rtol=1e-6)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        train_dual_eeg.main(["--config", path, "--device", "cpu", "--multihost"])


def test_multihost_under_torchrun_trains_each_process_on_its_shard(tmp_path):
    """Two processes from ``torchrun --standalone`` (a free port on
    localhost), gloo on the CPU: each loads its half of the split's trials
    (3 train and 1 validation trial of 3 windows), rank 0 alone logs and
    writes the checkpoint."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    _, path = _flagship_config(tmp_path, "torchrun")
    torchrun = shutil.which("torchrun") or [sys.executable, "-m", "torch.distributed.run"]
    cmd = [*([torchrun] if isinstance(torchrun, str) else torchrun), "--standalone",
           "--nproc-per-node", "2", "-m", "eyegaze_tpu_torch.train_dual_eeg", "--config", path,
           "--device", "cpu", "--multihost"]
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**env, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[multihost] process 0/2" in r.stdout and "[multihost] process 1/2" in r.stdout
    assert r.stdout.count("[data] train windows: 9, val windows: 3") == 2
    assert r.stdout.count("[done] best f1:") == 1
    records = [json.loads(line) for line in (tmp_path / "torchrun" / "run.jsonl").open()]
    assert len(records) == 1 and np.isfinite(records[0]["train/loss"])
    assert (tmp_path / "torchrun" / "checkpoints" / "best_model.pt").exists()


def test_mesh_specs_the_port_refuses(tmp_path):
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        parallel.mesh_world("dp2", "cuda") if not torch.cuda.is_available() else \
            parallel.mesh_world(f"dp{torch.cuda.device_count() + 1}", "cuda")
    assert parallel.mesh_world("dp", "cpu") == 1 and parallel.mesh_world("dp3", "cpu") == 3
    # A tensor-parallel spec trains: as one device, and as JAX's tp run.
    cfg, single = _flagship_config(tmp_path, "single")
    one = train_dual_eeg.main(["--config", single, "--device", "cpu"])["history"][-1]
    _, path = _flagship_config(tmp_path, "tp2")
    tp = train_dual_eeg.main(["--config", path, "--device", "cpu", "--mesh", "dp1,tp2"])
    assert len(tp["history"]) == 1 and tp["best_metric"] is not None
    assert (tmp_path / "tp2" / "checkpoints" / "best_model.pt").exists()
    tp = tp["history"][-1]
    _assert_same_epoch(tp, one, [k for k in one if k.startswith("train/loss")])
    _assert_same_epoch(tp, _jax_mesh_run(tmp_path, cfg, "dp1,tp2")["history"][-1])


def _on_ranks(entry, mesh, *args, **kwargs):
    """``entry`` (a ``run`` of tests/_torch_parallel_ranks.py) in this
    process, or on the ranks of ``mesh``."""
    if mesh is None:
        return entry(*args, device=CPU, **kwargs)
    return parallel.fit_on_ranks(entry, parallel.mesh_world(mesh, CPU), CPU, *args, **kwargs)


def _gaze(tmp_path, tag, mesh):
    cfg = {"model": {"fusion_mode": "concat"}, "data": {"synthetic_trials": 30, "random_seed": 42},
           "training": {"output_dir": str(tmp_path / tag), "num_train_epochs": 1,
                        "per_device_train_batch_size": 4, "per_device_eval_batch_size": 4,
                        "learning_rate": 1e-3, "warmup_epochs": 1, "bf16": False,
                        "dropout": 0.0, "use_class_weights": True},
           "system": {"seed": 0, "device": "cpu", "mesh": mesh}}
    path = tmp_path / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return _on_ranks(ranks.gaze_without_augment, mesh, load_yaml_config(str(path)), "early",
                     tiny=True)


def _composite(tmp_path, tag, mesh):
    raw = yaml.safe_load(open(ROOT / "configs" / "multimodal_fuzzy_fusion.yaml"))
    raw["data"].update(synthetic_trials=10, window_size=512)
    raw["training"].update(output_dir=str(tmp_path / tag), dropout=0.0, bf16=False)
    raw["system"] = {"seed": 42, "device": "cpu"}
    path = tmp_path / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return train_multimodal.main(["--config", str(path), "--tiny", "--epochs", "1",
                                  "--device", "cpu", *(["--mesh", mesh] if mesh else [])])


def _hypereeg(tmp_path, tag, mesh):
    args = train_hypereeg.parse_args(["--tiny", "--epochs", "1", "--channels", "8",
                                      "--batch-size", "20", "--no-augment",
                                      "--output-dir", str(tmp_path / tag)])
    args.mesh = mesh
    return _on_ranks(ranks.hypereeg_without_dropout, mesh, args)


@pytest.mark.parametrize("entry", [_gaze, _composite, _hypereeg],
                         ids=["gaze_early", "composite", "hypereeg"])
def test_mesh_dp2_trains_as_one_process(tmp_path, entry):
    one = entry(tmp_path, "one", None)["history"][-1]
    two = entry(tmp_path, "dp2", "dp2")["history"][-1]
    losses = [k for k in one if k.startswith("train/loss")]
    assert "train/loss" in losses
    _assert_same_epoch(two, one, losses)
    for k in ("val/f1_macro", "val/accuracy"):
        np.testing.assert_allclose(two[k], one[k], atol=ACC_ATOL, err_msg=k)


def test_run_experiments_passes_the_mesh_through(capsys):
    from eyegaze_tpu_torch import run_experiments

    assert run_experiments.main(["--dry-run", "--experiments", "A", "--mesh", "dp2"]) == 0
    out = capsys.readouterr().out
    assert out.count("eyegaze_tpu_torch.train_dual_eeg --config") == out.count("--mesh dp2") == 5
