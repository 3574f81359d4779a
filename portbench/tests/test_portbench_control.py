"""The comparison that decides ``correct`` fails what it has to fail.

At small sizes on the CPU, with the cells' own limits:

- the control, the reference computed with float8 operands in the
  program's place, fails a serve cell's ``answer_gap`` and a train cell's
  numbers (the readings ``portbench.calibrate`` takes on the card at the
  cells' sizes);
- a run whose timed path is broken underneath comes out with ``correct``
  false, for each fault a cell can have: an answer altered where it is
  produced, half of a request's rows left out, a stale answer (serving);
  a step that leaves its state unchanged, and half of the batch left out
  with the mean taken over the rest (training).  The harness's look for a
  card is skipped: ``run_cell`` is driven on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

from portbench import calibrate, compare, run
from portbench.tests.conftest import small_setup

CPU = torch.device("cpu")
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _args(seed=SEEDS[0]):
    return argparse.Namespace(seed=seed, seconds=0.5, trace=0)


@pytest.mark.parametrize("family", ["dual_eeg", "art"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_serving(family, seed):
    setup = small_setup(family, "serve")
    gaps = calibrate.serve_control(setup, seed, CPU)
    checks = compare.judge(gaps, setup["config"]["limits"]["serve"])
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.parametrize("family", ["dual_eeg", "art"])
def test_control_fails_training(family):
    setup = small_setup(family, "train")
    readings = calibrate.train_readings(setup, SEEDS[0], CPU)
    for name in ("control", "half_batch"):
        checks = compare.judge(readings[name], setup["config"]["limits"]["train"])
        assert not all(c["ok"] for c in checks.values()), (name, checks)


class Broken:
    """A predictor whose answers are spoiled where they are produced."""

    def __init__(self, inner, fault: str, answer_key: str):
        self.inner, self.fault, self.key, self.last = inner, fault, answer_key, None
        self.buckets = inner.buckets

    def predict(self, *arrays):
        out = self.inner.predict(*arrays)
        value = out[self.key]
        if self.fault == "altered":
            value[len(value) // 2] += np.abs(value).max()
        elif self.fault == "half_rows":
            half = len(value) // 2
            value[half:] = value[:len(value) - half]
        elif self.fault == "stale":
            value, self.last = (self.last if self.last is not None else value), value.copy()
        out[self.key] = value
        return out


@pytest.mark.parametrize("family,key", [("dual_eeg", "logits"), ("art", "denoised")])
@pytest.mark.parametrize("fault", ["altered", "half_rows", "stale"])
def test_a_broken_serving_path_is_not_correct(family, key, fault, monkeypatch):
    setup = small_setup(family, "serve")
    fam = setup["family"]
    real = fam.predictor
    monkeypatch.setattr(fam, "predictor", lambda *a: Broken(real(*a), fault, key))
    result, _ = run.run_cell(setup, _args(), CPU)
    assert result["correct"] is False


@pytest.mark.parametrize("family", ["dual_eeg", "art"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(family, fault, monkeypatch):
    from eyegaze_tpu_torch.train.optim import Optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer

    if fault == "unchanged":
        monkeypatch.setattr(Optimizer, "step", lambda self: torch.zeros(()))
    else:
        step = Trainer.train_step

        def half(self, batch):
            n = len(next(iter(batch.values()))) // 2
            return step(self, {k: v[:n] for k, v in batch.items()})

        monkeypatch.setattr(Trainer, "train_step", half)
    result, _ = run.run_cell(small_setup(family, "train"), _args(), CPU)
    assert result["correct"] is False
