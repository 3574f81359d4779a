"""The harness on the CPU: names resolve, the closed loop counts, a run
without a card gives no result, and the result line has the contract's keys."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, trace
from portbench.tests.conftest import small_setup

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FAMILY_API = ("program_model", "predictor", "requests", "answer", "reference_serve",
              "train_batch", "objective", "reference_loss", "shapes", "kernel_shapes")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    setup = run.resolve(cell)
    for name in FAMILY_API:
        assert callable(getattr(setup["family"], name)), name
    assert setup["mix"]["kind"] in ("serve", "train")
    assert set(setup["config"]["limits"][setup["mix"]["kind"]])
    reported = {m["name"] for m in setup["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert setup["per_layer"]
    for m in setup["per_layer"]:
        reader = run.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.SOURCE, reader.MOVES) == \
            (m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert m["moves"] in reported


def test_every_metric_file_is_declared():
    declared = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert files == declared


class StubBatcher:
    """Answers after ``delay`` seconds; records overlapping calls per client."""

    def __init__(self, delay: float):
        self.delay, self.lock, self.active, self.overlap = delay, threading.Lock(), {}, 0

    def predict(self, x):
        me = threading.current_thread().name
        with self.lock:
            self.overlap += self.active.get(me, 0)
            self.active[me] = 1
        time.sleep(self.delay)
        with self.lock:
            self.active[me] = 0
        return {"logits": x[:, :3].copy()}


def test_closed_loop_counts_requests_and_latencies():
    batcher = StubBatcher(0.01)
    pools = [[(np.full((4, 5), 10 * c + s, np.float32),) for s in range(3)] for c in range(2)]
    schedule = run.Schedule({"loop": "closed"}, None)
    start, window = threading.Event(), {}
    clients = [run.Client(i, pool, batcher, schedule, start, window, lambda o: o["logits"], 2, i)
               for i, pool in enumerate(pools)]
    for c in clients:
        c.start()
    window["start"] = time.perf_counter()
    window["end"] = window["start"] + 0.3
    start.set()
    for c in clients:
        c.join(timeout=5)
        assert not c.is_alive()
    assert batcher.overlap == 0  # a client never has two requests out
    for c in clients:
        assert 10 <= len(c.records) <= 31
        for (due, done, rows), nxt in zip(c.records, c.records[1:]):
            assert rows == 4 and done - due >= 0.01 and nxt[0] >= done
        assert len(c.kept) == 2
        for slot, out in c.kept:  # each client got its own rows back
            assert np.all(out == 10 * c.index + slot)


def test_open_loop_sends_on_its_schedule():
    import random

    schedule = run.Schedule({"loop": "open", "rate_per_s": 200.0, "schedule_seconds": 1.0},
                            random.Random(1))
    assert 150 < len(schedule.offsets) < 250
    t0 = time.perf_counter()
    dues = []
    while (due := schedule.take(t0, t0 + 0.2)) is not None:
        dues.append(due)
    assert dues == sorted(dues) and all(d < t0 + 0.2 for d in dues)
    assert time.perf_counter() >= dues[-1]


def test_a_run_without_a_card_gives_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("kind,trace", [("serve", 0), ("serve", 1), ("train", 0), ("train", 1)])
def test_result_line_has_the_contract_keys(kind, trace):
    setup = small_setup("dual_eeg", kind)
    setup["end_to_end"] = [m for m in BENCH["end_to_end"]
                           if m["name"] == "setup_s" or kind in m["name"]]
    setup["per_layer"] = [m for m in BENCH["per_layer"] if m["name"].endswith(kind)]
    args = argparse.Namespace(seed=2 ** 31 + 7, seconds=0.5, trace=trace)
    result, checks = run.run_cell(setup, args, torch.device("cpu"))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(checks)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in result["metrics"]
        assert any(k.endswith("_per_s") for k in result["metrics"])
    json.dumps(result)


class Event:
    """The parts of a profiler event that ``trace.read`` uses."""

    def __init__(self, name, start, end, device=False, annotation=False, corr=0):
        self._name, self.start, self.end = name, start, end
        self.device, self.annotation, self.corr = device, annotation, corr

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self.device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def correlation_id(self):
        return self.corr


def test_trace_counts_work_on_the_device_and_not_its_annotations():
    events = [
        Event(trace.WINDOW, 0, 1000),
        Event(trace.WINDOW, 100, 950, device=True, annotation=True),
        Event("cudaLaunchKernel", 100, 110, corr=3),
        Event("void phase_metrics_kernel<false>(float const*)", 100, 300, device=True, corr=3),
        Event("Optimizer.step#AdamW.step", 500, 700),
        Event("cudaLaunchKernel", 510, 520, corr=7),
        Event("Optimizer.step#AdamW.step", 600, 900, device=True, annotation=True),
        Event("adam_kernel", 600, 650, device=True, corr=7),
        Event("Memcpy HtoD (Pageable -> Device)", 850, 1100, device=True),
    ]
    out = trace.read(events)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["busy_s"] == pytest.approx((200 + 50 + 150) * 1e-9)  # the copy clipped at 1000
    assert out["kernel_s"] == pytest.approx(250e-9)
    assert out["under_range"] == pytest.approx(50e-9)
    assert out["kernels"]["k1"] == {"launches": 1, "seconds": pytest.approx(200e-9)}
    assert [name for name, _ in out["device_ops"]] == [
        "phase_metrics_kernel<false>", "Memcpy HtoD (Pageable -> Device)", "adam_kernel"]
    assert out["idle_gaps"][0] == [trace.NO_OP, pytest.approx(300e-9)]  # 300-600 ns


@pytest.mark.cuda
def test_one_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "art.serve-w128-c2", "--seed", "2147483650", "--seconds", "3",
                           "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
