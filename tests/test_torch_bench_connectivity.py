"""The port's connectivity shootout (``eyegaze_tpu_torch.bench_connectivity``),
the counterpart of ``scripts/bench_pallas.py``, run on the CPU at a tiny
shape: every key of its JSON line, differences within the bounds that
chip_smoke.py holds it to on the card."""

import json

import pytest
import torch

from eyegaze_tpu_torch import bench_connectivity
from eyegaze_tpu_torch.kernels import phase_metrics

KEYS = {"shape", "plain_ms", "kernel_ms", "speedup_kernel_over_plain", "max_abs_diff", "winner",
        "plv4_production_ms", "plv5_widened_ms", "plv_widened_speedup", "plv_max_abs_diff",
        "plv_winner", "coherence_6pass_ms", "coherence_fused_ms", "coherence_speedup",
        "coherence_max_abs_diff", "device"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cpu_run_reports_every_key_within_bounds(capsys):
    before = dict(phase_metrics.launch_count)
    result = bench_connectivity.main(["--batch", "2", "--channels", "8", "--time", "256",
                                      "--iters", "2", "--device", "cpu"])
    assert phase_metrics.launch_count == before  # plain versions on the CPU
    assert set(result) == KEYS
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert result["shape"] == [2, 8, 256] and result["device"] == "cpu"
    assert result["max_abs_diff"] <= 1.1e-4
    assert result["plv_max_abs_diff"] <= 1e-5
    assert result["coherence_max_abs_diff"] <= 1e-5
    assert all(result[k] > 0 for k in KEYS if k.endswith("_ms"))


def test_tf32_flags_are_restored():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        bench_connectivity.main(["--batch", "1", "--channels", "4", "--time", "128",
                                 "--iters", "1", "--device", "cpu"])
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_refuses_to_run_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_connectivity.main(["--batch", "1", "--channels", "4", "--time", "128"])
