"""Small configurations and mixes of the benchmark's cells for CPU tests."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
SMALL = {
    "dual_eeg": dict(in_channels=8, d_model=32, num_layers=1, num_heads=4, d_ff=64, window=256),
    "art": dict(in_channels=8, out_channels=8, embedding_size=32, num_encoder_layers=1,
                num_decoder_layers=1, num_heads=4, feedforward_size=64, window=128),
}
CONFIG = {"dual_eeg": "dualeeg-flagship-bf16", "art": "art-bf16"}
TRAIN = {"dual_eeg": "train-b256", "art": "train-b128-attn0"}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on a CPU with a lower quota than its core count slows down many
    times with one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_setup(family: str, kind: str, dtype: str = "bfloat16") -> dict:
    """A cell's setup at a size the CPU runs in seconds: its configuration
    with narrow widths, its mix with a few small requests or batches."""
    cfg = json.loads((HERE / "configs" / f"{CONFIG[family]}.json").read_text())
    cfg.update(SMALL[family], dtype=dtype)
    name = "serve-w128-c2" if kind == "serve" else TRAIN[family]
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if kind == "serve":
        mix.update(request_windows=4, pool_per_client=2, buckets=[1, 4], warmup_requests=1)
    else:
        mix.update(batch=8, pool_batches=4)
    return {"cell": {"chips": 1}, "config": cfg, "mix": mix, "per_layer": [], "end_to_end": [],
            "family": importlib.import_module(f"portbench.families.{family}")}
