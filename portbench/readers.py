"""What the per-layer metrics share: reading a run's record.

A run's record (``run.run_cell``) holds ``kind`` ('serve' or 'train'),
``config``, ``family``, ``rows`` (windows a dispatch or step carries),
``windows`` and ``elapsed`` (the measured window on the host clock), the
batcher's per-request lists (serve), and ``trace``, the device trace's
summary (``trace.read``) in a ``--trace 1`` run.  A reader returns None
where it finds nothing to read, and the metric is left out of the line.
"""

from __future__ import annotations

from portbench import counts

BOUNDS = {"k1": counts.k1, "k3": counts.k3, "k4bwd": counts.k4_backward}


def roofline(run: dict, kind: str, kernel: str):
    """Percent of the kernel's bound: launches times the bound of one launch
    at the cell's shape, over the kernel's device seconds in the trace."""
    if run["kind"] != kind or run["trace"] is None:
        return None
    seen = run["trace"]["kernels"][kernel]
    shape = run["family"].kernel_shapes(run["config"], run["rows"]).get(kernel)
    if shape is None or seen["launches"] == 0 or seen["seconds"] <= 0:
        return None
    return 100.0 * seen["launches"] * BOUNDS[kernel](*shape)["bound_s"] / seen["seconds"]


def mfu(run: dict, kind: str):
    """Percent of the bf16 tensor-core peak: model operations per window
    (``counts.flops_per_window``) times the windows of the measured window,
    over its length."""
    if run["kind"] != kind:
        return None
    ops = counts.flops_per_window(run["config"], training=kind == "train") * run["windows"]
    return 100.0 * ops / (run["elapsed"] * counts.PEAK_BF16_FLOPS)


def idle_pct(run: dict, kind: str):
    if run["kind"] != kind or run["trace"] is None:
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def batcher_mean(run: dict, key: str):
    values = run.get("batcher", {}).get(key) if run["kind"] == "serve" else None
    return sum(values) / len(values) if values else None


def optimizer_pct(run: dict):
    """Percent of the window's kernel time launched inside torch.optim's
    ``Optimizer.step#AdamW.step`` range."""
    t = run["trace"]
    if run["kind"] != "train" or t is None or t["kernel_s"] <= 0:
        return None
    return 100.0 * t["under_range"] / t["kernel_s"]
