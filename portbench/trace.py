"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

``Tracer`` profiles CPU ops and CUDA activity over the measured window,
which the main thread marks with the range ``portbench.window``.  ``read``
turns the profiler's raw events (not its per-event Python objects, which
cost about 0.1 ms each to build) into one summary:

- ``window_s``: the marked range's length; ``busy_s``: the union of every
  kernel, copy and set on the device inside it; device events clipped to it
  (the profiler also draws CPU ranges on the device's timeline, from their
  first kernel to their last: those are left out);
- ``device_ops``: device seconds by name, the ten largest;
- ``idle_gaps``: the ten longest stretches with nothing on the device, each
  named by what the host was doing at its middle: the shortest CPU op or
  CUDA runtime call that covers it, else ``host: Python (no traced op)``
  (ops of threads other than the main one are not recorded: CUDA's runtime
  calls are, from every thread);
- ``kernels``: for each kernel of the program that a metric reads
  (``KERNELS``), its launches and device seconds;
- ``under_range``: device seconds of kernels launched inside CPU ranges of
  the names in ``RANGES`` (torch.optim's own ``Optimizer.step#AdamW.step``);
- ``kernel_s``: device seconds of all kernels.
"""

from __future__ import annotations

import bisect
import re

import torch

WINDOW = "portbench.window"
# The program's kernels, by the name the CUDA runtime reports.
KERNELS = {
    "k1": "phase_metrics_kernel<false>",
    "k3": "attention_kernel_bf16<",
    "k4bwd": "attention_bwd_one_pass",
}
RANGES = ("Optimizer.step#AdamW.step",)
NO_OP = "host: Python (no traced op)"


class Tracer:
    """A context that profiles its body; ``summary`` holds ``read``'s result."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            act = torch.profiler.ProfilerActivity
            activities = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = read(self._prof.profiler.kineto_results.events())
        return False


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' parentheses and
    argument list, at most 64 characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:64]
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\(.*", "", name)[:64]


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events) -> dict:
    cpu, device = [], []
    windows = []
    for e in events:
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and e.is_user_annotation():
            continue  # a CPU range drawn on the device's timeline: no work of its own
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        if name == WINDOW:
            windows.append((s, s + d))
            continue
        (device if on_device else cpu).append((s, s + d, name, e.correlation_id()))
    if not windows:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    w0, w1 = windows[0]
    clipped = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _, _ in clipped])
    by_name, kernels = {}, {k: [0, 0.0] for k in KERNELS}
    for s, e, n, _ in clipped:
        by_name[_short(n)] = by_name.get(_short(n), 0.0) + (e - s) / 1e9
        for key, pattern in KERNELS.items():
            if pattern in n:
                kernels[key][0] += 1
                kernels[key][1] += (e - s) / 1e9
    kernel_s = sum((e - s) / 1e9 for s, e, n, _ in clipped
                   if not n.startswith(("Memcpy", "Memset")))
    # Kernels under the CPU ranges: launched (by correlation id) inside one.
    launches = {c: s for s, _, n, c in cpu if n.startswith("cuda") and c}
    ranges = sorted((s, e) for s, e, n, _ in cpu if n in RANGES)
    starts = [s for s, _ in ranges]
    under = 0.0
    for s, e, n, c in clipped:
        t = launches.get(c)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            under += (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    named_gaps = [[_host_at(cpu, (a + b) // 2), n / 1e9] for n, a, b in gaps[:10]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": kernel_s,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": named_gaps,
        "kernels": {k: {"launches": n, "seconds": t} for k, (n, t) in kernels.items()},
        "under_range": under,
    }


def _host_at(cpu: list, t: int) -> str:
    covering = [(e - s, n) for s, e, n, _ in cpu if s <= t <= e]
    return f"host: {min(covering)[1][:58]}" if covering else NO_OP
