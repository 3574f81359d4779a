"""Weights and signals made on the device from the seed, in a few large calls.

``make_params`` draws one normal vector for every parameter of a reference's
shape table and scales it leaf by leaf through one repeat of the per-leaf
standard deviations: kernels N(0, 1/fan_in), biases and the small type
embedding N(0, 0.02^2), norm gains 1 + N(0, 0.1^2), embeddings and the CLS
token N(0, 1).  Biases and gains are drawn away from 0 and 1 so that a
comparison sees every parameter.

``eeg`` makes EEG-like windows: per channel, four sinusoids of random
frequency in 1-45 Hz, amplitude and phase, plus white noise of std
``noise``, all drawn on the device.
"""

from __future__ import annotations

import math

import torch

STD = {"bias": 0.02, "small": 0.02, "norm_weight": 0.1, "normal": 1.0}
MEAN = {"norm_weight": 1.0}


def make_params(shapes: list, seed: int, device) -> dict:
    """{name: float32 tensor} on ``device`` from ``shapes`` [(name, shape, init)]."""
    counts = [math.prod(shape) for _, shape, _ in shapes]
    std = [1.0 / math.sqrt(math.prod(shape[1:])) if init == "fan_in" else STD[init]
           for _, shape, init in shapes]
    mean = [MEAN.get(init, 0.0) for _, _, init in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(counts), generator=gen, device=device)
    n = torch.tensor(counts, device=device)
    flat = flat * torch.tensor(std, device=device).repeat_interleave(n) \
        + torch.tensor(mean, device=device).repeat_interleave(n)
    return {name: part.view(shape)
            for (name, shape, _), part in zip(shapes, flat.split(counts))}


def eeg(gen: torch.Generator, rows: int, channels: int, t: int, fs: float,
        noise: float = 0.5, sines: int = 4) -> torch.Tensor:
    """(rows, channels, t) float32 on ``gen``'s device."""
    dev = gen.device
    shape = (rows, channels, sines, 1)
    freq = 1.0 + 44.0 * torch.rand(shape, generator=gen, device=dev)
    amp = 0.2 + 0.8 * torch.rand(shape, generator=gen, device=dev)
    phase = 2 * math.pi * torch.rand(shape, generator=gen, device=dev)
    time = torch.arange(t, device=dev, dtype=torch.float32) / fs
    x = torch.empty(rows, channels, t, device=dev)
    step = 256  # rows at a time: (step, C, sines, T) stays under 140 MB
    for r in range(0, rows, step):
        x[r:r + step] = (amp[r:r + step] * torch.sin(
            2 * math.pi * freq[r:r + step] * time + phase[r:r + step])).sum(2)
    return x + noise * torch.randn(rows, channels, t, generator=gen, device=dev)
