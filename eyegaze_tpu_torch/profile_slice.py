"""Where the serving paths' time goes on one CUDA device.

    python -m eyegaze_tpu_torch.profile_slice

It profiles both serving paths in turn, ART in float32 and in bf16 compute.

EEG: builds the full-width DualEEGTransformer (random weights from seed 0)
and serves raw (trials, 32, 3250) pairs through ``preprocess_eeg`` ->
``sliding_windows`` -> ``Predictor.predict``, as ``chip_smoke.py`` does.  For
requests of 1 and 16 trials (buckets 8 and 128) it prints the median
CUDA-event time of each stage at the request's padded bucket (preprocessing
of both players, the model's blocks, the whole forward).

ART: builds the full-width ART denoiser (``ArtConfig()``, random weights
from seed 0, float32 and then bf16 compute) behind ``ArtDenoiser``.  For
requests of 1 and 32 windows
(buckets 1 and 32) it prints the median CUDA-event time of the embeddings,
the encoder, the decoder, the reconstructor, the whole forward, and the
forward's 18 attention kernel launches alone.

For each request both print the median synchronized wall time and, from
``torch.profiler`` over 5 requests, the summed CUDA-kernel time against the
wall time (the device's busy share), the attention kernel's share of the
kernel time (ART), and the operators with the most device time.  TF32 is
off.  It needs a CUDA device.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.ops.connectivity import connectivity_matrices
from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows
from eyegaze_tpu_torch.serving import ArtDenoiser, Predictor, _bucket

CHANNELS, RAW_SAMPLES, WINDOW, STRIDE = 32, 3250, 1024, 512
BUCKETS = (1, 8, 32, 128)
REQUESTS = (1, 16)
ART_BUCKETS = (1, 8, 32)
ART_REQUESTS = (1, 32)


def median_cuda_ms(fn, reps: int = 10) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_and_profile(request, kernel_share: str | None = None) -> None:
    """Median wall time of 10 requests, then the profiler over 5."""
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        request()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"  request wall median {statistics.median(walls):.3f} ms over 10")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            request()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    print(f"  profiled 5 requests: wall {wall:.1f} ms, {len(kernels)} CUDA kernels, "
          f"summed kernel time {busy:.1f} ms, busy share {busy / wall:.0%}")
    if kernel_share:
        mine = sum(e.device_time for e in kernels if kernel_share in e.name) / 1e3
        print(f"  {kernel_share}: {mine:.1f} ms, {mine / busy:.0%} of the kernel time")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                    max_name_column_width=60))


def eeg(dev: torch.device) -> None:
    model = DualEEGTransformer(device=dev, generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, device=dev, batch_buckets=BUCKETS, preprocess=False)
    pred.warmup(CHANNELS, WINDOW)
    rng = np.random.default_rng(0)
    raw = [rng.normal(size=(max(REQUESTS), CHANNELS, RAW_SAMPLES)).astype(np.float32)
           for _ in range(2)]

    def windows(x: np.ndarray) -> torch.Tensor:
        x = preprocess_eeg(torch.from_numpy(x).to(dev), sampling_rate=256.0)
        return sliding_windows(x, WINDOW, STRIDE).reshape(-1, CHANNELS, WINDOW)

    for trials in REQUESTS:
        def request():
            return pred.predict(windows(raw[0][:trials]), windows(raw[1][:trials]))

        request()
        w1, w2 = windows(raw[0][:trials]), windows(raw[1][:trials])
        b = _bucket(len(w1), BUCKETS)
        p1, p2 = (torch.cat([w, w.new_zeros((b - len(w),) + w.shape[1:])]) for w in (w1, w2))
        tokens = torch.randn(b, 139, model.cls_token.shape[-1], device=dev)
        stages = {
            "preprocess + windows, both players": lambda: (windows(raw[0][:trials]),
                                                           windows(raw[1][:trials])),
            "model forward": lambda: model(p1, p2),
            "  spectrogram tokens, both streams": lambda: (model.spectrogram_generator(p1),
                                                           model.spectrogram_generator(p2)),
            "  encoder, both streams": lambda: (model.encoder(tokens), model.encoder(tokens)),
            "  connectivity matrices (K1 inside)": lambda: connectivity_matrices(p1, p2, 256.0),
            "  temporal conv, both streams": lambda: (model.temporal_conv(p1),
                                                      model.temporal_conv(p2)),
        }
        print(f"--- EEG, {trials} trial(s) = {len(w1)} windows, bucket {b}: "
              "median CUDA-event ms")
        with torch.inference_mode():
            for name, fn in stages.items():
                print(f"  {name}: {median_cuda_ms(fn):.3f}")
        wall_and_profile(request)


def art(dev: torch.device, dtype: torch.dtype) -> None:
    model = ArtifactRemovalTransformer(ArtConfig(), device=dev, dtype=dtype,
                                       generator=torch.Generator().manual_seed(0))
    den = ArtDenoiser(model, device=dev, batch_buckets=ART_BUCKETS)
    den.warmup(CHANNELS, WINDOW)
    noisy = np.random.default_rng(0).normal(
        size=(max(ART_REQUESTS), CHANNELS, WINDOW)).astype(np.float32)
    heads = model.config.num_heads
    d_k = model.config.embedding_size // heads

    for n in ART_REQUESTS:
        b = _bucket(n, ART_BUCKETS)
        x = torch.from_numpy(noisy[:b]).to(dev)
        with torch.inference_mode():
            src, tgt = model.src_embed(x), model.tgt_embed(x)
            memory = model.encoder(src)
            out = model.decoder(tgt, memory)
            qkv = [torch.randn(b, WINDOW, heads, d_k, device=dev, dtype=dtype) for _ in range(3)]
            stages = {
                "model forward": lambda: model(x),
                "  embeddings, src and tgt": lambda: (model.src_embed(x), model.tgt_embed(x)),
                "  encoder, 6 layers": lambda: model.encoder(src),
                "  decoder, 6 layers": lambda: model.decoder(tgt, memory),
                "  reconstructor": lambda: model.reconstructor(out),
                "  18 attention kernel launches alone": lambda: [
                    attention.headpacked_attention(*qkv, 1.0 / math.sqrt(d_k))
                    for _ in range(18)],
            }
            print(f"--- ART ({str(dtype)[6:]} compute), {n} window(s), bucket {b}: "
                  "median CUDA-event ms")
            for name, fn in stages.items():
                print(f"  {name}: {median_cuda_ms(fn):.3f}")
        wall_and_profile(lambda: den.predict(noisy[:n]), kernel_share="attention_kernel")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    eeg(dev)
    for dtype in (torch.float32, torch.bfloat16):
        art(dev, dtype)


if __name__ == "__main__":
    main()
