"""Where the serving paths' and the train steps' time goes on one CUDA
device.

    python -m eyegaze_tpu_torch.profile_slice           # serving: EEG, ART, gaze, composite
    python -m eyegaze_tpu_torch.profile_slice --train   # the train steps
    python -m eyegaze_tpu_torch.profile_slice --features   # the offline feature extractor

It profiles the EEG and ART serving paths in turn, each in float32 and
then in bf16 compute (the type the JAX package's ``from_checkpoint``
serves), then the gaze ViTs and the multimodal composite in bf16.

EEG: builds the full-width DualEEGTransformer (random weights from seed 0)
and serves raw (trials, 32, 3250) pairs through ``preprocess_eeg`` ->
``sliding_windows`` -> ``Predictor.predict``, as ``chip_smoke.py`` does.  For
requests of 1 and 16 trials (buckets 8 and 128) it prints the median
CUDA-event time of each stage at the request's padded bucket (preprocessing
of both players, the model's blocks, the whole forward), the CUDA kernels
of the spectrogram stage and of its first conv alone (one input channel) by
device time (their names say which convolution algorithm cuDNN picked),
and, as a diagnostic the port leaves off, the
spectrogram stage's time with ``torch.backends.cudnn.benchmark`` on.

ART: builds the full-width ART denoiser (``ArtConfig()``, random weights
from seed 0, float32 and then bf16 compute) behind ``ArtDenoiser``.  For
requests of 1 and 32 windows
(buckets 1 and 32) it prints the median CUDA-event time of the embeddings,
the encoder, the decoder, the reconstructor, the whole forward, and the
forward's 18 attention kernel launches alone.

Gaze: the early- (concat) and late-fusion (full) ViT-B/16 at full width
(random weights from seed 5, bf16 compute, as ``GazePredictor.
from_checkpoint`` serves them) behind ``GazePredictor``, for requests of 1
and 32 uint8 pairs (buckets 1 and 32): the median CUDA-event time of the
forward on the normalized images and of one encoder pass.

Composite: the multimodal fuzzy-gating model at full width (ViT-B/16 early
fusion + the flagship EEG encoder + the gate, random weights from seed 11,
bf16) behind ``MultimodalPredictor``, for requests of 1 and 32 pairs of
uint8 images and (32, 1024) windows: the median CUDA-event time of the
gaze encoder, the EEG encoder (K1 inside), the gate and the whole forward,
and K1's share of the kernel time.

For each request all three print the median synchronized wall time and, from
``torch.profiler`` over 5 requests, the summed CUDA-kernel time against the
wall time (the device's busy share), the attention kernel's share of the
kernel time (ART), and the operators with the most device time.

``--train``: the flagship's train step at full width as the JAX bench
takes it (batch 64 of (32, 1024) window pairs, CE + 0.1 sym + 0.1 align +
0.3 IBS-CE + 0.1 contrastive, AdamW at 1e-4 with clip 1.0, dropout 0.1),
in bf16 and then float32 compute: the median CUDA-event time of the
forward (loss included), the backward and the optimizer (clip + AdamW)
over 10 steps, and from ``torch.profiler`` over 5 synchronized steps the
busy share, K1's share of the kernel time and the top operators.  Then
ART's train step the same way (``eyegaze_tpu_torch.train_art``'s recipe:
full width, batch 16 of (32, 1024) pairs, dropout 0.1, AdamW at 1e-4 with
clip 1.0), in float32 and then in bf16 compute (``bench.py``'s bf16 ART
steps), each with attention dropout 0.1 (the plain attention path) and 0.0
(K3 under autograd: in f32 with its stock-op backward, in bf16 with K4's
backward kernels), and the shares of the attention kernel's forward and of
the backward kernels.
Then the ViT-B/16 train step of ``eyegaze_tpu_torch.train_gaze`` (bf16,
batch 16 of uint8 pairs, dropout 0.1, the augment on the card,
class-weighted CE, AdamW at 1e-4 with clip 1.0), early (concat) and late
(full) fusion.

``--features``: the offline feature extractor (``extract_eeg_features``)
on synthetic (32, 3250) trial pairs at fs 250, at chunks of 8 and 1 trials:
the median CUDA-event time and the CUDA kernels of each stage of one
chunk (the Welch PSD; the five bands' filtfilts in one blocked recurrence,
and one band at a time for comparison; the Hilbert parts; the three
metric sets; the whole chunk), the host's time to enqueue a chunk, and
trials per second over FEATURE_TRIALS trials with the writes asynchronous
(as the entry point writes), synchronous (each chunk copied and written in
the loop) and left out, in turns.

TF32 is off.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from eyegaze_tpu_torch import train_art, train_gaze
from eyegaze_tpu_torch.config import ExperimentConfig, ModelConfig, TrainingConfig
from eyegaze_tpu_torch.data.image_fusion import imagenet_normalize
from eyegaze_tpu_torch.data.metadata import class_weights
from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.ops.connectivity import connectivity_matrices
from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows
from eyegaze_tpu_torch.ops.spectral import stft_log_magnitude
from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
from eyegaze_tpu_torch.models.vit import EarlyFusionViT, LateFusionViT
from eyegaze_tpu_torch.serving import (
    ArtDenoiser,
    GazePredictor,
    MultimodalPredictor,
    Predictor,
    _bucket,
)
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES, build_model, make_objective

CHANNELS, RAW_SAMPLES, WINDOW, STRIDE = 32, 3250, 1024, 512
BUCKETS = (1, 8, 32, 128)
REQUESTS = (1, 16)
ART_BUCKETS = (1, 8, 32)
ART_REQUESTS = (1, 32)
GAZE_BUCKETS = (1, 8, 32)
GAZE_REQUESTS = (1, 32)
TRAIN_BATCH = 64
ART_TRAIN_BATCH = 16
GAZE_TRAIN_BATCH = 16
FEATURE_TRIALS = 64
FEATURE_FS = 250.0
FEATURE_ROUNDS = 3


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


def wall_and_profile(request, kernel_share: tuple[str, ...] = ()) -> None:
    """Median wall time of 10 requests, then the profiler over 5 (a request
    ends in a wait on the device), with the share of the kernel time of the
    kernels whose names hold each of ``kernel_share``."""
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
    for name in kernel_share:
        mine = sum(e.device_time for e in kernels if name in e.name) / 1e3
        print(f"  {name}: {mine:.1f} ms, {mine / busy:.0%} of the kernel time")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                    max_name_column_width=60))


def kernel_table(fn, rows: int = 8) -> None:
    """The CUDA kernels of one call of ``fn`` by device time, from
    ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.device_time / 1e3
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1])[:rows]:
        print(f"    {ms:8.3f} ms  {name[:110]}")


def eeg(dev: torch.device, dtype: torch.dtype) -> None:
    model = DualEEGTransformer(device=dev, dtype=dtype,
                               generator=torch.Generator().manual_seed(0))
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
        tokens = torch.randn(b, 139, model.cls_token.shape[-1], device=dev, dtype=dtype)
        spec = model.spectrogram_generator
        mag = stft_log_magnitude(p1.reshape(-1, WINDOW), spec.n_fft, spec.hop_length,
                                 spec.freq_bins, window=spec.window)[:, None]
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
        print(f"--- EEG ({str(dtype)[6:]} compute), {trials} trial(s) = {len(w1)} windows, "
              f"bucket {b}: median CUDA-event ms")
        with torch.inference_mode():
            for name, fn in stages.items():
                print(f"  {name}: {median_cuda_ms(fn):.3f}")
            spectrogram = stages["  spectrogram tokens, both streams"]
            print("  spectrogram tokens' CUDA kernels, one call (device ms):")
            kernel_table(spectrogram)
            print(f"  its first conv alone, one stream ({tuple(mag.shape)} -> 32 channels), "
                  "CUDA kernels of one call (device ms):")
            kernel_table(lambda: spec.spec_conv[0](mag), rows=4)
            torch.backends.cudnn.benchmark = True
            try:
                print(f"  spectrogram tokens with cudnn.benchmark on (not the port's "
                      f"setting): {median_cuda_ms(spectrogram):.3f}")
                kernel_table(spectrogram, rows=4)
            finally:
                torch.backends.cudnn.benchmark = False
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
        wall_and_profile(lambda: den.predict(noisy[:n]), kernel_share=("attention_kernel",))


def gaze(dev: torch.device) -> None:
    for cls, mode in ((EarlyFusionViT, "concat"), (LateFusionViT, "full")):
        model = cls(fusion_mode=mode, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(5))
        pred = GazePredictor(model, device=dev, batch_buckets=GAZE_BUCKETS)
        pred.warmup()
        r = np.random.default_rng(0)
        a, b = (r.integers(0, 256, size=(max(GAZE_REQUESTS), 3, 224, 224), dtype=np.uint8)
                for _ in range(2))
        encoder = model.backbone if cls is EarlyFusionViT else model.encoder
        for n in GAZE_REQUESTS:
            x1, x2 = (torch.from_numpy(x[:n]).to(dev).float() / 255.0 for x in (a, b))
            with torch.inference_mode():
                one = torch.cat([x1, x2], 1) if cls is EarlyFusionViT else x1
                stages = {"model forward": lambda: model(x1, x2),
                          "  one encoder pass": lambda: encoder(one)}
                print(f"--- {cls.__name__} ({mode}, bf16 compute), {n} pair(s), bucket "
                      f"{_bucket(n, GAZE_BUCKETS)}: median CUDA-event ms")
                for name, fn in stages.items():
                    print(f"  {name}: {median_cuda_ms(fn):.3f}")
            wall_and_profile(lambda: pred.predict(a[:n], b[:n]))


def multimodal(dev: torch.device) -> None:
    model = MultimodalFusionModel(device=dev, dtype=torch.bfloat16,
                                  generator=torch.Generator().manual_seed(11))
    pred = MultimodalPredictor(model, device=dev, batch_buckets=GAZE_BUCKETS)
    pred.warmup()
    r = np.random.default_rng(0)
    n_max = max(GAZE_REQUESTS)
    a, b = (r.integers(0, 256, size=(n_max, 3, 224, 224), dtype=np.uint8) for _ in range(2))
    e1, e2 = (r.normal(size=(n_max, CHANNELS, WINDOW)).astype(np.float32) for _ in range(2))
    for n in GAZE_REQUESTS:
        x1, x2 = (imagenet_normalize(torch.from_numpy(x[:n]).to(dev).float() / 255.0)
                  for x in (a, b))
        w1, w2 = (torch.from_numpy(x[:n]).to(dev) for x in (e1, e2))
        with torch.inference_mode():
            img_logits = model.gaze_encoder(x1, x2)
            eeg_logits = model.eeg_encoder(w1, w2)["logits"]
            stages = {"model forward": lambda: model(x1, x2, w1, w2),
                      "  gaze encoder (ViT-B/16, early fusion)": lambda: model.gaze_encoder(x1, x2),
                      "  EEG encoder (K1 inside)": lambda: model.eeg_encoder(w1, w2),
                      "  fuzzy gate": lambda: model.fusion(img_logits, eeg_logits)}
            print(f"--- multimodal composite (bf16 compute), {n} pair(s), bucket "
                  f"{_bucket(n, GAZE_BUCKETS)}: median CUDA-event ms")
            for name, fn in stages.items():
                print(f"  {name}: {median_cuda_ms(fn):.3f}")
        wall_and_profile(lambda: pred.predict(a[:n], b[:n], e1[:n], e2[:n]),
                         kernel_share=("phase_metrics_kernel",))


def train_step_profile(title: str, model, opt, loss_fn, batch,
                       kernel_share: tuple[str, ...]) -> None:
    """Median CUDA-event ms of the forward (loss included), the backward
    and the optimizer over 10 steps, then ``wall_and_profile`` of the
    synchronized step."""
    model.train()

    def step(events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        loss, _ = loss_fn(model, batch)
        mark(1)
        opt.zero_grad()
        loss.backward()
        mark(2)
        opt.step()
        mark(3)

    for _ in range(3):
        step()
    parts = {"forward (loss included)": [], "backward": [], "optimizer (clip + AdamW)": [],
             "whole step": []}
    for _ in range(10):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(events)
        torch.cuda.synchronize()
        times = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
        for name, ms in zip(parts, times + [sum(times)]):
            parts[name].append(ms)
    print(f"--- {title}: median CUDA-event ms over 10 steps")
    for name, times in parts.items():
        print(f"  {name}: {statistics.median(times):.3f}")

    def synced_step():
        step()
        torch.cuda.synchronize()

    wall_and_profile(synced_step, kernel_share=kernel_share)


def train(dev: torch.device, dtype: torch.dtype) -> None:
    cfg = ExperimentConfig(training=TrainingConfig(dropout=0.1, bf16=dtype == torch.bfloat16,
                                                   **BENCH_LOSSES))
    model = build_model(cfg, device=dev, dtype=dtype)
    loss_fn, _ = make_objective(cfg)
    r = np.random.default_rng(1)
    batch = {k: torch.from_numpy(r.normal(size=(TRAIN_BATCH, CHANNELS, WINDOW)).astype(
        np.float32)).to(dev) for k in ("eeg1", "eeg2")}
    batch["label"] = torch.from_numpy((np.arange(TRAIN_BATCH) % 3).astype(np.int32)).to(dev)
    train_step_profile(f"flagship train step ({str(dtype)[6:]} compute, dropout 0.1), batch "
                       f"{TRAIN_BATCH}", model, make_optimizer(model, 1e-4, 0.01, grad_clip=1.0),
                       loss_fn, batch, ("phase_metrics_kernel",))


def art_train(dev: torch.device, attn_dropout, dtype: torch.dtype) -> None:
    model = ArtifactRemovalTransformer(ArtConfig(attn_dropout=attn_dropout), device=dev,
                                       dtype=dtype, generator=torch.Generator().manual_seed(42))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             train_art.build_dataset(ART_TRAIN_BATCH, CHANNELS, WINDOW).arrays.items()}
    backward = "K4's backward kernels" if dtype == torch.bfloat16 else "its stock-op backward"
    recipe = ("0.1, the plain attention path" if attn_dropout is None
              else f"{attn_dropout}, K3 and {backward}")
    train_step_profile(f"ART train step ({str(dtype)[6:]} compute, dropout 0.1, attention "
                       f"dropout {recipe}), batch {ART_TRAIN_BATCH}", model,
                       make_optimizer(model, 1e-4, 0.01, grad_clip=1.0),
                       train_art.make_objective(False)[0], batch,
                       ("attention_kernel", "attention_bwd"))


def gaze_train(dev: torch.device, kind: str, mode: str) -> None:
    cfg = ExperimentConfig(model=ModelConfig(fusion_mode=mode),
                           training=TrainingConfig(dropout=0.1, bf16=True))
    model = train_gaze.build_model(cfg, kind, device=dev)
    labels = (np.arange(GAZE_TRAIN_BATCH) % 3).astype(np.int32)
    loss_fn, _ = train_gaze.make_objective(
        kind, img_size=224, weights=torch.as_tensor(class_weights(labels.tolist()), device=dev),
        generator=torch.Generator(device=dev).manual_seed(0))
    r = np.random.default_rng(1)
    batch = {k: torch.from_numpy(r.integers(0, 256, size=(GAZE_TRAIN_BATCH, 3, 224, 224),
                                            dtype=np.uint8)).to(dev) for k in ("img1", "img2")}
    batch["label"] = torch.from_numpy(labels).to(dev)
    train_step_profile(f"ViT-B/16 {kind} fusion ({mode}) train step (bf16 compute, dropout 0.1, "
                       f"augment on the card), batch {GAZE_TRAIN_BATCH}", model,
                       make_optimizer(model, 1e-4, 0.01, grad_clip=1.0), loss_fn, batch, ())


def kernel_count(fn) -> int:
    """CUDA kernels launched by one call of ``fn``, from ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def extraction_rate(data: dict, chunk: int, writes: str, dev: torch.device) -> float:
    """Trials per second of ``extract_eeg_features``'s loop over ``data``:
    ``writes`` "async" as the entry point writes (``ChunkWriter``), "sync"
    each chunk copied to the host and written in the loop, "none" no copy
    and no file."""
    from eyegaze_tpu_torch import extract_eeg_features as ex

    n = len(data["label"])
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        writer = ex.ChunkWriter(out, data["label"], data["pair"], dev) if writes == "async" else None
        t0 = time.perf_counter()
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            feats = ex.chunk_features(ex.upload(data["eeg1"][lo:hi], dev),
                                      ex.upload(data["eeg2"][lo:hi], dev), FEATURE_FS, 8)
            rows = list(enumerate(range(lo, hi)))
            if writer is not None:
                writer.submit(rows, feats)
            elif writes == "sync":
                arrays = {k: v.cpu().numpy() for k, v in feats.items()}
                for j, i in rows:
                    ex.write_trial(out, i, arrays, j, data["label"][i], data["pair"][i])
        if writer is not None:
            writer.close()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)


def features(dev: torch.device) -> None:
    from eyegaze_tpu_torch import extract_eeg_features as ex
    from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset
    from eyegaze_tpu_torch.ops import features as feat
    from eyegaze_tpu_torch.ops.preprocess import bandpass_filtfilt_blocked
    from eyegaze_tpu_torch.ops.spectral import welch_psd

    data = synthetic_eeg_pair_dataset(FEATURE_TRIALS, C=CHANNELS, T=RAW_SAMPLES, fs=FEATURE_FS,
                                      seed=28)
    bands = feat.FEATURE_BANDS_5
    for chunk in (8, 1):
        e1, e2 = (torch.from_numpy(data[k][:chunk]).to(dev) for k in ("eeg1", "eeg2"))
        pair = torch.stack([e1, e2])
        filtered = feat._filter_bands(pair, FEATURE_FS, bands)
        parts = feat._parts(filtered, 256)
        left = feat._Parts(*(torch.cat([x, x[:1]]) for x in parts))
        right = feat._Parts(*(torch.cat([x, x[1:]]) for x in parts))
        stages = {
            "Welch PSD": lambda: welch_psd(torch.stack([e1, e2], dim=1), FEATURE_FS),
            "filtfilt, 5 bands in one recurrence": lambda: feat._filter_bands(pair, FEATURE_FS,
                                                                              bands),
            "filtfilt, one band at a time": lambda: torch.stack(
                [bandpass_filtfilt_blocked(pair, lo, hi, FEATURE_FS) for _, lo, hi in bands], -3),
            "Hilbert parts": lambda: feat._parts(filtered, 256),
            "metrics, 3 sets x 5 bands": lambda: feat._pair_metrics(left, right, 8),
            "chunk_features": lambda: ex.chunk_features(e1, e2, FEATURE_FS, 8),
        }
        print(f"features, chunk of {chunk} trial pair(s) (32, 3250):")
        for name, fn in stages.items():
            print(f"  {name}: {median_cuda_ms(fn):.3f} ms (CUDA events), "
                  f"{kernel_count(fn)} kernels")
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.chunk_features(e1, e2, FEATURE_FS, 8)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        print(f"  host time to enqueue chunk_features: median {statistics.median(enqueue):.3f} ms")
    for chunk in (8, 1):
        extraction_rate(data, chunk, "async", dev)  # the first call at this chunk's shapes
        rates = {w: [] for w in ("async", "sync", "none")}
        for _ in range(FEATURE_ROUNDS):
            for writes, acc in rates.items():
                acc.append(extraction_rate(data, chunk, writes, dev))
        print(f"features, {FEATURE_TRIALS} trials at chunk {chunk}, trials/s in "
              f"{FEATURE_ROUNDS} rounds in turns: "
              + "; ".join(f"writes {w} {[round(r, 1) for r in acc]} (median "
                          f"{statistics.median(acc):.1f})" for w, acc in rates.items()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the train steps (the flagship, ART, the gaze ViTs) instead of "
                           "the serving paths")
    mode.add_argument("--features", action="store_true",
                      help="profile the offline feature extractor instead of the serving paths")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.features:
        features(dev)
        return
    if args.train:
        for dtype in (torch.bfloat16, torch.float32):
            train(dev, dtype)
        for dtype in (torch.float32, torch.bfloat16):
            for attn_dropout in (None, 0.0):
                art_train(dev, attn_dropout, dtype)
        for kind, mode in (("early", "concat"), ("late", "full")):
            gaze_train(dev, kind, mode)
        return
    for dtype in (torch.float32, torch.bfloat16):
        eeg(dev, dtype)
    for dtype in (torch.float32, torch.bfloat16):
        art(dev, dtype)
    gaze(dev)
    multimodal(dev)


if __name__ == "__main__":
    main()
