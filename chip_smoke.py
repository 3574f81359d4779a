"""Smoke run of the PyTorch port (eyegaze_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``eyegaze_tpu_torch/csrc`` with nvcc,
one process per source, all at once, and prints each kernel's registers and
spills, the tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of
each instance of the attention kernel and of K4's backward kernels (the
one-pass kernel and the dQ and dK/dV kernels), the arithmetic, LDS and
other instructions per pair and sample in the main loop of each
phase-metrics instance, and the instructions per score in the backward
kernels' main loops: a phase-metrics, f32 attention or backward instance
that spills, an f32 attention instance with any tensor-core instruction (a
TF32 product in the f32 path), or a bf16 forward or backward instance with
none, fails the run.  Then, each phase raising on any failure:

1. K1 (phase metrics) against its plain PyTorch version on the card at the
   shapes the EEG serving run and flagship training launch it with (N =
   384 for a train batch of 64, and the last eval batch's ragged N), at a
   ragged one and at one whose T is not a multiple of 4 (rows staged
   element by element), timed in turns with CUDA events at those shapes,
   one call between the events and 20 calls replayed from a CUDA graph,
   with the split of T over a block cluster and the block count at each.
2. K2 (the widened phase metrics, K1's sums plus mean cos and sin of the
   phase difference) the same way at the shootout's (64, 32, 1024) and at
   (768, 32, 1024), the largest N of the EEG serving run.  In both, the
   tied pair (0, 0) must give mean sign and Phase_Diff 0 (K2: mean cos 1):
   padded samples add nothing.
3. The attention kernel (K3 and K4) against its plain twin: the head-packed
   entry point at ART's serving shapes (B, 1024, 8, 16) for B = 1, 8, 32 and
   at a ragged (3, 200, 8, 16), in f32 and bf16, the flash entry point at
   (2, 8, 1024, 128) bf16, timed in turns at the serving shapes beside
   ``F.scaled_dot_product_attention``, a yardstick no path of the port calls
   (f32 with the query rows per thread the launch picked at each shape):
   one call between CUDA events, 20 back-to-back calls between one pair
   (where the host's enqueue time hides behind the device's work, if the
   device's is longer), and 20 calls captured in a CUDA graph and replayed
   (device time alone).  Then K4's backward, bf16 under autograd
   (``attention_backward_phase``) at ART's training shape (16, 1024, 8,
   16) head-packed, K4's (2, 8, 1024, 128) flash layout, d = 32 and 64, and
   ART's cross attention with Tk 1000 (the one-pass kernel at d = 16, PR
   14's dQ and dK/dV kernels at the other head dims), and at ART's shape
   with Tk 2048 (past the one-pass kernel's reach): the forward's saved
   log-sum-exp within 1e-4 of the twin's, dq, dk, dv within the bf16 bound
   of ``attention.backward_bound`` of the twin backward on the same output
   and log-sum-exp, and within SDPA_WITNESS_RTOL of
   ``F.scaled_dot_product_attention``'s gradients; the
   kernels alone one call, 20 back to back and 20 from a CUDA graph, each
   kernel's device time (``torch.profiler``, which must see the kernels of
   the case's path), beside the twin and the library's backward
   (``aten._scaled_dot_product_flash_attention_backward``), the bound (the
   five products at the bf16 peak against the bytes) and the exponentials
   on the SFU; the Function's forward + backward beside the library's and
   beside the kernel forward + the stock-op backward K3 trained with, in
   turns, with each one's peak memory in transit.
4. The flagship EEG serving path at full width (DualEEGTransformer d_model
   256, 6 layers, 8 heads, random weights from a seed): raw (trials, 32,
   3250) pairs -> ``preprocess_eeg`` -> ``sliding_windows`` ->
   ``Predictor.predict`` for requests of 1, 3 and 16 trials.  Every forward
   launches K1; its 139-token attention stays on the plain path; the card's
   logits for one trial match the same weights run on the CPU.
5. The flagship as the JAX package serves it: the same weights saved as a
   state_dict plus ``.meta.json`` in a temporary directory, loaded by
   ``Predictor.from_checkpoint`` (bf16 compute) and served the same
   requests.  K1 launches once per forward; the card's logits for one trial
   are within 2**-5 of the largest |logit| of the same bf16 model on the
   CPU, printed beside the gap between bf16 and f32 on the card, and each
   request's median wall time beside the f32 path's.
6. The same checkpoint behind ``python -m eyegaze_tpu_torch.serve
   --dynamic-batch`` (its ``main`` in a thread, 127.0.0.1, port 0, one
   bucket of 128): 16 concurrent single-trial requests (5 windows each) over
   HTTP.  Each answer equals, to the bit, a direct ``predict`` of its rows
   at the same bucket, labels included; the requests take fewer dispatches
   than there are requests, and K1 launches once per dispatch.  Prints the
   p50 and p99 of the request wall times.
7. ART serving at full width (``ArtConfig()``: 6 + 6 layers, embed 128, ff
   2048, 8 heads, random weights from a seed): ``ArtDenoiser.predict`` on
   (N, 32, 1024) windows for N = 1, 5 and 16.  Every one of the 18 attention
   calls of each forward launches the head-packed entry point, with the
   query rows per thread printed for each bucket; the card's output for one
   window matches the same weights run on the CPU.
8. ART served in bf16 compute (``ArtifactRemovalTransformer(dtype=
   torch.bfloat16)``, the JAX ``from_checkpoint`` default), the same weights
   and requests as phase 5: 18 launches of the head-packed entry point's
   bf16 instance per forward and no flash launch; the card's output for one
   window matches the same weights served in bf16 on the CPU.
9. ART from a checkpoint: phase 8's weights saved as a state_dict plus
   meta, loaded by ``ArtDenoiser.from_checkpoint`` (bf16) and served the
   16-window request at bucket 32: 18 launches of the bf16 instance, and the
   output equal to the bit to phase 8's for the same windows.
10. The flash route: a bf16 ``MultiHeadAttention`` with d_k 128, the
   counterpart of the JAX call site of the stock flash kernel, launches the
   flash entry point on every forward and matches its own plain path; then
   it trains, 3 AdamW steps through the route (a K4 launch and a call of
   K4's dQ and dK/dV backward kernels each, no stock backward), and one
   backward's gradients match the plain route's within 2**-5 of each
   tensor's largest |entry|.
11. The connectivity shootout, ``eyegaze_tpu_torch.bench_connectivity.main``
   at its defaults: K1 against its plain version, PLV by four matrix
   products plus K1 against K2 alone, six coherence passes against one; its
   JSON line is printed and every difference held to its bound.  It is the
   path that launches K2.
12. The legacy IBS configuration at full width (``use_robust_ibs=False``):
   3-trial requests through ``Predictor``, no phase-metrics launch, logits
   within the flagship's tolerance of the same weights on the CPU.
13. Flagship training at full width, the bench's train step (batch 64 of
   (32, 1024) window pairs, CE + 0.1 sym + 0.1 align + 0.3 IBS-CE + 0.1
   contrastive, AdamW at 1e-4 with clip 1.0), its config built from the
   dataclasses (no YAML).  First one f32 step without dropout at batch 4 on
   the card and on the CPU from the same seeded weights: loss, gradient
   norm and parameter change within the bounds stated at
   ``PARITY_GRAD_NORM_RTOL``.  Then ``Trainer.train_step`` with dropout 0.1,
   3 steps untimed and 20 timed to a synchronize, in bf16 and then f32:
   median step time, peak memory, every loss finite, one K1 launch per
   forward and no attention launch.  Last ``train_dual_eeg.run`` (the
   entry point without its YAML) trains one bf16 epoch on the 96 synthetic
   trials into a temporary directory with ``--watch 1`` (one more K1
   launch: the watch's forward), and ``Predictor.from_checkpoint`` serves
   the validation windows from the best_model.pt it wrote: within 2**-5 of
   the largest |logit| of the trainer's own eval logits.
14. ART training parity at full width (``ArtConfig(attn_dropout=0.0)``,
   f32, as ``eyegaze_tpu_torch.train_art`` trains): one dropout-free step at
   batch 2 on the card, through K3 and its autograd Function (18 launches
   and 18 backward calls), and on the CPU through the plain path, from the
   same seeded weights, held to the flagship step's bounds; then the
   Function's dq, dk, dv at (16, 1024, 8, 16) f32 against autograd through
   the plain twin, within 1e-4 of each one's largest |entry|.  The
   Function's forward + backward is timed there beside the kernel's forward
   alone and ``F.scaled_dot_product_attention``'s forward + backward (the
   yardstick), with the backward's bound (its five matmuls) and the peak
   memory one backward holds.
15. ``Trainer.train_step`` on ART at batch 16 of (32, 1024) pairs, 3 steps
   untimed and 20 timed to a synchronize, for both recipes: attention
   dropout 0.1 (the default; the plain path, no K3 launch) and 0.0 (18 K3
   launches and 18 backward calls a step): median step time, peak memory.
16. ``train_art.run`` for one epoch at full width on 40 synthetic trials at
   attention dropout 0.0 into a temporary directory (K3 in its train steps
   and its evaluation), then ``ArtDenoiser.from_checkpoint`` (bf16) serves
   the validation windows from the best_model.pt it wrote: within 2**-5 of
   the largest output of the trained model in f32 (``tgt = src``).
17. Gaze serving: ``EarlyFusionViT`` (concat) and ``LateFusionViT`` (full),
   ViT-B/16 at full width (224 x 224, embed 768, depth 12, 12 heads),
   seeded weights saved as a state_dict plus meta and served by
   ``GazePredictor.from_checkpoint`` (bf16): requests of 1, 8 and 32 uint8
   pairs, no attention-kernel launch, the 8-pair logits within 2**-5 of the
   largest |logit| of the same checkpoint served on the CPU; then one
   request of 8 pairs through ``serve --kind gaze`` over HTTP, equal to a
   direct ``predict``.
18. Gaze training parity: one f32 ViT-B/16 early-fusion (concat) train
   step at batch 16 without dropout or augment, card against CPU from the
   same seeded weights and uint8 batch (train_gaze's forward and
   class-weighted CE), held to the flagship step's bounds and every
   gradient tensor to ART's (``check_step_parity``, ``check_grad_parity``).
19. ``Trainer.train_step`` with train_gaze's objective (the flip + jitter
   augment drawn on the card, class-weighted CE, dropout 0.1, bf16) on
   ViT-B/16 early (concat) and late (full) fusion at batch 16: 3 steps
   untimed, 20 timed to a synchronize, then ``torch.profiler`` over 5:
   median step time, peak memory, CUDA kernels per step, busy share; no
   kernel of the port launches (the ViT's attention is Flax's).
20. ``train_gaze.run`` (the entry point without its YAML) for one epoch at
   full width on 48 synthetic trials, bf16, for the early and datafusion
   (horizontal paste) kinds; ``GazePredictor.from_checkpoint`` serves the
   validation pairs from the best_model.pt each wrote, within 2**-5 of the
   largest |logit| of the trainer's own eval logits.
21. The multimodal composite at full width (ViT-B/16 early fusion + the
   flagship EEG encoder + the fuzzy gate), seeded weights saved as a
   reference-named state_dict plus a meta with the ``model.multimodal``
   stamp, served by ``MultimodalPredictor.from_checkpoint`` (bf16):
   requests of 1, 8 and 32 pairs of uint8 images and (32, 1024) windows,
   K1 launched once per forward inside the EEG encoder (N = 6, 48 and 192),
   counted from 0 for the phase; per bucket the wall times, K1's time and
   share of the kernel time from ``torch.profiler``, and the first 8 pairs'
   logits, img_logits, eeg_logits and alpha within 2**-5 of each one's
   largest |value| of the same checkpoint served on the CPU.
22. One request of 8 pairs through ``serve --kind multimodal`` over HTTP,
   equal to a direct ``predict``, alpha and labels included.
23. Multimodal training at full width (``train_multimodal``'s recipe at
   configs/multimodal_fuzzy_fusion.yaml's values, the config built from the
   dataclasses): one f32 step without dropout at batch 8 (uint8 pairs and
   (32, 1024) windows) on the card and on the CPU from the same seeded
   weights, held as the flagship's step, one K1 launch on the card; every
   gradient tensor of the card's within ART's 2e-3 of its largest |entry|
   of a float64 step on the CPU (``float64_casts``), the CPU's float32
   gradients' distance from it printed beside; then
   ``Trainer.train_step`` with the two-group optimizer (encoders 1e-5, gate
   1e-4) in bf16 with dropout 0.1, 3 steps untimed, 20 timed to a
   synchronize and ``torch.profiler`` over 5: median step time, peak
   memory, CUDA kernels per step, busy share, K1 once a step (N = 48) with
   its device time; then one step with ``freeze_encoders`` leaves every
   encoder tensor equal to the bit.
24. ``train_multimodal.run`` for one epoch at full width on the YAML's 24
   synthetic trials (2 steps, one eval batch of 4 windows: K1 at N = 48 and
   24), its best_model.pt served by ``MultimodalPredictor.from_checkpoint``
   at the eval batch's size: logits equal to the bit to the trainer's eval
   logits.
25. HyperEEG serving at the documented preset (embed 128, 4 heads, sinc
   kernel 125: 274,819 parameters), seeded weights saved with the
   ``model.hypereeg`` stamp and served bf16 by
   ``HyperEEGPredictor.from_checkpoint``: requests of 1, 8 and 32 (32,
   1024) window pairs, no kernel of the port, the 8-pair logits within 2**-5
   of the largest |logit| of the same checkpoint served on the CPU; one
   request of 8 through ``serve --kind hypereeg`` over HTTP, equal to a
   direct ``predict``.
26. HyperEEG training as ``train_hypereeg`` trains it (f32): one step
   without dropout or augment at batch 16, card against CPU (the key and
   logvar biases, zero in exact arithmetic, held to the largest gradient's
   share); ``Trainer.train_step`` at batch 256 with the augment drawn on the
   card, 3 steps untimed, 20 timed, ``torch.profiler`` over 5: median step
   time, peak memory, kernels per step, busy share; ``train_hypereeg.run``
   for one epoch served back by ``HyperEEGPredictor.from_checkpoint``
   within 2**-5 of the largest |logit| of the trainer's eval logits.
27. The offline EEG pipeline's first stages: 32 synthetic trial pairs at
   (32, 3250) written as CSVs (channel-major, two time-major) with
   ``synthetic_metadata``'s records, through ``preprocess_eeg_raw`` (the
   native loader in use, CSVs per second, every trial within the CSV's six
   decimals of its source); its two splits saved as the trial arrays
   ``preprocess_eeg_windows`` reads, which runs on the card and with
   ``--device cpu``: windows within 1e-3, labels, pairs and metadata equal.
28. ``extract_eeg_features`` on 256 synthetic pairs at (32, 3250), fs 250,
   after a warm-up run at each chunk size: ``--trial-chunk`` 8 and 1, two
   runs each in turns, with their end-to-end trials per second
   (asynchronous writes), the
   CUDA-event ms of one chunk's features, kernels per chunk and busy share
   from one profiled chunk and the projected wall time for the dataset's
   4,463 trials; every file's arrays at their byte sizes, chunk 8 against
   chunk 1 and against ``--device cpu`` on 4 trials at the test bounds;
   ``--resume`` after deleting 3 files writes exactly those 3; then
   ``spectral_entropy`` on (256, 32, 3250) and ``spatial_entropy`` on 16
   float heatmaps at (1583, 3000, 3), card against CPU.  Neither phase
   launches a kernel of the port.
29. ART's bf16 train step at full width, ``bench.py``'s two bf16 recipes
   (``ArtifactRemovalTransformer(ArtConfig(attn_dropout=...),
   dtype=bfloat16)``): one dropout-free step at batch 2 at attention dropout
   0.0 on the card (18 K3-bf16 launches, 18 launches of K4's one-pass
   backward kernel, none of the two-kernel path, no stock backward) against the CPU's plain path from the same seeded
   weights, the loss within 2**-8 relative and every gradient tensor within
   ART_BF16_GRAD_SHARE on its module's scale, the parameters and gradients
   f32; ``Trainer.train_step`` at batch 16 with dropout 0.1, 3 steps
   untimed, 20 timed to a synchronize and ``torch.profiler`` over 5, at
   attention dropout 0.1 (the plain path, no kernel) and 0.0 (per step 18
   K3-bf16 launches and 18 backward calls of one launch each): median step
   time, peak memory, kernels per step, busy share; then one epoch at 0.0
   through ``Trainer.fit`` on 40 synthetic trials, its best_model.pt served
   by ``ArtDenoiser.from_checkpoint`` (bf16) within 2**-5 of the largest
   output of the trained model's bf16 forward.
30. ``python -m eyegaze_tpu_torch.import_torch_checkpoint`` on seeded
   full-width reference-named state_dicts of the five kinds (the flagship
   also at a non-default geometry), each under ``model_state_dict`` with the
   ``module.`` prefix and the reference's buffers; each import served by
   ``from_checkpoint`` (bf16) on the card equal to the bit to the same
   weights served from the bare state_dict with their meta; the imported
   flagship and composite requests launch K1 once, the imported ART request
   K3-bf16 18 times.
31. ``analyze_eeg`` (metrics, frequency, ibs, attention, Grad-CAM) at full
   width on the imported flagship, ``--trials 24 --batch-size 16``, float32,
   on the card and on the CPU: K1 launches equal the forwards
   ``planned_forwards`` predicts (none on the CPU); the IBS means and the
   attention maps within 2e-3, the Grad-CAM CSVs within 5e-3 of each map's
   largest entry (+ the CSV's 1e-6) and the maps themselves within 5e-2
   of each map's largest entry (a map jumps when a conv2 output within
   rounding of 0 flips its ReLU; printed beside: the card's maps with K1's
   plain twin and with cuDNN off, the CPU's under a 1e-7 input change),
   the masked-band accuracies equal (or apart by at most the windows inside
   the margin); each stage's wall time.
32. Gaze introspection on ViT-B/16 early fusion (224 px, f32) at batch 2,
   card against CPU: saliency within 2e-3 of each map's largest entry, the
   CLS features within 2e-3, the ViT Grad-CAM equal (zero on both: only
   the CLS token of the last block's output reaches the logits); no kernel
   of the port.
33. ``analyze_gaze``'s numeric stages (``analyze_gaze.analyze``) at full
   width: ViT-B/16 early ('concat') and late ('full') fusion at 224 px,
   weights from seed 0, over the JAX script's synthetic validation set at
   ``--trials 24``, card against CPU: the logits, probabilities and CLS
   features within 1e-4, the predictions equal outside the top-two margin
   and the confusion matrix, per-pair accuracies and mechanism statistics
   equal where every trial clears it, the saliency maps within 2e-3 of each
   map's largest entry; each stage's wall time on both; then
   ``MultiModelComparator``'s ranking and McNemar tests on the two models;
   no kernel of the port.
34. ``analyze_entropy``'s EEG file path at the recorded trial shape: 64
   reference-named CSVs of (32, 3250) (28 pairs, the three conditions)
   through ``analyze_eeg_entropy_files`` at fs 250 and the 0.5-50 Hz band,
   card against CPU: the spectral entropies within 1e-4 (and each device's
   gap from a float64 scipy reference printed); the card's trials per
   second, the CSV parse share and the run's peak memory (one chunk); then
   ``compute_real_entropy`` at ``--trials 30`` on both (within 3e-4, its
   T = 1024 filter's float32 gap twice); then phase 13's
   ``--watch 1`` history read back by ``LearningCurveAnalyzer`` and
   ``WatchAnalyzer``: the best epoch's metric is the trainer's
   best_metric, every watched layer's norms finite; no kernel of the port.
35. The full-scale rehearsal (``python -m
   eyegaze_tpu_torch.rehearsal_full_scale``), its steps one by one at 448
   of the dataset's 4,463 trials (32 of the JAX script's 100 CSV trials,
   16 of its 112 JPG trials, its 64 feature trials): the raw volume, CSVs
   and 3000 x 1583 JPGs generated, converted, windowed on the card (the
   pair split's 320 / 128 trials and 9 windows a trial; the first train
   trials' windows within 1e-3 of the CPU's), features extracted, the
   flagship trained for one epoch at full width at batch 128 (K1 once per
   train step and eval batch, counted from a reset; finite losses; its
   best_model.pt served back) and ViT-B/16 early fusion on the converted
   images, the entropy numbers of the JPG and CSV trees
   (``analyze_entropy.compute``: the tables and figures need matplotlib)
   and ``analyze_eeg --analyses metrics`` on the checkpoint (K1 once per
   planned forward); no K1-K4 launch in any other step.  Each step's wall
   seconds and the process's peak RSS after it.
36. Data parallelism (``eyegaze_tpu_torch.parallel``).  (a) ``train_dual_eeg``'s
   CLI (its ``main``) at full width, bf16, batch 64, dropout 0, on 240
   synthetic trials (3 steps and one eval batch), without ``--mesh`` and
   with ``--mesh dp``: one rank on the one card through NCCL and DDP, K1
   once per step and eval batch, the epoch's losses within 2e-3 and its
   gradient norm within 1e-3 relative of the run without; ``--mesh dp2``
   raises on the one card.  (b, c) Two ranks sharing the card through
   ``parallel.launch`` with gloo on CUDA tensors, each on its rows of the
   same global batches as one process: 3 steps of the flagship's bench
   step (bf16, batch 64, every dropout off, the five loss terms, the IBS
   alignment and contrastive terms over the global batch) and 3 of bf16
   ART at attention dropout 0.0 (batch 16); each step's loss and gradient
   norm and the parameters after the 3 steps held to one process's at
   ``check_step_parity``'s bounds (ART's loss at its bf16 bound); per rank
   per step K1 once at N = 192, 18 K3-bf16 launches and 18 launches of
   K4's one-pass backward.  The step times per rank beside one process's
   are two ranks sharing one card, not a scale-out rate.
37. Tensor parallelism (``eyegaze_tpu_torch.parallel.tensor``: Megatron
   column and row layers, one all_reduce per sharded block forward and one
   per copy into a tp region backward).  Gloo ranks share the card through
   ``parallel.launch``, against one process on the same batches and
   checkpoints, at ``check_dp_parity``'s bounds (the parameters gathered
   over the tp ranks).  Two ranks, ``tp2``: (a) 3 bf16 ART steps at batch 16,
   attention dropout 0.0, every dropout off: per rank per step 18 K3-bf16
   launches at (16, 1024, 4, 16), 18 launches of K4's one-pass backward and
   the all_reduces predicted from the layers (6 encoder blocks x 2 + 6
   decoder blocks x 3 forward, 6 x 2 + 6 x 4 copies backward); (b) 3 bf16
   ViT-B/16 early-fusion steps at batch 16 without dropout or augment, each
   rank's parameter bytes beside one process's; (d) the flagship, ViT-B/16
   early fusion, ART, the composite and HyperEEG served bf16 from a
   checkpoint under ``tp2``, each within 2**-5 of the largest output of the
   same checkpoint served unsharded on the card, K1 as often as unsharded
   and ART's request 18 K3-bf16 launches at 4 heads a rank.  Four ranks,
   ``dp2,tp2``: (c) 3 bf16 and one f32 flagship bench steps at batch 64,
   dropout 0, K1 once per rank per step at N = 192.  In one process: (e),
   run beside phase 3, K3-bf16's forward and K4's one-pass backward at
   (16, 1024, 4, 16) against their twins, timed beside SDPA's and their
   bounds; (f) ``--mesh tp2`` on the one card raises in ``train_art``'s CLI
   and in ``serve``.
   The step times are ranks sharing one card, not a scale-out rate.

Every phase runs in float32 (TF32 off) unless it says bf16.  There is no
CPU fallback: without a CUDA device the script exits non-zero and prints no
result.  For each kernel it prints the least time the card could take for
the same work (``bound_ms``, set by bytes or by operations at the card's
peak rate for their type; for attention the operations are the matmuls)
and its launches per request; for attention also the time its
exponentials take on the SFU alone (``sfu_ex2_ms``, not a floor).  The
second-to-last line of stdout is a JSON object with each kernel entry
point's launches, error, times and bound (K1's launches are serving's,
training's, the composite's, multimodal training's, the imported
checkpoints', the analysis's, the rehearsal's and phases 36's and 37's, with its timing at
the train shape and the train step's median times and peak memory beside
them, its time, bound and share at each composite bucket, the
composite train step's time, memory and K1 launches per step, and the
analysis's predicted forwards, stage times and timing at its shapes; the
f32 head-packed entry's are
serving's and ART training's, with its backward calls, the ART train
step's medians and the autograd timing; the bf16 head-packed entry's are
bf16 serving's, bf16 ART training's, the imported ART's and phases 36's
and 37's ranks', with that step's medians and phase 37's timing at a tp2
rank's shape; the
one-pass backward kernel's, ``flash_attention_bwd``, are bf16 ART
training's and phases 36's and 37's ranks', timed at ART's training shape
and at a tp2 rank's, each case of the backward phase
beside; the two backward kernels', ``flash_attention_bwd_dkv`` and
``flash_attention_bwd_dq``, the flash route's train steps, timed at K4's
shape and past the one-pass kernel's reach);
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SAMPLING_RATE = 256.0
WINDOW, STRIDE = 1024, 512
CHANNELS, RAW_SAMPLES, TRIALS = 32, 3250, 16
WINDOWS_PER_TRIAL = (RAW_SAMPLES - WINDOW) // STRIDE + 1  # 5
REQUESTS = (1, 3, 16)  # trials per request: 5, 15 and 80 windows
REPEATS = 5
BUCKETS = (1, 8, 32, 128)
GEOMETRY = dict(in_channels=CHANNELS, num_classes=3, d_model=256, num_layers=6, num_heads=8,
                d_ff=1024, max_len=256, sampling_rate=SAMPLING_RATE)
RAGGED_SHAPE = (7, 30, 1000)
UNALIGNED_SHAPE = (7, 30, 1001)  # T % 4 != 0: K1 and K2 stage rows element by element
SUM_NAMES = ("mean_sign", "wnum", "pdiff", "mean_cos", "mean_sin")
SOURCES = ("phase_metrics", "attention")
LOGIT_TOL = 2e-3  # the repo's cross-framework tolerance for this model (tests/test_torch_port.py)
# bf16 compute, card vs CPU: a share of the largest |logit|, the bound that
# tests/test_torch_dual_eeg_bf16.py holds the port to against Flax's bf16
# model on the CPU (single bf16 roundings flip and spread).
LOGIT_BF16_TOL_SHARE = 2.0 ** -5
# What the JAX package's trainer writes beside an orbax checkpoint, for the
# seeded flagship at GEOMETRY (max_len comes from the positional table).
FLAGSHIP_META = {"config": {
    "model": {"in_channels": CHANNELS, "num_labels": 3, "d_model": 256, "num_layers": 6,
              "num_heads": 8, "d_ff": 1024},
    "ablation": {"use_spectrogram": True, "use_ibs": True, "ibs_mode": "robust",
                 "use_cross_attention": True, "ibs_instance_norm": True,
                 "ibs_feature_type": "all"},
    "data": {"sampling_rate": SAMPLING_RATE, "enable_preprocessing": False}}}
HTTP_REQUESTS = 16  # concurrent single-trial requests, 5 windows each
# One bucket for the HTTP run: every dispatch, coalesced or not, and every
# direct predict it is held against pad to the same shape, so the rows
# must agree to the bit.
HTTP_BUCKET = 128

ART_REQUESTS = (1, 5, 16)  # windows per request: buckets 1, 8 and 32
ART_BUCKETS = (1, 8, 32)
ART_ATTENTION_CALLS = 18  # 6 encoder self + 6 decoder self + 6 decoder cross, per forward
ART_TOL = 2e-3  # card vs CPU, float32 both (the flagship's cross-device tolerance)
# Card vs CPU, bf16 compute both: a share of the largest output, 8 bf16 steps
# there.  The two sum in another order and the kernel rounds unnormalised
# probabilities, so single bf16 roundings flip, and each post-LN block
# spreads a flip over its row: tests/test_torch_art.py holds the port to the
# JAX bf16 model by the same bound on the CPU.
ART_BF16_TOL_SHARE = 2.0 ** -5
ATTN_HEADS, ATTN_DK = 8, 16  # ART's attention geometry at T = 1024
ATTN_RAGGED = (3, 200, 8, 16)
FLASH_SHAPE = (2, 8, 1024, 128)  # (B, H, T, d)
# A bf16 layer of d_k 64 at T = 1024 takes the head-packed route, and its
# backward the wgmma one-pass kernel: K4's backward at d = 64.
HEADPACKED64_SHAPE = (4, 8, 1024, 64)
FLASH_CALLS = 3
FLASH_TRAIN_STEPS = 3
# f32: the kernel and the twin sum the same products in another order; an
# output near zero is a sum that cancels, whose error scales with its O(1)
# terms, hence the absolute part.
ATTN_F32_TOL = dict(rtol=1e-5, atol=1e-5)
BACK_TO_BACK = 20  # calls between one pair of CUDA events

# K2 at the shootout's default shape and at the largest N the EEG serving run
# launches K1 with (6 bands x bucket 128), where the widened route would run.
PLV_SHAPES = ((64, 32, 1024), (768, 32, 1024))
# The shootout's bounds: PLV and coherence 1e-5; PLI, wPLI and Phase_Diff K1's
# tolerances at the metrics' largest values (PLI atol 1e-6; wPLI <= 1 with
# rtol 1e-4; Phase_Diff <= 2 pi with rtol 1e-5), so at most 1.1e-4.
SHOOTOUT_BOUNDS = {"max_abs_diff": 1.1e-4, "plv_max_abs_diff": 1e-5,
                   "coherence_max_abs_diff": 1e-5}
LEGACY_TRIALS = 3

# Flagship training: the bench's train step (bench.py:223-258), batch 64,
# AdamW at 1e-4 (weight decay 0.01) with clip 1.0, and its objective
# (train_dual_eeg.BENCH_LOSSES).
TRAIN_BATCH = 64
TRAIN_LR = 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 20  # steps untimed, then timed, per compute type
PARITY_BATCH = 4  # card-vs-CPU step: a small batch, for the CPU's time
# One f32 step, card against CPU (TF32 off, no dropout), same weights and
# batch.  The loss: the repo's card-vs-CPU logit tolerance (LOGIT_TOL) on an
# O(1) loss.  The gradient norm: 1e-3 relative; the CPU holds every
# gradient tensor to 1e-4 of its largest value against JAX
# (tests/test_torch_trainer.py), and the card sums in other orders again
# (cuBLAS, cuFFT, cuDNN).  The step: Adam's first update is lr * g / (|g| +
# eps) + lr * wd * p per entry, so the largest change on each device is
# lr * (1 + wd |p|) up to rounding: equal within 1e-3 relative; an entry
# whose gradient is rounding noise may flip sign between devices, so
# entries may differ by up to 2 lr (the Adam bound, checked too), plus 1%
# for the float32 rounding of the parameters stepped (|p| < 8, whose ulp
# is 9.5e-7, 0.5% of 2 lr).
PARITY_GRAD_NORM_RTOL = 1e-3
PARITY_STEP_RTOL = 1e-3
# ART's step also holds each gradient tensor, card against CPU, to 2e-3 of
# its largest |entry| (ART_TOL's share).  At full width the FFN's linear1
# gradients, sums over 2048 tokens with cancellation that no attention
# call computes, differ between cuBLAS and the CPU by several times 1e-4 of
# their largest |entry| even on the plain path (the phase prints the three
# worst tensors), so the CPU tests' 1e-4 against JAX on one device does not
# carry over; a wrong q, k or v gradient moves its tensors by far more.
# The key projections' biases, zero in exact arithmetic (the softmax
# ignores a shift of a row's scores), to 1e-6 of the largest gradient.
PARITY_GRAD_SHARE = 2e-3
PARITY_ZERO_GRAD_SHARE = 1e-6

# ART training (eyegaze_tpu_torch.train_art's recipe: f32, AdamW at 1e-4,
# weight decay 0.01, clip 1.0): the timed step at the JAX script's batch of
# 16 windows, the card-vs-CPU step at 2 (the CPU's time), the entry point on
# 40 synthetic trials (32 train, 8 validation: 2 steps and 1 eval batch).
ART_TRAIN_BATCH = 16
ART_PARITY_BATCH = 2
ART_TRAIN_LR = 1e-4
ART_TRAIN_TRIALS = 40
# The Function's gradients on the card against autograd through the plain
# twin, f32 at ART's training shape: the same f32 math in other orders, 1e-4
# of each gradient's largest |entry|.
ART_GRAD_SHARE = 1e-4
ART_TRAIN_SHAPE = (ART_TRAIN_BATCH, WINDOW, ATTN_HEADS, ATTN_DK)  # (B, T, H, d)

# F.scaled_dot_product_attention's gradients, a second witness: it rounds its
# own output, P and dS, so it is held in relative Frobenius norm, a few bf16
# steps (u = 2**-8 each) apart at most.
SDPA_WITNESS_RTOL = 2.0 ** -6

# ART's bf16 train step (phase 29): bench.py's flash recipe, attention
# dropout 0.0, and the reference recipe (None), at batch 16, AdamW at 1e-4,
# clip 1.0; the card-vs-CPU step at batch 2.  Each gradient tensor is held
# to the CPU's plain path within 2**-4 of the largest |entry| of its
# module's gradients of its kind (``module_scale``: the weights, or the
# biases, of one attention block, FFN, LayerNorm or embedding), not of its
# own: where an attention block barely depends on q and k (V's rows alike),
# their own gradients are tiny, and the flash backward computes Di = sum_d O
# dO from the bf16 output, as the Pallas backward does, while the plain path
# sums dP P in f32; that rounding of O (u = 2**-8 of each term) then
# outweighs them (the CPU twin against the CPU plain path at this width:
# 1.75x decoder.layers.5.self_mha.q_proj's own largest |entry|, 0.0068 on
# the module scale).  Two bf16 steps also round apart at every projection:
# the CPU's bf16 step is 0.034 on the module scale from its f32 step.  The
# two together stay under 2**-4; the run prints the CPU's bf16-vs-f32
# distance beside the card's.  The loss within 2**-8 relative.
ART_BF16_GRAD_SHARE = 2.0 ** -4
ART_BF16_LOSS_RTOL = 2.0 ** -8

# Gaze serving: ViT-B/16 at full width (224 x 224, patch 16, embed 768,
# depth 12, 12 heads: 197 tokens), bf16 from a checkpoint, buckets (1, 8, 32).
GAZE_GEOMETRY = dict(img_size=224, embed_dim=768, depth=12, num_heads=12)
GAZE_MODELS = (("early", "concat"), ("late", "full"))
GAZE_REQUESTS = (1, 8, 32)
GAZE_BUCKETS = (1, 8, 32)
GAZE_CPU_PAIRS = 8  # card vs CPU on the 8-pair request (ViT-B on the CPU is slow)
# bf16 compute, card vs CPU: a share of the largest |logit|, the bound
# tests/test_torch_vit.py holds the port's bf16 ViTs to against Flax's.
GAZE_BF16_TOL_SHARE = 2.0 ** -5

# Gaze training, eyegaze_tpu_torch.train_gaze's recipe at configs/gaze_earlyfusion.yaml's
# values: ViT-B/16 at img 224, batch 16, bf16, dropout 0.1, AdamW at 1e-4 (weight
# decay 0.01, clip 1.0), class-weighted CE, the flip + jitter augment on the card;
# 48 synthetic trials (34 train, 14 validation: 2 steps and 1 eval batch).
GAZE_TRAIN_BATCH = 16
GAZE_TRAIN_LR = 1e-4
GAZE_TRAIN_TRIALS = 48
GAZE_TRAIN_KINDS = (("early", "concat"), ("late", "full"))
GAZE_SERVE_KINDS = ("early", "datafusion")
PROFILED_STEPS = 5

# The multimodal composite at full width: ViT-B/16 (early fusion, concat) plus
# the flagship encoder (d_model 256, 6 layers, 8 heads, d_ff 1024, eeg_max_len
# 256) and the fuzzy gate ('full'), as configs/multimodal_fuzzy_fusion.yaml and
# scripts/train_multimodal.py build it; served bf16 from a checkpoint.
MM_GEOMETRY = dict(num_classes=3, gaze_fusion_mode="concat", fuzzy_mode="full",
                   eeg_in_channels=CHANNELS, eeg_d_model=256, eeg_num_layers=6, eeg_num_heads=8,
                   eeg_d_ff=1024, eeg_max_len=256, sampling_rate=SAMPLING_RATE,
                   use_spectrogram=True, use_ibs=True, use_robust_ibs=True,
                   use_cross_attention=True, vit_embed_dim=768, vit_depth=12, vit_num_heads=12,
                   img_size=224, dropout=0.1)
MM_REQUESTS = (1, 8, 32)  # pairs of 1,024-sample windows per request
MM_BUCKETS = (1, 8, 32)
MM_CPU_PAIRS = 8  # card vs CPU on the first 8 pairs (ViT-B in bf16 on the CPU is slow)
# bf16 compute, card vs CPU: a share of the largest |output|, each encoder's
# bound (GAZE_BF16_TOL_SHARE, LOGIT_BF16_TOL_SHARE), for the fused logits and
# alpha too.
MM_BF16_TOL_SHARE = 2.0 ** -5
MM_OUTPUTS = ("logits", "img_logits", "eeg_logits", "alpha")
# Multimodal training, eyegaze_tpu_torch.train_multimodal's recipe at the
# YAML's values: batch 8, bf16, dropout 0.1, AdamW with the encoders at 1e-5
# and the gate at 1e-4 (weight decay 0.01, clip 1.0); the YAML's 24 synthetic
# trials (20 train, 4 validation windows: 2 steps and 1 eval batch).
MM_TRAIN_BATCH = 8
MM_TRAIN_LR, MM_ENCODER_LR = 1e-4, 1e-5
MM_TRAIN_TRIALS = 24
# The composite's gradient tensors are held to a float64 step on the CPU
# from the same weights and batch (``float64_grads``), not to the CPU's
# float32 step: the spectrogram's log(|STFT| + 1e-8) turns the CPU FFT's
# absolute float32 rounding into large relative errors at small magnitudes,
# which put the CPU's flagship-encoder gradients (FFN linear1, the temporal
# and spectrogram convs) up to 2.15e-3 of their largest entry from float64,
# while the card's stay within 5e-5.

# HyperEEG at the documented preset (embed 128, 4 heads, sinc kernel 125),
# served bf16 from a checkpoint on (N, 32, 1024) window pairs, and trained as
# eyegaze_tpu_torch.train_hypereeg trains it: f32, batch 256, AdamW at 5e-4
# (weight decay 0.01, clip 1.0), the augment on; the card-vs-CPU step at 16.
HYPEREEG_PARAMETERS = 274_819
HYPEREEG_REQUESTS = (1, 8, 32)  # window pairs per request, each request its own bucket
HYPEREEG_CPU_PAIRS = 8
HYPEREEG_TRAIN_BATCH = 256
HYPEREEG_PARITY_BATCH = 16
HYPEREEG_TRAIN_LR = 5e-4
# The sinc bank's band edges are parameters of up to 40 Hz: at |p| < 64 the
# float32 ulp, 7.6e-6, is 0.76% of HyperEEG's 2 lr = 1e-3, inside the step
# bound's 1% (``check_step_parity``).
HYPEREEG_PARAM_LIMIT = 64.0

# The offline EEG pipeline (phases 27-28) at the recorded trial shape: 32
# channels x 3,250 samples at 250 Hz, seeded synthetic trials.
OFFLINE_FS = 250.0
CSV_TRIALS = 32
CSV_TIME_MAJOR = ((3, "player1"), (22, "player2"))  # a train and a validation file
WINDOWS_TOL = 1e-3  # tests/test_torch_ops.py::test_preprocess_eeg_matches_jax
FEATURE_TRIALS = 256
FEATURE_CHUNKS = (8, 1)
FEATURE_PARITY_TRIALS = 4
FEATURE_WARMUP_TRIALS = 16  # run first at each chunk size, so that the timed runs are warm
FEATURE_ROUNDS = 2
FEATURE_ROW_CHUNK = 8
RESUME_DELETED = (5, 100, 255)
DATASET_TRIALS = 4463  # trials of the recorded dataset: the projected wall time
# One trial's npz arrays: psd (2, 32, 129), band_energy (2, 32, 5), intra
# (2, 7, 5, 32, 32), inter (7, 5, 32, 32), float32.
FEATURE_BYTES = {"psd": 33_024, "band_energy": 1_280, "intra": 286_720, "inter": 143_360}
# tests/test_torch_features.py's bounds: PSD and band energy 1e-3 relative
# and 1e-5 absolute; pearson, power_corr, PLV, coherence 1e-3 absolute;
# phase_diff 1e-2 rad wrapped where PLV >= 1e-2; PLI and wPLI (means of
# signs) 0.1 at most and 1e-2 on average; intra PLI 0 on the diagonal.
# Between chunkings tests/test_scripts.py's: 0.08 for intra and inter, 1e-3
# for the rest.
CHUNK_TOL = {"intra": 0.08, "inter": 0.08}
SPECTRAL_ENTROPY_TOL = 1e-4  # bits, tests/test_torch_entropy.py
SPATIAL_ENTROPY_RTOL = 1e-5
HEATMAPS, HEATMAP_SHAPE = 16, (1583, 3000)  # the native gaze heatmap, (H, W, 3)

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# HBM bytes per second and dense operations per second by type.
# Importing a reference checkpoint (phase 30): the flagship at one
# non-default geometry besides GEOMETRY; at T = 1024 its stride-2 frontend
# gives 256 tokens, 313 in all.
IMPORT_ALT_GEOMETRY = dict(in_channels=CHANNELS, num_classes=3, d_model=128, num_layers=4,
                           num_heads=4, d_ff=512, max_len=320, conv_kernel_size=15,
                           conv_stride=2, conv_layers=2, sampling_rate=SAMPLING_RATE,
                           ibs_feature_type="phase", ibs_instance_norm=False)
IMPORT_ALT_FLAGS = ["--num-heads", "4", "--conv-stride", "2"]
IMPORT_WINDOWS = 10  # windows per imported EEG / ART request: bucket 32, one forward
IMPORT_PAIRS = 2  # gaze and composite pairs per request: bucket 8, one forward
# analyze_eeg at full width on the imported flagship (phase 31): the JAX
# script's defaults, its numeric stages; the embedding stage needs
# scikit-learn, which the card's host lacks.
ANALYSIS_FLAGS = ["--trials", "24", "--batch-size", "16", "--channels", str(CHANNELS),
                  "--window", str(WINDOW), "--fs", str(SAMPLING_RATE)]
ANALYSIS_STAGES = "metrics,frequency,ibs,attention,gradcam"
ANALYSIS_TOL = 2e-3  # card (K1) vs CPU (its plain version), f32 both: the cross-device bound
# A Grad-CAM map is a gradient through the whole network times the
# activation: each CSV map is held at this share of its largest entry, plus
# the CSV's resolution (1e-6), as tests/test_torch_analyze_eeg_maps.py holds
# it.  The maps themselves, card against CPU, at ANALYSIS_CAM_MAP_SHARE of
# each map's largest entry: at full width a map is a discontinuous function
# of float32 rounding.  A conv2 output within rounding of 0 flips its ReLU's
# mask, which moves that channel's weight, the gradient's spatial mean, by a
# finite step, so two float32 runs that round differently (cuFFT against the
# CPU's FFT) can put a map a few percent apart.  Phase 31 prints the
# evidence beside the check: the CPU's maps moved by an input change of
# ANALYSIS_NUDGE (relative, float32 rounding's size), and the card's maps
# with K1's plain twin and with cuDNN off.
ANALYSIS_CAM_SHARE = 5e-3
ANALYSIS_CAM_MAP_SHARE = 5e-2
ANALYSIS_NUDGE = 1e-7
ANALYSIS_NUDGE_DRAWS = 4
# Gaze introspection on ViT-B/16 early fusion (phase 32): card vs CPU, f32
# both; saliency is a gradient through 12 blocks, held at this share of
# each map's largest entry; the CLS features at the cross-device bound.
GAZE_INTROSPECT_PAIRS = 2
GAZE_MAP_SHARE = 2e-3
# analyze_gaze's numeric stages at full width (phase 33): the JAX script's
# synthetic validation set at --trials 24 through ViT-B/16 early and late
# fusion, weights from seed 0 (analyze_gaze.build_model), card vs CPU, f32
# both.  The logits, probabilities and CLS features are held at
# GAZE_ANALYSIS_TOL: phase 32 measures the CLS features about 5e-6 apart,
# and a logit is a weighted sum of them through the head.  The
# predictions and every table built from them must be equal wherever every
# trial's top-two logit margin on the card exceeds 3 x GAZE_ANALYSIS_TOL
# (tests/test_torch_analyze_eeg.py's rule); saliency at GAZE_MAP_SHARE of
# each map's largest entry, as in phase 32.
GAZE_ANALYSIS_TRIALS = 24
GAZE_ANALYSIS_MODELS = (("early", "concat"), ("late", "full"))
GAZE_ANALYSIS_TOL = 1e-4
# analyze_entropy's EEG file path at the recorded trial shape (phase 34): 64
# reference-named CSVs of (32, 3250) (32 synthetic trials x 2 players),
# fs 250, the default 0.5-50 Hz band, card vs CPU.  A float32 filtfilt,
# Welch and entropy on each device: the spectral entropies are held at
# twice the gap of each device's entropies from a float64 filtfilt and
# Welch (scipy), which tests/test_torch_analyze_entropy_synthetic.py bounds
# at 5e-5 for T = 3250 (ENTROPY_TOL; the phase prints both devices' gaps
# from it) and 1.5e-4 for compute_real_entropy's T = 1024
# (ENTROPY_SYNTHETIC_TOL).  Its spatial entropies at ENTROPY_SPATIAL_RTOL,
# the cross-framework bound of tests/test_torch_entropy.py.
ENTROPY_TRIALS = 32
ENTROPY_FS = 250.0
ENTROPY_TOL = 1e-4
ENTROPY_SYNTHETIC_TOL = 3e-4
ENTROPY_SPATIAL_RTOL = 1e-5
ENTROPY_SYNTHETIC_TRIALS = 30
# The full-scale rehearsal (phase 35), cut to fit this script's time: the
# JAX script's defaults are --trials 4463 --csv-trials 100 --jpg-trials 112
# (--features-trials 64 stays).  The windows of the first REHEARSAL_CHECKED
# train trials are held against the CPU's preprocess_and_window.
REHEARSAL_FLAGS = ["--trials", "448", "--csv-trials", "32", "--jpg-trials", "16",
                   "--features-trials", "64"]
REHEARSAL_CHECKED = 4
REHEARSAL_SERVED = 16  # validation windows served from the trained checkpoint
# Phase 36, data parallelism: the CLI's run on DP_CLI_TRIALS synthetic
# trials of one window (192 train windows: 3 steps at batch 64; 48
# validation windows: one eval batch), and DP_WORLD ranks sharing the one
# card through gloo for DP_STEPS steps of the flagship and of bf16 ART.
DP_CLI_TRIALS = 240
DP_WORLD = 2
DP_STEPS = 3
# Phase 37 (tensor parallelism): two ranks at tp2 and four at dp2,tp2 sharing
# the card; a tp2 rank holds 4 of ART's 8 heads.
TP_MESH, TP_DPTP, TP_WORLD, TP_STEPS = "tp2", "dp2,tp2", 2, 3
TP_ATTN_SHAPE = (16, 1024, 4, 16)  # (B, T, H, d): ART's train batch at 8 / tp heads
TP_SERVE_SHARE = 2.0 ** -5  # the port's bf16 card bound, of the largest |output|
# Two ranks against one process in bf16: the same math, rounded to bf16
# at other places (the products' shapes differ), as ART's bf16 step
# against the CPU (ART_BF16_LOSS_RTOL): the losses, the first step's
# gradient norm and the largest parameter change after the steps within
# 2**-8 relative.  On the card the first bf16 step's gradient norm was
# 1.4e-3 apart, past check_step_parity's float32 1e-3, which the float32
# step is held to.
DP_BF16_RTOL = 2.0 ** -8
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # float32 on the CUDA cores
BF16_OPS_PER_S = 989e12   # bf16 on the tensor cores
SMS = 132                 # streaming multiprocessors
SFU_EX2_PER_CLOCK = 16    # exponentials per clock per SM (the SFU)


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of the bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bound(shape, plv: bool) -> tuple[float, str]:
    """K1 / K2 at (N, C, T): four inputs read once, three or five (N, C, C)
    outputs written once.  Per pair and sample K1 issues 7 FP32 instructions
    (the difference, the sign as a compare and a sign-bit OR, the sign sum,
    the |dphi| sum, two FMAs for sign * pw1 and sign * pw2), K2 four FMAs
    more (11), plus a sin and a cos of each phase sample.  Each instruction
    takes one lane-cycle of the SM's FP32 lanes, as an FMA does, and the
    peak counts an FMA as two operations: so 2 operations per instruction,
    14 (K1) or 22 (K2) per pair and sample, against ``F32_OPS_PER_S``."""
    n, c, t = shape
    outs = 5 if plv else 3
    ops = 2 * (11 if plv else 7) * n * c * c * t + (4 * n * c * t if plv else 0)
    return bound(4 * (4 * n * c * t + outs * n * c * c), ops, F32_OPS_PER_S)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def attention_bound(b, h, t, d, dtype) -> tuple[float, str]:
    """(B, H, T, d) attention: Q, K, V read once and O written once, against
    4 * B * H * T^2 * d matmul operations at the f32 CUDA-core or the bf16
    tensor-core peak."""
    size = 4 if dtype == torch.float32 else 2
    rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    return bound(4 * b * h * t * d * size, 4 * b * h * t * t * d, rate)


def sfu_ex2_ms(b, h, t, clock_hz) -> float:
    """ms for one exponential per score, B * H * T^2, on the SFU alone (16 a
    clock per SM on 132 SMs at ``clock_hz``).  A diagnostic, not a floor:
    the FMA pipes can compute exp2 as a polynomial too."""
    return b * h * t * t / (SFU_EX2_PER_CLOCK * SMS * clock_hz) * 1e3


def path_kernel_shapes() -> tuple:
    """The (N, C, T) at which the serving run launches K1, one per request size.

    ``Predictor`` zero-pads each request's windows up to its bucket, and
    ``connectivity_matrices`` stacks the six bands, so N = 6 * bucket:
    5, 15 and 80 windows run at buckets 8, 32 and 128.
    """
    from eyegaze_tpu_torch.serving import _bucket

    return tuple((6 * _bucket(trials * WINDOWS_PER_TRIAL, BUCKETS), CHANNELS, WINDOW)
                 for trials in REQUESTS)


def train_kernel_shapes() -> tuple:
    """The (N, C, T) at which flagship training launches K1: N = 6 x the
    batch rows, one launch per forward: the bench's train batch of 64 and
    the last (ragged) eval batch of the train-then-serve run's validation
    split (one window per synthetic trial of 1,024 samples)."""
    from eyegaze_tpu_torch.data.metadata import stratified_split

    d = flagship_train_config(".").data
    labels = np.arange(d.synthetic_trials) % 3  # the balanced synthetic fixtures
    val = len(stratified_split(list(range(len(labels))), labels, d.train_test_split,
                               d.random_seed)[1])
    eval_rows = val % min(TRAIN_BATCH, val) or min(TRAIN_BATCH, val)
    return ((6 * TRAIN_BATCH, CHANNELS, WINDOW), (6 * eval_rows, CHANNELS, WINDOW))


def composite_kernel_shapes() -> tuple:
    """The (N, C, T) at which the composite's EEG encoder launches K1: one
    (N, 32, 1024) window pair per gaze pair, N = 6 bands x the bucket when
    served, 6 x the batch of 8 in a train step, 6 x the 4 validation
    windows in the train run's eval."""
    served = tuple((6 * b, CHANNELS, WINDOW) for b in MM_BUCKETS)
    return served + ((6 * MM_TRAIN_BATCH, CHANNELS, WINDOW),
                     (6 * max(MM_TRAIN_TRIALS // 5, 1), CHANNELS, WINDOW))


def analysis_kernel_shapes() -> tuple:
    """The (N, C, T) at which phase 31's analysis launches K1: N = 6 bands x
    the windows of each batch of the analysed validation split, one launch
    per forward; and N = 96, a full batch of 16."""
    from eyegaze_tpu_torch import analyze_eeg

    args = analyze_eeg.parse_args(ANALYSIS_FLAGS + ["--device", "cpu"])
    sizes = {len(b["label"]) for b in analyze_eeg.make_batches(args)()} | {16}
    return tuple((6 * n, CHANNELS, WINDOW) for n in sorted(sizes))


def cuda_ms(fn, reps: int, calls: int = 1) -> list[float]:
    """Per-call device times of ``fn`` in ms, from CUDA events around
    ``calls`` calls in a row."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def phase_inputs(shape, device, seed):
    n, c, t = shape
    r = np.random.default_rng(seed)
    ph1 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2[:, 0] = ph1[:, 0]  # exact ties exercise sign(0) = 0
    pw1 = r.random((n, c, t)).astype(np.float32)
    pw2 = r.random((n, c, t)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (ph1, ph2, pw1, pw2)]


def phase_kernel_phase(device, plv: bool) -> tuple[dict, dict]:
    """K1 (K2 with ``plv``) against its plain version at its timed shapes,
    at RAGGED_SHAPE and at UNALIGNED_SHAPE, whose rows the kernel stages
    element by element.  The tied pair (0, 0) must give mean sign and
    Phase_Diff 0 (and mean cos 1): padded samples add nothing.

    Timed shapes: K1 the serving run's (``path_kernel_shapes``), the
    training run's (``train_kernel_shapes``), the composite's
    (``composite_kernel_shapes``) and the analysis's
    (``analysis_kernel_shapes``), K2 PLV_SHAPES.  Kernel and
    plain version are timed in turns, one call between CUDA events, and the
    kernel again as 20 calls replayed from a CUDA graph (device time alone).
    Returns the JSON fields at the largest timed shape, and those of every
    timed shape by shape.
    """
    from eyegaze_tpu_torch.kernels import phase_metrics

    name = "K2" if plv else "K1"
    kernel = phase_metrics.phase_plv_metric_sums if plv else phase_metrics.phase_metric_sums
    plain = (phase_metrics.pairwise_phase_plv_metrics_reference if plv
             else phase_metrics.pairwise_phase_metrics_reference)
    timed = PLV_SHAPES if plv else tuple(dict.fromkeys(
        path_kernel_shapes() + train_kernel_shapes() + composite_kernel_shapes()
        + analysis_kernel_shapes()))
    max_err = 0.0
    for seed, shape in enumerate(timed + (RAGGED_SHAPE, UNALIGNED_SHAPE)):
        x = phase_inputs(shape, device, seed)
        got = kernel(*x)
        torch.cuda.synchronize()
        errs = phase_metrics.assert_sums_close(got, plain(*x), x[2], x[3])
        max_err = max(max_err, *errs)
        tie_cos = float((got[3][:, 0, 0] - 1.0).abs().max()) if plv else 0.0
        if (got[0][:, 0, 0].any() or got[2][:, 0, 0].any()
                or tie_cos > phase_metrics.PLV_TOL["atol"]):
            raise RuntimeError(f"{name} {shape}: tied pair (0, 0) gives mean sign "
                               f"{got[0][:, 0, 0].tolist()}, pdiff {got[2][:, 0, 0].tolist()}, "
                               f"|mean cos - 1| {tie_cos:.3e}")
        print(f"{name} {shape}: max |kernel - plain| "
              + ", ".join(f"{k} {e:.3e}" for k, e in zip(SUM_NAMES, errs))
              + f" (|wnum| max {float(got[1].abs().max()):.1f}); tied pair (0, 0) mean sign and "
              + "pdiff 0" + (f", |mean cos - 1| {tie_cos:.3e}" if plv else "")
              + ": within tolerance")
        del x, got

    per_shape = {}
    for seed, shape in enumerate(timed):
        x = phase_inputs(shape, device, seed)
        ms, plain_ms = alternate_ms(lambda: kernel(*x), lambda: plain(*x))
        ms_graph = graph_ms(lambda: kernel(*x))
        split = phase_metrics.split(*shape)
        blocks = phase_metrics.grid_blocks(shape[0], shape[1], split)
        bound_ms, bound_by = phase_bound(shape, plv)
        print(f"{name} {shape}: kernel median {ms:.4f} ms, plain median {plain_ms:.4f} ms over "
              f"20 calls each (CUDA events, one call between them); replayed from a CUDA graph "
              f"of {BACK_TO_BACK} calls {ms_graph:.4f} ms, {bound_ms / ms_graph:.0%} of the "
              f"bound {bound_ms:.4f} ms ({bound_by}); T split over {split} block(s) of a "
              f"cluster, {blocks} blocks on {SMS} SMs")
        per_shape[shape] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "ms_graph": ms_graph, "split": split,
                            "shape": list(shape)}
        del x
    largest = max(timed, key=lambda shape: shape[0])
    return {"max_abs_err": max_err, "library_ms": None, **per_shape[largest]}, per_shape


def windows(raw: np.ndarray, device) -> torch.Tensor:
    from eyegaze_tpu_torch.ops.preprocess import preprocess_eeg, sliding_windows

    x = preprocess_eeg(torch.from_numpy(raw).to(device), sampling_rate=SAMPLING_RATE)
    return sliding_windows(x, WINDOW, STRIDE).reshape(-1, CHANNELS, WINDOW)


def flagship_raw() -> tuple[np.ndarray, np.ndarray]:
    """The raw (TRIALS, 32, 3250) pairs every flagship phase serves."""
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(TRIALS, CHANNELS, RAW_SAMPLES)).astype(np.float32)
                 for _ in range(2))


def serve_flagship(pred, device, name: str):
    """Warm ``pred`` up and drive raw trials -> windows -> ``pred.predict``
    for each request size of REQUESTS, REPEATS times.  Every forward must
    launch K1 once.  Returns the K1 launches of the run (counted from 0),
    the median wall ms of each request size and the first request's logits."""
    from eyegaze_tpu_torch.kernels import phase_metrics

    raw1, raw2 = flagship_raw()
    t0 = time.perf_counter()
    pred.warmup(CHANNELS, WINDOW)
    print(f"{name}: warmup of buckets {BUCKETS}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    windows(raw1[:1], device)  # the filter's constants are made once per signal length
    print(f"{name}: first preprocess call: {time.perf_counter() - t0:.2f} s")

    first, medians = None, {}
    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)
    for trials in REQUESTS:
        walls = []
        for _ in range(REPEATS):
            before = phase_metrics.launch_count["phase_metric_sums"]
            t0 = time.perf_counter()
            out = pred.predict(windows(raw1[:trials], device), windows(raw2[:trials], device))
            walls.append((time.perf_counter() - t0) * 1e3)
            n = trials * WINDOWS_PER_TRIAL
            forwards = math.ceil(n / BUCKETS[-1])
            launched = phase_metrics.launch_count["phase_metric_sums"] - before
            if launched != forwards:
                raise RuntimeError(f"{forwards} forwards launched K1 {launched} times")
            logits = out["logits"]
            if logits.shape != (n, 3) or not np.isfinite(logits).all():
                raise RuntimeError(f"bad logits: shape {logits.shape}, finite "
                                   f"{np.isfinite(logits).all()}")
            if not np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5):
                raise RuntimeError("probs do not sum to 1")
            if first is None:
                first = logits
        medians[trials] = statistics.median(walls)
        print(f"{name}: request of {trials} trial(s) = {n} windows: wall ms "
              f"{[round(w, 3) for w in walls]}, median {medians[trials]:.3f} "
              f"(preprocess + windows + predict; logits back on the host)")
    launches = phase_metrics.launch_count["phase_metric_sums"]
    if launches == 0 or phase_metrics.launch_count["phase_plv_metric_sums"] != 0:
        raise RuntimeError(f"the serving path's phase-metrics launches: "
                           f"{phase_metrics.launch_count}")
    print(f"K1 launches during the {name} run: {launches}")
    return launches, medians, first


def slice_phase(device):
    """Drive raw trials -> windows -> Predictor on ``device`` (float32).

    Returns the kernel launches of the run, the median wall ms of each
    request size, the raw pair of the first request, its logits and the
    model's state_dict.
    """
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    model = DualEEGTransformer(**GEOMETRY, device=device,
                               generator=torch.Generator().manual_seed(0))
    print(f"DualEEGTransformer: {sum(p.numel() for p in model.parameters()):,} parameters "
          f"on {device}")
    pred = Predictor(model, device=device, batch_buckets=BUCKETS, preprocess=False)
    launches, medians, first = serve_flagship(pred, device, "flagship (f32)")
    raw1, raw2 = flagship_raw()
    return launches, medians, raw1[:1], raw2[:1], first, model.state_dict()


def save_checkpoint(state, meta: dict, path: Path) -> Path:
    """``state`` as the export script writes it (a CPU state_dict saved with
    ``torch.save``) and ``meta`` beside it as ``.meta.json``."""
    torch.save({k: v.cpu() for k, v in state.items()}, path)
    path.with_suffix(".meta.json").write_text(json.dumps(meta))
    return path


def flagship_bf16_phase(device, tmp: Path, state, f32_medians, f32_logits):
    """Serve the f32 phase's weights as the JAX package serves them: from a
    checkpoint, in bf16 compute.  Returns the K1 launches of the run and the
    checkpoint's path."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.serving import Predictor

    path = save_checkpoint(state, FLAGSHIP_META, tmp / "flagship.pt")
    pred = Predictor.from_checkpoint(path, device=device, batch_buckets=BUCKETS)
    if pred.model.dtype != torch.bfloat16 or pred.preprocess:
        raise RuntimeError(f"from_checkpoint built dtype {pred.model.dtype}, preprocess "
                           f"{pred.preprocess}")
    reset_attention_counts()
    launches, medians, logits = serve_flagship(pred, device, "flagship (bf16, from a checkpoint)")
    if any(attention.launch_count.values()):
        raise RuntimeError("the flagship's 139-token attention launched the attention kernel")
    for trials in REQUESTS:
        print(f"flagship request of {trials} trial(s), median wall ms: bf16 {medians[trials]:.3f}, "
              f"f32 {f32_medians[trials]:.3f}")
    cpu = torch.device("cpu")
    raw1, raw2 = flagship_raw()
    want = Predictor.from_checkpoint(path, device=cpu, batch_buckets=BUCKETS).predict(
        windows(raw1[:1], cpu), windows(raw2[:1], cpu))["logits"]
    gap = float(np.abs(logits - want).max())
    tol = LOGIT_BF16_TOL_SHARE * float(np.abs(want).max())
    print(f"1-trial logits, bf16 compute: card vs CPU max |diff| {gap:.3e} (tolerance {tol:.3e}, "
          f"2**-5 of the largest |logit| {float(np.abs(want).max()):.3f}); bf16 vs f32 on the "
          f"card {float(np.abs(logits - f32_logits).max()):.3e}")
    if not gap <= tol:
        raise RuntimeError(f"bf16 flagship, card vs CPU: {gap:.3e} over {tol:.3e}")
    return launches, path


def http_phase(device, path: Path) -> None:
    """``eyegaze_tpu_torch.serve --dynamic-batch`` on the bf16 checkpoint, in
    a thread: HTTP_REQUESTS concurrent single-trial requests, each answer
    held to a direct ``predict`` of its rows."""
    from eyegaze_tpu_torch import serve
    from eyegaze_tpu_torch.kernels import phase_metrics
    from eyegaze_tpu_torch.serving import Predictor

    raw1, raw2 = flagship_raw()
    w1, w2 = (windows(r[:HTTP_REQUESTS], device).cpu().numpy() for r in (raw1, raw2))
    rows = [slice(i * WINDOWS_PER_TRIAL, (i + 1) * WINDOWS_PER_TRIAL)
            for i in range(HTTP_REQUESTS)]
    direct = Predictor.from_checkpoint(path, device=device, batch_buckets=(HTTP_BUCKET,))
    want = [direct.predict(w1[r], w2[r]) for r in rows]
    del direct

    bound = []
    argv = ["--checkpoint", str(path), "--device", str(device), "--host", "127.0.0.1",
            "--port", "0", "--buckets", str(HTTP_BUCKET), "--dynamic-batch"]
    thread = threading.Thread(target=serve.main, args=(argv, bound.append), daemon=True)
    thread.start()
    for _ in range(600):
        if bound or not thread.is_alive():
            break
        thread.join(0.5)
    if not bound:
        raise RuntimeError("eyegaze_tpu_torch.serve did not start")
    server = bound[0]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)

        def post(r):
            buf = io.BytesIO()
            np.savez(buf, eeg1=w1[r], eeg2=w2[r])
            req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                out = json.load(resp)
            return out, (time.perf_counter() - t0) * 1e3

        with ThreadPoolExecutor(HTTP_REQUESTS) as pool:
            answers = list(pool.map(post, rows))
        launches = phase_metrics.launch_count["phase_metric_sums"]
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as resp:
            metrics = json.load(resp)
    finally:
        server.shutdown()
        thread.join(60)
    for i, ((got, _), ref) in enumerate(zip(answers, want)):
        logits = np.asarray(got["logits"], np.float32)
        if not np.array_equal(logits, ref["logits"]) or got["labels"] != ref["labels"]:
            raise RuntimeError(f"request {i}: answer {got['labels']} / max |diff| "
                               f"{float(np.abs(logits - ref['logits']).max()):.3e} is not the "
                               f"direct predict's {ref['labels']}")
    batch = metrics["dynamic_batch"]
    if batch["requests"] != HTTP_REQUESTS or not batch["dispatches"] < HTTP_REQUESTS:
        raise RuntimeError(f"{HTTP_REQUESTS} requests took {batch['dispatches']} dispatches")
    if launches != batch["dispatches"]:
        raise RuntimeError(f"{batch['dispatches']} dispatches launched K1 {launches} times")
    walls = np.array([ms for _, ms in answers])
    print(f"HTTP, {HTTP_REQUESTS} concurrent single-trial requests ({WINDOWS_PER_TRIAL} windows "
          f"each) through eyegaze_tpu_torch.serve --dynamic-batch, bucket {HTTP_BUCKET}: every "
          f"answer equals the direct predict of its rows, labels included; "
          f"{batch['dispatches']} dispatches of {batch['max_coalesced']} requests at most, "
          f"{launches} K1 launches; request wall ms p50 {np.percentile(walls, 50):.3f}, "
          f"p99 {np.percentile(walls, 99):.3f}, all {sorted(round(float(w), 3) for w in walls)}; "
          f"server phases {batch['phase_breakdown']}")


def cpu_parity(raw1, raw2, logits, state, **flags) -> None:
    """The first request's card logits against the same weights on the CPU."""
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    cpu = torch.device("cpu")
    model = DualEEGTransformer(**GEOMETRY, **flags, device=cpu,
                               generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    out = Predictor(model, device=cpu, batch_buckets=BUCKETS, preprocess=False).predict(
        windows(raw1, cpu), windows(raw2, cpu))
    torch.testing.assert_close(torch.from_numpy(logits), torch.from_numpy(out["logits"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    err = float(np.abs(logits - out["logits"]).max())
    print(f"{len(raw1)}-trial logits {flags or ''}, card vs CPU (plain kernel twin): max |diff| "
          f"{err:.3e}, |logits| max {float(np.abs(logits).max()):.3f}, tolerance {LOGIT_TOL}")


def attention_inputs(shape, dtype, device, seed):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


def assert_within_bf16_bound(got, want, terms) -> float:
    """bf16: each side rounds every probability to bf16 (2**-9 relative), the
    kernel unnormalised and the twin normalised, and its output once more
    (2**-8 relative: 8 significant bits).  So |got - want| <= 2**-8 *
    sum_j p_j |v_j| + 2**-7 |want|, where ``terms``, the sum, is the twin run
    on |v|.  Returns the largest share of the bound used."""
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -8 * terms.float() + 2.0 ** -7 * want.float().abs() + 1e-6
    share = float((err / bound).max())
    if share > 1.0:
        raise AssertionError(f"bf16 attention off by {float(err.max()):.3e}: {share:.2f}x "
                             "its rounding bound")
    return share


def graph_ms(fn, calls: int = BACK_TO_BACK, reps: int = 10) -> float:
    """Median device ms per call of ``fn``, ``calls`` calls captured in one
    CUDA graph and replayed between CUDA events: no host enqueue time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return statistics.median(cuda_ms(graph.replay, reps)) / calls


def alternate_ms(*fns, rounds: int = 10, calls: int = 1) -> list[float]:
    """Median CUDA-event ms per call of each function, timed in turns after
    a warm-up, ``calls`` calls between one pair of events."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(rounds):  # in turns, so drift in clocks hits all alike
        for fn, acc in zip(fns, times):
            acc += cuda_ms(fn, 2, calls)
    return [statistics.median(t) for t in times]


def attention_phase(device, clock_hz) -> dict:
    """Both attention entry points against the twin; timings at ART's
    serving shapes and K4's, one call and ``BACK_TO_BACK`` calls between
    events.  Returns the JSON fields of each (entry point, dtype) the paths
    launch."""
    from eyegaze_tpu_torch.kernels import attention

    serving = [(b, WINDOW, ATTN_HEADS, ATTN_DK) for b in ART_BUCKETS]
    err = {}  # (entry, dtype) -> max |kernel - twin|
    cases = [("headpacked_attention", shape, dt) for shape in serving + [ATTN_RAGGED]
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(("flash_attention", FLASH_SHAPE, torch.bfloat16))
    for seed, (entry, shape, dt) in enumerate(cases):
        q, k, v = attention_inputs(shape, dt, device, seed)
        scale = 1.0 / math.sqrt(shape[-1])
        if entry == "headpacked_attention":  # compare in (B, H, T, d)
            got = attention.headpacked_attention(q, k, v, scale).transpose(1, 2)
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        else:
            got = attention.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = attention.attention_reference(q, k, v, scale)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, **ATTN_F32_TOL)
            bound = f"tolerance {ATTN_F32_TOL}"
        else:
            share = assert_within_bf16_bound(got, want,
                                             attention.attention_reference(q, k, v.abs(), scale))
            bound = f"{share:.2f} of the bf16 bound"
        e = float((got.float() - want.float()).abs().max())
        err[entry, dt] = max(err.get((entry, dt), 0.0), e)
        print(f"{entry} {shape} {str(dt)[6:]}: max |kernel - twin| {e:.3e} "
              f"(|out| max {float(want.float().abs().max()):.3f}), {bound}")
        del q, k, v, got, want

    times = {}
    for seed, (entry, shape, dt) in enumerate(cases):
        if shape == ATTN_RAGGED:
            continue
        q, k, v = attention_inputs(shape, dt, device, seed)
        scale = 1.0 / math.sqrt(shape[-1])
        if entry == "headpacked_attention":
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel = lambda: attention.headpacked_attention(q, k, v, scale)  # noqa: E731
        else:
            qt, kt, vt = q, k, v
            kernel = lambda: attention.flash_attention(q, k, v, scale)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)  # noqa: E731
        ms, plain_ms, library_ms = alternate_ms(
            kernel, lambda: attention.attention_reference(qt, kt, vt, scale), library)
        ms_b2b, library_ms_b2b = alternate_ms(kernel, library, calls=BACK_TO_BACK)
        ms_graph, library_ms_graph = graph_ms(kernel), graph_ms(library)
        bound_ms, bound_by = attention_bound(*qt.shape, dt)
        sfu_ms = sfu_ex2_ms(*qt.shape[:3], clock_hz)
        times[(entry, shape, dt)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                     "bound_by": bound_by, "sfu_ex2_ms": sfu_ms,
                                     "library_ms": library_ms, "ms_back_to_back": ms_b2b,
                                     "library_ms_back_to_back": library_ms_b2b,
                                     "ms_graph": ms_graph, "library_ms_graph": library_ms_graph}
        tiling = ""
        if dt == torch.float32:
            rows = attention.f32_rows_per_thread(shape[0], shape[2], shape[1], shape[3])
            times[(entry, shape, dt)]["rows_per_thread"] = rows
            tiling = f" ({rows} query rows per thread)"
        print(f"{entry} {shape} {str(dt)[6:]}{tiling}: kernel median {ms:.4f} ms, twin median "
              f"{plain_ms:.4f} ms, F.scaled_dot_product_attention median {library_ms:.4f} ms "
              f"over 20 calls each (CUDA events, one call between them); back to back "
              f"({BACK_TO_BACK} calls between events) kernel {ms_b2b:.4f} ms, library "
              f"{library_ms_b2b:.4f} ms; replayed from a CUDA graph of {BACK_TO_BACK} calls "
              f"kernel {ms_graph:.4f} ms, library {library_ms_graph:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_by}); exponentials on the SFU alone "
              f"{sfu_ms:.4f} ms (not a floor)")
        del q, k, v, qt, kt, vt
    largest = serving[-1]  # the 16-window request's bucket
    fields = {}
    for entry, shape, dt in (("headpacked_attention", largest, torch.float32),
                             ("headpacked_attention", largest, torch.bfloat16),
                             ("flash_attention", FLASH_SHAPE, torch.bfloat16)):
        fields[entry, dt] = {"max_abs_err": err[entry, dt], **times[(entry, shape, dt)],
                             "shape": list(shape), "dtype": str(dt)[6:]}
    return fields


def reset_attention_counts() -> None:
    from eyegaze_tpu_torch.kernels import attention

    for counts in (attention.launch_count, attention.bf16_launch_count):
        counts.update(headpacked_attention=0, flash_attention=0)


def art_phase(device, dtype=torch.float32):
    """Serve (N, 32, 1024) windows through ArtDenoiser at full width, in
    ``dtype`` compute.

    Every launch must be of the head-packed entry point's instance for
    ``dtype``.  Returns those launches, the median wall ms of each request
    size, the windows served, each request size's output (its last repeat)
    and the model's state_dict.
    """
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    name = f"ART ({str(dtype)[6:]} compute)"
    model = ArtifactRemovalTransformer(ArtConfig(), device=device, dtype=dtype,
                                       generator=torch.Generator().manual_seed(0))
    print(f"{name} {ArtConfig()}: "
          f"{sum(p.numel() for p in model.parameters()):,} parameters on {device}")
    den = ArtDenoiser(model, device=device, batch_buckets=ART_BUCKETS)
    t0 = time.perf_counter()
    den.warmup(CHANNELS, WINDOW)
    print(f"warmup of buckets {ART_BUCKETS}: {time.perf_counter() - t0:.2f} s")
    noisy = np.random.default_rng(1).normal(
        size=(max(ART_REQUESTS), CHANNELS, WINDOW)).astype(np.float32)

    def instance_launches() -> int:  # head-packed launches of the dtype's instance
        bf16 = attention.bf16_launch_count["headpacked_attention"]
        return bf16 if dtype == torch.bfloat16 else (
            attention.launch_count["headpacked_attention"] - bf16)

    if dtype == torch.float32:
        rows = {b: attention.f32_rows_per_thread(b, ATTN_HEADS, WINDOW, ATTN_DK)
                for b in ART_BUCKETS}
        print(f"{name}: the f32 attention instance's query rows per thread at each bucket: "
              f"{rows}")
    outs, medians = {}, {}
    reset_attention_counts()
    for n in ART_REQUESTS:
        walls = []
        for _ in range(REPEATS):
            before = instance_launches()
            t0 = time.perf_counter()
            out = den.predict(noisy[:n])["denoised"]
            walls.append((time.perf_counter() - t0) * 1e3)
            forwards = math.ceil(n / ART_BUCKETS[-1])
            launched = instance_launches() - before
            if launched != ART_ATTENTION_CALLS * forwards:
                raise RuntimeError(f"{forwards} forwards launched the attention kernel's "
                                   f"{str(dtype)[6:]} instance {launched} times, not "
                                   f"{ART_ATTENTION_CALLS * forwards}")
            if out.shape != (n, CHANNELS, WINDOW) or not np.isfinite(out).all():
                raise RuntimeError(f"bad output: shape {out.shape}, finite "
                                   f"{np.isfinite(out).all()}")
        outs[n] = out
        medians[n] = statistics.median(walls)
        print(f"{name} request of {n} window(s): wall ms {[round(w, 3) for w in walls]}, "
              f"median {medians[n]:.3f} (predict; output back on the host)")
    launches = instance_launches()
    if (launches == 0 or launches != attention.launch_count["headpacked_attention"]
            or attention.launch_count["flash_attention"] != 0):
        raise RuntimeError(f"{name}'s attention launches: {attention.launch_count}, of them "
                           f"bf16 {attention.bf16_launch_count}")
    print(f"head-packed attention launches ({str(dtype)[6:]} instance) during the {name} "
          f"run: {launches}")
    return launches, medians, noisy, outs, model.state_dict()


def art_cpu_parity(noisy, denoised, state, dtype=torch.float32) -> np.ndarray:
    """The first request's card output against the same weights, served in
    the same compute type on the CPU; returns the CPU's output."""
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    cpu = torch.device("cpu")
    model = ArtifactRemovalTransformer(ArtConfig(), device=cpu, dtype=dtype,
                                       generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    want = ArtDenoiser(model, device=cpu, batch_buckets=ART_BUCKETS).predict(noisy)["denoised"]
    if dtype == torch.float32:
        tol = dict(rtol=ART_TOL, atol=ART_TOL)
    else:
        tol = dict(rtol=0, atol=ART_BF16_TOL_SHARE * float(np.abs(want).max()))
    torch.testing.assert_close(torch.from_numpy(denoised), torch.from_numpy(want), **tol)
    print(f"1-window ART output ({str(dtype)[6:]} compute), card vs CPU (plain attention "
          f"twin): max |diff| {float(np.abs(denoised - want).max()):.3e}, |out| max "
          f"{float(np.abs(want).max()):.3f}, tolerance {tol}")
    return want


def art_bf16_phase(device, f32_medians, f32_denoised):
    """ART served in bf16 compute: the same weights and requests as the f32
    phase, 18 bf16 head-packed launches per forward, the 1-window output
    against the CPU's bf16 run.  Returns the launches of the run, the
    windows, the outputs of each request size and the state_dict."""
    launches, medians, noisy, outs, state = art_phase(device, torch.bfloat16)
    for n in ART_REQUESTS:
        print(f"ART request of {n} window(s), median wall ms: bf16 {medians[n]:.3f}, "
              f"f32 {f32_medians[n]:.3f} ({f32_medians[n] / medians[n]:.2f}x)")
    n = ART_REQUESTS[0]
    want = art_cpu_parity(noisy[:n], outs[n], state, torch.bfloat16)
    print(f"1-window ART output, bf16 vs f32 compute, same weights: max |diff| on the card "
          f"{float(np.abs(outs[n] - f32_denoised).max()):.3e}, on the CPU's bf16 against "
          f"the card's f32 {float(np.abs(want - f32_denoised).max()):.3e}")
    return launches, noisy, outs, state


def art_checkpoint_phase(device, tmp: Path, state, noisy, outs) -> int:
    """``ArtDenoiser.from_checkpoint`` (bf16) on the bf16 phase's weights,
    saved as a state_dict plus meta: the 16-window request at bucket 32
    launches the bf16 instance 18 times and gives, to the bit, the bf16
    phase's output for the same windows.  Returns the launches."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.art import ArtConfig
    from eyegaze_tpu_torch.serving import ArtDenoiser

    meta = {"config": {"model": dataclasses.asdict(ArtConfig())}}
    den = ArtDenoiser.from_checkpoint(save_checkpoint(state, meta, tmp / "art.pt"),
                                      device=device, batch_buckets=ART_BUCKETS)
    den.warmup(CHANNELS, WINDOW)
    n = ART_REQUESTS[-1]
    reset_attention_counts()
    out = den.predict(noisy[:n])["denoised"]
    launches, bf16 = dict(attention.launch_count), dict(attention.bf16_launch_count)
    if den.model.dtype != torch.bfloat16 or launches != bf16 or launches != {
            "headpacked_attention": ART_ATTENTION_CALLS, "flash_attention": 0}:
        raise RuntimeError(f"ArtDenoiser.from_checkpoint ({den.model.dtype}), one forward at "
                           f"bucket {ART_BUCKETS[-1]}: {launches}, of them bf16 {bf16}")
    if not np.array_equal(out, outs[n]):
        raise RuntimeError(f"ART from a checkpoint differs from the bf16 phase's output for the "
                           f"same weights: max |diff| {float(np.abs(out - outs[n]).max()):.3e}")
    print(f"ART from a checkpoint (bf16), {n} windows at bucket {ART_BUCKETS[-1]}: "
          f"{bf16['headpacked_attention']} bf16 head-packed launches, output equal to the bit "
          "to the bf16 phase's")
    return bf16["headpacked_attention"]


def kernel_route_phase(device, shape) -> dict:
    """A bf16 MultiHeadAttention of ``shape`` (B, H, T, d_k) takes its kernel
    route on every forward (flash at d_k 128, head-packed at d_k 64) and
    matches its own plain path (forced by returning weights); then it trains
    through the route, FLASH_TRAIN_STEPS AdamW steps, each one forward launch
    and one backward call of K4's backward on the path the library picks for
    the shape (``attention.backward_path``: at d_k 128 the dQ and dK/dV
    kernels, at d_k 64 the wgmma one-pass kernel), and one backward's
    gradients match the plain route's within 2**-5 of each tensor's largest
    |entry| (k_proj.bias of the largest gradient; the bound of
    tests/test_torch_attention.py).  Returns the entry, its forward
    launches, the backward calls and the backward path and its launches,
    counted from 0 for the phase."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.transformer import MultiHeadAttention, init_weights_
    from eyegaze_tpu_torch.train.optim import make_optimizer

    b, h, t, d = shape
    entry = "flash_attention" if d % 128 == 0 else "headpacked_attention"
    path = attention.backward_path(t, d)
    route = entry.split("_")[0]
    mha = MultiHeadAttention(h * d, h, device=device, dtype=torch.bfloat16)
    init_weights_(mha, torch.Generator().manual_seed(2))
    mha.eval()
    x = torch.randn(b, t, h * d, generator=torch.Generator().manual_seed(3)).to(
        device, torch.bfloat16)
    reset_attention_counts()
    reset_backward_count()
    with torch.inference_mode():
        outs = [mha(x, x, x) for _ in range(FLASH_CALLS)]
        launches, bf16 = dict(attention.launch_count), dict(attention.bf16_launch_count)
        plain = mha(x, x, x, return_weights=True)[0]
    torch.cuda.synchronize()
    want_launches = {"headpacked_attention": 0, "flash_attention": 0, entry: FLASH_CALLS}
    if launches != bf16 or launches != want_launches:
        raise RuntimeError(f"{FLASH_CALLS} bf16 d_k-{d} forwards: {launches}, of them "
                           f"bf16 {bf16}")
    # The contexts agree to the bf16 bound of the attention phase; out_proj
    # sums h d of them with weights of std (h d)**-0.5 and rounds once more
    # to bf16.
    torch.testing.assert_close(outs[0].float(), plain.float(), rtol=2.0 ** -7, atol=2.0 ** -6)
    print(f"{route} route, bf16 MultiHeadAttention (B {b}, T {t}, H {h}, d_k {d}): "
          f"{launches[entry]} launches for {FLASH_CALLS} forwards, "
          f"max |kernel route - plain route| {float((outs[0].float() - plain.float()).abs().max()):.3e}")

    target = torch.randn(b, t, h * d, generator=torch.Generator().manual_seed(4)).to(device)
    mha.train()  # no dropout in the module: the kernel route under grad
    opt = make_optimizer(mha, 1e-4, 0.01, grad_clip=1.0)
    losses = []
    for _ in range(FLASH_TRAIN_STEPS):
        loss = (mha(x, x, x).float() - target).square().mean()
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    counts = (attention.launch_count[entry], attention.backward_count[entry],
              dict(attention.backward_launch_count), dict(attention.stock_backward_count))
    want = (FLASH_CALLS + FLASH_TRAIN_STEPS, FLASH_TRAIN_STEPS,
            {**{p: 0 for p in attention.BACKWARD_LAUNCHES},
             path: attention.BACKWARD_LAUNCHES[path] * FLASH_TRAIN_STEPS},
            {"float32": 0, "bfloat16": 0})
    if counts != want or not np.isfinite(losses).all():
        raise RuntimeError(f"{FLASH_TRAIN_STEPS} {route}-route train steps: (forward "
                           f"launches, backward calls, backward kernel launches by path, stock) "
                           f"{counts}, not {want}; losses {losses}")
    grads = []
    for weights in (False, True):  # the kernel route, then the plain route
        out = mha(x, x, x, return_weights=weights)
        ((out[0] if weights else out).float() - target).square().mean().backward()
        grads.append({n: p.grad.detach().clone() for n, p in mha.named_parameters()})
        opt.zero_grad()
    largest = max(float(g.abs().max()) for g in grads[1].values())
    shares = sorted(((float((grads[0][n] - w).abs().max()) / (
        largest if n == "k_proj.bias" else float(w.abs().max())), n)
        for n, w in grads[1].items()), reverse=True)
    print(f"{route} route trains: {FLASH_TRAIN_STEPS} AdamW steps, losses "
          f"{[round(v, 5) for v in losses]}, {counts[1]} backward calls of K4's backward "
          f"(kernel launches by path {counts[2]}), no stock backward; gradients against the plain "
          f"route's, the largest |difference| as a share of the tensor's largest |entry| "
          f"(bound 2**-5): " + ", ".join(f"{n} {v:.4f}" for v, n in shares[:3]))
    if shares[0][0] > 2.0 ** -5:
        raise RuntimeError(f"the {route} route's gradient {shares[0][1]} is not the plain route's")
    return {"entry": entry, "launches": counts[0], "backward_calls": counts[1], "path": path,
            "backward_launches": counts[2][path]}


def shootout_phase() -> tuple[dict, dict]:
    """The connectivity shootout at its defaults on the card.

    Returns its result and the phase-metrics launches of the run, counted
    from 0: the run is the path that launches K2.
    """
    from eyegaze_tpu_torch import bench_connectivity
    from eyegaze_tpu_torch.kernels import phase_metrics

    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)
    result = bench_connectivity.main([])  # prints its JSON line
    launches = dict(phase_metrics.launch_count)
    if result["device"] != torch.cuda.get_device_name(0) or not all(launches.values()):
        raise RuntimeError(f"shootout on {result['device']!r} launched {launches}")
    for key, limit in SHOOTOUT_BOUNDS.items():
        if not result[key] <= limit:
            raise RuntimeError(f"shootout {key} {result[key]:.3e} over its bound {limit:.1e}")
    print(f"shootout: differences within {SHOOTOUT_BOUNDS}; launches {launches}")
    return result, launches


def legacy_phase(device):
    """Serve 3-trial requests through the legacy IBS configuration
    (``use_robust_ibs=False``) at full width; it launches no phase-metrics
    kernel.  Returns the raw pair of the request, its logits and the state."""
    from eyegaze_tpu_torch.kernels import phase_metrics
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.serving import Predictor

    model = DualEEGTransformer(**GEOMETRY, use_robust_ibs=False, device=device,
                               generator=torch.Generator().manual_seed(0))
    print(f"DualEEGTransformer(use_robust_ibs=False): "
          f"{sum(p.numel() for p in model.parameters()):,} parameters on {device}")
    pred = Predictor(model, device=device, batch_buckets=BUCKETS, preprocess=False)
    pred.warmup(CHANNELS, WINDOW)
    rng = np.random.default_rng(2)
    raw1, raw2 = (rng.normal(size=(LEGACY_TRIALS, CHANNELS, RAW_SAMPLES)).astype(np.float32)
                  for _ in range(2))
    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = pred.predict(windows(raw1, device), windows(raw2, device))
        walls.append((time.perf_counter() - t0) * 1e3)
    n = LEGACY_TRIALS * WINDOWS_PER_TRIAL
    logits = out["logits"]
    if logits.shape != (n, 3) or not np.isfinite(logits).all():
        raise RuntimeError(f"bad logits: shape {logits.shape}, finite {np.isfinite(logits).all()}")
    if any(phase_metrics.launch_count.values()):
        raise RuntimeError(f"the legacy IBS token launched {phase_metrics.launch_count}")
    print(f"legacy IBS request of {LEGACY_TRIALS} trials = {n} windows: wall ms "
          f"{[round(w, 3) for w in walls]}, median {statistics.median(walls):.3f}; "
          f"phase-metrics launches {phase_metrics.launch_count}")
    return raw1, raw2, logits, model.state_dict()


def flagship_train_config(output_dir, *, bf16: bool = True, dropout: float = 0.1):
    """The flagship's training config at full width, built from the
    dataclasses (no YAML): the default ModelConfig, 96 seeded synthetic
    trials of 1,024 samples, the bench's recipe, one epoch."""
    from eyegaze_tpu_torch.config import DataConfig, ExperimentConfig, SystemConfig, TrainingConfig
    from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES

    return ExperimentConfig(
        data=DataConfig(window_size=WINDOW, stride=STRIDE, sampling_rate=SAMPLING_RATE,
                        synthetic=True, synthetic_trials=96),
        training=TrainingConfig(output_dir=str(output_dir), num_train_epochs=1,
                                per_device_train_batch_size=TRAIN_BATCH,
                                per_device_eval_batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR,
                                weight_decay=0.01, grad_clip=1.0, dropout=dropout, bf16=bf16,
                                **BENCH_LOSSES),
        system=SystemConfig(seed=0, device="cuda"))


def bench_batch(n: int, device, seed: int = 1) -> dict:
    """The bench's train batch: normal (n, 32, 1024) window pairs, labels
    cycling over the three classes."""
    r = np.random.default_rng(seed)
    e1, e2 = (r.normal(size=(n, CHANNELS, WINDOW)).astype(np.float32) for _ in range(2))
    return {"eeg1": torch.from_numpy(e1).to(device), "eeg2": torch.from_numpy(e2).to(device),
            "label": torch.from_numpy((np.arange(n) % 3).astype(np.int32)).to(device)}


def one_step(model, loss_fn, batch, lr: float) -> tuple:
    """One optimizer step (AdamW at ``lr``, weight decay 0.01, clip 1.0) on
    ``batch``: (loss, grad norm, each parameter's change on the CPU, the
    parameters before, wall seconds, each parameter's gradient before the
    clip on the CPU by name)."""
    from eyegaze_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer(model, lr, 0.01, grad_clip=1.0)
    before = [p.detach().clone() for p in model.parameters()]
    t0 = time.perf_counter()
    loss, _ = loss_fn(model.train(), batch)
    loss.backward()
    # Copies, on the CPU too: the clip scales the gradients in place.
    grads = {n: p.grad.detach().to("cpu", copy=True) for n, p in model.named_parameters()
             if p.grad is not None}
    norm = opt.step()
    step = [(p.detach() - b).cpu() for p, b in zip(model.parameters(), before)]
    return loss.item(), norm.item(), step, before, time.perf_counter() - t0, grads


def check_step_parity(name: str, card: tuple, cpu: tuple, lr: float, loss_tol: float,
                      param_limit: float = 8.0) -> None:
    """``one_step`` on the card against the CPU: the loss within
    ``loss_tol``, the gradient norm within PARITY_GRAD_NORM_RTOL, the
    largest parameter change within PARITY_STEP_RTOL and every entry within
    2 lr + 1% (the Adam bound, reasoned at PARITY_STEP_RTOL for parameters
    below ``param_limit``, whose float32 ulp is under 1% of 2 lr)."""
    (loss, norm, step, params, card_s, _), (cpu_loss, cpu_norm, cpu_step, _, cpu_s, _) = card, cpu
    largest = max(float(d.abs().max()) for d in step)
    cpu_largest = max(float(d.abs().max()) for d in cpu_step)
    apart = max(float((a - b).abs().max()) for a, b in zip(step, cpu_step))
    apart_bound = 2 * lr * 1.01
    max_p = max(float(p.abs().max()) for p in params)
    print(f"{name}, card vs CPU: loss {loss:.6f} / {cpu_loss:.6f} (|diff| "
          f"{abs(loss - cpu_loss):.3e}, bound {loss_tol}); grad norm {norm:.6f} / {cpu_norm:.6f} "
          f"(rel diff {abs(norm / cpu_norm - 1):.3e}, bound {PARITY_GRAD_NORM_RTOL}); largest "
          f"parameter change {largest:.6e} / {cpu_largest:.6e}, entries apart by {apart:.3e} at "
          f"most (bound 2 lr + 1%: {apart_bound:.3e}); max |p| {max_p:.3f}; wall "
          f"{card_s:.2f} / {cpu_s:.2f} s")
    if not (abs(loss - cpu_loss) <= loss_tol
            and abs(norm / cpu_norm - 1) <= PARITY_GRAD_NORM_RTOL
            and abs(largest / cpu_largest - 1) <= PARITY_STEP_RTOL
            and apart <= apart_bound and max_p < param_limit):
        raise RuntimeError(f"{name}: the card's train step is not the CPU's within the bounds")


def check_grad_parity(name: str, card: dict, want: dict, zero: tuple,
                      against: str = "CPU") -> None:
    """Each gradient tensor of a ``one_step`` on the card against ``want``
    (the CPU's, or ``against`` another reference's): within
    PARITY_GRAD_SHARE of the reference tensor's largest |entry|, those
    named with a suffix in ``zero`` within PARITY_ZERO_GRAD_SHARE of the
    largest gradient entry of all."""
    if card.keys() != want.keys():
        raise RuntimeError(f"{name}: the card and the {against} have gradients for other "
                           "parameters")
    largest = max(float(g.abs().max()) for g in want.values())
    shares = []
    for k, w in want.items():
        bound = (PARITY_ZERO_GRAD_SHARE * largest if k.endswith(zero)
                 else PARITY_GRAD_SHARE * float(w.abs().max()))
        shares.append((float((card[k].double() - w.double()).abs().max()) / bound, k))
    shares.sort(reverse=True)
    worst = ", ".join(f"{k} {share:.3f}" for share, k in shares[:3])
    print(f"{name}, card vs {against}, {len(want)} gradient tensors, the largest |difference| "
          f"as a share of its bound ({PARITY_GRAD_SHARE} of the tensor's largest |entry|, "
          f"{PARITY_ZERO_GRAD_SHARE} of the largest gradient for {', '.join(zero)}): {worst}")
    if shares[0][0] > 1.0:
        raise RuntimeError(f"{name}: the gradient {shares[0][1]} differs from the {against}'s")


def train_parity_phase(device) -> None:
    """One f32 train step without dropout on the card and on the CPU, from
    the same seeded weights and batch: the loss, the gradient norm and the
    parameter change held to the bounds above."""
    from eyegaze_tpu_torch.train_dual_eeg import build_model, make_objective

    cfg = flagship_train_config(".", bf16=False, dropout=0.0)
    loss_fn, _ = make_objective(cfg)
    out = []
    for dev in (device, torch.device("cpu")):
        model = build_model(cfg, device=dev)
        for m in model.modules():  # the IBS head's fixed 0.3 too
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        out.append(one_step(model, loss_fn, bench_batch(PARITY_BATCH, dev, seed=3), TRAIN_LR))
    check_step_parity(f"one f32 flagship train step at batch {PARITY_BATCH} without dropout",
                      *out, TRAIN_LR, LOGIT_TOL)


def reset_k1_count() -> None:
    from eyegaze_tpu_torch.kernels import phase_metrics

    phase_metrics.launch_count.update(phase_metric_sums=0, phase_plv_metric_sums=0)


def k1_count() -> int:
    from eyegaze_tpu_torch.kernels import phase_metrics

    if phase_metrics.launch_count["phase_plv_metric_sums"]:
        raise RuntimeError(f"flagship training launched K2: {phase_metrics.launch_count}")
    return phase_metrics.launch_count["phase_metric_sums"]


def profile_steps(step, n: int = PROFILED_STEPS) -> dict:
    """``torch.profiler`` over ``n`` calls of ``step`` (each ending in a
    synchronize): CUDA kernels per call, the summed kernel time against the
    wall time (the device's busy share), and K1's kernel time per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    k1 = sum(e.device_time for e in kernels if "phase_metrics_kernel" in e.name) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"kernels_per_call": len(kernels) / n, "busy_share": busy / wall,
            "kernel_ms_per_call": busy / n, "wall_ms_per_call": wall / n, "k1_ms_per_call": k1 / n,
            "top_kernels": [(name[:60], ms / max(busy, 1e-9)) for name, ms in top]}


def assert_no_port_kernel(name: str) -> None:
    """Raises if K1, K2 or an attention kernel launched since the counts
    were last set to 0."""
    from eyegaze_tpu_torch.kernels import attention, phase_metrics

    counts = {**phase_metrics.launch_count, **attention.launch_count,
              **{f"bf16 {k}": v for k, v in attention.bf16_launch_count.items()}}
    if any(counts.values()):
        raise RuntimeError(f"{name} launched a kernel of the port: {counts}")


def time_train_steps(name: str, trainer, batch, device, *, reset=None, read=None,
                     profiled: bool = True) -> dict:
    """TRAIN_WARMUP steps of ``trainer.train_step(batch)``; then ``reset()``
    and TRAIN_STEPS steps from a fresh peak-memory count, each timed to a
    ``torch.cuda.synchronize()``, and ``read()`` (the timed steps'
    launches, as "counts"); then, where ``profiled``, ``profile_steps``
    over PROFILED_STEPS more.  Raises unless every timed loss is finite.
    Returns the times, losses, peak memory, counts and profile, with
    ``summary``, a line of them for the phase's print."""
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    if reset is not None:
        reset()
    walls, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    median = statistics.median(walls)
    out = {"median_ms": median, "walls_ms": walls, "peak_bytes":
           torch.cuda.max_memory_allocated(device), "counts": read() if read else None}
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{name}: losses {losses}")
    out["summary"] = (f"{TRAIN_WARMUP} warm-up steps {warmup_s:.2f} s; {TRAIN_STEPS} steps, "
                      f"CUDA-synchronized wall ms median {median:.3f}, min {min(walls):.3f}, "
                      f"max {max(walls):.3f}; peak memory {out['peak_bytes'] / 2**30:.3f} GiB; "
                      f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite")
    if profiled:
        def step():
            trainer.train_step(batch)
            torch.cuda.synchronize()

        prof = profile_steps(step)
        out.update(prof, busy_share_of_median=prof["kernel_ms_per_call"] / median)
        out["summary"] += (
            f"; torch.profiler over {PROFILED_STEPS} steps: {prof['kernels_per_call']:.0f} CUDA "
            f"kernels a step, kernel time {prof['kernel_ms_per_call']:.3f} of "
            f"{prof['wall_ms_per_call']:.3f} ms a step, busy share {prof['busy_share']:.1%} (of "
            f"the unprofiled median {out['busy_share_of_median']:.1%})")
    return out


def train_timed_phase(device, dtype) -> dict:
    """``Trainer.train_step`` at full width on the bench's batch of 64,
    with dropout 0.1 in ``dtype`` compute (``time_train_steps``, not
    profiled).  Every forward must launch K1 once.  Returns the times, the
    peak memory and K1's launches."""
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
    from eyegaze_tpu_torch.train_dual_eeg import build_model, make_objective

    name = str(dtype)[6:]
    cfg = flagship_train_config(".", bf16=dtype == torch.bfloat16)
    model = build_model(cfg, device=device, dtype=dtype)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, make_optimizer(model, TRAIN_LR, 0.01, grad_clip=1.0),
                      *make_objective(cfg), TrainerConfig(seed=0), device=device)
    t = time_train_steps(f"{name} training", trainer, bench_batch(TRAIN_BATCH, device), device,
                         reset=reset_k1_count, read=k1_count, profiled=False)
    launches = t["counts"]
    if launches != TRAIN_STEPS:
        raise RuntimeError(f"{name} training: {launches} K1 launches for {TRAIN_STEPS} forwards")
    print(f"flagship train step ({name} compute, dropout 0.1, batch {TRAIN_BATCH}, "
          f"{n_params:,} parameters): {t['summary']}; "
          f"{TRAIN_BATCH * 1e3 / t['median_ms']:.1f} window pairs/s; K1 launches {launches} for "
          f"{TRAIN_STEPS} forwards")
    return {**t, "launches": launches, "parameters": n_params}


def train_serve_phase(device, tmp: Path) -> tuple[int, dict]:
    """``train_dual_eeg.run`` (``main`` without its YAML) at full width
    for one epoch on the synthetic fixtures, bf16 as the YAML trains, with
    ``--watch 1``, into ``tmp``; then ``Predictor.from_checkpoint`` serves
    the validation windows from the best_model.pt it wrote, on the card.
    Its logits must be the trainer's own eval logits within 2**-5 of the
    largest |logit|.  Returns K1's launches in the training run and the run's
    history as ``LearningCurveAnalyzer`` and ``WatchAnalyzer`` read it back
    from its RunLogger JSONL and watch sidecar, beside the trainer's
    ``best_metric`` (phase 34 checks them)."""
    from eyegaze_tpu_torch import train_dual_eeg
    from eyegaze_tpu_torch.analysis.learning_curves import LearningCurveAnalyzer, WatchAnalyzer
    from eyegaze_tpu_torch.serving import Predictor

    cfg = flagship_train_config(tmp / "train")
    reset_k1_count()
    t0 = time.perf_counter()
    result = train_dual_eeg.run(cfg, device=device, watch=1)
    run_s = time.perf_counter() - t0
    launches = k1_count()
    trainer = result["trainer"]
    jsonl = Path(cfg.training.output_dir) / f"{cfg.wandb.run_name}.jsonl"
    history = {"curves": LearningCurveAnalyzer.from_jsonl(jsonl),
               "watch": WatchAnalyzer.for_run(jsonl), "best_metric": result["best_metric"]}
    _, val = train_dual_eeg.prepare_datasets(cfg)
    eval_batches = math.ceil(len(val) / min(TRAIN_BATCH, len(val)))
    # The watch takes one more forward and backward on the epoch's last batch.
    if launches != trainer.optimizer.count + eval_batches + 1:
        raise RuntimeError(f"{trainer.optimizer.count} train steps, {eval_batches} eval "
                           f"batches and the watch launched K1 {launches} times")
    path = Path(cfg.training.output_dir) / "checkpoints" / "best_model.pt"
    pred = Predictor.from_checkpoint(path, device=device, batch_buckets=BUCKETS)
    windows_ = val.batch(list(range(len(val))))
    logits = pred.predict(windows_["eeg1"], windows_["eeg2"])["logits"]
    want = trainer.eval_logits
    gap = float(np.abs(logits - want).max())
    tol = LOGIT_BF16_TOL_SHARE * float(np.abs(want).max())
    print(f"train_dual_eeg --watch 1, 1 epoch at full width on {len(val)} validation windows: "
          f"{trainer.optimizer.count} step(s) of {TRAIN_BATCH}, {eval_batches} eval batch(es), "
          f"the watch's step, {launches} K1 launches, {run_s:.2f} s; best_model.pt served by "
          f"Predictor.from_checkpoint (bf16): max |logits - the trainer's eval logits| "
          f"{gap:.3e} (tolerance {tol:.3e}, 2**-5 of the largest |logit|)")
    if not (logits.shape == want.shape and gap <= tol):
        raise RuntimeError(f"the served checkpoint's logits differ from training's: {gap:.3e}")
    return launches, history


def reset_backward_count() -> None:
    from eyegaze_tpu_torch.kernels import attention

    attention.backward_count.update(headpacked_attention=0, flash_attention=0)
    attention.backward_launch_count.update(one_pass=0, two_kernel=0, one_pass_wgmma=0)
    attention.stock_backward_count.update(float32=0, bfloat16=0)


def art_train_counts() -> tuple[int, int]:
    """(f32 head-packed launches, backward calls) since the last reset;
    raises on any other attention launch, and on a backward call that did
    not take the stock backward."""
    from eyegaze_tpu_torch.kernels import attention

    launches = attention.launch_count["headpacked_attention"]
    backward = attention.backward_count["headpacked_attention"]
    if (attention.launch_count["flash_attention"] or attention.bf16_launch_count[
            "headpacked_attention"] or any(attention.backward_launch_count.values())
            or attention.stock_backward_count != {"float32": backward, "bfloat16": 0}):
        raise RuntimeError(f"f32 ART training launched {attention.launch_count}, of them bf16 "
                           f"{attention.bf16_launch_count}, backward kernels "
                           f"{attention.backward_launch_count}; stock backward calls "
                           f"{attention.stock_backward_count} of {backward}")
    return launches, backward


def art_bf16_train_counts() -> tuple[int, int, int]:
    """(bf16 head-packed launches, backward calls, launches of the one-pass
    backward kernel) since the last reset; raises on any other attention
    launch, on any launch of the two-kernel backward path (ART's Tk of 1024
    is within one cluster's reach) and on any call of the stock backward."""
    from eyegaze_tpu_torch.kernels import attention

    launches = attention.bf16_launch_count["headpacked_attention"]
    if (attention.launch_count != {"headpacked_attention": launches, "flash_attention": 0}
            or attention.backward_count["flash_attention"]
            or attention.backward_launch_count["two_kernel"]
            or attention.backward_launch_count["one_pass_wgmma"]
            or any(attention.stock_backward_count.values())):
        raise RuntimeError(f"bf16 ART training launched {attention.launch_count}, of them bf16 "
                           f"{attention.bf16_launch_count}; backward kernels "
                           f"{attention.backward_launch_count}; stock backward calls "
                           f"{attention.stock_backward_count}")
    return (launches, attention.backward_count["headpacked_attention"],
            attention.backward_launch_count["one_pass"])


def art_train_model(device, attn_dropout, dtype=torch.float32):
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer

    return ArtifactRemovalTransformer(ArtConfig(attn_dropout=attn_dropout), device=device,
                                      dtype=dtype, generator=torch.Generator().manual_seed(42))


def art_train_batch(n: int, device) -> dict:
    from eyegaze_tpu_torch import train_art

    return {k: torch.from_numpy(v).to(device)
            for k, v in train_art.build_dataset(n, CHANNELS, WINDOW).arrays.items()}


def art_train_parity_phase(device) -> tuple[float, tuple[int, int], dict]:
    """One dropout-free ART step at full width (``attn_dropout=0.0``) at
    batch 2 on the card, through K3 and its autograd Function (18 launches,
    18 backward calls), and on the CPU through the plain path, from the
    same seeded weights: held as the flagship's step, and each gradient
    tensor against the CPU's.  Then the Function's dq, dk, dv at ART's
    training shape against autograd through the plain twin.  Returns their
    largest difference, the step's (launches, backward calls) on the card
    and the CPU's gradients."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.kernels import attention

    loss_fn, _ = train_art.make_objective(False)
    out = []
    for dev in (device, torch.device("cpu")):
        model = art_train_model(dev, 0.0)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        reset_attention_counts()
        reset_backward_count()
        out.append(one_step(model, loss_fn, art_train_batch(ART_PARITY_BATCH, dev),
                            ART_TRAIN_LR))
        if dev.type == "cuda":
            step_counts = art_train_counts()
            if step_counts != (ART_ATTENTION_CALLS, ART_ATTENTION_CALLS):
                raise RuntimeError(f"one ART step launched K3 and its backward "
                                   f"{step_counts} times, not {ART_ATTENTION_CALLS}")
    name = (f"one f32 ART train step at batch {ART_PARITY_BATCH} without dropout "
            f"({ART_ATTENTION_CALLS} K3 launches and backward calls on the card)")
    check_step_parity(name, *out, ART_TRAIN_LR, ART_TOL)
    check_grad_parity(name, out[0][-1], out[1][-1], ("k_proj.bias",))
    cpu_f32_grads = out[1][-1]

    q, k, v, g = attention_inputs(ART_TRAIN_SHAPE, torch.float32, device, 20) + \
        attention_inputs(ART_TRAIN_SHAPE, torch.float32, device, 21)[:1]
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    scale = 1.0 / math.sqrt(ATTN_DK)
    got = torch.autograd.grad(attention.headpacked_attention(q, k, v, scale), (q, k, v), g)
    ref = attention.attention_reference(*(x.transpose(1, 2) for x in (q, k, v)), scale)
    want = torch.autograd.grad(ref.transpose(1, 2), (q, k, v), g)
    errs = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err, largest = float((a - w).abs().max()), float(w.abs().max())
        errs.append(err)
        print(f"K3 autograd Function at {ART_TRAIN_SHAPE} f32, {name}: max |Function - autograd "
              f"through the twin| {err:.3e}, |{name}| max {largest:.3e} (bound "
              f"{ART_GRAD_SHARE} of it)")
        if not err <= ART_GRAD_SHARE * largest:
            raise RuntimeError(f"K3's backward {name} off by {err:.3e}")
    return max(errs), step_counts, cpu_f32_grads


def attention_train_timing(device) -> dict:
    """The Function's forward + backward (K3, then the stock-op backward)
    against ``F.scaled_dot_product_attention``'s forward + backward, the
    same function on the same inputs, at ART's training shape in f32; the
    kernel's forward alone beside them, and the peak memory one backward
    holds in transit."""
    from eyegaze_tpu_torch.kernels import attention

    q, k, v, g = attention_inputs(ART_TRAIN_SHAPE, torch.float32, device, 22) + \
        attention_inputs(ART_TRAIN_SHAPE, torch.float32, device, 23)[:1]
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    scale = 1.0 / math.sqrt(ATTN_DK)
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))

    def forward():
        with torch.no_grad():
            attention.headpacked_attention(q, k, v, scale)

    def function():
        torch.autograd.grad(attention.headpacked_attention(q, k, v, scale), (q, k, v), g)

    def library():
        torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                            (q, k, v), gt)

    fwd_ms, ms, library_ms = alternate_ms(forward, function, library)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    function()
    torch.cuda.synchronize()
    transit = torch.cuda.max_memory_allocated(device) - base
    b, t, h, d = ART_TRAIN_SHAPE
    # The backward's five matmuls (scores, dv, dp, dq, dk), 2 B H T^2 d
    # operations each, against q, k, v, g read once and dq, dk, dv written.
    bwd_bound, bwd_by = bound(7 * b * t * h * d * 4, 10 * b * h * t * t * d, F32_OPS_PER_S)
    fwd_bound, _ = attention_bound(b, h, t, d, torch.float32)
    print(f"K3 under autograd at {ART_TRAIN_SHAPE} f32: forward (kernel) {fwd_ms:.4f} ms, "
          f"forward + backward (Function) {ms:.4f} ms, F.scaled_dot_product_attention forward "
          f"+ backward {library_ms:.4f} ms (median CUDA-event ms, 20 each, in turns); backward "
          f"bound {bwd_bound:.4f} ms ({bwd_by}: its five matmuls at {F32_OPS_PER_S / 1e12:g} "
          f"TFLOP/s), forward + backward bound {fwd_bound + bwd_bound:.4f} ms; peak memory in "
          f"transit during one forward + backward {transit / 2**30:.3f} GiB")
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": ms, "library_fwd_bwd_ms": library_ms,
            "bwd_bound_ms": bwd_bound, "fwd_bwd_bound_ms": fwd_bound + bwd_bound,
            "bwd_transit_gib": transit / 2**30, "shape": list(ART_TRAIN_SHAPE)}


# The backward's kernels by path, as torch.profiler names them.
BWD_KERNELS = {"one_pass": ("attention_bwd_one_pass_kernel",),
               "one_pass_wgmma": ("attention_bwd_one_pass_wgmma_kernel",),
               "two_kernel": ("attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")}


def attention_backward_phase(device, clock_hz) -> dict:
    """K4's backward in bf16 under autograd, at ``attention.BACKWARD_CASES``
    and ``attention.BACKWARD_PAST_REACH``, each on the path the library
    picks (``attention.backward_path``: the one-pass kernel at d = 16 within
    its reach, else the dQ and dK/dV kernels): dq, dk, dv against the twin on the same forward
    output and log-sum-exp (the forward's LSE against the twin's too) and
    against ``F.scaled_dot_product_attention``'s gradients; the kernels'
    time alone (one call, back to back, graph; each kernel's device time
    from ``torch.profiler``, which must see the kernels of the case's path
    and no other) beside the twin's and the library's backward
    (``aten._scaled_dot_product_flash_attention_backward`` on its own
    forward's outputs), the bound and the exponentials; the Function's
    forward + backward beside the library's and beside the old stock
    backward's, with each one's peak memory in transit.  Returns each
    case's fields; the first case's (ART's shape) are the one-pass
    kernel's on the kernels line, the second's (K4's) the two kernels'."""
    from eyegaze_tpu_torch.kernels import attention

    return [backward_case(device, clock_hz, 40 + seed, entry, shape, tk)
            for seed, (entry, shape, tk) in enumerate(
                attention.BACKWARD_CASES + (attention.BACKWARD_PAST_REACH,))]


def backward_case(device, clock_hz, seed: int, entry: str, shape: tuple, tk: int) -> dict:
    """One case of ``attention_backward_phase`` (its docstring): ``entry``
    at (B, Tq, H, d) ``shape`` with ``tk`` keys, inputs drawn from
    ``seed``."""
    from torch.profiler import ProfilerActivity, profile

    from eyegaze_tpu_torch.kernels import attention

    b, tq, h, d = shape
    path = attention.backward_path(tk, d)
    flash = entry == "flash_attention"
    t_dim, h_dim = (2, 1) if flash else (1, 2)
    scale = 1.0 / math.sqrt(d)
    r = np.random.default_rng(seed)
    x = [torch.from_numpy(r.normal(size=(b, t, h, d)).astype(np.float32)).to(
        device, torch.bfloat16) for t in (tq, tk, tk, tq)]
    if flash:
        x = [a.transpose(1, 2).contiguous() for a in x]
    q, k, v, g = x
    for a in (q, k, v):
        a.requires_grad_()
    fn = getattr(attention, entry)
    shape = f"{entry} (B {b}, H {h}, Tq {tq}, Tk {tk}, d {d}) bf16"

    def bhtd(a):
        return a if flash else a.transpose(1, 2)

    out = fn(q, k, v, scale)
    o, lse = out.detach(), out.grad_fn.saved_tensors[4]
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    qd, kd, vd = (a.detach() for a in (q, k, v))
    qt, kt, vt, ot, gt = (bhtd(a) for a in (qd, kd, vd, o, g))
    lse_err = float((lse - attention.attention_lse_reference(qt, kt, scale)).abs().max())
    if not lse_err <= 1e-4:
        raise RuntimeError(f"{shape}: the forward's log-sum-exp is off by {lse_err:.3e}")
    want = attention.flash_attention_backward_reference(qt, kt, vt, ot, lse, gt, scale)
    errs = attention.assert_backward_within(
        shape, [bhtd(a) for a in got], want,
        attention.backward_bound(qt, kt, vt, ot, lse, gt, scale))
    del want
    qs, ks, vs = (bhtd(a).detach().clone().requires_grad_() for a in (q, k, v))
    sdpa = torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs, scale=scale),
                               (qs, ks, vs), gt)
    witness = {label: float(torch.linalg.vector_norm((bhtd(a) - w).float())
                            / torch.linalg.vector_norm(w.float()))
               for label, a, w in zip(("dq", "dk", "dv"), got, sdpa)}
    del sdpa, qs, ks, vs
    if max(witness.values()) > SDPA_WITNESS_RTOL:
        raise RuntimeError(f"{shape}: the kernels' gradients are not "
                           f"F.scaled_dot_product_attention's: {witness}")
    print(f"{shape} backward ({path} path): max |kernels - twin| "
          + ", ".join(f"{k} {e['max_abs_err']:.3e} ({e['share_of_bound']:.2f} of its bound)"
                      for k, e in errs.items())
          + f"; forward LSE within {lse_err:.2e} of the twin's; relative Frobenius distance "
          f"from F.scaled_dot_product_attention's gradients "
          + ", ".join(f"{k} {e:.2e}" for k, e in witness.items())
          + f" (bound {SDPA_WITNESS_RTOL:g})")

    def kernels():
        attention._launch_backward(qd, kd, vd, o, lse, g, scale, t_dim, h_dim)

    def twin():
        attention.flash_attention_backward_reference(qt, kt, vt, ot, lse, gt, scale)

    lib = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, False, False,
                                                             scale=scale)

    def library():
        torch.ops.aten._scaled_dot_product_flash_attention_backward(
            gt, qt, kt, vt, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5], 0.0, False,
            lib[6], lib[7], scale=scale)

    ms, plain_ms, library_ms = alternate_ms(kernels, twin, library)
    ms_b2b, library_b2b = alternate_ms(kernels, library, calls=BACK_TO_BACK)
    ms_graph, library_graph = graph_ms(kernels), graph_ms(library)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BACK_TO_BACK):
            kernels()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and "attention_bwd" in ev.name:
            name = re.search(r"attention_bwd_\w+?_kernel", ev.name).group(0)
            per_kernel[name] = per_kernel.get(name, 0.0) + ev.device_time / 1e3
    per_kernel = {k: v / BACK_TO_BACK for k, v in per_kernel.items()}
    if set(per_kernel) != set(BWD_KERNELS[path]):
        raise RuntimeError(f"{shape}: torch.profiler saw the backward kernels "
                           f"{sorted(per_kernel)} on the {path} path")

    # The bound: the backward's five products (S, dP, dV, dK, dQ), 2 B H
    # Tq Tk d operations each, against Q, K, V, O, dO read, dQ, dK, dV
    # written (bf16), LSE read and Di written once (f32); the one-pass
    # kernel does that work.  On the two-kernel path each kernel's own:
    # dQ recomputes S and dP and sums dQ (3 products), reads q, k, v, o,
    # dO and LSE and writes dQ and Di; dK/dV recomputes S and dP and sums
    # dV and dK (4), reads q, k, v, dO, LSE and Di, writes dK, dV.
    mm = 2 * b * h * tq * tk * d
    q_bytes, k_bytes, row_bytes = 2 * b * tq * h * d, 2 * b * tk * h * d, 4 * b * h * tq
    bwd_bound, bwd_by = bound(4 * q_bytes + 4 * k_bytes + 2 * row_bytes, 5 * mm,
                              BF16_OPS_PER_S)
    dq_bound = bound(3 * q_bytes + 2 * k_bytes + 2 * row_bytes + q_bytes, 3 * mm,
                     BF16_OPS_PER_S)
    dkv_bound = bound(2 * q_bytes + 2 * k_bytes + 2 * row_bytes + 2 * k_bytes, 4 * mm,
                      BF16_OPS_PER_S)
    # How often each score's exponential is taken.
    passes = 1 if path.startswith("one_pass") else 2
    sfu_ms = passes * b * h * tq * tk / (SFU_EX2_PER_CLOCK * SMS * clock_hz) * 1e3

    def function():
        torch.autograd.grad(fn(q, k, v, scale), (q, k, v), g)

    ql, kl, vl = (bhtd(a).detach().clone().requires_grad_() for a in (q, k, v))

    def library_train():
        torch.autograd.grad(F.scaled_dot_product_attention(ql, kl, vl, scale=scale),
                            (ql, kl, vl), gt)

    def stock():  # the kernel forward, then the stock-op backward K3 had
        with torch.no_grad():
            fn(qd, kd, vd, scale)
        bthd = (lambda a: a.transpose(1, 2)) if flash else (lambda a: a)
        attention.attention_backward_reference(bthd(qd), bthd(kd), bthd(vd), bthd(g), scale)

    fwd_bwd_ms, library_fwd_bwd_ms, stock_ms = alternate_ms(function, library_train, stock)
    transit = {}
    for label, call in (("function", function), ("stock", stock)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        call()
        torch.cuda.synchronize()
        transit[label] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    split = ("" if path.startswith("one_pass") else
             f"; dQ kernel {dq_bound[0]:.4f}, dK/dV kernel {dkv_bound[0]:.4f}")
    print(f"{shape} backward kernels alone ({path} path): one call {ms:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in per_kernel.items())
          + f" ms of device time, torch.profiler), back to back {ms_b2b:.4f}, CUDA graph "
          f"{ms_graph:.4f} ({bwd_bound / ms_graph:.0%} of the bound); twin {plain_ms:.4f}; "
          f"the library's backward (aten flash backward) one call {library_ms:.4f}, back to "
          f"back {library_b2b:.4f}, graph {library_graph:.4f}; bound {bwd_bound:.4f} ms "
          f"({bwd_by}: 10 B H Tq Tk d = {5 * mm:.3g} operations at "
          f"{BF16_OPS_PER_S / 1e12:g} TFLOP/s{split}); the {passes * b * h * tq * tk:.3g} "
          f"exponentials on the SFU alone {sfu_ms:.4f} ms (not a floor).  Forward + "
          f"backward: Function "
          f"{fwd_bwd_ms:.4f} ms, F.scaled_dot_product_attention {library_fwd_bwd_ms:.4f} ms, "
          f"kernel forward + the stock-op backward {stock_ms:.4f} ms (in turns); peak "
          f"memory in transit {transit['function']:.3f} GiB (Function) against "
          f"{transit['stock']:.3f} GiB (stock backward)")
    result = {
        "shape": [b, h, tq, d], "tk": tk, "entry": entry, "path": path, "errors": errs,
        "lse_max_abs_err": lse_err, "sdpa_relative_distance": witness,
        "ms": ms, "ms_back_to_back": ms_b2b, "ms_graph": ms_graph,
        "kernel_ms": per_kernel, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_ms_back_to_back": library_b2b, "library_ms_graph": library_graph,
        "bound_ms": bwd_bound, "bound_by": bwd_by, "dq_bound": dq_bound,
        "dkv_bound": dkv_bound, "sfu_ex2_ms": sfu_ms, "fwd_bwd_ms": fwd_bwd_ms,
        "library_fwd_bwd_ms": library_fwd_bwd_ms, "stock_fwd_bwd_ms": stock_ms,
        "transit_gib": transit}
    del q, k, v, g, x, got, out, o, lse, lib, ql, kl, vl
    torch.cuda.empty_cache()
    return result


def art_train_timed_phase(device, attn_dropout) -> dict:
    """``Trainer.train_step`` on ART at full width, batch 16 of (32, 1024)
    pairs, dropout 0.1, attention dropout ``attn_dropout`` (None: follows
    dropout, the plain path; 0.0: K3 and its backward), through
    ``time_train_steps`` (not profiled): 18 K3 launches and backward calls
    a timed step at 0.0, none otherwise."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    name = f"attention dropout {0.1 if attn_dropout is None else attn_dropout}"
    model = art_train_model(device, attn_dropout)
    loss_fn, metrics_fn = train_art.make_objective(False)
    trainer = Trainer(model, make_optimizer(model, ART_TRAIN_LR, 0.01, grad_clip=1.0), loss_fn,
                      None, TrainerConfig(seed=7), device=device, eval_metrics_fn=metrics_fn)

    def reset():
        reset_attention_counts()
        reset_backward_count()

    t = time_train_steps(f"ART training ({name})", trainer,
                         art_train_batch(ART_TRAIN_BATCH, device), device, reset=reset,
                         read=art_train_counts, profiled=False)
    launches, backward = t["counts"]
    want = ART_ATTENTION_CALLS * TRAIN_STEPS if attn_dropout == 0.0 else 0
    if (launches, backward) != (want, want):
        raise RuntimeError(f"ART training ({name}): {launches} K3 launches and {backward} "
                           f"backward calls for {TRAIN_STEPS} steps, not {want}")
    print(f"ART train step (f32, dropout 0.1, {name}, batch {ART_TRAIN_BATCH}): {t['summary']}; "
          f"{ART_TRAIN_BATCH * 1e3 / t['median_ms']:.1f} windows/s; per step "
          f"{launches / TRAIN_STEPS:g} K3 launches, {backward / TRAIN_STEPS:g} backward calls")
    return {**t, "launches": launches, "backward": backward}


def art_train_serve_phase(device, tmp: Path) -> tuple[int, int]:
    """``train_art.run`` at full width for one epoch on ART_TRAIN_TRIALS
    synthetic trials with ``--attn-dropout 0.0`` into ``tmp`` (K3 and its
    backward in each train step, K3 in the evaluation), then
    ``ArtDenoiser.from_checkpoint`` (bf16) serves the validation windows
    from the best_model.pt it wrote: within 2**-5 of the largest output of
    the trained module in f32 (``tgt = src``).  Returns (K3 launches,
    backward calls) of the run."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.serving import ArtDenoiser

    args = train_art.parse_args(["--epochs", "1", "--trials", str(ART_TRAIN_TRIALS),
                                 "--batch-size", str(ART_TRAIN_BATCH), "--attn-dropout", "0.0",
                                 "--output-dir", str(tmp / "art_train")])
    reset_attention_counts()
    reset_backward_count()
    t0 = time.perf_counter()
    result = train_art.run(args, device=device)
    run_s = time.perf_counter() - t0
    launches, backward = art_train_counts()
    trainer, val = result["trainer"], result["val"]
    steps, eval_batches = trainer.optimizer.count, math.ceil(len(val) / ART_TRAIN_BATCH)
    if (launches, backward) != (ART_ATTENTION_CALLS * (steps + eval_batches),
                                ART_ATTENTION_CALLS * steps):
        raise RuntimeError(f"{steps} ART train steps and {eval_batches} eval batch(es) launched "
                           f"K3 {launches} times with {backward} backward calls")
    den = ArtDenoiser.from_checkpoint(tmp / "art_train" / "checkpoints" / "best_model.pt",
                                      device=device, batch_buckets=ART_BUCKETS)
    noisy = val.arrays["input_values"]
    got = den.predict(noisy)["denoised"]
    trainer.model.eval()
    with torch.inference_mode():
        want = trainer.model(torch.from_numpy(noisy).to(device)).cpu().numpy()
    gap, tol = float(np.abs(got - want).max()), ART_BF16_TOL_SHARE * float(np.abs(want).max())
    history = result["history"][-1]
    print(f"train_art, 1 epoch at full width, attention dropout 0.0, {len(val)} validation "
          f"windows: {steps} step(s) of {ART_TRAIN_BATCH}, {eval_batches} eval batch(es), "
          f"{launches} K3 launches, {backward} backward calls, {run_s:.2f} s; val/loss "
          f"{history['val/loss']:.4f}, val/snr_improvement_db "
          f"{history['val/snr_improvement_db']:.3f}; best_model.pt served by "
          f"ArtDenoiser.from_checkpoint (bf16): max |denoised - the trained model's f32 output| "
          f"{gap:.3e} (tolerance {tol:.3e}, 2**-5 of the largest |output|)")
    if den.model.dtype != torch.bfloat16 or got.shape != want.shape or not gap <= tol:
        raise RuntimeError(f"ART served from the trained checkpoint differs: {gap:.3e}")
    return launches, backward


def module_scale(name: str) -> tuple[str, str]:
    """The module a parameter belongs to for ART_BF16_GRAD_SHARE (an
    attention block or FFN for its projections, else the parameter's own
    module) and its kind (weight or bias)."""
    owner, kind = name.rsplit(".", 1)
    if owner.rsplit(".", 1)[-1] in ("q_proj", "k_proj", "v_proj", "out_proj", "linear1",
                                    "linear2"):
        owner = owner.rsplit(".", 1)[0]
    return owner, kind


def module_shares(got: dict, want: dict, own: bool = False) -> list:
    """(share, name) for each tensor, largest first: its largest |got -
    want| over the largest |entry| of ``want``'s gradients of its module
    and kind (``module_scale``), or of its own with ``own``."""
    scale = {}
    for k, w in want.items():
        key = k if own else module_scale(k)
        scale[key] = max(scale.get(key, 0.0), float(w.abs().max()))
    return sorted(((float((got[k].double() - w.double()).abs().max())
                    / scale[k if own else module_scale(k)], k) for k, w in want.items()),
                  reverse=True)


def art_bf16_train_parity_phase(device, cpu_f32_grads: dict) -> tuple[int, int, int]:
    """One dropout-free bf16 ART step at full width (``attn_dropout=0.0``)
    at batch 2 on the card, through K3's bf16 instance and K4's one-pass
    backward kernel (18 launches, 18 backward calls of one launch each, none
    of the two-kernel path, no stock backward), and on the CPU through the plain path, from the same seeded
    weights: the loss within ART_BF16_LOSS_RTOL, every gradient tensor within
    ART_BF16_GRAD_SHARE on its module's scale (``module_shares``), beside
    the CPU's own bf16-vs-f32 distance (``cpu_f32_grads``, the f32 parity
    step's, same weights and batch); the parameters and gradients stay f32.
    Returns the card's counts."""
    from eyegaze_tpu_torch import train_art

    loss_fn, _ = train_art.make_objective(False)
    out = []
    for dev in (device, torch.device("cpu")):
        model = art_train_model(dev, 0.0, torch.bfloat16)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        reset_attention_counts()
        reset_backward_count()
        out.append(one_step(model, loss_fn, art_train_batch(ART_PARITY_BATCH, dev),
                            ART_TRAIN_LR))
        if dev.type == "cuda":
            counts = art_bf16_train_counts()
            if counts != (ART_ATTENTION_CALLS,) * 3:
                raise RuntimeError(f"one bf16 ART step: {counts} (K3 launches, backward calls, "
                                   f"backward kernel launches)")
    (loss, norm, step, _, card_s, card), (cpu_loss, cpu_norm, _, _, cpu_s, cpu) = out
    if card.keys() != cpu.keys() or any(g.dtype != torch.float32 for g in card.values()) or any(
            d.dtype != torch.float32 for d in step):
        raise RuntimeError("a bf16 ART step must leave f32 parameters and f32 gradients")
    shares, level = module_shares(card, cpu), module_shares(cpu, cpu_f32_grads)
    print(f"one bf16 ART train step at batch {ART_PARITY_BATCH} without dropout (card: "
          f"{ART_ATTENTION_CALLS} K3-bf16 launches, {ART_ATTENTION_CALLS} backward calls of "
          f"the one-pass kernel, no stock backward), card vs CPU (plain path): loss {loss:.6f} / "
          f"{cpu_loss:.6f} (bound {ART_BF16_LOSS_RTOL:g} relative), grad norm {norm:.6f} / "
          f"{cpu_norm:.6f}; {len(cpu)} gradient tensors, the largest |difference| as a share of "
          f"the largest |entry| of the module's gradients of its kind (bound "
          f"{ART_BF16_GRAD_SHARE:g}): "
          + ", ".join(f"{k} {v:.4f}" for v, k in shares[:3])
          + "; on their own scale: "
          + ", ".join(f"{k} {v:.4f}" for v, k in module_shares(card, cpu, own=True)[:3])
          + "; the CPU's own bf16 step against its f32 step on the module scale: "
          + ", ".join(f"{k} {v:.4f}" for v, k in level[:3])
          + f"; wall {card_s:.2f} / {cpu_s:.2f} s")
    if not (abs(loss / cpu_loss - 1) <= ART_BF16_LOSS_RTOL
            and shares[0][0] <= ART_BF16_GRAD_SHARE):
        raise RuntimeError("the card's bf16 ART step is not the CPU's within the bounds")
    return counts


def art_bf16_train_timed_phase(device, attn_dropout) -> dict:
    """``Trainer.train_step`` on ART at full width in bf16 compute, batch 16
    of (32, 1024) pairs, dropout 0.1, attention dropout ``attn_dropout``
    (None: the plain path; 0.0: K3-bf16 and K4's backward kernels), through
    ``time_train_steps`` (profiled): at 0.0, per timed step 18 K3-bf16
    launches and 18 backward calls of one launch each; none at None; no
    stock backward in either."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    name = f"attention dropout {0.1 if attn_dropout is None else attn_dropout}"
    model = art_train_model(device, attn_dropout, torch.bfloat16)
    loss_fn, metrics_fn = train_art.make_objective(False)
    trainer = Trainer(model, make_optimizer(model, ART_TRAIN_LR, 0.01, grad_clip=1.0), loss_fn,
                      None, TrainerConfig(seed=7), device=device, eval_metrics_fn=metrics_fn)

    def reset():
        reset_attention_counts()
        reset_backward_count()

    t = time_train_steps(f"bf16 ART training ({name})", trainer,
                         art_train_batch(ART_TRAIN_BATCH, device), device, reset=reset,
                         read=art_bf16_train_counts)
    launches, backward, kernel_launches = t["counts"]
    want = ART_ATTENTION_CALLS * TRAIN_STEPS if attn_dropout == 0.0 else 0
    if (launches, backward, kernel_launches) != (want, want, want):
        raise RuntimeError(f"bf16 ART training ({name}): {launches} K3 launches, {backward} "
                           f"backward calls, {kernel_launches} one-pass backward launches for "
                           f"{TRAIN_STEPS} steps, not {want} each")
    print(f"ART train step (bf16, dropout 0.1, {name}, batch {ART_TRAIN_BATCH}): "
          f"{t['summary']}; {ART_TRAIN_BATCH * 1e3 / t['median_ms']:.1f} windows/s; per step "
          f"{launches / TRAIN_STEPS:g} K3-bf16 launches, {backward / TRAIN_STEPS:g} backward "
          f"calls, {kernel_launches / TRAIN_STEPS:g} one-pass backward launches, 0 stock "
          "backward")
    return {**t, "launches": launches, "backward": backward, "kernel_launches": kernel_launches}


def art_bf16_epoch_phase(device, tmp: Path) -> tuple[int, int, int]:
    """One epoch of the bf16 recipe at attention dropout 0.0 through the
    port's ``Trainer`` (``train_art.run``'s split, optimizer and schedule on
    ART_TRAIN_TRIALS synthetic trials, with a bf16 model; ``train_art`` has
    no dtype flag, as the JAX script has none), its best checkpoint served
    back by ``ArtDenoiser.from_checkpoint`` (bf16): within 2**-5 of the
    largest output of the trained model's own bf16 forward.  Returns (K3
    launches, backward calls, backward kernel launches) of the epoch."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.data.loader import ArrayDataset, batch_iterator
    from eyegaze_tpu_torch.models.art import ArtConfig
    from eyegaze_tpu_torch.serving import ArtDenoiser
    from eyegaze_tpu_torch.train.optim import cosine_annealing_schedule, make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = art_train_model(device, 0.0, torch.bfloat16)
    ds = train_art.build_dataset(ART_TRAIN_TRIALS, CHANNELS, WINDOW)
    n_val = ART_TRAIN_TRIALS // 5
    train_ds = ArrayDataset({k: v[:-n_val] for k, v in ds.arrays.items()})
    val_ds = ArrayDataset({k: v[-n_val:] for k, v in ds.arrays.items()})
    steps = len(train_ds) // ART_TRAIN_BATCH
    loss_fn, metrics_fn = train_art.make_objective(False)
    trainer = Trainer(
        model, make_optimizer(model, cosine_annealing_schedule(ART_TRAIN_LR, 1, steps), 0.01,
                              grad_clip=1.0), loss_fn, None,
        TrainerConfig(num_epochs=1, metric_for_best="loss", greater_is_better=False,
                      checkpoint_dir=str(tmp / "art_bf16" / "checkpoints"), seed=7),
        device=device, eval_metrics_fn=metrics_fn)
    reset_attention_counts()
    reset_backward_count()
    t0 = time.perf_counter()
    result = trainer.fit(
        train_batches_fn=lambda epoch: batch_iterator(train_ds, ART_TRAIN_BATCH, shuffle=True,
                                                      seed=42, drop_remainder=True, epoch=epoch),
        eval_batches_fn=lambda: batch_iterator(val_ds, min(ART_TRAIN_BATCH, len(val_ds))),
        config_dict={"model": dataclasses.asdict(ArtConfig(attn_dropout=0.0))})
    run_s = time.perf_counter() - t0
    launches, backward, kernel_launches = art_bf16_train_counts()
    eval_batches = math.ceil(len(val_ds) / ART_TRAIN_BATCH)
    if (launches, backward, kernel_launches) != (ART_ATTENTION_CALLS * (steps + eval_batches),
                                                 ART_ATTENTION_CALLS * steps,
                                                 ART_ATTENTION_CALLS * steps):
        raise RuntimeError(f"{steps} bf16 ART train steps and {eval_batches} eval batch(es): "
                           f"{launches} K3 launches, {backward} backward calls, "
                           f"{kernel_launches} backward kernel launches")
    den = ArtDenoiser.from_checkpoint(tmp / "art_bf16" / "checkpoints" / "best_model.pt",
                                      device=device, batch_buckets=ART_BUCKETS)
    noisy = val_ds.arrays["input_values"]
    got = den.predict(noisy)["denoised"]
    trainer.model.eval()
    with torch.inference_mode():
        want = trainer.model(torch.from_numpy(noisy).to(device)).float().cpu().numpy()
    gap, tol = float(np.abs(got - want).max()), ART_BF16_TOL_SHARE * float(np.abs(want).max())
    history = result["history"][-1]
    print(f"bf16 ART, 1 epoch at full width, attention dropout 0.0, {len(val_ds)} validation "
          f"windows: {steps} step(s) of {ART_TRAIN_BATCH}, {eval_batches} eval batch(es), "
          f"{launches} K3-bf16 launches, {backward} backward calls ({kernel_launches} backward "
          f"kernel launches), {run_s:.2f} s; val/loss {history['val/loss']:.4f}; best_model.pt "
          f"served by ArtDenoiser.from_checkpoint (bf16): max |denoised - the trained model's "
          f"bf16 output| {gap:.3e} (tolerance {tol:.3e}, 2**-5 of the largest |output|)")
    if den.model.dtype != torch.bfloat16 or got.shape != want.shape or not gap <= tol:
        raise RuntimeError(f"bf16 ART served from the trained checkpoint differs: {gap:.3e}")
    return launches, backward, kernel_launches


def gaze_pairs(n: int, seed: int) -> list:
    r = np.random.default_rng(seed)
    size = GAZE_GEOMETRY["img_size"]
    return [r.integers(0, 256, size=(n, 3, size, size), dtype=np.uint8) for _ in range(2)]


def gaze_phase(device, tmp: Path) -> Path:
    """The early- (concat) and late-fusion (full) ViT-B/16 at full width,
    seeded weights saved as a state_dict plus meta and served by
    ``GazePredictor.from_checkpoint`` (bf16) on the card: requests of 1, 8
    and 32 uint8 pairs, REPEATS times each, no attention-kernel launch, and
    the 8-pair request's logits within 2**-5 of the largest |logit| of the
    same checkpoint served on the CPU.  Returns the late-fusion
    checkpoint's path."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.vit import EarlyFusionViT, LateFusionViT
    from eyegaze_tpu_torch.serving import GazePredictor

    paths = {}
    for kind, mode in GAZE_MODELS:
        cls = EarlyFusionViT if kind == "early" else LateFusionViT
        model = cls(fusion_mode=mode, **GAZE_GEOMETRY, device=torch.device("cpu"),
                    generator=torch.Generator().manual_seed(5))
        name = f"{cls.__name__} ({mode})"
        meta = {"config": {"model": {"kind": kind, "fusion_mode": mode, "num_labels": 3,
                                     "img_size": GAZE_GEOMETRY["img_size"],
                                     "vit_num_heads": GAZE_GEOMETRY["num_heads"]}}}
        paths[kind] = save_checkpoint(model.state_dict(), meta, tmp / f"gaze_{kind}.pt")
        pred = GazePredictor.from_checkpoint(paths[kind], device=device,
                                             batch_buckets=GAZE_BUCKETS)
        print(f"{name}, ViT-B/16 {GAZE_GEOMETRY}: "
              f"{sum(p.numel() for p in model.parameters()):,} parameters, served bf16 from a "
              f"checkpoint on {device}")
        t0 = time.perf_counter()
        pred.warmup()
        print(f"{name}: warmup of buckets {GAZE_BUCKETS}: {time.perf_counter() - t0:.2f} s")
        a, b = gaze_pairs(max(GAZE_REQUESTS), 6)
        reset_attention_counts()
        for n in GAZE_REQUESTS:
            walls = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out = pred.predict(a[:n], b[:n])
                walls.append((time.perf_counter() - t0) * 1e3)
                if out["logits"].shape != (n, 3) or not np.isfinite(out["logits"]).all():
                    raise RuntimeError(f"{name}: bad logits {out['logits'].shape}")
                if n == GAZE_CPU_PAIRS:
                    card = out["logits"]
            print(f"{name} request of {n} uint8 pair(s): wall ms {[round(w, 3) for w in walls]}, "
                  f"median {statistics.median(walls):.3f} (uint8 to the card, normalize, forward; "
                  f"logits back on the host); attention-kernel launches per request 0")
        if any(attention.launch_count.values()):
            raise RuntimeError(f"{name} launched the attention kernel: {attention.launch_count}")
        want = GazePredictor.from_checkpoint(paths[kind], device=torch.device("cpu"),
                                             batch_buckets=GAZE_BUCKETS).predict(
            a[:GAZE_CPU_PAIRS], b[:GAZE_CPU_PAIRS])["logits"]
        gap = float(np.abs(card - want).max())
        tol = GAZE_BF16_TOL_SHARE * float(np.abs(want).max())
        print(f"{name}, {GAZE_CPU_PAIRS}-pair logits, bf16 compute: card vs CPU max |diff| "
              f"{gap:.3e} (tolerance {tol:.3e}, 2**-5 of the largest |logit| "
              f"{float(np.abs(want).max()):.3f})")
        if not gap <= tol:
            raise RuntimeError(f"{name}, card vs CPU: {gap:.3e} over {tol:.3e}")
    return paths["late"]


def serve_request(kind: str, path: Path, device, bucket: int, arrays: dict) -> tuple[dict, float]:
    """One POST /predict of ``arrays`` (an ``.npz`` body) to ``python -m
    eyegaze_tpu_torch.serve --kind kind`` on the checkpoint ``path``, its
    ``main`` in a thread on 127.0.0.1 port 0 with the one bucket
    ``bucket``; the server is shut down after.  Returns the JSON answer and
    the request's wall ms."""
    from eyegaze_tpu_torch import serve

    bound_, argv = [], ["--checkpoint", str(path), "--kind", kind, "--device", str(device),
                        "--host", "127.0.0.1", "--port", "0", "--buckets", str(bucket)]
    thread = threading.Thread(target=serve.main, args=(argv, bound_.append), daemon=True)
    thread.start()
    for _ in range(600):
        if bound_ or not thread.is_alive():
            break
        thread.join(0.5)
    if not bound_:
        raise RuntimeError(f"eyegaze_tpu_torch.serve --kind {kind} did not start")
    server = bound_[0]
    try:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/predict",
                                     data=buf.getvalue(), method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            got = json.load(resp)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        thread.join(60)
    return got, wall


def gaze_http_phase(device, path: Path) -> None:
    """``python -m eyegaze_tpu_torch.serve --kind gaze`` on the late-fusion
    checkpoint (``serve_request``, bucket 8): one request of 8 uint8 pairs,
    its answer equal to a direct ``predict`` at the same bucket, labels
    included."""
    from eyegaze_tpu_torch.serving import GazePredictor

    a, b = gaze_pairs(GAZE_CPU_PAIRS, 7)
    want = GazePredictor.from_checkpoint(path, device=device,
                                         batch_buckets=(GAZE_CPU_PAIRS,)).predict(a, b)
    got, wall = serve_request("gaze", path, device, GAZE_CPU_PAIRS, {"img1": a, "img2": b})
    logits = np.asarray(got["logits"], np.float32)
    if not np.array_equal(logits, want["logits"]) or got["labels"] != want["labels"]:
        raise RuntimeError(f"serve --kind gaze answered {got['labels']}, max |diff| "
                           f"{float(np.abs(logits - want['logits']).max()):.3e} from the direct "
                           "predict")
    print(f"HTTP, serve --kind gaze (late fusion, bucket {GAZE_CPU_PAIRS}): one request of "
          f"{GAZE_CPU_PAIRS} uint8 pairs in {wall:.3f} ms, answer equal to the direct predict, "
          "labels included")


def gaze_train_config(output_dir, *, bf16: bool = True, dropout: float = 0.1,
                      fusion_mode: str = "concat"):
    """configs/gaze_earlyfusion.yaml's training config built from the
    dataclasses (no YAML), one epoch into ``output_dir``."""
    from eyegaze_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        SystemConfig,
        TrainingConfig,
    )

    return ExperimentConfig(
        model=ModelConfig(fusion_mode=fusion_mode, img_size=GAZE_GEOMETRY["img_size"]),
        data=DataConfig(synthetic=True, synthetic_trials=GAZE_TRAIN_TRIALS, random_seed=42),
        training=TrainingConfig(output_dir=str(output_dir), num_train_epochs=1,
                                per_device_train_batch_size=GAZE_TRAIN_BATCH,
                                per_device_eval_batch_size=32, learning_rate=GAZE_TRAIN_LR,
                                weight_decay=0.01, grad_clip=1.0, dropout=dropout,
                                warmup_epochs=2, bf16=bf16, use_class_weights=True,
                                scheduler="warmup_cosine_step"),
        system=SystemConfig(seed=42, device="cuda"))


def gaze_train_batch(n: int, device, seed: int) -> dict:
    """A train batch as converted gaze data arrives: uint8 (n, 3, 224, 224)
    pairs, labels cycling over the three classes."""
    a, b = gaze_pairs(n, seed)
    return {"img1": torch.from_numpy(a).to(device), "img2": torch.from_numpy(b).to(device),
            "label": torch.from_numpy((np.arange(n) % 3).astype(np.int32)).to(device)}


def gaze_class_weights(device) -> torch.Tensor:
    """train_gaze's inverse-frequency class weights, of a train batch's
    labels."""
    from eyegaze_tpu_torch.data.metadata import class_weights

    labels = np.arange(GAZE_TRAIN_BATCH) % 3
    return torch.as_tensor(class_weights(labels.tolist()), device=device)


def gaze_train_parity_phase(device) -> None:
    """One f32 ViT-B/16 early-fusion (concat) train step at batch 16, without
    dropout and without the augment, on the card and on the CPU from the
    same seeded weights and batch: train_gaze's forward (on-device
    to_unit_float and ImageNet normalization) and class-weighted CE, held to
    the flagship step's bounds (``check_step_parity``) and every gradient
    tensor to ``check_grad_parity``'s."""
    from eyegaze_tpu_torch import train_gaze
    from eyegaze_tpu_torch.train.losses import weighted_cross_entropy

    cfg = gaze_train_config(".", bf16=False, dropout=0.0)
    out = []
    for dev in (device, torch.device("cpu")):
        model = train_gaze.build_model(cfg, "early", device=dev)
        _, forward = train_gaze.make_objective("early", img_size=cfg.model.img_size,
                                               generator=torch.Generator(device=dev))
        weights = gaze_class_weights(dev)

        def loss_fn(m, batch, forward=forward, weights=weights):
            return weighted_cross_entropy(forward(m, batch), batch["label"], weights), {}

        out.append(one_step(model, loss_fn, gaze_train_batch(GAZE_TRAIN_BATCH, dev, seed=8),
                            GAZE_TRAIN_LR))
    name = (f"one f32 ViT-B/16 early-fusion train step at batch {GAZE_TRAIN_BATCH} without "
            "dropout or augment")
    check_step_parity(name, *out, GAZE_TRAIN_LR, LOGIT_TOL)
    check_grad_parity(name, out[0][5], out[1][5], ())


def gaze_train_timed_phase(device, kind: str, mode: str) -> dict:
    """``Trainer.train_step`` with train_gaze's objective (the augment on the
    card, class-weighted CE) on ViT-B/16 ``kind`` fusion at batch 16, bf16,
    dropout 0.1, through ``time_train_steps``.  No kernel of the port
    launches (the ViT's attention is Flax's, in stock ops)."""
    from eyegaze_tpu_torch import train_gaze
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    name = f"ViT-B/16 {kind} fusion ({mode})"
    cfg = gaze_train_config(".", fusion_mode=mode)
    model = train_gaze.build_model(cfg, kind, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    objective = train_gaze.make_objective(
        kind, img_size=cfg.model.img_size, weights=gaze_class_weights(device),
        generator=torch.Generator(device=device).manual_seed(0))
    trainer = Trainer(model, make_optimizer(model, GAZE_TRAIN_LR, 0.01, grad_clip=1.0),
                      *objective, TrainerConfig(seed=0), device=device)
    reset_k1_count()
    reset_attention_counts()
    t = time_train_steps(f"{name} training", trainer,
                         gaze_train_batch(GAZE_TRAIN_BATCH, device, seed=9), device)
    assert_no_port_kernel(f"{name} training")
    print(f"{name} train step (bf16 compute, dropout 0.1, augment on the card, batch "
          f"{GAZE_TRAIN_BATCH}, {n_params:,} parameters): {t['summary']}; "
          f"{GAZE_TRAIN_BATCH * 1e3 / t['median_ms']:.1f} pairs/s; no kernel of the port "
          "launched")
    return {**t, "parameters": n_params}


def gaze_train_serve_phase(device, tmp: Path) -> None:
    """``train_gaze.run`` (``main`` without its YAML) at full width for one
    epoch on the 48 synthetic trials, bf16, for the early and datafusion
    (horizontal paste) kinds; then ``GazePredictor.from_checkpoint`` serves
    the validation pairs from the best_model.pt it wrote, on the card: its
    logits must be the trainer's own eval logits within 2**-5 of the
    largest |logit|."""
    from eyegaze_tpu_torch import train_gaze
    from eyegaze_tpu_torch.serving import GazePredictor

    for kind in GAZE_SERVE_KINDS:
        cfg = gaze_train_config(tmp / f"train_gaze_{kind}")
        t0 = time.perf_counter()
        result = train_gaze.run(cfg, kind, device=device)
        run_s = time.perf_counter() - t0
        trainer, val = result["trainer"], result["val"]
        path = Path(cfg.training.output_dir) / "checkpoints" / "best_model.pt"
        pred = GazePredictor.from_checkpoint(path, device=device, batch_buckets=GAZE_BUCKETS)
        logits = pred.predict(val.arrays["img1"], val.arrays["img2"])["logits"]
        want = trainer.eval_logits
        gap = float(np.abs(logits - want).max())
        tol = GAZE_BF16_TOL_SHARE * float(np.abs(want).max())
        fusion = f", {pred.data_fusion_mode} paste" if kind == "datafusion" else ""
        print(f"train_gaze --model {kind}, 1 epoch at full width: {trainer.optimizer.count} "
              f"step(s) of {GAZE_TRAIN_BATCH}, {len(val)} validation pairs, {run_s:.2f} s; "
              f"best_model.pt served by GazePredictor.from_checkpoint (bf16{fusion}): max "
              f"|logits - the trainer's eval logits| {gap:.3e} (tolerance {tol:.3e}, 2**-5 of "
              f"the largest |logit|)")
        if not (logits.shape == want.shape and gap <= tol):
            raise RuntimeError(f"train_gaze --model {kind}: the served checkpoint's logits "
                               f"differ from training's: {gap:.3e}")


def multimodal_inputs(n: int, seed: int) -> list:
    """n uint8 gaze pairs and n (32, 1024) float32 EEG window pairs."""
    r = np.random.default_rng(seed)
    e1, e2 = (r.normal(size=(n, CHANNELS, WINDOW)).astype(np.float32) for _ in range(2))
    return [*gaze_pairs(n, seed + 1), e1, e2]


def multimodal_phase(device, tmp: Path) -> tuple[int, dict, Path]:
    """The composite at full width (MM_GEOMETRY), seeded weights saved as a
    reference-named state_dict plus a meta with the ``model.multimodal``
    stamp, served by ``MultimodalPredictor.from_checkpoint`` (bf16) on the
    card: requests of 1, 8 and 32 pairs, REPEATS times each, one K1 launch
    per forward (inside the EEG encoder) and no attention-kernel launch;
    per bucket ``torch.profiler`` over one request (K1's share of the
    kernel time); the first 8 pairs of each request's logits, img_logits,
    eeg_logits and alpha within 2**-5 of the largest |value| of the same
    checkpoint served on the CPU.  Returns K1's launches, the per-bucket
    numbers and the checkpoint's path."""
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
    from eyegaze_tpu_torch.serving import MultimodalPredictor

    model = MultimodalFusionModel(**MM_GEOMETRY, device=torch.device("cpu"),
                                  generator=torch.Generator().manual_seed(11))
    meta = {"config": {"model": {"multimodal": MM_GEOMETRY, "num_labels": 3,
                                 "img_size": MM_GEOMETRY["img_size"]}}}
    path = save_checkpoint(model.state_dict(), meta, tmp / "multimodal.pt")
    n_params = sum(p.numel() for p in model.parameters())
    del model
    inputs = multimodal_inputs(max(MM_REQUESTS), 12)
    t0 = time.perf_counter()
    want = MultimodalPredictor.from_checkpoint(path, device=torch.device("cpu"),
                                               batch_buckets=(MM_CPU_PAIRS,)).predict(
        *(x[:MM_CPU_PAIRS] for x in inputs))
    cpu_s = time.perf_counter() - t0
    reset_k1_count()
    reset_attention_counts()
    pred = MultimodalPredictor.from_checkpoint(path, device=device, batch_buckets=MM_BUCKETS)
    t0 = time.perf_counter()
    pred.warmup()
    print(f"multimodal composite (ViT-B/16 early fusion + flagship EEG encoder + fuzzy gate), "
          f"{n_params:,} parameters, served bf16 from a checkpoint on {device}; warmup of "
          f"buckets {MM_BUCKETS}: {time.perf_counter() - t0:.2f} s; the CPU's reference on "
          f"{MM_CPU_PAIRS} pairs: {cpu_s:.2f} s")
    per_bucket = {}
    for n in MM_REQUESTS:
        before = k1_count()
        walls = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = pred.predict(*(x[:n] for x in inputs))
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = k1_count() - before
        if launches != REPEATS or any(attention.launch_count.values()):
            raise RuntimeError(f"composite, {n} pair(s): {launches} K1 launches for {REPEATS} "
                               f"forwards; attention {attention.launch_count}")
        prof = profile_steps(lambda: pred.predict(*(x[:n] for x in inputs)), 1)
        rows = min(n, MM_CPU_PAIRS)
        errors = {}
        for k in MM_OUTPUTS:
            got, ref = out[k][:rows], want[k][:rows]
            if got.shape != ref.shape or not np.isfinite(out[k]).all():
                raise RuntimeError(f"composite, {n} pair(s): bad {k} {out[k].shape}")
            errors[k] = {"max_abs_err": float(np.abs(got - ref).max()),
                         "bound": MM_BF16_TOL_SHARE * float(np.abs(ref).max())}
        median = statistics.median(walls)
        shape = (6 * n, CHANNELS, WINDOW)
        k1_bound, k1_bound_by = phase_bound(shape, plv=False)
        print(f"composite request of {n} pair(s) (bucket {n}): wall ms "
              f"{[round(w, 3) for w in walls]}, median {median:.3f} (uint8 images and f32 "
              f"windows to the card, forward, outputs back on the host); K1 launches "
              f"{launches} for {REPEATS} requests; one profiled request: "
              f"{prof['kernels_per_call']:.0f} CUDA kernels, kernel time "
              f"{prof['kernel_ms_per_call']:.3f} of {prof['wall_ms_per_call']:.3f} ms (busy "
              f"{prof['busy_share']:.1%}), K1 at N = {shape[0]} {prof['k1_ms_per_call']:.4f} ms "
              f"(bound {k1_bound:.4f} ms, {k1_bound_by}), "
              f"{prof['k1_ms_per_call'] / prof['kernel_ms_per_call']:.2%} of the kernel time; "
              f"card vs CPU, bf16, first {rows} pair(s): "
              + ", ".join(f"{k} {e['max_abs_err']:.3e} (bound {e['bound']:.3e})"
                          for k, e in errors.items()))
        bad = [k for k, e in errors.items() if not e["max_abs_err"] <= e["bound"]]
        if bad:
            raise RuntimeError(f"composite, {n} pair(s), card vs CPU: {bad} over the bound")
        per_bucket[n] = {"wall_ms": walls, "median_ms": median, "k1_launches": launches,
                         "k1_ms": prof["k1_ms_per_call"], "k1_bound_ms": k1_bound,
                         "k1_bound_by": k1_bound_by,
                         "k1_share_of_kernel_time": prof["k1_ms_per_call"]
                         / prof["kernel_ms_per_call"],
                         "kernels_per_request": prof["kernels_per_call"],
                         "busy_share": prof["busy_share"], "card_vs_cpu": errors}
    launches = k1_count()
    expected = len(MM_BUCKETS) + len(MM_REQUESTS) * (REPEATS + 1)  # warmup, timed, profiled
    if launches != expected:
        raise RuntimeError(f"the composite launched K1 {launches} times for {expected} forwards")
    return launches, per_bucket, path


def multimodal_http_phase(device, path: Path) -> int:
    """``python -m eyegaze_tpu_torch.serve --kind multimodal`` on the
    composite's checkpoint (``serve_request``, bucket 8): one request of 8
    pairs, its answer equal to a direct ``predict`` at the same bucket,
    labels and alpha included.  Returns K1's launches: the server's warmup,
    the request and the direct predict, one each."""
    from eyegaze_tpu_torch.serving import MultimodalPredictor

    inputs = multimodal_inputs(MM_CPU_PAIRS, 13)
    reset_k1_count()
    want = MultimodalPredictor.from_checkpoint(path, device=device,
                                               batch_buckets=(MM_CPU_PAIRS,)).predict(*inputs)
    got, wall = serve_request("multimodal", path, device, MM_CPU_PAIRS,
                              dict(zip(("img1", "img2", "eeg1", "eeg2"), inputs)))
    launches = k1_count()
    for k in MM_OUTPUTS:
        if not np.array_equal(np.asarray(got[k], np.float32), want[k]):
            raise RuntimeError(f"serve --kind multimodal answered another {k}: max |diff| "
                               f"{float(np.abs(np.asarray(got[k]) - want[k]).max()):.3e}")
    if got["labels"] != want["labels"] or launches != 3:
        raise RuntimeError(f"serve --kind multimodal: labels {got['labels']} vs "
                           f"{want['labels']}, {launches} K1 launches for 3 forwards")
    print(f"HTTP, serve --kind multimodal (bucket {MM_CPU_PAIRS}): one request of "
          f"{MM_CPU_PAIRS} pairs in {wall:.3f} ms, answer equal to the direct predict (logits, "
          f"img_logits, eeg_logits, alpha, labels); K1 launches {launches} (server warmup, "
          "request, direct predict)")
    return launches


def mm_train_config(output_dir, *, bf16: bool = True, dropout: float = 0.1,
                    freeze: bool = False):
    """configs/multimodal_fuzzy_fusion.yaml's training config built from the
    dataclasses (no YAML), one epoch into ``output_dir``: the composite at
    MM_GEOMETRY, batch 8, AdamW with the encoders at 1e-5 and the gate at
    1e-4, the loss weights 0.3 / 0.3 / 0.1, 24 synthetic trials."""
    from eyegaze_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        SystemConfig,
        TrainingConfig,
    )

    return ExperimentConfig(
        model=ModelConfig(in_channels=CHANNELS, d_model=256, num_layers=6, num_heads=8,
                          d_ff=1024, fusion_mode="concat", fuzzy_mode="full", img_size=224),
        data=DataConfig(window_size=WINDOW, stride=STRIDE, sampling_rate=SAMPLING_RATE,
                        random_seed=42, synthetic=True, synthetic_trials=MM_TRAIN_TRIALS),
        training=TrainingConfig(output_dir=str(output_dir), num_train_epochs=1,
                                per_device_train_batch_size=MM_TRAIN_BATCH,
                                per_device_eval_batch_size=16, learning_rate=MM_TRAIN_LR,
                                encoder_learning_rate=MM_ENCODER_LR, weight_decay=0.01,
                                grad_clip=1.0, dropout=dropout, bf16=bf16, lambda_img=0.3,
                                lambda_eeg=0.3, lambda_temp_reg=0.1, freeze_encoders=freeze),
        system=SystemConfig(seed=42, device="cuda"))


def mm_train_model(cfg, device):
    """``train_multimodal.build_model`` of ``cfg``, checked to be the
    composite at MM_GEOMETRY."""
    from eyegaze_tpu_torch import train_multimodal
    from eyegaze_tpu_torch.models.multimodal import FIELDS

    model = train_multimodal.build_model(cfg, device=device)
    fields = {f: getattr(model, f) for f in FIELDS}
    if fields != {**MM_GEOMETRY, "dropout": cfg.training.dropout}:
        raise RuntimeError(f"train_multimodal built {fields}, not {MM_GEOMETRY}")
    return model


def mm_train_batch(n: int, device, seed: int) -> dict:
    """A train batch as converted data arrives: uint8 (n, 3, 224, 224) pairs,
    (n, 32, 1024) window pairs, labels cycling over the three classes."""
    return {**{k: torch.from_numpy(v).to(device)
               for k, v in zip(("img1", "img2", "eeg1", "eeg2"), multimodal_inputs(n, seed))},
            "label": torch.from_numpy((np.arange(n) % 3).astype(np.int32)).to(device)}


# Tensor factories whose float32 ``float64_casts`` makes float64.
FACTORIES = ("tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange", "linspace",
             "hann_window", "zeros_like", "ones_like", "empty_like", "full_like")


@contextlib.contextmanager
def float64_casts():
    """While open, float32 means float64 in the port's code:
    ``Tensor.float``, ``Tensor.to(torch.float32)`` and the factories in
    FACTORIES make float64, and K1's wrapper takes float64 inputs (its
    plain version, on the CPU).  A model moved to float64 with ``.double()``
    then runs in float64 from end to end: the witness that the float32
    steps of the card and of the CPU are held to."""
    from eyegaze_tpu_torch.kernels import phase_metrics

    to, to_float, check = torch.Tensor.to, torch.Tensor.float, phase_metrics._check
    factories = {f: getattr(torch, f) for f in FACTORIES}

    def to64(self, *args, **kwargs):
        args = tuple(torch.float64 if a is torch.float32 else a for a in args)
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        return to(self, *args, **kwargs)

    def wide(make):
        def made(*args, **kwargs):
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
            return make(*args, **kwargs)
        return made

    torch.Tensor.to = to64
    torch.Tensor.float = lambda self, *args, **kwargs: to(self, torch.float64)
    phase_metrics._check = lambda tensors: None
    for f, make in factories.items():
        setattr(torch, f, wide(make))
    try:
        yield
    finally:
        torch.Tensor.to, torch.Tensor.float, phase_metrics._check = to, to_float, check
        for f, make in factories.items():
            setattr(torch, f, make)


def float64_grads(model, loss_fn, batch) -> dict:
    """Each parameter's gradient of ``loss_fn`` on ``batch`` with ``model``
    (on the CPU, its dropouts off) and its floating inputs in float64,
    inside ``float64_casts``."""
    model = model.double().train()
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    with float64_casts():
        loss, _ = loss_fn(model, batch)
        loss.backward()
    if loss.dtype != torch.float64:
        raise RuntimeError(f"the float64 witness computed its loss in {loss.dtype}")
    return {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}


def print_float64_gaps(name: str, card: dict, cpu: dict, f64: dict, zero: tuple) -> None:
    """Prints how far the card's and the CPU's float32 gradients each stand
    from the float64 witness's, as a share of the witness tensor's largest
    |entry|, for the four tensors farthest on either side (those named
    with a suffix in ``zero``, zero in exact arithmetic, left out)."""
    gaps = []
    for k, want in f64.items():
        if not k.endswith(zero):
            scale = float(want.abs().max())
            gaps.append(tuple(float((g[k].double() - want).abs().max()) / scale
                              for g in (card, cpu)) + (k,))
    gaps.sort(key=lambda g: -max(g[:2]))
    print(f"{name}, each side's largest |difference| from the float64 witness as a share of "
          "the tensor's largest |entry| (card / CPU), the four tensors farthest on either side: "
          + ", ".join(f"{k} {c:.3e} / {p:.3e}" for c, p, k in gaps[:4])
          + f"; at most {max(g[0] for g in gaps):.3e} / {max(g[1] for g in gaps):.3e}")


def mm_train_parity_phase(device) -> int:
    """One f32 train step of the composite at full width and batch 8, without
    dropout, on the card and on the CPU from the same seeded weights and
    batch: train_multimodal's loss (the aux CEs on the temperature-scaled
    logits, the temperature penalty), held to the flagship step's bounds
    and every card gradient tensor to ``check_grad_parity``'s bound of the
    float64 witness's (``float64_grads``; the EEG attentions' key biases,
    zero in exact arithmetic, to the largest gradient's share), with the
    CPU's float32 gradients' distance from it beside.  K1 launches once in
    the card's step; returns that count."""
    from eyegaze_tpu_torch import train_multimodal

    cfg = mm_train_config(".", bf16=False, dropout=0.0)
    loss_fn, _ = train_multimodal.make_objective(cfg)
    out = []
    for dev in (device, torch.device("cpu")):
        model = mm_train_model(cfg, dev)
        for m in model.modules():  # the flagship encoder's fixed-rate dropouts too
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        reset_k1_count()
        out.append(one_step(model, loss_fn, mm_train_batch(MM_TRAIN_BATCH, dev, 14), MM_TRAIN_LR))
        if dev.type == "cuda":
            launches = k1_count()
            if launches != 1:
                raise RuntimeError(f"one composite train step launched K1 {launches} times")
        del model
    name = (f"one f32 multimodal composite train step at batch {MM_TRAIN_BATCH} without dropout "
            "(1 K1 launch on the card)")
    check_step_parity(name, *out, MM_TRAIN_LR, LOGIT_TOL)
    model = mm_train_model(cfg, torch.device("cpu"))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    t0 = time.perf_counter()
    f64 = float64_grads(model, loss_fn, mm_train_batch(MM_TRAIN_BATCH, torch.device("cpu"), 14))
    print(f"the float64 witness's step on the CPU: {time.perf_counter() - t0:.2f} s")
    print_float64_gaps(name, out[0][5], out[1][5], f64, ("k_proj.bias",))
    check_grad_parity(name, out[0][5], f64, ("k_proj.bias",), against="float64 witness")
    return launches


def mm_train_timed_phase(device) -> dict:
    """``Trainer.train_step`` with train_multimodal's objective and two-group
    optimizer on the composite at full width, batch 8, bf16, dropout 0.1,
    through ``time_train_steps``: K1 launched once a timed and a profiled
    step, no attention-kernel launch."""
    from eyegaze_tpu_torch import train_multimodal
    from eyegaze_tpu_torch.kernels import attention
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = mm_train_config(".")
    model = mm_train_model(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, train_multimodal.make_multimodal_optimizer(model, cfg),
                      *train_multimodal.make_objective(cfg), TrainerConfig(seed=0), device=device)
    reset_attention_counts()
    t = time_train_steps("composite training", trainer,
                         mm_train_batch(MM_TRAIN_BATCH, device, 15), device,
                         reset=reset_k1_count, read=k1_count)
    launches = t["counts"]
    prof_launches = k1_count() - launches
    if (launches != TRAIN_STEPS or prof_launches != PROFILED_STEPS
            or any(attention.launch_count.values())):
        raise RuntimeError(f"composite training: {launches} + {prof_launches} K1 launches for "
                           f"{TRAIN_STEPS} + {PROFILED_STEPS} steps, attention "
                           f"{attention.launch_count}")
    n = 6 * MM_TRAIN_BATCH
    k1_bound, k1_bound_by = phase_bound((n, CHANNELS, WINDOW), plv=False)
    print(f"multimodal composite train step (bf16 compute, dropout 0.1, batch {MM_TRAIN_BATCH} "
          f"uint8 pairs + (32, 1024) windows, encoders at {MM_ENCODER_LR} / gate at "
          f"{MM_TRAIN_LR}, {n_params:,} parameters): {t['summary']}; "
          f"{MM_TRAIN_BATCH * 1e3 / t['median_ms']:.1f} samples/s; K1 launches {launches} for "
          f"{TRAIN_STEPS} steps; K1 at N = {n} {t['k1_ms_per_call']:.4f} ms a step (bound "
          f"{k1_bound:.4f} ms, {k1_bound_by}), "
          f"{t['k1_ms_per_call'] / t['kernel_ms_per_call']:.2%} of the kernel time")
    return {**t, "parameters": n_params, "launches": launches + prof_launches,
            "launches_per_step": launches / TRAIN_STEPS}


def mm_frozen_phase(device) -> int:
    """One bf16 train step of the composite with ``freeze_encoders`` leaves
    every encoder tensor equal to the bit while the gate moves.  Returns
    K1's launches (one)."""
    from eyegaze_tpu_torch import train_multimodal
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = mm_train_config(".", freeze=True)
    model = mm_train_model(cfg, device)
    trainer = Trainer(model, train_multimodal.make_multimodal_optimizer(model, cfg),
                      *train_multimodal.make_objective(cfg), TrainerConfig(seed=0), device=device)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    reset_k1_count()
    trainer.train_step(mm_train_batch(MM_TRAIN_BATCH, device, 16))
    moved = {k.split(".")[0] for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])}
    encoders = sum(1 for k in before if k.split(".")[0] in train_multimodal.ENCODERS)
    print(f"composite, freeze_encoders: one bf16 step leaves all {encoders} encoder tensors "
          f"equal to the bit; the gate's {len(before) - encoders} tensors move")
    if moved != {"fusion"}:
        raise RuntimeError(f"a step with freeze_encoders moved {sorted(moved)}")
    return k1_count()


def mm_train_serve_phase(device, tmp: Path) -> int:
    """``train_multimodal.run`` (``main`` without its YAML) at full width for
    one epoch on the YAML's 24 synthetic trials, bf16, into ``tmp``: K1 once
    a train step and once an eval batch.  Then
    ``MultimodalPredictor.from_checkpoint`` serves the validation windows
    from the best_model.pt it wrote at the eval batch's size: its logits
    must equal the trainer's own eval logits to the bit, in one K1 launch.
    Returns K1's launches, the served request's included."""
    from eyegaze_tpu_torch import train_multimodal
    from eyegaze_tpu_torch.serving import MultimodalPredictor

    cfg = mm_train_config(tmp / "train_multimodal")
    reset_k1_count()
    t0 = time.perf_counter()
    result = train_multimodal.run(cfg, device=device)
    run_s = time.perf_counter() - t0
    launches = k1_count()
    trainer, val = result["trainer"], result["val"]
    eval_rows = min(MM_TRAIN_BATCH, len(val))
    eval_batches = math.ceil(len(val) / eval_rows)
    if launches != trainer.optimizer.count + eval_batches:
        raise RuntimeError(f"{trainer.optimizer.count} train steps and {eval_batches} eval "
                           f"batches launched K1 {launches} times")
    path = Path(cfg.training.output_dir) / "checkpoints" / "best_model.pt"
    pred = MultimodalPredictor.from_checkpoint(path, device=device, batch_buckets=(eval_rows,))
    rows = val.batch(list(range(len(val))))
    reset_k1_count()
    logits = pred.predict(rows["img1"], rows["img2"], rows["eeg1"], rows["eeg2"])["logits"]
    served = k1_count()
    want = trainer.eval_logits
    equal = logits.shape == want.shape and np.array_equal(logits, want)
    print(f"train_multimodal, 1 epoch at full width: {trainer.optimizer.count} step(s) of "
          f"{MM_TRAIN_BATCH}, {len(val)} validation windows in {eval_batches} eval batch(es), "
          f"{launches} K1 launches, {run_s:.2f} s; best_model.pt served by "
          f"MultimodalPredictor.from_checkpoint (bf16, bucket {eval_rows}) in {served} K1 "
          f"launch(es): logits equal to the trainer's eval logits: {equal} (max |diff| "
          f"{float(np.abs(logits - want).max()):.3e})")
    if not equal:
        raise RuntimeError("the served checkpoint's logits differ from training's eval logits")
    if served != 1:
        raise RuntimeError(f"serving the {len(val)} validation windows launched K1 {served} times")
    return launches + served


def hypereeg_pairs(n: int, seed: int) -> list:
    r = np.random.default_rng(seed)
    return [r.normal(size=(n, CHANNELS, WINDOW)).astype(np.float32) for _ in range(2)]


def hypereeg_phase(device, tmp: Path) -> tuple[Path, dict]:
    """HyperEEG at the documented preset (embed 128, 4 heads, sinc kernel
    125: 274,819 parameters), seeded weights saved as a state_dict plus a
    meta with the ``model.hypereeg`` stamp, served by
    ``HyperEEGPredictor.from_checkpoint`` (bf16) on the card: requests of
    1, 8 and 32 (32, 1024) window pairs, REPEATS times each, no kernel of
    the port; the 8-pair logits within 2**-5 of the largest |logit| of the
    same checkpoint served on the CPU.  Returns the checkpoint's path and
    each request's median wall ms."""
    from eyegaze_tpu_torch.models.hypereeg import FIELDS, create_hypereeg_model
    from eyegaze_tpu_torch.serving import HyperEEGPredictor

    model = create_hypereeg_model("full", "documented", device=torch.device("cpu"),
                                  generator=torch.Generator().manual_seed(17))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != HYPEREEG_PARAMETERS:
        raise RuntimeError(f"HyperEEG at the documented preset has {n_params:,} parameters")
    meta = {"config": {"model": {"hypereeg": {f: getattr(model, f) for f in FIELDS}}}}
    path = save_checkpoint(model.state_dict(), meta, tmp / "hypereeg.pt")
    e1, e2 = hypereeg_pairs(max(HYPEREEG_REQUESTS), 18)
    reset_k1_count()
    reset_attention_counts()
    pred = HyperEEGPredictor.from_checkpoint(path, device=device, batch_buckets=HYPEREEG_REQUESTS)
    t0 = time.perf_counter()
    pred.warmup()
    print(f"HyperEEG (documented preset, {n_params:,} parameters), served bf16 from a checkpoint "
          f"on {device}; warmup of buckets {HYPEREEG_REQUESTS}: {time.perf_counter() - t0:.2f} s")
    medians = {}
    for n in HYPEREEG_REQUESTS:
        walls = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = pred.predict(e1[:n], e2[:n])
            walls.append((time.perf_counter() - t0) * 1e3)
            if out["logits"].shape != (n, 3) or not np.isfinite(out["logits"]).all():
                raise RuntimeError(f"HyperEEG, {n} pair(s): bad logits {out['logits'].shape}")
            if n == HYPEREEG_CPU_PAIRS:
                card = out["logits"]
        medians[n] = statistics.median(walls)
        print(f"HyperEEG request of {n} window pair(s): wall ms {[round(w, 3) for w in walls]}, "
              f"median {medians[n]:.3f} (f32 windows to the card, forward, logits back on the "
              "host)")
    assert_no_port_kernel("HyperEEG serving")
    want = HyperEEGPredictor.from_checkpoint(path, device=torch.device("cpu"),
                                             batch_buckets=(HYPEREEG_CPU_PAIRS,)).predict(
        e1[:HYPEREEG_CPU_PAIRS], e2[:HYPEREEG_CPU_PAIRS])["logits"]
    gap = float(np.abs(card - want).max())
    tol = LOGIT_BF16_TOL_SHARE * float(np.abs(want).max())
    print(f"HyperEEG, {HYPEREEG_CPU_PAIRS}-pair logits, bf16 compute: card vs CPU max |diff| "
          f"{gap:.3e} (tolerance {tol:.3e}, 2**-5 of the largest |logit| "
          f"{float(np.abs(want).max()):.3f})")
    if not gap <= tol:
        raise RuntimeError(f"HyperEEG, card vs CPU: {gap:.3e} over {tol:.3e}")
    return path, medians


def hypereeg_http_phase(device, path: Path) -> float:
    """``python -m eyegaze_tpu_torch.serve --kind hypereeg`` on HyperEEG's
    checkpoint (``serve_request``, bucket 8): one request of 8 window pairs,
    its answer equal to a direct ``predict`` at the same bucket, labels
    included.  Returns the request's wall ms."""
    from eyegaze_tpu_torch.serving import HyperEEGPredictor

    e1, e2 = hypereeg_pairs(HYPEREEG_CPU_PAIRS, 19)
    want = HyperEEGPredictor.from_checkpoint(path, device=device,
                                             batch_buckets=(HYPEREEG_CPU_PAIRS,)).predict(e1, e2)
    got, wall = serve_request("hypereeg", path, device, HYPEREEG_CPU_PAIRS,
                              {"eeg1": e1, "eeg2": e2})
    logits = np.asarray(got["logits"], np.float32)
    if not np.array_equal(logits, want["logits"]) or got["labels"] != want["labels"]:
        raise RuntimeError(f"serve --kind hypereeg answered {got['labels']}, max |diff| "
                           f"{float(np.abs(logits - want['logits']).max()):.3e} from the direct "
                           "predict")
    print(f"HTTP, serve --kind hypereeg (bucket {HYPEREEG_CPU_PAIRS}): one request of "
          f"{HYPEREEG_CPU_PAIRS} window pairs in {wall:.3f} ms, answer equal to the direct "
          "predict, labels included")
    return wall


def hypereeg_args(*argv):
    """train_hypereeg's flags at their defaults (the documented preset,
    float32, batch 256, lr 5e-4) plus ``argv``."""
    from eyegaze_tpu_torch import train_hypereeg

    return train_hypereeg.parse_args(["--device", "cuda", *argv])


def hypereeg_batch(n: int, device, seed: int) -> dict:
    e1, e2 = hypereeg_pairs(n, seed)
    return {"eeg1": torch.from_numpy(e1).to(device), "eeg2": torch.from_numpy(e2).to(device),
            "label": torch.from_numpy((np.arange(n) % 3).astype(np.int32)).to(device)}


def hypereeg_train_parity_phase(device) -> None:
    """One f32 HyperEEG step (documented preset) at batch 16 without dropout
    or augment on the card and on the CPU from the same seeded weights and
    batch: held to the flagship step's bounds and every gradient tensor to
    ``check_grad_parity``'s (the key and logvar biases, zero in exact
    arithmetic, to the largest gradient's share)."""
    from eyegaze_tpu_torch import train_hypereeg

    args = hypereeg_args("--no-augment")
    out = []
    for dev in (device, torch.device("cpu")):
        loss_fn, _ = train_hypereeg.make_objective(augment=False,
                                                   generator=torch.Generator(device=dev))
        model = train_hypereeg.build_model(args, device=dev, dropout=0.0)
        out.append(one_step(model, loss_fn, hypereeg_batch(HYPEREEG_PARITY_BATCH, dev, 20),
                            HYPEREEG_TRAIN_LR))
    name = (f"one f32 HyperEEG train step at batch {HYPEREEG_PARITY_BATCH} without dropout or "
            "augment")
    check_step_parity(name, *out, HYPEREEG_TRAIN_LR, LOGIT_TOL,
                      param_limit=HYPEREEG_PARAM_LIMIT)
    check_grad_parity(name, out[0][5], out[1][5], ("key.bias", "logvar.bias"))


def hypereeg_train_timed_phase(device) -> dict:
    """``Trainer.train_step`` with train_hypereeg's objective (``augment_eeg``
    on each stream, drawn on the card) on the documented preset in f32 at
    batch 256, dropout 0.1, AdamW at 5e-4 (weight decay 0.01, clip 1.0),
    through ``time_train_steps``.  No kernel of the port launches."""
    from eyegaze_tpu_torch import train_hypereeg
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    args = hypereeg_args()
    model = train_hypereeg.build_model(args, device=device)
    trainer = Trainer(model, make_optimizer(model, HYPEREEG_TRAIN_LR, 0.01, grad_clip=1.0),
                      *train_hypereeg.make_objective(
                          augment=True, generator=torch.Generator(device=device).manual_seed(0)),
                      TrainerConfig(seed=0), device=device)
    reset_k1_count()
    reset_attention_counts()
    t = time_train_steps("HyperEEG training", trainer,
                         hypereeg_batch(HYPEREEG_TRAIN_BATCH, device, 21), device)
    assert_no_port_kernel("HyperEEG training")
    print(f"HyperEEG train step (f32, documented preset, augment on the card, dropout 0.1, batch "
          f"{HYPEREEG_TRAIN_BATCH} window pairs): {t['summary']}; "
          f"{HYPEREEG_TRAIN_BATCH * 1e3 / t['median_ms']:.1f} window pairs/s; no kernel of the "
          "port launched")
    return t


def hypereeg_train_serve_phase(device, tmp: Path) -> None:
    """``train_hypereeg.run`` at its defaults (documented preset, f32, the
    augment on) for one epoch into ``tmp``; then
    ``HyperEEGPredictor.from_checkpoint`` (bf16) serves the validation
    windows from the best_model.pt it wrote, on the card: within 2**-5 of
    the largest |logit| of the trainer's own (f32) eval logits."""
    from eyegaze_tpu_torch import train_hypereeg
    from eyegaze_tpu_torch.serving import HyperEEGPredictor

    args = hypereeg_args("--epochs", "1", "--output-dir", str(tmp / "train_hypereeg"))
    t0 = time.perf_counter()
    result = train_hypereeg.run(args, device=device)
    run_s = time.perf_counter() - t0
    trainer, val = result["trainer"], result["val"]
    path = Path(args.output_dir) / "checkpoints" / "best_model.pt"
    pred = HyperEEGPredictor.from_checkpoint(path, device=device, batch_buckets=HYPEREEG_REQUESTS)
    rows = val.batch(list(range(len(val))))
    logits = pred.predict(rows["eeg1"], rows["eeg2"])["logits"]
    want = trainer.eval_logits
    gap = float(np.abs(logits - want).max())
    tol = LOGIT_BF16_TOL_SHARE * float(np.abs(want).max())
    print(f"train_hypereeg, 1 epoch (documented preset): {trainer.optimizer.count} step(s), "
          f"{len(val)} validation windows, {run_s:.2f} s; best_model.pt served by "
          f"HyperEEGPredictor.from_checkpoint (bf16): max |logits - the trainer's f32 eval "
          f"logits| {gap:.3e} (tolerance {tol:.3e}, 2**-5 of the largest |logit|)")
    if not (logits.shape == want.shape and gap <= tol):
        raise RuntimeError(f"train_hypereeg: the served checkpoint's logits differ from "
                           f"training's: {gap:.3e}")



def offline_raw_windows_phase(device, tmp: Path) -> None:
    """``preprocess_eeg_raw`` on CSV_TRIALS synthetic pairs at (32, 3250)
    written as CSVs (channel-major, two time-major) with
    ``synthetic_metadata``'s records; the native loader must be in use, and
    every trial must come back within the CSV's six decimals.  Then the two
    splits, saved as the trial arrays ``preprocess_eeg_windows`` reads,
    through it on the card and with ``--device cpu``: windows within 1e-3,
    labels, pairs and metadata equal."""
    from eyegaze_tpu_torch import preprocess_eeg_raw, preprocess_eeg_windows
    from eyegaze_tpu_torch.data import native
    from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset, synthetic_metadata

    meta = synthetic_metadata(CSV_TRIALS, seed=27)
    data = synthetic_eeg_pair_dataset(CSV_TRIALS, C=CHANNELS, T=RAW_SAMPLES, fs=OFFLINE_FS,
                                      seed=27)
    csv_dir = tmp / "csv"
    csv_dir.mkdir()
    for i, m in enumerate(meta):
        for player, eeg in (("player1", data["eeg1"]), ("player2", data["eeg2"])):
            arr = eeg[i].T if (i, player) in CSV_TIME_MAJOR else eeg[i]
            np.savetxt(csv_dir / f"{m[player]}.csv", arr, delimiter=",", fmt="%.6f")
    (tmp / "metadata.json").write_text(json.dumps(meta))
    raw = tmp / "raw"
    t0 = time.perf_counter()
    if preprocess_eeg_raw.main(["--metadata", str(tmp / "metadata.json"), "--eeg-dir",
                                str(csv_dir), "--output-dir", str(raw)]) != 0:
        raise RuntimeError("preprocess_eeg_raw failed")
    raw_s = time.perf_counter() - t0
    if not native.native_available():
        raise RuntimeError("preprocess_eeg_raw parsed the CSVs without the native loader")
    arrays = {}
    for split in ("train", "val"):
        idx = json.loads((raw / f"{split}_metadata.json").read_text())["metadata_indices"]
        for k in (1, 2):
            got, want = np.load(raw / f"{split}_eeg{k}.npy"), data[f"eeg{k}"][idx]
            tol = 5e-7 + float(np.spacing(np.abs(want).max()))  # six decimals, then float32
            gap = float(np.abs(got - want).max())
            if got.shape != (len(idx), CHANNELS, RAW_SAMPLES) or not gap <= tol:
                raise RuntimeError(f"preprocess_eeg_raw, {split} eeg{k}: shape {got.shape}, "
                                   f"max |diff| {gap:.3e} over {tol:.3e}")
        arrays[split] = {name: np.load(raw / f"{split}_{name}.npy")
                         for name in ("eeg1", "eeg2", "labels", "pairs")}
    n_train, n_val = len(arrays["train"]["labels"]), len(arrays["val"]["labels"])
    if n_train + n_val != CSV_TRIALS:
        raise RuntimeError(f"preprocess_eeg_raw kept {n_train} + {n_val} trials")
    print(f"preprocess_eeg_raw: {2 * CSV_TRIALS} CSVs of (32, 3250) ({len(CSV_TIME_MAJOR)} "
          f"time-major) in {raw_s:.3f} s, {2 * CSV_TRIALS / raw_s:.1f} CSVs/s, native loader "
          f"{native.native_available()}; {n_train} train + {n_val} val trials, each within the "
          "CSV's six decimals of its source")

    trials = tmp / "trials"
    trials.mkdir()
    for name in ("eeg1", "eeg2", "labels", "pairs"):
        np.save(trials / f"{name}.npy", np.concatenate([arrays[s][name] for s in arrays]))
    walls = {}
    for run in ("first card", "cpu", "card"):  # the first run makes the host constants
        t0 = time.perf_counter()
        if preprocess_eeg_windows.main(["--input-dir", str(trials), "--output-dir",
                                        str(tmp / f"windows_{run.split()[-1]}"), "--device",
                                        "cpu" if run == "cpu" else device.type]) != 0:
            raise RuntimeError(f"preprocess_eeg_windows ({run}) failed")
        walls[run] = time.perf_counter() - t0
    gaps = {}
    for split in ("train", "val"):
        card, cpu = tmp / "windows_card", tmp / "windows_cpu"
        for k in (1, 2):
            got, want = (np.load(d / f"{split}_eeg{k}.npy") for d in (card, cpu))
            gaps[f"{split}_eeg{k}"] = gap = float(np.abs(got - want).max())
            if got.shape != want.shape or got.shape[1:] != (CHANNELS, WINDOW) or not (
                    np.isfinite(got).all() and gap <= WINDOWS_TOL):
                raise RuntimeError(f"preprocess_eeg_windows, {split} eeg{k}: card vs CPU "
                                   f"{got.shape} / {want.shape}, max |diff| {gap:.3e}")
        for name in (f"{split}_labels.npy", f"{split}_pairs.npy", f"{split}_metadata.json"):
            if (card / name).read_bytes() != (cpu / name).read_bytes():
                raise RuntimeError(f"preprocess_eeg_windows: {name} differs card vs CPU")
    windows = len(np.load(tmp / "windows_card" / "train_labels.npy"))
    print(f"preprocess_eeg_windows (stride 256, window 1024, pair split): {windows} train "
          f"windows; wall {walls['card']:.3f} s on {device} ({walls['first card']:.3f} s the first "
          f"time), {walls['cpu']:.3f} s with --device cpu; card vs CPU max |diff| {max(gaps.values()):.3e} (bound {WINDOWS_TOL:g}); "
          "labels, pairs and metadata equal")


def assert_features_close(name: str, got, want, *, chunking: bool = False) -> dict:
    """One trial's npz against another at the card-vs-CPU bounds (or, with
    ``chunking``, at the bounds between chunkings); returns the largest gaps."""
    if got.files != want.files:
        raise RuntimeError(f"{name}: arrays {got.files} against {want.files}")
    gaps = {}
    for k in got.files:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype or not np.isfinite(g).all():
            raise RuntimeError(f"{name}:{k}: {g.shape} {g.dtype} against {w.shape} {w.dtype}")
        if k in ("label", "pair"):
            if g != w:
                raise RuntimeError(f"{name}:{k}: {g} against {w}")
            continue
        gaps[k] = float(np.abs(g - w).max())
        if chunking:
            ok = gaps[k] <= CHUNK_TOL.get(k, 1e-3)
        elif k in ("psd", "band_energy"):
            ok = bool(np.all(np.abs(g - w) <= 1e-5 + 1e-3 * np.abs(w)))
        else:
            ok = metrics_close(g, w, intra=k == "intra", gaps=gaps)
        if not ok:
            raise RuntimeError(f"{name}:{k}: over the bound, gaps {gaps}")
    return gaps


def metrics_close(got: np.ndarray, want: np.ndarray, *, intra: bool, gaps: dict) -> bool:
    """(..., 7, 5, C, C) at tests/test_torch_features.py's bounds, the
    largest gap of each metric into ``gaps``."""
    from eyegaze_tpu_torch.ops.features import METRIC_NAMES

    ok = True
    off = ~np.eye(got.shape[-1], dtype=bool)
    for m, name in enumerate(METRIC_NAMES):
        g, w = got[..., m, :, :, :], want[..., m, :, :, :]
        if name == "phase_diff":
            defined = want[..., METRIC_NAMES.index("plv"), :, :, :] >= 1e-2
            gap = np.abs(np.angle(np.exp(1j * (g - w))))[defined]
            ok &= bool(defined.any()) and gap.max() <= 1e-2
        elif name in ("pli", "wpli"):
            if intra and name == "pli":
                ok &= bool((g[..., ~off] == 0).all() and (w[..., ~off] == 0).all())
                g, w = g[..., off], w[..., off]
            gap = np.abs(g - w)
            ok &= gap.max() <= 0.1 and gap.mean() <= 1e-2
        else:
            gap = np.abs(g - w)
            ok &= gap.max() <= 1e-3
        gaps[f"{name}{' intra' if intra else ''}"] = float(gap.max())
    return ok


def offline_features_phase(device, tmp: Path) -> dict:
    """``extract_eeg_features`` on FEATURE_TRIALS synthetic pairs at (32,
    3250), fs 250, read through ``--input-dir``, at ``--trial-chunk`` 8 and 1
    on the card: end-to-end trials per second, CUDA-event ms of one chunk's
    features, kernels per chunk and busy share from one profiled chunk, the
    projected wall time for DATASET_TRIALS trials; every file's arrays at
    their shapes, chunk 8 against chunk 1 on FEATURE_PARITY_TRIALS trials at
    the chunking bounds and against the CPU path (``--device cpu``) at the
    test bounds.  ``--resume`` after deleting RESUME_DELETED's files writes
    exactly those.  Then ``spectral_entropy`` on all the trials' first
    streams and ``spatial_entropy`` on HEATMAPS float heatmaps at (1583,
    3000, 3), card against CPU.  Returns the numbers."""
    from eyegaze_tpu_torch import extract_eeg_features
    from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset

    data = synthetic_eeg_pair_dataset(FEATURE_TRIALS, C=CHANNELS, T=RAW_SAMPLES, fs=OFFLINE_FS,
                                      seed=28)
    inputs = {"eeg1": data["eeg1"], "eeg2": data["eeg2"], "labels": data["label"],
              "pairs": data["pair"]}
    trials, parity_in, warm_in = tmp / "trials", tmp / "parity_trials", tmp / "warmup_trials"
    for d, n in ((trials, FEATURE_TRIALS), (parity_in, FEATURE_PARITY_TRIALS),
                 (warm_in, FEATURE_WARMUP_TRIALS)):
        d.mkdir()
        for name, arr in inputs.items():
            np.save(d / f"{name}.npy", arr[:n])
    t0 = time.perf_counter()
    for chunk in FEATURE_CHUNKS:  # the first calls at each chunk's shapes
        if extract_eeg_features.main(["--input-dir", str(warm_in), "--output-dir",
                                      str(tmp / f"warmup_{chunk}"), "--trial-chunk", str(chunk),
                                      "--device", device.type]) != 0:
            raise RuntimeError(f"extract_eeg_features --trial-chunk {chunk} failed")
    print(f"extract_eeg_features, first calls in the process ({FEATURE_WARMUP_TRIALS} trials at "
          f"each chunk size: FFT plans, filter constants, memory pools): "
          f"{time.perf_counter() - t0:.3f} s")
    walls = {chunk: [] for chunk in FEATURE_CHUNKS}
    for rnd in range(FEATURE_ROUNDS):  # in turns: the host's pace drifts
        for chunk in FEATURE_CHUNKS:
            d = tmp / f"features_{chunk}" if rnd == 0 else tmp / f"features_{chunk}_{rnd}"
            t0 = time.perf_counter()
            if extract_eeg_features.main(["--input-dir", str(trials), "--output-dir", str(d),
                                          "--trial-chunk", str(chunk), "--device",
                                          device.type]) != 0:
                raise RuntimeError(f"extract_eeg_features --trial-chunk {chunk} failed")
            walls[chunk].append(time.perf_counter() - t0)
            names = sorted(p.name for p in d.glob("trial_*.npz"))
            if names != [f"trial_{i:05d}.npz" for i in range(FEATURE_TRIALS)]:
                raise RuntimeError(f"extract_eeg_features --trial-chunk {chunk}: {len(names)} "
                                   "files")
            for name in (names[0], names[-1]):
                f = np.load(d / name)
                sizes = {k: f[k].nbytes for k in FEATURE_BYTES}
                if sizes != FEATURE_BYTES or f["intra"].shape != (2, 7, 5, CHANNELS, CHANNELS):
                    raise RuntimeError(f"{name}: array bytes {sizes}")
    out = {}
    for chunk in FEATURE_CHUNKS:
        e1, e2 = (torch.from_numpy(data[k][:chunk]).to(device) for k in ("eeg1", "eeg2"))

        def features():
            return extract_eeg_features.chunk_features(e1, e2, OFFLINE_FS, FEATURE_ROW_CHUNK)

        features()
        device_ms = statistics.median(cuda_ms(features, 5))
        prof = profile_steps(lambda: (features(), torch.cuda.synchronize()), n=1)
        rates = [FEATURE_TRIALS / w for w in walls[chunk]]
        rate = statistics.median(rates)
        out[chunk] = {"trials_per_s_runs": rates, "trials_per_s": rate,
                      "device_ms_per_chunk": device_ms,
                      "kernels_per_chunk": prof["kernels_per_call"],
                      "busy_share": prof["busy_share"],
                      "kernel_ms_per_chunk": prof["kernel_ms_per_call"],
                      "wall_ms_per_profiled_chunk": prof["wall_ms_per_call"],
                      "projected_dataset_s": DATASET_TRIALS / rate}
        print(f"extract_eeg_features --trial-chunk {chunk}: {FEATURE_TRIALS} trials end to end in "
              f"{', '.join(f'{w:.3f}' for w in walls[chunk])} s, "
              f"{', '.join(f'{r:.2f}' for r in rates)} trials/s (projected {DATASET_TRIALS} "
              f"trials at the median: {DATASET_TRIALS / rate:.1f} s); one chunk's features "
              f"{device_ms:.3f} ms between CUDA events ({device_ms / chunk:.3f} ms a trial); one "
              f"profiled chunk {prof['kernels_per_call']:.0f} kernels, "
              f"{prof['kernel_ms_per_call']:.3f} ms of kernel time in "
              f"{prof['wall_ms_per_call']:.3f} ms, busy {prof['busy_share']:.1%}; top kernels by "
              "device time: "
              + ", ".join(f"{name} {share:.1%}" for name, share in prof["top_kernels"]))
    card, single = tmp / "features_8", tmp / "features_1"
    chunk_gaps, cpu_gaps = {}, {}
    for i in range(FEATURE_PARITY_TRIALS):
        name = f"trial_{i:05d}.npz"
        for k, v in assert_features_close(f"chunk 8 vs 1, {name}", np.load(card / name),
                                          np.load(single / name), chunking=True).items():
            chunk_gaps[k] = max(chunk_gaps.get(k, 0.0), v)
    t0 = time.perf_counter()
    if extract_eeg_features.main(["--input-dir", str(parity_in), "--output-dir",
                                  str(tmp / "features_cpu"), "--device", "cpu"]) != 0:
        raise RuntimeError("extract_eeg_features --device cpu failed")
    cpu_s = time.perf_counter() - t0
    for i in range(FEATURE_PARITY_TRIALS):
        name = f"trial_{i:05d}.npz"
        for k, v in assert_features_close(f"card vs CPU, {name}", np.load(card / name),
                                          np.load(tmp / "features_cpu" / name)).items():
            cpu_gaps[k] = max(cpu_gaps.get(k, 0.0), v)
    print(f"extract_eeg_features, {FEATURE_PARITY_TRIALS} trials: chunk 8 vs chunk 1 max "
          f"|diff| {json.dumps({k: float(f'{v:.3e}') for k, v in chunk_gaps.items()})}; card vs "
          f"--device cpu ({cpu_s:.2f} s on the CPU) "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in cpu_gaps.items()})}: within the "
          "bounds")

    before = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in card.glob("trial_*.npz")}
    deleted = [f"trial_{i:05d}.npz" for i in RESUME_DELETED]
    for name in deleted:
        (card / name).unlink()
    t0 = time.perf_counter()
    if extract_eeg_features.main(["--input-dir", str(trials), "--output-dir", str(card),
                                  "--trial-chunk", "8", "--resume", "--device",
                                  device.type]) != 0:
        raise RuntimeError("extract_eeg_features --resume failed")
    resume_s = time.perf_counter() - t0
    after = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in card.glob("trial_*.npz")}
    rewritten = sorted(n for n in after if n not in before or after[n][0] != before[n][0])
    if sorted(after) != sorted(before) or rewritten != deleted:
        raise RuntimeError(f"--resume wrote {rewritten}, not {deleted}")
    same = all(after[n][1] == before[n][1] for n in deleted)
    print(f"extract_eeg_features --resume after deleting {deleted}: wrote exactly those in "
          f"{resume_s:.3f} s, byte-identical to the first run's: {same}")

    eeg = torch.from_numpy(data["eeg1"])
    x = eeg.to(device)
    from eyegaze_tpu_torch.ops import entropy

    card_h = entropy.spectral_entropy(x, OFFLINE_FS)
    spectral_ms = statistics.median(cuda_ms(lambda: entropy.spectral_entropy(x, OFFLINE_FS), 3))
    t0 = time.perf_counter()
    cpu_h = entropy.spectral_entropy(eeg, OFFLINE_FS)
    spectral_cpu_s = time.perf_counter() - t0
    gap = float((card_h.cpu() - cpu_h).abs().max())
    if card_h.shape != (FEATURE_TRIALS, CHANNELS) or not gap <= SPECTRAL_ENTROPY_TOL:
        raise RuntimeError(f"spectral_entropy card vs CPU: {tuple(card_h.shape)}, {gap:.3e}")
    print(f"spectral_entropy on ({FEATURE_TRIALS}, 32, 3250): {spectral_ms:.3f} ms on the card "
          f"(CUDA events), {spectral_cpu_s:.3f} s on the CPU; card vs CPU max |diff| "
          f"{gap:.3e} bits (bound {SPECTRAL_ENTROPY_TOL:g}), mean "
          f"{float(cpu_h.mean()):.4f} bits")
    del x

    from eyegaze_tpu_torch.data.synthetic import synthetic_gaze_heatmap

    rng = np.random.default_rng(29)
    maps = torch.from_numpy(np.stack([synthetic_gaze_heatmap(i % 3, *HEATMAP_SHAPE, rng)
                                      .transpose(1, 2, 0) for i in range(HEATMAPS)]))
    x = maps.to(device)
    card_s = entropy.spatial_entropy(x)
    spatial_ms = statistics.median(cuda_ms(lambda: entropy.spatial_entropy(x), 3))
    t0 = time.perf_counter()
    cpu_s_h = entropy.spatial_entropy(maps)
    spatial_cpu_s = time.perf_counter() - t0
    gap = float(((card_s.cpu() - cpu_s_h).abs() / cpu_s_h.abs()).max())
    if card_s.shape != (HEATMAPS,) or not gap <= SPATIAL_ENTROPY_RTOL:
        raise RuntimeError(f"spatial_entropy card vs CPU: {tuple(card_s.shape)}, {gap:.3e}")
    print(f"spatial_entropy on {HEATMAPS} float heatmaps {(*HEATMAP_SHAPE, 3)}: {spatial_ms:.3f} ms on "
          f"the card (CUDA events), {spatial_cpu_s:.3f} s on the CPU; card vs CPU max relative "
          f"diff {gap:.3e} (bound {SPATIAL_ENTROPY_RTOL:g})")
    return {"chunks": out, "cpu_gaps": cpu_gaps, "chunk_gaps": chunk_gaps,
            "resume_byte_identical": same, "spectral_entropy_ms": spectral_ms,
            "spatial_entropy_ms": spatial_ms}


F32_INSTANCES = {(16, 4), (16, 1), (32, 2), (32, 1), (64, 1), (128, 1)}  # (d, rows per thread)
BF16_HEAD_DIMS = {16, 32, 64, 128}


def import_cases(cpu) -> list:
    """Phase 30's models, seeded at full width on the CPU: (name, importer
    kind, model, importer flags, the reference's buffers, the meta a bare
    state_dict is served with, predictor class, request)."""
    from eyegaze_tpu_torch import serving
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
    from eyegaze_tpu_torch.models.vit import EarlyFusionViT, LateFusionViT
    from eyegaze_tpu_torch.ops.spectral import hann_window

    def seeded():
        return dict(device=cpu, generator=torch.Generator().manual_seed(17))

    r = np.random.default_rng(30)
    eeg = [r.normal(size=(IMPORT_WINDOWS, CHANNELS, WINDOW)).astype(np.float32)
           for _ in range(2)]
    window = {"spectrogram_generator.window": hann_window(128, cpu)}
    alt = IMPORT_ALT_GEOMETRY
    alt_meta = {"config": {
        "model": {"in_channels": CHANNELS, "num_labels": 3, "d_model": alt["d_model"],
                  "num_layers": alt["num_layers"], "num_heads": alt["num_heads"],
                  "d_ff": alt["d_ff"], "conv_kernel_size": alt["conv_kernel_size"],
                  "conv_stride": alt["conv_stride"], "conv_layers": alt["conv_layers"]},
        "ablation": {"use_spectrogram": True, "use_ibs": True, "ibs_mode": "robust",
                     "use_cross_attention": True, "ibs_instance_norm": False,
                     "ibs_feature_type": "phase"},
        "data": {"sampling_rate": SAMPLING_RATE}}}
    art = ArtConfig()
    pe = torch.zeros(1, art.max_len, art.embedding_size)
    gaze_meta = {"img_size": GAZE_GEOMETRY["img_size"], "num_labels": 3,
                 "vit_num_heads": GAZE_GEOMETRY["num_heads"]}
    return [
        ("flagship", "dual_eeg", DualEEGTransformer(**GEOMETRY, **seeded()), [], window,
         FLAGSHIP_META, serving.Predictor, eeg),
        ("flagship, non-default geometry", "dual_eeg",
         DualEEGTransformer(**alt, **seeded()), IMPORT_ALT_FLAGS, window, alt_meta,
         serving.Predictor, eeg),
        ("ART", "art", ArtifactRemovalTransformer(art, **seeded()), [],
         {"src_embed.1.pe": pe, "tgt_embed.1.pe": pe},
         {"config": {"model": dataclasses.asdict(art)}}, serving.ArtDenoiser, eeg[:1]),
        ("gaze early (ViT-B/16)", "gaze_early",
         EarlyFusionViT(fusion_mode="concat", **GAZE_GEOMETRY, **seeded()), [], {},
         {"config": {"model": {"kind": "early", "fusion_mode": "concat", **gaze_meta}}},
         serving.GazePredictor, gaze_pairs(IMPORT_PAIRS, 31)),
        ("gaze late (ViT-B/16)", "gaze_late",
         LateFusionViT(fusion_mode="full", **GAZE_GEOMETRY, **seeded()), [], {},
         {"config": {"model": {"kind": "late", "fusion_mode": "full", **gaze_meta}}},
         serving.GazePredictor, gaze_pairs(IMPORT_PAIRS, 32)),
        ("multimodal composite", "multimodal", MultimodalFusionModel(**MM_GEOMETRY, **seeded()),
         [], {"fusion.c_reliable": torch.tensor(0.0),
              "eeg_encoder.spectrogram_generator.window": hann_window(128, cpu)},
         {"config": {"model": {"multimodal": MM_GEOMETRY, "num_labels": 3}}},
         serving.MultimodalPredictor, multimodal_inputs(IMPORT_PAIRS, 33)),
    ]


def import_phase(device, tmp: Path) -> dict:
    """Phase 30: ``import_torch_checkpoint`` on each of ``import_cases``'s
    reference-named state_dicts, under ``model_state_dict`` with the
    ``module.`` prefix and the reference's buffers; the import served by
    ``from_checkpoint`` (bf16) on the card equal to the bit to the same
    weights served from the bare state_dict with their meta.  The imported
    flagship and composite requests launch K1 once each, the imported ART
    request K3-bf16 18 times.  Returns the launches and the imported
    flagship's path."""
    from eyegaze_tpu_torch import import_torch_checkpoint as importer
    from eyegaze_tpu_torch.kernels import attention, phase_metrics

    cpu = torch.device("cpu")
    k1 = k3 = 0
    flagship = None
    for name, kind, model, flags, buffers, meta, cls, request in import_cases(cpu):
        t0 = time.perf_counter()
        state = model.state_dict()
        wrapped = {f"module.{k}": v for k, v in {**state, **buffers}.items()}
        src = tmp / f"reference_{kind}_{len(flags)}.pt"
        torch.save({"model_state_dict": wrapped, "epoch": 7}, src)
        out = tmp / f"imported_{kind}_{len(flags)}"
        if importer.main([str(src), "--out", str(out)] + flags) != 0:
            raise RuntimeError(f"{name}: the import failed")
        t_import = time.perf_counter() - t0
        bare = save_checkpoint(state, meta, tmp / f"bare_{kind}_{len(flags)}.pt")
        imported = cls.from_checkpoint(out / "best_model.pt", device=device)
        served = cls.from_checkpoint(bare, device=device)
        reset_attention_counts()
        reset_k1_count()
        t0 = time.perf_counter()
        got = imported.predict(*request)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {"K1": phase_metrics.launch_count["phase_metric_sums"],
                    "K3-bf16": attention.bf16_launch_count["headpacked_attention"],
                    "K3/K4 all": sum(attention.launch_count.values())}
        want = served.predict(*request)
        for k, v in want.items():
            if not np.array_equal(np.asarray(got[k]), np.asarray(v)):
                raise RuntimeError(f"{name}: the import's {k} differs from the bare "
                                   "state_dict's")
        expect = {"dual_eeg": {"K1": 1, "K3-bf16": 0, "K3/K4 all": 0},
                  "multimodal": {"K1": 1, "K3-bf16": 0, "K3/K4 all": 0},
                  "art": {"K1": 0, "K3-bf16": ART_ATTENTION_CALLS,
                          "K3/K4 all": ART_ATTENTION_CALLS}}.get(
            kind, {"K1": 0, "K3-bf16": 0, "K3/K4 all": 0})
        if launches != expect:
            raise RuntimeError(f"{name}: the imported request launched {launches}, not {expect}")
        k1, k3 = k1 + launches["K1"], k3 + launches["K3-bf16"]
        params = sum(v.numel() for v in state.values())
        print(f"import {name}: {params:,} parameters, {len(buffers)} buffer(s) dropped, "
              f"imported in {t_import:.2f} s; from_checkpoint on the card equal to the bit to "
              f"the bare state_dict's ({', '.join(want)}); first request {ms:.1f} ms; launches "
              f"{launches}")
        if kind == "dual_eeg" and not flags:
            flagship = out / "best_model.pt"
        del imported, served, model
    torch.cuda.empty_cache()
    return {"k1": k1, "k3_bf16": k3, "flagship": flagship}


def analysis_margins(args, band: int) -> np.ndarray:
    """Top-two logit margins of the analysed windows on the CPU, with
    ``band`` masked."""
    from eyegaze_tpu_torch import analyze_eeg
    from eyegaze_tpu_torch.analysis import run_inference

    model, _ = analyze_eeg.load_model(args, torch.device("cpu"))
    top2 = np.sort(run_inference(model.with_mask_band(band),
                                 analyze_eeg.make_batches(args)())["logits"], axis=-1)
    return top2[:, -1] - top2[:, -2]


def analysis_cams(args, where, *, plain_k1: bool = False, cudnn: bool = True,
                  nudge: float = 0.0, seed: int = 0) -> np.ndarray:
    """``gradcam_spectrogram`` on ``analyze_eeg``'s model and batches on
    ``where``: with ``plain_k1`` K1's plain twin in place of the kernel (on
    any device), with ``cudnn`` False no cuDNN, with ``nudge`` the EEG times
    (1 + nudge * N(0, 1)) drawn from ``seed``."""
    from eyegaze_tpu_torch import analyze_eeg
    from eyegaze_tpu_torch.analysis import gradcam_spectrogram
    from eyegaze_tpu_torch.kernels import phase_metrics

    model, _ = analyze_eeg.load_model(args, where)
    batches = list(analyze_eeg.make_batches(args)())
    if nudge:
        r = np.random.default_rng(seed)
        batches = [{**b, **{k: (b[k] * (1 + nudge * r.standard_normal(b[k].shape)))
                            .astype(np.float32) for k in ("eeg1", "eeg2")}} for b in batches]
    sums, enabled = phase_metrics._sums, torch.backends.cudnn.enabled
    if plain_k1:
        phase_metrics._sums = lambda wrapper, reference, tensors: reference(*tensors)
    torch.backends.cudnn.enabled = cudnn
    try:
        return gradcam_spectrogram(model, iter(batches), out_size=64)
    finally:
        phase_metrics._sums, torch.backends.cudnn.enabled = sums, enabled


def analyze_phase(device, tmp: Path, checkpoint: Path) -> dict:
    """Phase 31: ``analyze_eeg`` (``ANALYSIS_STAGES``) at full width on the
    imported flagship, on the card and on the CPU (K1's plain version).  K1
    launches once per analysed forward, as ``planned_forwards`` predicts
    from the batches and stages.  The IBS class means and difference, the
    attention maps, the Grad-CAM maps (the CSVs; and the maps themselves
    from ``gradcam_spectrogram`` beside the CLI: their launches are not
    counted) and the band accuracies, card against CPU."""
    from eyegaze_tpu_torch import analyze_eeg
    from eyegaze_tpu_torch.analysis import BAND_NAMES

    runs = []
    for where, name in ((device.type, "card"), ("cpu", "cpu")):
        args = analyze_eeg.parse_args(ANALYSIS_FLAGS + [
            "--checkpoint", str(checkpoint), "--analyses", ANALYSIS_STAGES,
            "--output-dir", str(tmp / f"analysis_{name}"), "--device", where])
        reset_k1_count()
        t0 = time.perf_counter()
        summary = analyze_eeg.run(args)
        summary["wall_s"] = time.perf_counter() - t0
        summary["k1"] = k1_count()
        runs.append(summary)
    card, cpu = runs
    predicted = sum(card["planned"].values())
    if card["k1"] != predicted or cpu["k1"] != 0:
        raise RuntimeError(f"analyze_eeg launched K1 {card['k1']} times on the card (predicted "
                           f"{predicted}: {card['planned']}) and {cpu['k1']} on the CPU")
    print(f"analyze_eeg at full width, {card['batches']} batch(es): K1 launches {card['k1']} = "
          f"the forwards predicted {card['planned']}; wall s card {card['wall_s']:.3f}, CPU "
          f"{cpu['wall_s']:.3f}")
    print("analyze_eeg stage wall s, card / CPU: " + ", ".join(
        f"{k} {v['seconds']:.3f} / {cpu['stages'][k]['seconds']:.3f}"
        for k, v in card["stages"].items()))

    a, b = tmp / "analysis_card", tmp / "analysis_cpu"
    gaps = {"ibs": 0.0, "ibs_file": "", "attention": 0.0, "gradcam_share": 0.0}
    for p in sorted(b.rglob("*.csv")):
        rel = p.relative_to(b)
        if not (a / rel).exists():
            raise RuntimeError(f"the card's analysis lacks {rel}")
        group = rel.parts[0]
        if group not in ("ibs_connectivity", "attention_weights", "gradcam") or \
                rel.name in ("channel_names.csv", "gradcam_metadata.csv",
                             "attention_summary.csv"):
            continue
        got, want = (np.loadtxt(x / rel, delimiter=",", ndmin=2) for x in (a, b))
        gap = float(np.abs(got - want).max())
        if group == "gradcam":
            scale = float(np.abs(want).max())
            if not gap <= ANALYSIS_CAM_SHARE * scale + 1e-6:
                raise RuntimeError(f"{rel}: card vs CPU {gap:.3e}, map max {scale:.3e}")
            gaps["gradcam_share"] = max(gaps["gradcam_share"], gap / max(scale, 1e-12))
        else:
            if not gap <= ANALYSIS_TOL:
                raise RuntimeError(f"{rel}: card vs CPU {gap:.3e} over {ANALYSIS_TOL}")
            key = "ibs" if group == "ibs_connectivity" else "attention"
            if key == "ibs" and gap >= gaps["ibs"]:
                gaps["ibs_file"] = str(rel)
            gaps[key] = max(gaps[key], gap)
    name = Path("frequency_sensitivity") / "band_sensitivity.csv"
    rows = [line.split(",") for line in (a / name).read_text().splitlines()[1:]]
    want_rows = [line.split(",") for line in (b / name).read_text().splitlines()[1:]]
    accuracy = {}
    for band, (r_card, r_cpu) in enumerate(zip(rows, want_rows)):
        acc, acc_cpu = float(r_card[1]), float(r_cpu[1])
        accuracy[BAND_NAMES[band]] = acc
        if r_card != r_cpu:
            margins = analysis_margins(args, band)
            unclear = int((margins <= 2 * ANALYSIS_TOL).sum())
            if not abs(acc - acc_cpu) <= unclear / len(margins):
                raise RuntimeError(f"band {BAND_NAMES[band]}: card {r_card}, CPU {r_cpu}, "
                                   f"{unclear} window(s) inside the margin")
            print(f"band {BAND_NAMES[band]}: card {r_card} vs CPU {r_cpu}: {unclear} window(s) "
                  "inside the margin")
    # The CSV's six decimals leave a Grad-CAM map of this model one or two
    # digits, so the maps themselves are held too (ANALYSIS_CAM_MAP_SHARE),
    # with the variants that say where a gap comes from (not counted).
    host = torch.device("cpu")
    cams = {name: analysis_cams(args, where, **kw) for name, where, kw in (
        ("card", device, {}), ("CPU", host, {}),
        ("card, K1's plain twin", device, {"plain_k1": True}),
        ("card, cuDNN off", device, {"cudnn": False}))}
    want = cams["CPU"]
    scales = np.abs(want).max(axis=(1, 2))
    shares = {name: (np.abs(cam - want).max(axis=(1, 2)) / scales).tolist()
              for name, cam in cams.items() if name != "CPU"}
    nudged = [np.abs(analysis_cams(args, host, nudge=ANALYSIS_NUDGE, seed=seed) - want).max(
        axis=(1, 2)) / scales for seed in range(ANALYSIS_NUDGE_DRAWS)]
    shares[f"CPU, input x (1 + {ANALYSIS_NUDGE:g} N(0, 1)), largest of "
           f"{ANALYSIS_NUDGE_DRAWS} draws"] = np.max(nudged, axis=0).tolist()
    if not (scales.min() > 0 and max(shares["card"]) <= ANALYSIS_CAM_MAP_SHARE):
        raise RuntimeError(f"Grad-CAM card vs CPU, share of each map's max {shares['card']}, "
                           f"maps' max {scales.tolist()}")
    gaps["gradcam_map_share"] = shares
    print(f"analysis card vs CPU: IBS means max |diff| {gaps['ibs']:.3e} ({gaps['ibs_file']}), "
          f"attention maps {gaps['attention']:.3e} (bound {ANALYSIS_TOL}); Grad-CAM maps per "
          "class, largest |difference| from the CPU's as a share of the map's max (bound "
          f"{ANALYSIS_CAM_MAP_SHARE} for the card): " + "; ".join(
              f"{name} " + ", ".join(f"{x:.3e}" for x in v) for name, v in shares.items())
          + f" (maps' max {', '.join(f'{x:.3e}' for x in scales)}); the CSVs' "
          f"{gaps['gradcam_share']:.3e}, at their 1e-6 resolution; masked-band accuracies "
          f"{accuracy}")
    return {"k1": card["k1"], "planned": card["planned"], "batches": card["batches"],
            "stage_s": {k: v["seconds"] for k, v in card["stages"].items()},
            "cpu_stage_s": {k: v["seconds"] for k, v in cpu["stages"].items()},
            "wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"], "gaps": gaps}


def gaze_introspect_phase(device) -> dict:
    """Phase 32: ``input_saliency``, ``vit_gradcam`` (upsampled to 224) and
    ``extract_cls_features`` on ViT-B/16 early fusion ('concat', 224 px,
    seeded f32 weights) at batch 2, card against CPU.  No kernel of the port
    runs (the ViT's attention is the plain one)."""
    from eyegaze_tpu_torch.analysis import extract_cls_features, input_saliency, vit_gradcam
    from eyegaze_tpu_torch.data.image_fusion import imagenet_normalize, to_unit_float
    from eyegaze_tpu_torch.models.vit import EarlyFusionViT

    cpu = torch.device("cpu")
    model = EarlyFusionViT(fusion_mode="concat", **GAZE_GEOMETRY, device=cpu,
                           generator=torch.Generator().manual_seed(32)).eval()
    i1, i2 = (imagenet_normalize(to_unit_float(torch.from_numpy(x))).numpy()
              for x in gaze_pairs(GAZE_INTROSPECT_PAIRS, 34))
    batch = [{"img1": i1, "img2": i2, "label": np.arange(GAZE_INTROSPECT_PAIRS) % 3}]
    reset_attention_counts()
    reset_k1_count()
    results, times = [], []
    for where in (device, cpu):
        m = model.to(where)
        out, ms = {}, {}
        for name, fn in (("saliency", lambda: input_saliency(m, i1, i2)),
                         ("gradcam", lambda: vit_gradcam(m, i1, i2, upsample_to=224)),
                         ("cls", lambda: extract_cls_features(m, iter(batch)))):
            fn()  # warm
            t0 = time.perf_counter()
            out[name] = fn()  # numpy: the device work has ended
            ms[name] = (time.perf_counter() - t0) * 1e3
        results.append(out)
        times.append(ms)
    assert_no_port_kernel("gaze introspection")
    card, host = results
    share = 0.0
    for g, w in zip(card["saliency"], host["saliency"]):
        for gm, wm in zip(g, w):
            scale = float(np.abs(wm).max())
            gap = float(np.abs(gm - wm).max())
            if not (scale > 0 and gap <= GAZE_MAP_SHARE * scale):
                raise RuntimeError(f"saliency card vs CPU {gap:.3e}, map max {scale:.3e}")
            share = max(share, gap / scale)
    if card["gradcam"].shape != (GAZE_INTROSPECT_PAIRS, 224, 224) or \
            not np.array_equal(card["gradcam"], host["gradcam"]):
        raise RuntimeError("ViT Grad-CAM card vs CPU differs")
    cls_gap = float(np.abs(card["cls"]["features"] - host["cls"]["features"]).max())
    if card["cls"]["features"].shape != (GAZE_INTROSPECT_PAIRS, GAZE_GEOMETRY["embed_dim"]) or \
            not cls_gap <= ANALYSIS_TOL:
        raise RuntimeError(f"CLS features card vs CPU {cls_gap:.3e}")
    print(f"gaze introspection, ViT-B/16 early fusion, batch {GAZE_INTROSPECT_PAIRS}: card ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in times[0].items()) + "; CPU ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in times[1].items())
          + f"; saliency card vs CPU {share:.3e} of each map's max (bound {GAZE_MAP_SHARE}), "
          f"CLS features {cls_gap:.3e}; Grad-CAM at the last block's output zero on both "
          f"(max {float(np.abs(card['gradcam']).max()):g}: only the CLS token reaches the logits)")
    return {"card_ms": times[0], "cpu_ms": times[1], "saliency_share": share,
            "cls_gap": cls_gap}


def mechanism_key(numbers: dict) -> str:
    """The mechanism statistics of ``analyze_gaze.analyze`` as text, NaN
    included, for an exact comparison."""
    return json.dumps(numbers["mechanism"], sort_keys=True)


def gaze_analysis_phase(device) -> dict:
    """Phase 33: ``analyze_gaze.analyze``, the numeric part of
    ``python -m eyegaze_tpu_torch.analyze_gaze``, on ViT-B/16 early
    ('concat') and late ('full') fusion at 224 px, weights from seed 0, over
    the JAX script's synthetic validation set at ``--trials 24``: on the card
    (after one untimed run) and on the CPU, the same model moved between
    them.  The logits, probabilities and CLS features within
    GAZE_ANALYSIS_TOL; the predictions equal on every trial whose top-two
    margin on the card exceeds 3 x GAZE_ANALYSIS_TOL, and the confusion
    matrix, per-pair accuracies and mechanism statistics equal where every
    trial's does; the early model's saliency maps within GAZE_MAP_SHARE of
    each map's largest entry.  Then ``MultiModelComparator``'s ranking and
    pairwise tests (scipy) on the two models' card results, against the
    CPU's.  No kernel of the port runs."""
    from eyegaze_tpu_torch import analyze_gaze
    from eyegaze_tpu_torch.analysis import ModelResults, MultiModelComparator

    cpu = torch.device("cpu")
    val = analyze_gaze.validation_set(GAZE_ANALYSIS_TRIALS, tiny=False)
    reset_attention_counts()
    reset_k1_count()
    out, results = {}, {"card": [], "cpu": []}
    for kind, mode in GAZE_ANALYSIS_MODELS:
        name = f"{kind}_{mode}"
        model = analyze_gaze.build_model(kind, mode, tiny=False).eval()
        n_params = sum(p.numel() for p in model.parameters())
        analyze_gaze.analyze(model, kind, val, device)  # warm
        card = analyze_gaze.analyze(model, kind, val, device)
        host = analyze_gaze.analyze(model, kind, val, cpu)
        del model
        gaps = {k: float(np.abs(card[k] - host[k]).max())
                for k in ("logits", "probs", "features")}
        if not all(g <= GAZE_ANALYSIS_TOL for g in gaps.values()):
            raise RuntimeError(f"analyze_gaze {name}, card vs CPU: {gaps}")
        top2 = np.sort(card["logits"], axis=-1)
        clear = top2[:, -1] - top2[:, -2] > 3 * GAZE_ANALYSIS_TOL
        if not np.array_equal(card["preds"][clear], host["preds"][clear]):
            raise RuntimeError(f"analyze_gaze {name}: predictions differ outside the margin")
        if clear.all() and not (
                np.array_equal(card["metrics"]["confusion_matrix"],
                               host["metrics"]["confusion_matrix"])
                and card["per_pair"] == host["per_pair"]
                and mechanism_key(card) == mechanism_key(host)):
            raise RuntimeError(f"analyze_gaze {name}: the tables differ with every trial clear")
        if "saliency" in card:
            for g, w in zip(card["saliency"], host["saliency"]):
                scale = float(np.abs(w).max())
                gap = float(np.abs(g - w).max())
                if not (scale > 0 and gap <= GAZE_MAP_SHARE * scale):
                    raise RuntimeError(f"analyze_gaze {name} saliency: {gap:.3e}, max {scale:.3e}")
                gaps["saliency_share"] = max(gaps.get("saliency_share", 0.0), gap / scale)
        for where, n in (("card", card), ("cpu", host)):
            results[where].append(ModelResults(name, n["labels"], n["preds"], n["probs"]))
        out[name] = {"parameters": n_params, "card_s": card["seconds"], "cpu_s": host["seconds"],
                     "gaps": gaps, "inside_margin": int((~clear).sum()),
                     "accuracy": float(card["metrics"]["accuracy"])}
        print(f"analyze_gaze numbers, ViT-B/16 {name} ({n_params:,} parameters), "
              f"{GAZE_ANALYSIS_TRIALS} trials: stage wall s card / CPU "
              + ", ".join(f"{k} {v:.3f} / {host['seconds'][k]:.3f}"
                          for k, v in card["seconds"].items())
              + "; card vs CPU " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f"; trials inside the margin {int((~clear).sum())} of {len(clear)}; accuracy "
              f"{float(card['metrics']['accuracy']):.4f}")
    assert_no_port_kernel("analyze_gaze")
    comps = {where: MultiModelComparator(r) for where, r in results.items()}
    ranking = comps["card"].ranking()
    pairwise = comps["card"].pairwise_rows()
    every_clear = not any(o["inside_margin"] for o in out.values())
    if every_clear and (ranking != comps["cpu"].ranking()
                        or pairwise != comps["cpu"].pairwise_rows()):
        raise RuntimeError("MultiModelComparator: the card's ranking or tests differ from the "
                           "CPU's")
    print(f"MultiModelComparator on the card's results: ranking by f1_macro {ranking}; "
          f"pairwise McNemar tests {pairwise}"
          + ("; equal to the CPU's" if every_clear else "; a trial inside the margin: not "
             "compared with the CPU's"))
    return {"models": out, "ranking": ranking, "pairwise": pairwise}


def entropy_csvs(root: Path) -> Path:
    """ENTROPY_TRIALS synthetic trial pairs at the recorded shape (32,
    3250), fs 250, written as reference-named EEG CSVs (``%.5f``), one per
    player: the JAX script's three filename conventions, 28 pairs, the
    three conditions."""
    from eyegaze_tpu_torch.analyze_entropy import parse_eeg_filename
    from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset

    data = synthetic_eeg_pair_dataset(n=ENTROPY_TRIALS, C=CHANNELS, T=3250, fs=ENTROPY_FS,
                                      seed=34)
    d = root / "eeg_csv"
    d.mkdir()
    for i in range(ENTROPY_TRIALS):
        pair, trial, label = int(data["pair"][i]), i + 1, int(data["label"][i])
        if label == 0:
            stems = [f"Pair-{pair}-A-Single-EYE_trial{trial}_player",
                     f"Pair-{pair}-B-Single-EYE_trial{trial}_observer"]
        else:
            tag = "Comp" if label == 1 else "Coop"
            stems = [f"Pair-{pair}-{tag}-EYE_trial{trial}_player{ab}" for ab in "AB"]
        for stem, x in zip(stems, (data["eeg1"][i], data["eeg2"][i])):
            if parse_eeg_filename(f"{stem}.csv") is None:
                raise RuntimeError(f"{stem}.csv is not a reference EEG file name")
            np.savetxt(d / f"{stem}.csv", x, delimiter=",", fmt="%.5f")
    return d


def float64_spectral_entropy(x: np.ndarray, fs: float) -> np.ndarray:
    """``ops/entropy.spectral_entropy`` in float64 with scipy: Butterworth
    order 4 filtfilt over 0.5-50 Hz, Welch (nperseg 256), the entropy of
    each channel's PSD."""
    from scipy import signal

    b, a = signal.butter(4, [0.5, 50.0], btype="band", fs=fs)
    _, psd = signal.welch(signal.filtfilt(b, a, x.astype(np.float64), axis=-1), fs=fs,
                          nperseg=256, axis=-1)
    p = np.abs(psd) + 1e-10
    p = p / p.sum(-1, keepdims=True)
    return -(p * np.log(p)).sum(-1) / np.log(2)


def entropy_phase(device, tmp: Path, train_history: dict) -> dict:
    """Phase 34: ``analyze_entropy.analyze_eeg_entropy_files`` over
    ``entropy_csvs``' 64 files at fs 250 and the default band, on the card
    (after one untimed run) and on the CPU: the records' keys equal, the
    per-channel spectral entropies within ENTROPY_TOL; the card's trials per
    second (the faster of two runs), the CSV parse share of that wall time
    (the faster of two parses alone, as the function parses: the JAX
    script's zeroed (40, 65536) buffer a file; warm in the file cache) and
    the peak memory of the runs above what was allocated before them, one
    chunk each (``_chunk_size`` puts 769 trials of (32, 3250) in one).  Then ``compute_real_entropy`` at
    ``--trials 30`` on both devices (spectral entropies at
    ENTROPY_SYNTHETIC_TOL, spatial at ENTROPY_SPATIAL_RTOL).  Then the
    history of phase 13's ``train_dual_eeg --watch 1`` run read back: the
    best epoch's val/f1_macro is the trainer's best_metric, every watched
    layer's norms finite.  No kernel of the port runs."""
    from eyegaze_tpu_torch import analyze_entropy
    from eyegaze_tpu_torch.analysis import STANDARD_32_CHANNELS
    from eyegaze_tpu_torch.data.native import load_csv_f32

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    files = analyze_entropy.scan_eeg_files(entropy_csvs(tmp))
    write_s = time.perf_counter() - t0
    if len(files) != 2 * ENTROPY_TRIALS:
        raise RuntimeError(f"{len(files)} EEG files parsed by name")
    reset_attention_counts()
    reset_k1_count()
    analyze_entropy.analyze_eeg_entropy_files(files, ENTROPY_FS, device=device)  # warm
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)  # what earlier phases still hold
    card_s = parse_s = math.inf
    for _ in range(2):  # the faster of two runs, and of two parses alone
        t0 = time.perf_counter()
        card_rows = analyze_entropy.analyze_eeg_entropy_files(files, ENTROPY_FS, device=device)
        card_s = min(card_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        # Copied out of each file's buffer as the function copies, so that
        # the 10.5-MB buffer is freed and reused, not held for all 64.
        raw = np.stack([load_csv_f32(f["filepath"], max_rows=CHANNELS + 8, max_cols=65536)[0]
                        [:CHANNELS, :3250].copy() for f in files])
        parse_s = min(parse_s, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) - held
    t0 = time.perf_counter()
    cpu_rows = analyze_entropy.analyze_eeg_entropy_files(files, ENTROPY_FS, device=cpu)
    cpu_s = time.perf_counter() - t0
    keys = ("pair_id", "player", "trial_idx", "condition")
    if [[r[k] for k in keys] for r in card_rows] != [[r[k] for k in keys] for r in cpu_rows]:
        raise RuntimeError("analyze_eeg_entropy_files: the card's records differ in their keys")
    card_ent, cpu_ent = (np.asarray([[r[c] for c in STANDARD_32_CHANNELS] for r in rows])
                         for rows in (card_rows, cpu_rows))
    gap = float(np.abs(card_ent - cpu_ent).max())
    ref = float64_spectral_entropy(raw, ENTROPY_FS)
    ref_gaps = {"card": float(np.abs(card_ent - ref).max()),
                "cpu": float(np.abs(cpu_ent - ref).max())}
    if card_ent.shape != (2 * ENTROPY_TRIALS, CHANNELS) or not gap <= ENTROPY_TOL:
        raise RuntimeError(f"spectral entropies card vs CPU {gap:.3e}")
    conditions = sorted({r["condition"] for r in card_rows})
    pairs = len({r["pair_id"] for r in card_rows})
    print(f"analyze_eeg_entropy_files on {len(files)} CSVs of ({CHANNELS}, 3250), fs "
          f"{ENTROPY_FS:g}, {pairs} pairs, {conditions} (written in {write_s:.2f} s): card "
          f"{card_s:.3f} s, {len(files) / card_s:.1f} trials/s, CSV parse {parse_s:.3f} s "
          f"({parse_s / card_s:.1%} of the card's wall time, warm file cache), peak memory "
          f"{peak / 2**20:.1f} MiB for its one chunk (above the {held / 2**20:.1f} MiB held "
          f"before); CPU {cpu_s:.3f} s; card vs CPU "
          f"{gap:.3e} (bound {ENTROPY_TOL:g}); against float64 (scipy) card "
          f"{ref_gaps['card']:.3e}, CPU {ref_gaps['cpu']:.3e}")

    synth = {}
    for where in (device, cpu):
        t0 = time.perf_counter()
        gaze, eeg = analyze_entropy.compute_real_entropy(ENTROPY_SYNTHETIC_TRIALS, 256.0,
                                                         device=where)
        synth[where.type] = (gaze, eeg, time.perf_counter() - t0)
    (g_card, e_card, s_card), (g_cpu, e_cpu, s_cpu) = synth["cuda"], synth["cpu"]
    e_gap = max(float(np.abs(np.asarray(e_card[c]) - np.asarray(e_cpu[c])).max())
                for c in ("mean_entropy", *STANDARD_32_CHANNELS))
    s_rel = float((np.abs(g_card["spatial_entropy"] - g_cpu["spatial_entropy"])
                   / np.abs(g_cpu["spatial_entropy"])).max())
    if not (e_gap <= ENTROPY_SYNTHETIC_TOL and s_rel <= ENTROPY_SPATIAL_RTOL):
        raise RuntimeError(f"compute_real_entropy card vs CPU: spectral {e_gap:.3e}, spatial "
                           f"relative {s_rel:.3e}")
    assert_no_port_kernel("analyze_entropy")
    print(f"compute_real_entropy at --trials {ENTROPY_SYNTHETIC_TRIALS}: card {s_card:.3f} s, "
          f"CPU {s_cpu:.3f} s; spectral card vs CPU {e_gap:.3e} (bound "
          f"{ENTROPY_SYNTHETIC_TOL:g}), spatial relative {s_rel:.3e}")

    curves, watch = train_history["curves"], train_history["watch"]
    best = curves.best_epoch("val/f1_macro")
    norms = {kind: watch.norm_table(kind) for kind in ("param", "grad")}
    if best is None or best["val/f1_macro"] != train_history["best_metric"]:
        raise RuntimeError(f"best epoch {best} against best_metric "
                           f"{train_history['best_metric']}")
    if not (norms["param"] and norms["grad"] and all(
            len(v) == len(watch.records) and np.isfinite(v).all()
            for table in norms.values() for v in table.values())):
        raise RuntimeError("the watch sidecar holds a layer without finite norms")
    print(f"train_dual_eeg --watch 1 history read back: best epoch {best} = best_metric; "
          f"{len(watch.records)} watch record(s), {len(norms['param'])} parameter and "
          f"{len(norms['grad'])} gradient layers, every norm finite; health screen "
          f"{watch.vanishing_or_exploding() or 'clean'}")
    return {"files": len(files), "card_s": card_s, "cpu_s": cpu_s,
            "trials_per_s": len(files) / card_s, "parse_share": parse_s / card_s,
            "peak_mib": peak / 2**20, "gap": gap, "float64_gaps": ref_gaps,
            "synthetic": {"card_s": s_card, "cpu_s": s_cpu, "spectral_gap": e_gap,
                          "spatial_rel": s_rel}}


def rehearsal_phase(device, tmp: Path) -> dict:
    """Phase 35: ``rehearsal_full_scale``'s steps one by one at
    REHEARSAL_FLAGS under ``tmp``, K1's and the attention kernels' counts
    set to 0 before each: K1 launches once per train step and eval batch in
    ``train_eeg_full_windows`` and once per planned forward in
    ``analyze_eeg_ckpt``, and no K1-K4 launch elsewhere.  The
    ``analyze_entropy`` step's numbers (``analyze_entropy.compute`` on the
    JPG and CSV trees, as phase 34): its tables and figures need
    matplotlib, which the card's host lacks.  Checks: the trial and window
    counts are the pair split's (9 windows a trial), the CSV round trip
    within 1e-3, the first train trials' windows within WINDOWS_TOL of the
    CPU's ``preprocess_and_window``, finite losses, a best_model.pt that
    ``Predictor.from_checkpoint`` serves (finite logits).  Prints each
    step's wall seconds and the process's peak RSS after it."""
    from eyegaze_tpu_torch import analyze_entropy
    from eyegaze_tpu_torch import rehearsal_full_scale as rfs
    from eyegaze_tpu_torch.preprocess_eeg_windows import preprocess_and_window
    from eyegaze_tpu_torch.serving import Predictor

    r = rfs.Rehearsal(rfs.parse_args(["--root", str(tmp / "rehearsal"), *REHEARSAL_FLAGS,
                                      "--device", device.type]))
    k1 = {}
    for step in rfs.STEPS:
        reset_k1_count()
        reset_attention_counts()
        if step == "analyze_entropy_real_files":
            t0 = time.time()
            args = analyze_entropy.parse_args([str(a) for a in r.entropy_argv()])
            gaze, eeg, _ = analyze_entropy.compute(args, device)
            r.report[step] = {"wall_s": time.time() - t0,
                              "gaze_rows": analyze_entropy.n_rows(gaze),
                              "eeg_rows": analyze_entropy.n_rows(eeg),
                              "peak_rss_gib": rfs.peak_rss_gib(), "k1_launches": 0}
            want = {"gaze_rows": 2 * r.args.jpg_trials, "eeg_rows": 2 * r.args.csv_trials}
            got = {k: r.report[step][k] for k in want}
            finite = all(np.isfinite(analyze_entropy.column(table, col)).all()
                         for table, col in ((gaze, "spatial_entropy"), (eeg, "mean_entropy")))
            if got != want or not finite:
                raise RuntimeError(f"analyze_entropy on the rehearsal's files: {got}, "
                                   f"expected {want}, finite {finite}")
        else:
            r.run_step(step)
        k1[step] = k1_count()
        if step in rfs.K1_STEPS:
            reset_k1_count()
        assert_no_port_kernel(f"the rehearsal's {step}")
    report = r.report
    train, analysis = report["train_eeg_full_windows"], report["analyze_eeg_ckpt"]
    if (k1["train_eeg_full_windows"] != train["train_steps"] + train["eval_batches"]
            or k1["analyze_eeg_ckpt"] != analysis["forwards"]):
        raise RuntimeError(f"the rehearsal launched K1 {k1}: {train['train_steps']} train "
                           f"steps, {train['eval_batches']} eval batches, "
                           f"{analysis['forwards']} analysed forwards")
    gen, windows = report["gen_metadata"], report["windows_full"]
    per_trial = (rfs.T_RAW - rfs.WINDOW) // rfs.STRIDE + 1
    counts = [gen["train_trials"] * per_trial, gen["val_trials"] * per_trial]
    if ([windows["train_windows"], windows["val_windows"]] != counts
            or gen["train_trials"] + gen["val_trials"] != r.args.trials
            or not report["convert_eeg_csv"]["roundtrip_max_err"] < 1e-3):
        raise RuntimeError(f"rehearsal counts: {gen}, {windows}, expected windows {counts}")

    pairs = np.load(r.eeg_dir / "pairs.npy")
    first = np.flatnonzero(~np.isin(pairs, rfs.VAL_PAIRS))[:REHEARSAL_CHECKED]
    gaps = []
    for k in (1, 2):
        raw = np.load(r.eeg_dir / f"eeg{k}.npy", mmap_mode="r")[first]
        want = preprocess_and_window(raw, rfs.FS, 0.5, 50.0, rfs.WINDOW, rfs.STRIDE,
                                     device=torch.device("cpu")).reshape(-1, CHANNELS, rfs.WINDOW)
        got = np.load(r.win_dir / f"train_eeg{k}.npy", mmap_mode="r")[:len(want)]
        gaps.append(float(np.abs(got - want).max()))
    if not max(gaps) <= WINDOWS_TOL:
        raise RuntimeError(f"the rehearsal's first windows, card vs CPU: {gaps}")

    pred = Predictor.from_checkpoint(r.checkpoint, device=device, batch_buckets=BUCKETS)
    served = [np.array(np.load(r.win_dir / f"val_eeg{k}.npy", mmap_mode="r")[:REHEARSAL_SERVED])
              for k in (1, 2)]
    logits = pred.predict(*served)["logits"]
    if logits.shape != (REHEARSAL_SERVED, 3) or not np.isfinite(logits).all():
        raise RuntimeError(f"the rehearsal's checkpoint served {logits.shape} logits, finite "
                           f"{np.isfinite(logits).all()}")
    features = report["extract_features"]
    print(f"rehearsal_full_scale at {' '.join(REHEARSAL_FLAGS)}: {gen['train_trials']} / "
          f"{gen['val_trials']} trials, {windows['train_windows']} / {windows['val_windows']} "
          f"windows (the pair split's, {per_trial} a trial); CSV round trip "
          f"{report['convert_eeg_csv']['roundtrip_max_err']:.3e}; the first "
          f"{REHEARSAL_CHECKED} train trials' windows card vs CPU {max(gaps):.3e} (bound "
          f"{WINDOWS_TOL:g}); features {features['trials_per_s']:.2f} trials/s; flagship "
          f"{train['train_steps']} steps at {train['steps_per_s']:.2f} steps/s + "
          f"{train['eval_batches']} eval batches, losses {train['train_loss']}, K1 "
          f"{k1['train_eeg_full_windows']} launches; analyze_eeg K1 {k1['analyze_eeg_ckpt']} "
          f"= the {analysis['forwards']} forwards planned; best_model.pt served "
          f"{REHEARSAL_SERVED} windows, finite logits; no K1-K4 launch in the other steps")
    print("rehearsal step wall s (process peak RSS GiB after it): " + ", ".join(
        f"{step} {report[step]['wall_s']:.3f} ({report[step]['peak_rss_gib']:.2f})"
        for step in rfs.STEPS))
    return {"k1_train": k1["train_eeg_full_windows"], "k1_analysis": k1["analyze_eeg_ckpt"],
            "train_steps": train["train_steps"], "eval_batches": train["eval_batches"],
            "forwards": analysis["forwards"], "windows_gap": max(gaps),
            "wall_s": {step: report[step]["wall_s"] for step in rfs.STEPS},
            "peak_rss_gib": max(report[step]["peak_rss_gib"] for step in rfs.STEPS)}


def dp_flagship_yaml(output_dir: Path) -> Path:
    """The flagship's full-width config (ModelConfig's defaults) for
    ``train_dual_eeg``'s CLI: DP_CLI_TRIALS synthetic trials of one window
    each (a fifth held out), batch 64, bf16, dropout 0, the bench's
    objective, one epoch."""
    import yaml

    from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES

    cfg = {"data": {"window_size": WINDOW, "stride": STRIDE, "sampling_rate": SAMPLING_RATE,
                    "synthetic": True, "synthetic_trials": DP_CLI_TRIALS},
           "training": {"output_dir": str(output_dir), "num_train_epochs": 1,
                        "per_device_train_batch_size": TRAIN_BATCH,
                        "per_device_eval_batch_size": TRAIN_BATCH, "learning_rate": TRAIN_LR,
                        "weight_decay": 0.01, "grad_clip": 1.0, "dropout": 0.0, "bf16": True,
                        **BENCH_LOSSES},
           "system": {"seed": 0, "device": "cuda"}}
    path = output_dir.with_suffix(".yaml")
    path.write_text(yaml.safe_dump(cfg))
    return path


def dp_cli_phase(tmp: Path) -> dict:
    """Phase 36 (a): ``train_dual_eeg``'s CLI (its ``main``) on the flagship
    at full width, without ``--mesh`` and with ``--mesh dp``: one rank on
    the one card, through NCCL and DDP, in this process.  The run with the
    mesh launches K1 once per train step and eval batch; its epoch's losses
    and gradient norm are the single run's within the flagship's train
    parity bounds (the same seed, so the same IBS-head dropout masks).
    ``--mesh dp2`` on the one card raises before anything is built."""
    from eyegaze_tpu_torch import parallel, train_dual_eeg

    if parallel.mesh_world("dp", "cuda") != 1:
        raise RuntimeError("phase 36 expects one card")
    runs = {}
    for name, mesh in (("one device", []), ("--mesh dp", ["--mesh", "dp"])):
        path = dp_flagship_yaml(tmp / name.replace(" ", "_").strip("-"))
        reset_k1_count()
        t0 = time.perf_counter()
        result = train_dual_eeg.main(["--config", str(path), "--device", "cuda", *mesh])
        runs[name] = {"history": result["history"][-1], "k1": k1_count(),
                      "wall_s": time.perf_counter() - t0}
    one, mesh = runs["one device"]["history"], runs["--mesh dp"]["history"]
    n_val = DP_CLI_TRIALS // 5
    steps, eval_batches = (DP_CLI_TRIALS - n_val) // TRAIN_BATCH, -(-n_val // TRAIN_BATCH)
    k1 = runs["--mesh dp"]["k1"]
    losses = sorted(k for k in one if k.startswith("train/loss"))
    print(f"phase 36 (a), train_dual_eeg --mesh dp (one rank through NCCL and DDP) against "
          f"the run without --mesh, one bf16 epoch at batch {TRAIN_BATCH}: "
          + ", ".join(f"{k[6:]} {mesh[k]:.6f} / {one[k]:.6f}" for k in losses)
          + f", grad_norm {mesh['train/grad_norm']:.6f} / {one['train/grad_norm']:.6f}, val "
          f"accuracy {mesh['val/accuracy']:.4f} / {one['val/accuracy']:.4f} (bounds: each loss "
          f"within {LOGIT_TOL}, the grad norm within {PARITY_GRAD_NORM_RTOL} relative); K1 "
          f"launches {k1} ({steps} steps + {eval_batches} eval batch); wall "
          f"{runs['--mesh dp']['wall_s']:.2f} / {runs['one device']['wall_s']:.2f} s")
    if k1 != steps + eval_batches or runs["one device"]["k1"] != k1:
        raise RuntimeError(f"--mesh dp launched K1 {k1} times, not {steps + eval_batches}")
    if not (all(abs(mesh[k] - one[k]) <= LOGIT_TOL for k in losses)
            and abs(mesh["train/grad_norm"] / one["train/grad_norm"] - 1)
            <= PARITY_GRAD_NORM_RTOL):
        raise RuntimeError("train_dual_eeg --mesh dp is not the run without --mesh")
    try:
        train_dual_eeg.main(["--config", str(dp_flagship_yaml(tmp / "dp2")), "--device", "cuda",
                             "--mesh", "dp2"])
    except ValueError as e:
        print(f"phase 36: --mesh dp2 on the one card raises: {e}")
    else:
        raise RuntimeError("--mesh dp2 on one card trained instead of raising")
    return {"k1": k1, "steps": steps, "eval_batches": eval_batches,
            "wall_s": runs["--mesh dp"]["wall_s"]}


def dp_steps(trainer, batches: list, read=None, full: bool = False) -> dict:
    """``trainer.train_epoch`` on each global batch in turn (one step
    each), each step timed to a synchronize; ``read()`` after each step
    gives its launches.  ``full``: the parameters after the steps with the
    tp shards gathered (``tp_full_params``)."""
    losses, norms, walls, counts = [], [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        stats = trainer.train_epoch([batch], i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(stats["train/loss"])
        norms.append(stats["train/grad_norm"])
        if read is not None:
            counts.append(read())
    params = (tp_full_params(trainer.model) if full else
              {n: p.detach().float().cpu().clone() for n, p in trainer.model.named_parameters()})
    return {"losses": losses, "grad_norms": norms, "walls_ms": walls, "counts": counts,
            "params": params}


def dp_trainers(device, mesh, names=("flagship", "flagship_f32", "art")):
    """The flagship (bf16, the bench's objective; "flagship_f32" the same in
    float32) and ART (bf16, attention dropout 0.0) at full width, every
    dropout off, each in a ``Trainer`` (``mesh``: its ``use_mesh``) with
    AdamW at their train LRs; those of ``names``."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
    from eyegaze_tpu_torch.train_dual_eeg import build_model, make_objective

    cfg = flagship_train_config(".", dropout=0.0)
    build = {"flagship": lambda: build_model(cfg, device=device, dtype=torch.bfloat16),
             "flagship_f32": lambda: build_model(cfg, device=device),
             "art": lambda: art_train_model(device, 0.0, torch.bfloat16)}
    models = {name: build[name]() for name in names}
    flagship_loss = make_objective(cfg)[0]
    objectives = {"flagship": flagship_loss, "flagship_f32": flagship_loss,
                  "art": train_art.make_objective(False)[0]}
    lrs = {"flagship": TRAIN_LR, "flagship_f32": TRAIN_LR, "art": ART_TRAIN_LR}
    out = {}
    for name, model in models.items():
        for m in model.modules():  # the IBS head's fixed 0.3 too
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        out[name] = Trainer(model, make_optimizer(model, lrs[name], 0.01, grad_clip=1.0),
                            objectives[name], None,
                            TrainerConfig(use_mesh=mesh, prefetch=0), device=device)
    return out


def dp_batches() -> dict:
    """DP_STEPS global batches each: the bench's (64, 32, 1024) pairs and
    ART's 16 noisy -> clean windows, on the host."""
    from eyegaze_tpu_torch import train_art

    art = train_art.build_dataset(DP_STEPS * ART_TRAIN_BATCH, CHANNELS, WINDOW).arrays
    return {"flagship": [{k: v.cpu().numpy() for k, v in bench_batch(TRAIN_BATCH, "cpu",
                                                                     seed=10 + i).items()}
                         for i in range(DP_STEPS)],
            "art": [{k: v[i * ART_TRAIN_BATCH:(i + 1) * ART_TRAIN_BATCH] for k, v in art.items()}
                    for i in range(DP_STEPS)]}


def flagship_rank_steps(trainers: dict, batches: list, full: bool = False) -> dict:
    """A rank's flagship steps in phases 36 and 37: the bf16 trainer's on
    ``batches``, the f32 one's on the first (``dp_steps``, ``full`` its
    flag), each with K1's launches, the bf16 steps with the N of each."""
    from eyegaze_tpu_torch.kernels import phase_metrics

    ns = []
    launch = phase_metrics.phase_metric_sums

    def recording(*args):
        ns.append(int(args[0].shape[0]))
        return launch(*args)

    phase_metrics.phase_metric_sums = recording
    try:
        reset_k1_count()
        flagship = dp_steps(trainers["flagship"], batches, full=full)
        flagship["k1"], flagship["k1_n"] = k1_count(), list(ns)
        reset_k1_count()
        f32 = dp_steps(trainers["flagship_f32"], batches[:1], full=full)
        f32["k1"] = k1_count()
    finally:
        phase_metrics.phase_metric_sums = launch
    return {"flagship": flagship, "flagship_f32": f32}


@contextlib.contextmanager
def recorded_heads():
    """``attention.headpacked_attention`` recording the head count of each
    call into the list it yields."""
    from eyegaze_tpu_torch.kernels import attention

    heads = []
    launch = attention.headpacked_attention

    def recording(q, *args):
        heads.append(int(q.shape[2]))
        return launch(q, *args)

    attention.headpacked_attention = recording
    try:
        yield heads
    finally:
        attention.headpacked_attention = launch


def dp_rank(rank, world, device, batches) -> dict:
    """Phase 36 (b, c) on one rank of the two that share the card through
    gloo: DP_STEPS bf16 flagship steps, one f32 flagship step (on the first
    batch), then DP_STEPS ART steps, each rank on its rows of the global
    batches.  Returns the steps (``dp_steps``), K1's launches and their N,
    and the attention counts after each ART step."""
    trainers = dp_trainers(device, f"dp{world}")
    out = flagship_rank_steps(trainers, batches["flagship"])

    def read():
        counts = art_bf16_train_counts()
        reset_attention_counts()
        reset_backward_count()
        return counts

    reset_attention_counts()
    reset_backward_count()
    out["art"] = dp_steps(trainers["art"], batches["art"], read)
    return out


def check_dp_parity(name: str, ranks: list, one: dict, lr: float, loss_bound,
                    rtol: float) -> None:
    """The two ranks' steps against one process's on the same global
    batches: each step's loss within ``loss_bound(loss)``; the first step's
    gradient norm (from the same parameters) within ``rtol``; after the
    steps, every parameter equal on the ranks, the largest change within
    ``rtol`` of one process's and every entry within the Adam bound (2 lr +
    1%) per step.  In float32 ``rtol`` is ``check_step_parity``'s 1e-3; in
    bf16 it is DP_BF16_RTOL.  The later steps' gradient norms are printed,
    not bounded: after a step the parameters may differ by the Adam bound,
    up to 2 lr on an entry whose gradient is rounding noise, which moves a
    bf16 weight by an ulp and a gradient norm by far more than 1e-3."""
    if any(not torch.equal(ranks[0]["params"][k], other["params"][k])
           for other in ranks[1:] for k in ranks[0]["params"]):
        raise RuntimeError(f"{name}: the ranks hold other parameters")
    got = ranks[0]
    before = one["before"]
    step = {k: got["params"][k] - before[k] for k in before}
    one_step_ = {k: one["params"][k] - before[k] for k in before}
    largest = max(float(d.abs().max()) for d in step.values())
    one_largest = max(float(d.abs().max()) for d in one_step_.values())
    apart = max(float((got["params"][k] - one["params"][k]).abs().max()) for k in before)
    steps = len(one["losses"])
    apart_bound = 2 * lr * 1.01 * steps
    loss_gaps = [abs(a - b) / loss_bound(b) for a, b in zip(got["losses"], one["losses"])]
    norm_gap = abs(got["grad_norms"][0] / one["grad_norms"][0] - 1) / rtol
    print(f"{name}, {len(ranks)} ranks sharing one card through gloo against one process, "
          f"{steps} step(s): losses " + ", ".join(
              f"{a:.6f} / {b:.6f}" for a, b in zip(got["losses"], one["losses"]))
          + "; grad norms " + ", ".join(
              f"{a:.6f} / {b:.6f}" for a, b in zip(got["grad_norms"], one["grad_norms"]))
          + f"; the largest share of a loss bound {max(loss_gaps):.3f}, the first step's share "
          f"of the grad-norm bound ({rtol:g} relative) {norm_gap:.3f}; the largest parameter "
          f"change {largest:.6e} / {one_largest:.6e} (bound {rtol:g} relative), entries apart by "
          f"{apart:.3e} at most (bound {apart_bound:.3e})")
    if not (max(loss_gaps) <= 1.0 and norm_gap <= 1.0
            and abs(largest / one_largest - 1) <= rtol and apart <= apart_bound):
        raise RuntimeError(f"{name}: two ranks are not one process within the bounds")


def data_parallel_phase(device, tmp: Path, card: str) -> dict:
    """Phase 36: data parallelism on the card (a: ``dp_cli_phase``; b, c:
    ``dp_rank`` on two ranks through ``parallel.launch`` with gloo, against
    one process on the same global batches, ``check_dp_parity``).  Per rank
    per step: K1 once at N = 32 x 6 = 192, K3-bf16 18 launches, K4's
    one-pass backward 18 launches.  Prints the step times beside ``card``
    (nvidia-smi's name and power limit): two ranks sharing one card, not a
    scale-out rate."""
    from eyegaze_tpu_torch import parallel

    t_phase = time.perf_counter()
    cli = dp_cli_phase(tmp)
    batches = dp_batches()
    t0 = time.perf_counter()
    ranks = parallel.launch(dp_rank, DP_WORLD, batches, device=str(device), backend="gloo")
    launch_s = time.perf_counter() - t0
    trainers = dp_trainers(device, False)
    one = {}
    for name, trainer in trainers.items():
        before = {n: p.detach().float().cpu().clone() for n, p in trainer.model.named_parameters()}
        if name == "art":
            reset_attention_counts()
            reset_backward_count()
        mine = batches["flagship"][:1] if name == "flagship_f32" else batches[name]
        one[name] = {**dp_steps(trainer, mine), "before": before}
    check_dp_parity("phase 36 (b), the flagship's bench step in float32 (batch 64, dropout 0)",
                    [r["flagship_f32"] for r in ranks], one["flagship_f32"], TRAIN_LR,
                    lambda loss: LOGIT_TOL, PARITY_GRAD_NORM_RTOL)
    check_dp_parity("phase 36 (b), the flagship's bench step (bf16, batch 64, dropout 0)",
                    [r["flagship"] for r in ranks], one["flagship"], TRAIN_LR,
                    lambda loss: DP_BF16_RTOL * abs(loss), DP_BF16_RTOL)
    check_dp_parity(f"phase 36 (c), ART bf16 at attention dropout 0.0 (batch {ART_TRAIN_BATCH})",
                    [r["art"] for r in ranks], one["art"], ART_TRAIN_LR,
                    lambda loss: DP_BF16_RTOL * abs(loss), DP_BF16_RTOL)
    per_rows = TRAIN_BATCH // DP_WORLD
    for r, got in enumerate(ranks):
        f, a = got["flagship"], got["art"]
        if (f["k1"] != DP_STEPS or f["k1_n"] != [6 * per_rows] * DP_STEPS
                or got["flagship_f32"]["k1"] != 1):
            raise RuntimeError(f"rank {r}: K1 launched {f['k1']} times at N {f['k1_n']}")
        if any(c != (ART_ATTENTION_CALLS,) * 3 for c in a["counts"]):
            raise RuntimeError(f"rank {r}: ART steps launched (K3-bf16, backward calls, "
                               f"one-pass kernel) {a['counts']}")
    rank_ms = {name: [statistics.median(r[name]["walls_ms"][1:]) for r in ranks]
               for name in ("flagship", "art")}
    one_ms = {name: statistics.median(one[name]["walls_ms"][1:]) for name in rank_ms}
    print("phase 36, per rank per step: K1 1 launch at N = " + ", ".join(
        str(sorted(set(r["flagship"]["k1_n"]))) for r in ranks)
          + f", K3-bf16 {ART_ATTENTION_CALLS} launches and K4's one-pass backward "
          f"{ART_ATTENTION_CALLS} launches (each rank, each step); step ms, median of steps 2-"
          f"{DP_STEPS}, two ranks sharing one card through gloo ({card}; not a scale-out "
          "rate): "
          + "; ".join(f"{name} rank 0 {ms[0]:.2f}, rank 1 {ms[1]:.2f}, one process "
                      f"{one_ms[name]:.2f}" for name, ms in rank_ms.items())
          + f"; the launch of two ranks {launch_s:.2f} s, the phase {time.perf_counter() - t_phase:.2f} s")
    return {"cli": cli, "k1": sum(r["flagship"]["k1"] + r["flagship_f32"]["k1"] for r in ranks),
            "k3_bf16": sum(sum(c[0] for c in r["art"]["counts"]) for r in ranks),
            "bwd_calls": sum(sum(c[1] for c in r["art"]["counts"]) for r in ranks),
            "one_pass": sum(sum(c[2] for c in r["art"]["counts"]) for r in ranks),
            "rank_step_ms": rank_ms, "one_process_step_ms": one_ms, "launch_s": launch_s,
            "phase_s": time.perf_counter() - t_phase, "one": one}


def tp_full_params(model) -> dict:
    """Every parameter of ``model`` on the CPU in float32, the tp shards
    gathered: one process's names and shapes."""
    from eyegaze_tpu_torch.parallel import tensor

    names = {n for n, _ in model.named_parameters()}
    return {k: v.float().cpu().clone() for k, v in tensor.full_state_dict(model).items()
            if k in names}


def tp_art_trainer(device, mesh):
    """ART at full width in bf16, attention dropout 0.0 and every dropout
    off, in a ``Trainer`` under ``mesh`` (None: one process) with AdamW at
    ART's train LR."""
    from eyegaze_tpu_torch import train_art
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = art_train_model(device, 0.0, torch.bfloat16)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return Trainer(model, make_optimizer(model, ART_TRAIN_LR, 0.01, grad_clip=1.0),
                   train_art.make_objective(False)[0], None,
                   TrainerConfig(use_mesh=mesh, prefetch=0), device=device)


def tp_vit_trainer(device, mesh):
    """ViT-B/16 early fusion (concat) in bf16 without dropout, train_gaze's
    forward and class-weighted CE without the augment, in a ``Trainer``
    under ``mesh`` (None: one process)."""
    from eyegaze_tpu_torch import train_gaze
    from eyegaze_tpu_torch.train.losses import weighted_cross_entropy
    from eyegaze_tpu_torch.train.optim import make_optimizer
    from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = gaze_train_config(".", dropout=0.0)
    model = train_gaze.build_model(cfg, "early", device=device)
    _, forward = train_gaze.make_objective("early", img_size=cfg.model.img_size,
                                           generator=torch.Generator(device=device))
    weights = gaze_class_weights(device)

    def loss_fn(m, batch):
        return weighted_cross_entropy(forward(m, batch), batch["label"], weights), {}

    return Trainer(model, make_optimizer(model, GAZE_TRAIN_LR, 0.01, grad_clip=1.0), loss_fn,
                   None, TrainerConfig(use_mesh=mesh, prefetch=0), device=device)


def tp_batches(names=("art", "vit", "flagship")) -> dict:
    """TP_STEPS global batches of each of ``names``, on the host, drawn from
    seeds (each rank draws its own, the same): ART's 16 noisy -> clean
    windows and the bench's 64 window pairs (phase 36's), ViT pairs of 16
    uint8 (3, 224, 224) images."""
    out = {}
    if "art" in names or "flagship" in names:
        dp = dp_batches()
        out.update({k: dp[k] for k in ("art", "flagship") if k in names})
    if "vit" in names:
        out["vit"] = []
        for i in range(TP_STEPS):
            a, b = gaze_pairs(GAZE_TRAIN_BATCH, 70 + i)
            out["vit"].append({"img1": a, "img2": b,
                               "label": (np.arange(GAZE_TRAIN_BATCH) % 3).astype(np.int32)})
    return out


def tp_serve_cases(tmp: Path) -> list:
    """Phase 37 (d)'s checkpoints, seeded at full width (phase 30's models
    and metas, and HyperEEG at its documented preset) and written to
    ``tmp``: (kind, path, predictor class, request) for the flagship,
    ViT-B/16 early fusion, ART, the composite and HyperEEG."""
    from eyegaze_tpu_torch import serving
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.models.hypereeg import FIELDS, create_hypereeg_model
    from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
    from eyegaze_tpu_torch.models.vit import EarlyFusionViT

    def seeded():
        return dict(device=torch.device("cpu"), generator=torch.Generator().manual_seed(17))

    r = np.random.default_rng(30)
    eeg = [r.normal(size=(IMPORT_WINDOWS, CHANNELS, WINDOW)).astype(np.float32)
           for _ in range(2)]
    art = ArtConfig()
    gaze_meta = {"kind": "early", "fusion_mode": "concat", "img_size": GAZE_GEOMETRY["img_size"],
                 "num_labels": 3, "vit_num_heads": GAZE_GEOMETRY["num_heads"]}
    builds = (
        ("flagship", lambda: DualEEGTransformer(**GEOMETRY, **seeded()), FLAGSHIP_META,
         serving.Predictor, eeg),
        ("gaze early (ViT-B/16)",
         lambda: EarlyFusionViT(fusion_mode="concat", **GAZE_GEOMETRY, **seeded()),
         {"config": {"model": gaze_meta}}, serving.GazePredictor, gaze_pairs(IMPORT_PAIRS, 31)),
        ("ART", lambda: ArtifactRemovalTransformer(art, **seeded()),
         {"config": {"model": dataclasses.asdict(art)}}, serving.ArtDenoiser, eeg[:1]),
        ("multimodal composite", lambda: MultimodalFusionModel(**MM_GEOMETRY, **seeded()),
         {"config": {"model": {"multimodal": MM_GEOMETRY, "num_labels": 3}}},
         serving.MultimodalPredictor, multimodal_inputs(IMPORT_PAIRS, 33)),
        ("HyperEEG", lambda: create_hypereeg_model("full", "documented", **seeded()), None,
         serving.HyperEEGPredictor, hypereeg_pairs(IMPORT_WINDOWS, 37)))
    out = []
    for name, build, meta, cls, request in builds:
        model = build()
        if meta is None:
            meta = {"config": {"model": {"hypereeg": {f: getattr(model, f) for f in FIELDS}}}}
        path = save_checkpoint(model.state_dict(), meta, tmp / f"tp_{len(out)}.pt")
        out.append((name, str(path), cls, request))
        del model
    return out


def tp_serve(cases: list, device, mesh) -> dict:
    """Each case served bf16 ``from_checkpoint`` under ``mesh`` (None:
    unsharded): its first output, and each request's K1 and K3-bf16
    launches and the heads K3 saw."""
    from eyegaze_tpu_torch.kernels import attention

    out = {}
    with recorded_heads() as heads:
        for name, path, cls, request in cases:
            pred = cls.from_checkpoint(path, device=device, mesh=mesh)
            reset_k1_count()
            reset_attention_counts()
            heads.clear()
            got = pred.predict(*request)
            key = "denoised" if "denoised" in got else "logits"
            out[name] = {"out": np.asarray(got[key]), "k1": k1_count(),
                         "k3_bf16": attention.bf16_launch_count["headpacked_attention"],
                         "heads": sorted(set(heads))}
            del pred
    return out


def tp_rank(rank, world, device, payload) -> dict:
    """Phase 37 on one rank of the gloo ranks sharing the card.  Two ranks
    (``tp2``): (a) TP_STEPS bf16 ART steps, with each step's K3-bf16
    launches, backward calls, one-pass kernel launches, the heads K3 saw
    and the layers' all_reduces; (b) TP_STEPS bf16 ViT-B/16 steps and the
    rank's parameter bytes; (d) ``tp_serve`` under tp2.  Four ranks
    (``dp2,tp2``): (c) TP_STEPS bf16 flagship bench steps and one f32 step,
    with K1's launches and their N."""
    from eyegaze_tpu_torch.parallel import tensor

    seconds = {"start": time.time() - payload["t_launch"]}
    t0 = time.perf_counter()
    if world == 4:
        trainers = dp_trainers(device, TP_DPTP, names=("flagship", "flagship_f32"))
        out = flagship_rank_steps(trainers, tp_batches(("flagship",))["flagship"], full=True)
        seconds["flagship"] = time.perf_counter() - t0
        return {**out, "seconds": seconds}
    batches = tp_batches(("art", "vit"))
    with recorded_heads() as heads:

        def read():
            counts = art_bf16_train_counts() + (tensor.all_reduce_count,
                                                tuple(sorted(set(heads))))
            reset_attention_counts()
            reset_backward_count()
            tensor.all_reduce_count = 0
            heads.clear()
            return counts

        art_trainer = tp_art_trainer(device, TP_MESH)
        reset_attention_counts()
        reset_backward_count()
        tensor.all_reduce_count = 0
        art = dp_steps(art_trainer, batches["art"], read, full=True)
    del art_trainer
    seconds["art"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit_trainer = tp_vit_trainer(device, TP_MESH)
    vit = dp_steps(vit_trainer, batches["vit"], full=True)
    vit["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in vit_trainer.model.parameters())
    del vit_trainer
    torch.cuda.empty_cache()
    seconds["vit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = tp_serve(payload["serve"], device, TP_MESH)
    seconds["serve"] = time.perf_counter() - t0
    return {"art": art, "vit": vit, "serve": serve, "seconds": seconds}


def tp_attention_phase(device, clock_hz) -> dict:
    """Phase 37 (e), run beside phase 3: K3-bf16's forward and K4's
    one-pass backward at a tp2 rank's ART shape, (16, 1024, 4, 16), in this
    process: the forward
    within the bf16 bound of its twin (as phase 3 holds it), timed in turns
    with the twin and F.scaled_dot_product_attention, and replayed from a
    CUDA graph beside the library's; the backward through
    ``backward_case``."""
    from eyegaze_tpu_torch.kernels import attention

    q, k, v = attention_inputs(TP_ATTN_SHAPE, torch.bfloat16, device, 61)
    scale = 1.0 / math.sqrt(ATTN_DK)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = attention.headpacked_attention(q, k, v, scale).transpose(1, 2)
    want = attention.attention_reference(qt, kt, vt, scale)
    share = assert_within_bf16_bound(got, want, attention.attention_reference(qt, kt, vt.abs(),
                                                                             scale))
    err = float((got.float() - want.float()).abs().max())

    def kernel():
        attention.headpacked_attention(q, k, v, scale)

    def library():
        F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    ms, plain_ms, library_ms = alternate_ms(
        kernel, lambda: attention.attention_reference(qt, kt, vt, scale), library)
    ms_graph, library_graph = graph_ms(kernel), graph_ms(library)
    bound_ms, bound_by = attention_bound(*qt.shape, torch.bfloat16)
    print(f"phase 37 (e), headpacked_attention {TP_ATTN_SHAPE} bf16 (a tp2 rank's ART "
          f"heads): max |kernel - twin| {err:.3e}, {share:.2f} of the bf16 bound; one call "
          f"{ms:.4f} ms, twin {plain_ms:.4f} ms, F.scaled_dot_product_attention "
          f"{library_ms:.4f} ms; CUDA graph kernel {ms_graph:.4f} ms, library "
          f"{library_graph:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    forward = {"shape": list(TP_ATTN_SHAPE), "max_abs_err": err, "share_of_bf16_bound": share,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "ms_graph": ms_graph,
               "library_ms_graph": library_graph, "bound_ms": bound_ms, "bound_by": bound_by}
    del q, k, v, qt, kt, vt, got, want
    backward = backward_case(device, clock_hz, 62, "headpacked_attention", TP_ATTN_SHAPE,
                             WINDOW)
    if backward["path"] != "one_pass":
        raise RuntimeError(f"K4's backward at {TP_ATTN_SHAPE} took the {backward['path']} path")
    return {"forward": forward, "backward": backward}


def tp_refusal_phase(tmp: Path) -> None:
    """Phase 37 (f): ``--mesh tp2`` on the one card raises in a trainer's CLI
    (``train_art``) and in ``serve``, before anything is built."""
    from eyegaze_tpu_torch import serve, train_art

    for name, call in (
            ("train_art --mesh tp2", lambda: train_art.main(
                ["--tiny", "--epochs", "1", "--mesh", TP_MESH, "--output-dir",
                 str(tmp / "tp_refused")])),
            ("serve --mesh tp2", lambda: serve.main(
                ["--checkpoint", str(tmp / "tp_0.pt"), "--mesh", TP_MESH, "--port", "0"]))):
        try:
            call()
        except ValueError as e:
            print(f"phase 37 (f): {name} on the one card raises: {e}")
        else:
            raise RuntimeError(f"{name} on one card ran instead of raising")


def tensor_parallel_phase(device, tmp: Path, card: str, dp_one: dict, kernels: dict) -> dict:
    """Phase 37: tensor parallelism on the card.  Gloo ranks share the card
    through ``parallel.launch``: two (``tp2``: a, b, d) and four
    (``dp2,tp2``: c), against one process on the same batches and
    checkpoints (``check_dp_parity``'s bounds; serving within 2**-5 of the
    largest output); then (f) the refusals, in this process.  ``dp_one``:
    phase 36's one-process flagship steps on the same global batches;
    ``kernels``: (e), ``tp_attention_phase``'s, which runs beside phase 3
    (its backward case reads ``torch.profiler``, which saw no kernel when
    asked after phases 36-37's ranks, in one call of the whole script).
    Prints the step times beside ``card``: ranks sharing one card, not a
    scale-out rate."""
    from eyegaze_tpu_torch import parallel
    from eyegaze_tpu_torch.models.art import ArtConfig

    t_phase = time.perf_counter()
    batches = tp_batches(("art", "vit"))
    serve_cases = tp_serve_cases(tmp)
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    try:  # the ranks share the host's cores: each takes its part of them
        torch.set_num_threads(max(threads // TP_WORLD, 1))
        two = parallel.launch(tp_rank, TP_WORLD, {"serve": serve_cases, "t_launch": time.time()},
                              device=str(device), backend="gloo")
        t_two = time.perf_counter() - t0
        torch.set_num_threads(max(threads // (2 * TP_WORLD), 1))
        four = parallel.launch(tp_rank, 2 * TP_WORLD, {"t_launch": time.time()},
                               device=str(device), backend="gloo")
    finally:
        torch.set_num_threads(threads)
    launch_s = time.perf_counter() - t0
    one = {k: dp_one[k] for k in ("flagship", "flagship_f32")}  # phase 36's, same batches
    for name, build, mine in (("art", tp_art_trainer, batches["art"]),
                              ("vit", tp_vit_trainer, batches["vit"])):
        trainer = build(device, None)
        before = {n: p.detach().float().cpu().clone() for n, p in trainer.model.named_parameters()}
        one[name] = {**dp_steps(trainer, mine), "before": before}
        if name == "vit":
            one[name]["param_bytes"] = sum(p.numel() * p.element_size()
                                           for p in trainer.model.parameters())
        del trainer
    torch.cuda.empty_cache()
    check_dp_parity(f"phase 37 (a), ART bf16 at attention dropout 0.0 (batch {ART_TRAIN_BATCH}) "
                    f"under {TP_MESH}", [r["art"] for r in two], one["art"], ART_TRAIN_LR,
                    lambda loss: DP_BF16_RTOL * abs(loss), DP_BF16_RTOL)
    check_dp_parity(f"phase 37 (b), ViT-B/16 early fusion bf16 (batch {GAZE_TRAIN_BATCH}) under "
                    f"{TP_MESH}", [r["vit"] for r in two], one["vit"], GAZE_TRAIN_LR,
                    lambda loss: DP_BF16_RTOL * abs(loss), DP_BF16_RTOL)
    check_dp_parity(f"phase 37 (c), the flagship's bench step in float32 (batch {TRAIN_BATCH}) "
                    f"under {TP_DPTP}", [r["flagship_f32"] for r in four], one["flagship_f32"],
                    TRAIN_LR, lambda loss: LOGIT_TOL, PARITY_GRAD_NORM_RTOL)
    check_dp_parity(f"phase 37 (c), the flagship's bench step (bf16, batch {TRAIN_BATCH}) under "
                    f"{TP_DPTP}", [r["flagship"] for r in four], one["flagship"], TRAIN_LR,
                    lambda loss: DP_BF16_RTOL * abs(loss), DP_BF16_RTOL)
    cfg = ArtConfig()
    reduces = 4 * cfg.num_encoder_layers + 7 * cfg.num_decoder_layers
    for r, got in enumerate(two):
        want = (ART_ATTENTION_CALLS, ART_ATTENTION_CALLS, ART_ATTENTION_CALLS, reduces,
                (ATTN_HEADS // TP_WORLD,))
        if any(c != want for c in got["art"]["counts"]):
            raise RuntimeError(f"rank {r}: ART steps gave (K3-bf16, backward calls, one-pass "
                               f"kernel, all_reduces, heads) {got['art']['counts']}, not {want}")
    for r, got in enumerate(four):
        f = got["flagship"]
        if (f["k1"] != TP_STEPS or f["k1_n"] != [6 * TRAIN_BATCH // 2] * TP_STEPS
                or got["flagship_f32"]["k1"] != 1):
            raise RuntimeError(f"rank {r} of {TP_DPTP}: K1 launched {f['k1']} times at N "
                               f"{f['k1_n']}")
    served = tp_serve(serve_cases, device, None)
    for name, want in served.items():
        for r, got in enumerate(two):
            g = got["serve"][name]
            scale = float(np.abs(want["out"]).max())
            gap = float(np.abs(g["out"] - want["out"]).max())
            expect_k3 = ART_ATTENTION_CALLS if name == "ART" else 0
            heads = [ATTN_HEADS // TP_WORLD] if name == "ART" else []
            if gap > TP_SERVE_SHARE * scale or g["k3_bf16"] != expect_k3 or g["heads"] != heads \
                    or g["k1"] != want["k1"]:
                raise RuntimeError(f"{name} served under {TP_MESH} on rank {r}: gap {gap:.3e} "
                                   f"(bound {TP_SERVE_SHARE * scale:.3e}), K3-bf16 "
                                   f"{g['k3_bf16']} at heads {g['heads']}, K1 {g['k1']}")
        print(f"phase 37 (d), {name} served bf16 from a checkpoint under {TP_MESH} against the "
              f"same checkpoint unsharded on the card: max |gap| "
              + ", ".join(f"rank {r} {float(np.abs(g['serve'][name]['out'] - want['out']).max()):.3e}"
                          for r, g in enumerate(two))
              + f" (bound {TP_SERVE_SHARE:g} of the largest |output| "
              f"{float(np.abs(want['out']).max()):.3f}); per request per rank K1 "
              f"{two[0]['serve'][name]['k1']}, K3-bf16 {two[0]['serve'][name]['k3_bf16']} at "
              f"{two[0]['serve'][name]['heads'] or '-'} heads")
    tp_refusal_phase(tmp)
    rank_ms = {name: [statistics.median(r[name]["walls_ms"][1:]) for r in ranks]
               for name, ranks in (("art", two), ("vit", two), ("flagship", four))}
    one_ms = {name: statistics.median(one[name]["walls_ms"][1:]) for name in rank_ms}
    phase_s = time.perf_counter() - t_phase
    print(f"phase 37, per rank per step: ART K3-bf16 {ART_ATTENTION_CALLS} launches at "
          f"{ATTN_HEADS // TP_WORLD} heads, K4's one-pass backward {ART_ATTENTION_CALLS} "
          f"launches, {reduces} tp all_reduces (predicted from the layers); flagship K1 1 launch "
          f"at N = {6 * TRAIN_BATCH // 2}; ViT-B/16 parameter bytes per rank "
          + ", ".join(f"{r['vit']['param_bytes']:,}" for r in two)
          + f" against {one['vit']['param_bytes']:,} in one process; step ms, median of steps "
          f"2-{TP_STEPS}, ranks sharing one card through gloo ({card}; not a scale-out rate): "
          + "; ".join(f"{name} " + ", ".join(f"rank {i} {m:.2f}" for i, m in enumerate(ms))
                      + f", one process {one_ms[name]:.2f}" for name, ms in rank_ms.items())
          + f"; the two launches {launch_s:.2f} s (tp2 {t_two:.2f}: rank 0 in at "
          + ", ".join(f"{k} {v:.2f} s" for k, v in two[0]["seconds"].items())
          + "; dp2,tp2: rank 0 in at " + ", ".join(f"{k} {v:.2f} s"
                                                  for k, v in four[0]["seconds"].items())
          + f"), the phase {phase_s:.2f} s")
    art_counts = [c for r in two for c in r["art"]["counts"]]
    return {"k1": sum(r["flagship"]["k1"] + r["flagship_f32"]["k1"] for r in four),
            "k3_bf16_train": sum(c[0] for c in art_counts),
            "bwd_calls": sum(c[1] for c in art_counts),
            "one_pass": sum(c[2] for c in art_counts),
            "all_reduces_per_step": reduces,
            "k3_bf16_serve": sum(r["serve"]["ART"]["k3_bf16"] for r in two),
            "rank_step_ms": rank_ms, "one_process_step_ms": one_ms,
            "vit_param_bytes": {"ranks": [r["vit"]["param_bytes"] for r in two],
                                "one_process": one["vit"]["param_bytes"]},
            "kernels": kernels, "launch_s": launch_s, "phase_s": phase_s}


def assert_no_spill(report: str, kernel: str) -> None:
    """Raises if nvcc's ptxas report shows a spill in an instance of a
    kernel whose name holds ``kernel`` (an empty report, from a library
    built earlier, shows none)."""
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
            raise RuntimeError(f"ptxas spills in {name}: {line.strip()}")


# The arithmetic of the work: FP32 instructions and LOP3, the bit OR that
# gives the sign its sign bit (address arithmetic uses LOP3 too).
WORK_OPCODES = {"FADD", "FMUL", "FFMA", "FSET", "FSETP", "FSEL", "FMNMX", "LOP3"}
# Pairs per thread x samples per thread in one chunk of the main loop.
PAIR_SAMPLES_PER_ITERATION = 8 * 16


def phase_loop_counts(lib) -> dict:
    """Arithmetic (``WORK_OPCODES``), LDS and other instructions per pair and
    sample in the main loop
    of K1's and K2's instances, from the SASS: the body of the backward
    branch whose range holds the most arithmetic (one chunk: its
    staging, K2's sincos pass and the unrolled arithmetic).  Static counts:
    the code of both staging paths counts once, K2's sincos loop once."""
    from eyegaze_tpu_torch.kernels import sass

    code = {("K2" if name.endswith("ILb1E") else "K1"): ins for name, ins in
            sass.functions(sass.dump(lib), r"phase_metrics_kernelILb[01]E").items()}
    counts = {}
    for name, ins in sorted(code.items()):
        best = None
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr]
                fp32 = sum(o in WORK_OPCODES for o in body)
                if best is None or fp32 > best[0]:
                    best = (fp32, sum(o == "LDS" for o in body), len(body))
        if best is None:
            raise RuntimeError(f"no loop found in the SASS of {name}")
        per = PAIR_SAMPLES_PER_ITERATION
        counts[name] = {"arithmetic": best[0] / per, "lds": best[1] / per,
                        "other": (best[2] - best[0] - best[1]) / per}
    if set(counts) != {"K1", "K2"}:
        raise RuntimeError(f"phase-metrics instances in the SASS: {sorted(counts)}")
    print("main-loop instructions per pair and sample (static SASS counts): "
          + "; ".join(f"{k} arithmetic {v['arithmetic']:.2f}, LDS {v['lds']:.2f}, "
                      f"other {v['other']:.2f}"
                      for k, v in counts.items()))
    return counts


def tensor_core_proof(lib) -> dict:
    """Tensor-core instructions (``HMMA``, and Hopper's ``HGMMA``) in the
    SASS of each instance of the attention kernel and of K4's backward
    kernels (the one-pass kernels on mma.sync and on wgmma, and the dQ and
    dK/dV kernels), from ``cuobjdump --dump-sass`` of the built library.
    Raises unless every f32 instance has none (no TF32 product in the f32
    path), every bf16 forward and backward instance has some, and the
    one-pass kernels have an instance at just the head dims at which the
    library's ``attention_backward_path`` takes them."""
    from eyegaze_tpu_torch.kernels import attention, sass

    pattern = (r"attention_(kernel_f32|kernel_bf16|bwd_dq_kernel|bwd_dkv_kernel|"
               r"bwd_one_pass_kernel|bwd_one_pass_wgmma_kernel)ILi(\d+)E(?:Li(\d+)E)?")
    counts = {}
    for function, ins in sass.functions(sass.dump(lib), pattern).items():
        kind, d, rows = re.match(pattern, function).groups()
        kind = kind.replace("kernel_", "").replace("_kernel", "")
        name = (kind, int(d), int(rows)) if kind == "f32" else (kind, int(d))
        counts[name] = {op: sum(o == op for _, o, _ in ins) for op in ("HMMA", "HGMMA")}
    printable = {(f"f32 d={k[1]} R={k[2]}" if k[0] == "f32" else f"{k[0]} d={k[1]}"):
                 f"HMMA {n['HMMA']}, HGMMA {n['HGMMA']}" for k, n in counts.items()}
    print(f"tensor-core instructions per attention kernel instance: {printable}")
    counts = {k: n["HMMA"] + n["HGMMA"] for k, n in counts.items()}
    f32 = {k[1:]: n for k, n in counts.items() if k[0] == "f32"}
    if set(f32) != F32_INSTANCES or any(f32.values()):
        raise RuntimeError(f"the f32 attention instances are not the {sorted(F32_INSTANCES)} "
                           f"without tensor-core instructions: {printable}")
    one_pass = {path: {d for d in BF16_HEAD_DIMS
                       if attention.backward_path(1, d) == path}
                for path in ("one_pass", "one_pass_wgmma")}
    for kind in ("bf16", "bwd_dq", "bwd_dkv", "bwd_one_pass", "bwd_one_pass_wgmma"):
        tc = {k[1]: n for k, n in counts.items() if k[0] == kind}
        dims = one_pass.get(kind.removeprefix("bwd_"), BF16_HEAD_DIMS)
        if not dims or set(tc) != dims or not all(tc.values()):
            raise RuntimeError(f"a {kind} attention instance runs no tensor-core instruction: "
                               f"{printable}")
    return printable


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; it has no CPU mode")
    from eyegaze_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    clock_hz = sm_clock_hz()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"max SM clock {clock_hz / 1e6:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions: every phase runs in full float32 "
          "unless it says bf16")

    t0 = time.perf_counter()
    built = build.build_all(SOURCES)
    print(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s (one nvcc each, "
          "in parallel)")
    for name, (lib, report) in built.items():
        print(f"{name}: {lib.name}")
        for line in report.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    assert_no_spill(built["attention"][1], "attention_kernel_f32")
    assert_no_spill(built["attention"][1], "attention_bwd")
    assert_no_spill(built["phase_metrics"][1], "phase_metrics_kernel")
    tensor_core_proof(built["attention"][0])
    loop_counts = phase_loop_counts(built["phase_metrics"][0])

    from eyegaze_tpu_torch.kernels import attention

    # The backward kernels' main loops (phase 3's kernels), static SASS.
    bwd_mix = attention.backward_loop_mix(built["attention"][0])
    for kernel, counts in bwd_mix.items():
        print(f"main loop of the backward's {kernel}, instructions per score and thread (static "
              "SASS): " + ", ".join(f"{k} {v:.3f}" for k, v in counts.items()))

    k1_timing, k1_shapes = phase_kernel_phase(device, plv=False)
    k2_timing, _ = phase_kernel_phase(device, plv=True)
    attn_timing = attention_phase(device, clock_hz)
    bwd_cases = attention_backward_phase(device, clock_hz)
    tp_kernels = tp_attention_phase(device, clock_hz)

    reset_attention_counts()
    k1_launches, medians, raw1, raw2, logits, state = slice_phase(device)
    if any(attention.launch_count.values()):
        raise RuntimeError("the flagship's 139-token attention launched the attention kernel")
    cpu_parity(raw1, raw2, logits, state)

    with tempfile.TemporaryDirectory() as tmp:
        k1_bf16_launches, checkpoint = flagship_bf16_phase(device, Path(tmp), state, medians,
                                                           logits)
        http_phase(device, checkpoint)

        art_launches, art_medians, noisy, outs, art_state = art_phase(device)
        n = ART_REQUESTS[0]
        art_cpu_parity(noisy[:n], outs[n], art_state)
        art_bf16_launches, noisy, outs, art_state = art_bf16_phase(device, art_medians, outs[n])
        art_ckpt_launches = art_checkpoint_phase(device, Path(tmp), art_state, noisy, outs)
    flash_route = kernel_route_phase(device, FLASH_SHAPE)
    flash_launches = flash_route["launches"]
    headpacked64_route = kernel_route_phase(device, HEADPACKED64_SHAPE)

    _, shootout_launches = shootout_phase()
    legacy_raw1, legacy_raw2, legacy_logits, legacy_state = legacy_phase(device)
    cpu_parity(legacy_raw1, legacy_raw2, legacy_logits, legacy_state, use_robust_ibs=False)

    reset_attention_counts()
    train_parity_phase(device)
    train = {dt: train_timed_phase(device, dt) for dt in (torch.bfloat16, torch.float32)}
    with tempfile.TemporaryDirectory() as tmp:
        k1_train_serve_launches, train_history = train_serve_phase(device, Path(tmp))
    if any(attention.launch_count.values()):
        raise RuntimeError("flagship training launched the attention kernel")
    bf16, f32 = train[torch.bfloat16], train[torch.float32]
    print(f"flagship train step at batch {TRAIN_BATCH}, median ms: bf16 {bf16['median_ms']:.3f}, "
          f"f32 {f32['median_ms']:.3f} ({f32['median_ms'] / bf16['median_ms']:.2f}x); peak "
          f"memory GiB: bf16 {bf16['peak_bytes'] / 2**30:.3f}, f32 {f32['peak_bytes'] / 2**30:.3f}")
    k1_train = bf16["launches"] + f32["launches"] + k1_train_serve_launches

    reset_k1_count()
    art_grad_err, (parity_launches, parity_backward), cpu_f32_grads = \
        art_train_parity_phase(device)
    attn_train = attention_train_timing(device)
    art_train = {ad: art_train_timed_phase(device, ad) for ad in (None, 0.0)}
    with tempfile.TemporaryDirectory() as tmp:
        art_entry_launches, art_entry_backward = art_train_serve_phase(device, Path(tmp))
        reset_k1_count()
        gaze_http_phase(device, gaze_phase(device, Path(tmp)))
    from eyegaze_tpu_torch.kernels import phase_metrics

    if any(phase_metrics.launch_count.values()):
        raise RuntimeError(f"ART training or gaze serving launched {phase_metrics.launch_count}")
    gaze_train_parity_phase(device)
    gaze_train = {kind: gaze_train_timed_phase(device, kind, mode)
                  for kind, mode in GAZE_TRAIN_KINDS}
    with tempfile.TemporaryDirectory() as tmp:
        gaze_train_serve_phase(device, Path(tmp))
        k1_mm_launches, mm_buckets, mm_path = multimodal_phase(device, Path(tmp))
        k1_mm_launches += multimodal_http_phase(device, mm_path)

    k1_mm_train = mm_train_parity_phase(device)
    mm_train = mm_train_timed_phase(device)
    k1_mm_train += mm_train["launches"] + mm_frozen_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        k1_mm_train += mm_train_serve_phase(device, Path(tmp))
        reset_k1_count()
        reset_attention_counts()
        hx_path, hx_medians = hypereeg_phase(device, Path(tmp))
        hx_http_ms = hypereeg_http_phase(device, hx_path)
        hypereeg_train_parity_phase(device)
        hx_train = hypereeg_train_timed_phase(device)
        hypereeg_train_serve_phase(device, Path(tmp))
        assert_no_port_kernel("HyperEEG serving and training")
    with tempfile.TemporaryDirectory() as tmp:
        offline_raw_windows_phase(device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        offline = offline_features_phase(device, Path(tmp))
    assert_no_port_kernel("the offline EEG pipeline")

    bf16_parity = art_bf16_train_parity_phase(device, cpu_f32_grads)
    art_bf16_train = {ad: art_bf16_train_timed_phase(device, ad) for ad in (None, 0.0)}
    with tempfile.TemporaryDirectory() as tmp:
        bf16_epoch = art_bf16_epoch_phase(device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        imported = import_phase(device, Path(tmp))
        analysis = analyze_phase(device, Path(tmp), imported["flagship"])
    gaze_introspection = gaze_introspect_phase(device)
    gaze_analysis_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        entropy_phase(device, Path(tmp), train_history)
    with tempfile.TemporaryDirectory() as tmp:
        rehearsal = rehearsal_phase(device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        dp = data_parallel_phase(device, Path(tmp), card)
    with tempfile.TemporaryDirectory() as tmp:
        tp = tensor_parallel_phase(device, Path(tmp), card, dp["one"], tp_kernels)
    print("offline EEG features at (32, 3250), trials/s end to end: "
          + ", ".join(f"chunk {c} {o['trials_per_s']:.2f} ({o['kernels_per_chunk']:.0f} kernels "
                      f"a chunk, busy {o['busy_share']:.1%}, {o['device_ms_per_chunk']:.3f} ms "
                      f"a chunk on the device)" for c, o in offline["chunks"].items())
          + "; no kernel of the port launched")
    print(f"multimodal composite train step at batch {MM_TRAIN_BATCH}, bf16: median "
          f"{mm_train['median_ms']:.3f} ms, peak {mm_train['peak_bytes'] / 2**30:.3f} GiB, "
          f"{mm_train['kernels_per_call']:.0f} kernels a step, busy "
          f"{mm_train['busy_share_of_median']:.1%} of the median, K1 "
          f"{mm_train['launches_per_step']:g} launch a step; HyperEEG (documented preset): "
          "request median ms "
          + ", ".join(f"{n} pair(s) {ms:.3f}" for n, ms in hx_medians.items())
          + f", HTTP {hx_http_ms:.3f}; f32 train step at batch {HYPEREEG_TRAIN_BATCH} median "
          f"{hx_train['median_ms']:.3f} ms, peak {hx_train['peak_bytes'] / 2**30:.3f} GiB, "
          f"{hx_train['kernels_per_call']:.0f} kernels a step, busy "
          f"{hx_train['busy_share_of_median']:.1%} of the median")
    print("ViT-B/16 train step at batch {}, bf16, median ms: ".format(GAZE_TRAIN_BATCH)
          + ", ".join(f"{kind} {g['median_ms']:.3f} ({g['kernels_per_call']:.0f} kernels, busy "
                      f"{g['busy_share']:.1%}, peak {g['peak_bytes'] / 2**30:.3f} GiB)"
                      for kind, g in gaze_train.items()))
    plain_step, k3_step = art_train[None], art_train[0.0]
    print(f"ART train step at batch {ART_TRAIN_BATCH}, median ms: attention dropout 0.1 (plain "
          f"attention) {plain_step['median_ms']:.3f}, attention dropout 0.0 (K3 + autograd "
          f"Function) {k3_step['median_ms']:.3f} ({plain_step['median_ms'] / k3_step['median_ms']:.2f}x); "
          f"peak memory GiB: {plain_step['peak_bytes'] / 2**30:.3f} / "
          f"{k3_step['peak_bytes'] / 2**30:.3f}")
    k3_train_launches = k3_step["launches"] + art_entry_launches + parity_launches
    k3_backward = k3_step["backward"] + art_entry_backward + parity_backward
    bf16_plain, bf16_k4 = art_bf16_train[None], art_bf16_train[0.0]
    print(f"bf16 ART train step at batch {ART_TRAIN_BATCH}, median ms: attention dropout 0.1 "
          f"(plain attention) {bf16_plain['median_ms']:.3f}, attention dropout 0.0 (K3-bf16 + "
          f"K4's backward kernels) {bf16_k4['median_ms']:.3f} "
          f"({bf16_plain['median_ms'] / bf16_k4['median_ms']:.2f}x); peak memory GiB: "
          f"{bf16_plain['peak_bytes'] / 2**30:.3f} / {bf16_k4['peak_bytes'] / 2**30:.3f}; "
          f"kernels a step {bf16_plain['kernels_per_call']:.0f} / "
          f"{bf16_k4['kernels_per_call']:.0f}; f32 at 0.0 {k3_step['median_ms']:.3f}")
    # ART's bf16 training (the parity step, the timed steps, the epoch): the
    # one-pass kernel, one launch a backward call; the flash route's train
    # steps (d = 128): the dQ and dK/dV kernels.
    bf16_train_launches = bf16_parity[0] + bf16_k4["launches"] + bf16_epoch[0]
    bwd_calls = bf16_parity[1] + bf16_k4["backward"] + bf16_epoch[1]
    one_pass_launches = bf16_parity[2] + bf16_k4["kernel_launches"] + bf16_epoch[2]
    # Phase 36's launches: the CLI's --mesh dp run and the two ranks'.
    dp_path = ("data-parallel training: train_dual_eeg --mesh dp (one rank, NCCL) and two "
               "gloo ranks sharing the card")
    dp_k1 = dp["cli"]["k1"] + dp["k1"]
    dp_steps_ms = {"rank_step_ms": dp["rank_step_ms"],
                   "one_process_step_ms": dp["one_process_step_ms"],
                   "note": "two ranks sharing one card through gloo, not a scale-out rate"}
    # Phase 37's launches: the ranks of tp2 and dp2,tp2 sharing the card.
    tp_path = ("tensor-parallel training and serving: tp2 and dp2,tp2 gloo ranks sharing the "
               "card")
    tp_steps_ms = {"rank_step_ms": tp["rank_step_ms"],
                   "one_process_step_ms": tp["one_process_step_ms"],
                   "note": "ranks sharing one card through gloo, not a scale-out rate"}
    tp_fwd, tp_bwd = tp["kernels"]["forward"], tp["kernels"]["backward"]

    phase_source = "eyegaze_tpu_torch/csrc/phase_metrics.cu"
    source = "eyegaze_tpu_torch/csrc/attention.cu"
    art_forwards = len(ART_REQUESTS) * REPEATS
    k1_serving = k1_launches + k1_bf16_launches
    composite_ns = {6 * n: n for n in MM_BUCKETS}
    train_shape = (6 * TRAIN_BATCH, CHANNELS, WINDOW)
    art_bf16_all = art_bf16_launches + art_ckpt_launches
    kernels = [
        {"name": "pairwise_phase_metrics", "route": "cuda", "source": phase_source,
         "replaces": "eyegaze_tpu/ops/pallas_kernels.py:74",
         "launches": (k1_serving + k1_train + k1_mm_launches + k1_mm_train + imported["k1"]
                      + analysis["k1"] + rehearsal["k1_train"] + rehearsal["k1_analysis"]
                      + dp_k1 + tp["k1"]),
         "path": "EEG serving, f32 and bf16 from a checkpoint; flagship training, bf16 and "
                 "f32 steps and one epoch of train_dual_eeg; the multimodal composite served "
                 "bf16 from a checkpoint, and over HTTP; multimodal training (the f32 parity "
                 "step, bf16 timed and frozen steps, one epoch of train_multimodal and its "
                 "served checkpoint); imported reference checkpoints served (two flagships, "
                 "the composite); analyze_eeg at full width on the imported flagship; the "
                 "rehearsal's train_dual_eeg and analyze_eeg steps; " + dp_path + "; "
                 + tp_path + " (the flagship's steps under dp2,tp2)",
         "launches_data_parallel": {"cli_mesh_dp": dp["cli"]["k1"], "two_ranks": dp["k1"],
                                    "per_rank_per_step": dp["k1"] / (DP_WORLD * (DP_STEPS + 1)),
                                    "n_per_rank": 6 * TRAIN_BATCH // DP_WORLD, **dp_steps_ms},
         "launches_tensor_parallel": {
             "dp2_tp2_ranks": tp["k1"],
             "per_rank_per_step": tp["k1"] / (2 * TP_WORLD * (TP_STEPS + 1)),
             "n_per_rank": 6 * TRAIN_BATCH // 2, **tp_steps_ms},
         "launches_import": imported["k1"], "launches_analysis": analysis["k1"],
         "launches_rehearsal": {"train": rehearsal["k1_train"],
                                "analysis": rehearsal["k1_analysis"]},
         "rehearsal": rehearsal,
         "analysis": {"forwards_predicted": analysis["planned"], "batches": analysis["batches"],
                      "stage_s": analysis["stage_s"], "cpu_stage_s": analysis["cpu_stage_s"],
                      "wall_s": analysis["wall_s"], "cpu_wall_s": analysis["cpu_wall_s"],
                      "card_vs_cpu": analysis["gaps"],
                      "shape_timing": {f"N={shape[0]}": k1_shapes[shape]
                                       for shape in analysis_kernel_shapes()}},
         "gaze_introspection": gaze_introspection,
         "launches_per_request": k1_serving / (2 * len(REQUESTS) * REPEATS),
         "launches_serving": k1_serving, "launches_training": k1_train,
         "launches_composite": k1_mm_launches,
         "launches_multimodal_training": k1_mm_train,
         "multimodal_train": {
             "launches_per_step": mm_train["launches_per_step"],
             "step_ms": mm_train["median_ms"], "peak_gib": mm_train["peak_bytes"] / 2**30,
             "kernels_per_step": mm_train["kernels_per_call"],
             "busy_share_of_median": mm_train["busy_share_of_median"],
             "k1_ms_per_step": mm_train["k1_ms_per_call"],
             "train_shape_timing": k1_shapes[(6 * MM_TRAIN_BATCH, CHANNELS, WINDOW)],
             "eval_shape_timing": k1_shapes[composite_kernel_shapes()[-1]]},
         "composite": {f"N={N}": {"bucket": n, **k1_shapes[(N, CHANNELS, WINDOW)],
                                  **{k: mm_buckets[n][k] for k in
                                     ("k1_ms", "k1_share_of_kernel_time", "median_ms",
                                      "k1_launches")}}
                       for N, n in composite_ns.items()},
         "gaze_train_step_ms": {kind: g["median_ms"] for kind, g in gaze_train.items()},
         "launches_per_train_step": (bf16["launches"] + f32["launches"]) / (2 * TRAIN_STEPS),
         "train_shape_timing": k1_shapes[train_shape],
         "train_step_ms": {"bf16": bf16["median_ms"], "f32": f32["median_ms"]},
         "train_peak_gib": {"bf16": bf16["peak_bytes"] / 2**30, "f32": f32["peak_bytes"] / 2**30},
         "sass_per_pair_sample": loop_counts["K1"], **k1_timing},
        {"name": "pairwise_phase_plv_metrics", "route": "cuda", "source": phase_source,
         "replaces": "eyegaze_tpu/ops/pallas_kernels.py:151",
         "launches": shootout_launches["phase_plv_metric_sums"],
         "path": "connectivity shootout (bench_connectivity)",
         "launches_per_request": shootout_launches["phase_plv_metric_sums"],
         "sass_per_pair_sample": loop_counts["K2"], **k2_timing},
        {"name": "headpacked_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/ops/attn_kernels.py:78",
         "launches": art_launches + k3_train_launches,
         "path": "ART serving; ART training at attention dropout 0.0 (parity step, timed "
                 "steps, one epoch of train_art with its evaluation)",
         "launches_per_request": art_launches / art_forwards,
         "launches_serving": art_launches, "launches_training": k3_train_launches,
         "backward_calls": k3_backward,
         "launches_per_train_step": k3_step["launches"] / TRAIN_STEPS,
         "backward_calls_per_train_step": k3_step["backward"] / TRAIN_STEPS,
         "train_step_ms": {"attn_dropout_0.1_plain": plain_step["median_ms"],
                           "attn_dropout_0.0_k3": k3_step["median_ms"]},
         "train_peak_gib": {"attn_dropout_0.1_plain": plain_step["peak_bytes"] / 2**30,
                            "attn_dropout_0.0_k3": k3_step["peak_bytes"] / 2**30},
         "train_autograd": {**attn_train, "grad_max_abs_err": art_grad_err},
         **attn_timing["headpacked_attention", torch.float32]},
        {"name": "flash_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/models/transformer.py:232", "launches": flash_launches,
         "path": "bf16 MultiHeadAttention, d_k 128, served and trained",
         "launches_per_request": flash_launches / (FLASH_CALLS + FLASH_TRAIN_STEPS),
         **attn_timing["flash_attention", torch.bfloat16]},
        {"name": "headpacked_attention", "route": "cuda", "source": source,
         "replaces": "eyegaze_tpu/ops/attn_kernels.py:78",
         "launches": (art_bf16_all + bf16_train_launches + imported["k3_bf16"] + dp["k3_bf16"]
                      + tp["k3_bf16_train"] + tp["k3_bf16_serve"]),
         "path": "ART serving, bf16, and from a checkpoint; bf16 ART training at attention "
                 "dropout 0.0 (parity step, timed steps, one epoch), its forward; an imported "
                 "reference ART checkpoint served; " + dp_path + " (ART's steps); " + tp_path
                 + " (ART's tp2 steps and request, 4 heads a rank)",
         "launches_tensor_parallel": {
             "tp2_ranks_train": tp["k3_bf16_train"], "tp2_ranks_serve": tp["k3_bf16_serve"],
             "per_rank_per_step": tp["k3_bf16_train"] / (TP_WORLD * TP_STEPS),
             "per_rank_per_request": tp["k3_bf16_serve"] / TP_WORLD,
             "all_reduces_per_rank_per_step": tp["all_reduces_per_step"], **tp_steps_ms},
         "tensor_parallel_shape": tp_fwd,
         "launches_data_parallel": {"two_ranks": dp["k3_bf16"],
                                    "per_rank_per_step": dp["k3_bf16"] / (DP_WORLD * DP_STEPS),
                                    **dp_steps_ms},
         "launches_import": imported["k3_bf16"],
         "launches_per_request": art_bf16_all / (art_forwards + 1),
         "launches_serving": art_bf16_all, "launches_training": bf16_train_launches,
         "launches_per_train_step": bf16_k4["launches"] / TRAIN_STEPS,
         "train_step_ms": {"attn_dropout_0.1_plain": bf16_plain["median_ms"],
                           "attn_dropout_0.0_k3_k4bwd": bf16_k4["median_ms"]},
         "train_peak_gib": {"attn_dropout_0.1_plain": bf16_plain["peak_bytes"] / 2**30,
                            "attn_dropout_0.0_k3_k4bwd": bf16_k4["peak_bytes"] / 2**30},
         "train_kernels_per_step": {"attn_dropout_0.1_plain": bf16_plain["kernels_per_call"],
                                    "attn_dropout_0.0_k3_k4bwd": bf16_k4["kernels_per_call"]},
         **attn_timing["headpacked_attention", torch.bfloat16]},
    ]
    # ART's training shape (the one-pass kernel), K4's (the two kernels) and
    # d = 64 (the wgmma one-pass kernel).
    art_bwd, k4_bwd = bwd_cases[0], bwd_cases[1]
    d64_bwd = next(c for c in bwd_cases if c["path"] == "one_pass_wgmma")
    bwd_path = ("bf16 ART training at attention dropout 0.0 (the head-packed entry: parity "
                "step, timed steps, one epoch)")
    # The plain version and the library call compute the whole backward, as
    # does the one-pass kernel; each of the two kernels does a part of it.
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": source,
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "replaces_also": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "kernel": "attention_bwd_one_pass_kernel",
        "launches": one_pass_launches + dp["one_pass"] + tp["one_pass"],
        "path": bwd_path + "; " + dp_path + " (ART's steps); " + tp_path + " (ART's tp2 steps)",
        "launches_per_request": bf16_k4["kernel_launches"] / TRAIN_STEPS,
        "launches_per_train_step": bf16_k4["kernel_launches"] / TRAIN_STEPS,
        "backward_calls": bwd_calls + dp["bwd_calls"] + tp["bwd_calls"],
        "launches_data_parallel": {"two_ranks": dp["one_pass"],
                                   "per_rank_per_step": dp["one_pass"] / (DP_WORLD * DP_STEPS),
                                   **dp_steps_ms},
        "launches_tensor_parallel": {"tp2_ranks": tp["one_pass"],
                                     "per_rank_per_step": tp["one_pass"] / (TP_WORLD * TP_STEPS),
                                     **tp_steps_ms},
        "tensor_parallel_shape": {k: tp_bwd[k] for k in (
            "shape", "tk", "path", "errors", "ms", "ms_graph", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_ms_graph")},
        "max_abs_err": max(e["max_abs_err"] for e in art_bwd["errors"].values()),
        "share_of_bf16_bound": max(e["share_of_bound"] for e in art_bwd["errors"].values()),
        "ms": art_bwd["kernel_ms"]["attention_bwd_one_pass_kernel"],
        "bound_ms": art_bwd["bound_ms"], "bound_by": art_bwd["bound_by"],
        "plain_ms": art_bwd["plain_ms"], "library_ms": art_bwd["library_ms"],
        "library_call": "torch.ops.aten._scaled_dot_product_flash_attention_backward",
        "sass_per_score": bwd_mix, **{k: art_bwd[k] for k in (
            "ms_back_to_back", "ms_graph", "library_ms_back_to_back", "library_ms_graph",
            "sfu_ex2_ms", "fwd_bwd_ms", "library_fwd_bwd_ms", "stock_fwd_bwd_ms",
            "transit_gib")},
        "cases": [{k: c[k] for k in ("entry", "shape", "tk", "path", "errors", "ms", "ms_graph",
                                     "kernel_ms", "bound_ms", "library_ms", "library_ms_graph",
                                     "fwd_bwd_ms", "library_fwd_bwd_ms", "stock_fwd_bwd_ms",
                                     "transit_gib", "sdpa_relative_distance")}
                  for c in bwd_cases],
        "shape": art_bwd["shape"], "dtype": "bfloat16"})
    kernels.append({
        "name": "flash_attention_bwd_wgmma", "route": "cuda", "source": source,
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "replaces_also": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "kernel": "attention_bwd_one_pass_wgmma_kernel",
        "launches": headpacked64_route["backward_launches"],
        "path": "bf16 MultiHeadAttention, d_k 64 (the head-packed route's train steps)",
        "launches_per_request": headpacked64_route["backward_launches"] / FLASH_TRAIN_STEPS,
        "backward_calls": headpacked64_route["backward_calls"],
        "max_abs_err": max(e["max_abs_err"] for e in d64_bwd["errors"].values()),
        "share_of_bf16_bound": max(e["share_of_bound"] for e in d64_bwd["errors"].values()),
        "ms": d64_bwd["kernel_ms"]["attention_bwd_one_pass_wgmma_kernel"],
        "bound_ms": d64_bwd["bound_ms"], "bound_by": d64_bwd["bound_by"],
        "plain_ms": d64_bwd["plain_ms"], "library_ms": d64_bwd["library_ms"],
        "library_call": "torch.ops.aten._scaled_dot_product_flash_attention_backward",
        **{k: d64_bwd[k] for k in ("ms_graph", "library_ms_graph", "fwd_bwd_ms",
                                   "library_fwd_bwd_ms")},
        "shape": d64_bwd["shape"], "dtype": "bfloat16"})
    long_bwd = bwd_cases[-1]  # ART's shape with Tk past the one-pass kernel's reach
    two_kernel_launches = flash_route["backward_launches"] // 2  # each kernel's
    for name, kernel, line, errs, kernel_bound in (
            ("flash_attention_bwd_dkv", "attention_bwd_dkv_kernel", 941, ("dk", "dv"),
             k4_bwd["dkv_bound"]),
            ("flash_attention_bwd_dq", "attention_bwd_dq_kernel", 1287, ("dq",),
             k4_bwd["dq_bound"])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
            "kernel": kernel, "launches": two_kernel_launches,
            "path": "bf16 MultiHeadAttention, d_k 128 (the flash route's train steps)",
            "launches_per_request": two_kernel_launches / FLASH_TRAIN_STEPS,
            "backward_calls": flash_route["backward_calls"],
            "max_abs_err": max(k4_bwd["errors"][e]["max_abs_err"] for e in errs),
            "share_of_bf16_bound": max(k4_bwd["errors"][e]["share_of_bound"] for e in errs),
            "ms": k4_bwd["kernel_ms"][kernel], "bound_ms": kernel_bound[0],
            "bound_by": kernel_bound[1], "plain_ms": k4_bwd["plain_ms"],
            "library_ms": k4_bwd["library_ms"],
            "library_call": "torch.ops.aten._scaled_dot_product_flash_attention_backward",
            "pair": {k: k4_bwd[k] for k in ("ms", "ms_graph", "bound_ms", "library_ms_graph")},
            "past_reach": {k: long_bwd[k] for k in ("shape", "tk", "path", "errors", "kernel_ms",
                                                    "ms_graph", "bound_ms", "library_ms_graph")},
            "shape": k4_bwd["shape"], "dtype": "bfloat16"})
    for k in kernels:
        library = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        print(f"{k['name']} ({k['path']}) at {k['shape']}: {k['ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms (set by {k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library call {library}; "
              f"{k['launches_per_request']:g} launches per request of its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
