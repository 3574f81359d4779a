"""Serving: the DualEEGTransformer and the ART denoiser on one device behind
bucketed batching, and the dynamic batcher that coalesces concurrent
requests.

Port of ``eyegaze_tpu/serving.py::Predictor``, ``ArtDenoiser`` and
``DynamicBatcher``.  Request batches are zero-padded up to the next bucket
size, so the device sees a fixed set of batch shapes; above the largest
bucket a request is chunked, and padding rows are stripped from the
outputs.  The model runs in ``eval()`` under ``torch.inference_mode()``.

``from_checkpoint`` rebuilds a served model from the reference-named
state_dict that ``scripts/export_torch_checkpoint.py`` writes from an orbax
checkpoint, plus that checkpoint's ``.meta.json`` copied beside it, and
serves it in bf16 compute, as the JAX ``from_checkpoint`` does.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.ops.preprocess import common_average_reference, zscore

CLASS_NAMES = ("Single", "Competition", "Cooperation")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _predict_batched(forward, buckets: Sequence[int], *arrays, device: torch.device):
    """Run ``forward(*batches)`` over zero-padded bucket batches.

    ``arrays`` are numpy arrays or tensors with the batch on the leading
    axis; each chunk goes to ``device`` once.  ``forward`` returns a tensor
    whose padding rows are stripped; the chunks' results are concatenated
    as one numpy array.
    """
    n = len(arrays[0])
    max_b = buckets[-1]
    outs = []
    for start in range(0, n, max_b):
        parts = [torch.as_tensor(a[start:start + max_b], device=device) for a in arrays]
        keep = len(parts[0])
        pad = _bucket(keep, buckets) - keep
        if pad:
            parts = [torch.cat([p, p.new_zeros((pad,) + p.shape[1:])]) for p in parts]
        outs.append(forward(*parts)[:keep].cpu().numpy())
    return np.concatenate(outs)


def read_meta(state_path, meta_path=None) -> dict:
    """The meta of a served checkpoint: ``meta_path``, by default
    ``state_path`` with the suffix ``.meta.json``, where the user copies the
    orbax checkpoint's sibling meta; a missing meta reads as ``{}``, as in
    the JAX package."""
    path = Path(meta_path) if meta_path is not None else Path(state_path).with_suffix(".meta.json")
    return json.loads(path.read_text()) if path.exists() else {}


def load_checkpoint(state_path, meta_path=None) -> tuple[dict, dict]:
    """(state_dict, meta) of a served checkpoint.  ``state_path`` is a
    reference-named state_dict saved with ``torch.save``
    (``scripts/export_torch_checkpoint.py``'s output), read with
    ``weights_only=True`` onto the CPU; ``read_meta`` reads the meta."""
    state = torch.load(state_path, map_location="cpu", weights_only=True)
    return state, read_meta(state_path, meta_path)


class Predictor:
    """Bucketed predictor for the DualEEGTransformer family on one device."""

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32, 128), preprocess: bool = True):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(batch_buckets))
        self.preprocess = preprocess

    @classmethod
    def from_checkpoint(cls, state_path, *, device: torch.device, meta_path=None,
                        **kwargs) -> "Predictor":
        """The counterpart of the JAX ``Predictor.from_checkpoint``: the model
        rebuilt from the meta's geometry and ablation fields (JAX's keys and
        defaults), ``max_len`` from the rows of the positional table, bf16
        compute, the state_dict loaded with ``strict=True``; ``preprocess``
        defaults to the meta's ``data.enable_preprocessing`` (False when
        absent).  ``load_checkpoint`` says what the paths hold."""
        state, meta = load_checkpoint(state_path, meta_path)
        config = meta.get("config", {})
        mc, abl, dc = (config.get(k, {}) for k in ("model", "ablation", "data"))
        model = DualEEGTransformer(
            in_channels=mc.get("in_channels", 32),
            num_classes=mc.get("num_labels", 3),
            d_model=mc.get("d_model", 256),
            num_layers=mc.get("num_layers", 6),
            num_heads=mc.get("num_heads", 8),
            d_ff=mc.get("d_ff", 1024),
            max_len=int(state["pos_embed.pos_embed.weight"].shape[0]),
            # The frontend and spectrogram geometry change no parameter
            # shape: a mismatch would load cleanly and predict garbage.
            conv_kernel_size=mc.get("conv_kernel_size", 25),
            conv_stride=mc.get("conv_stride", 4),
            conv_layers=mc.get("conv_layers", 2),
            spec_n_fft=mc.get("spec_n_fft", 128),
            spec_hop_length=mc.get("spec_hop_length", 64),
            spec_freq_bins=mc.get("spec_freq_bins", 64),
            sampling_rate=float(dc.get("sampling_rate", 256.0)),
            use_spectrogram=abl.get("use_spectrogram", True),
            use_ibs=abl.get("use_ibs", True),
            use_robust_ibs=abl.get("ibs_mode", "robust") == "robust",
            use_cross_attention=abl.get("use_cross_attention", True),
            ibs_instance_norm=abl.get("ibs_instance_norm", True),
            ibs_feature_type=abl.get("ibs_feature_type", "all"),
            device=torch.device("cpu"), generator=torch.Generator().manual_seed(0),
            dtype=torch.bfloat16,
        )
        model.load_state_dict(state, strict=True)
        # Serving must preprocess as training did.
        kwargs.setdefault("preprocess", bool(dc.get("enable_preprocessing", False)))
        return cls(model, device=device, **kwargs)

    @torch.inference_mode()
    def _forward(self, eeg1: torch.Tensor, eeg2: torch.Tensor) -> torch.Tensor:
        # float32 whatever the request's type, as the JAX Predictor places it.
        eeg1, eeg2 = eeg1.float(), eeg2.float()
        if self.preprocess:
            eeg1 = zscore(common_average_reference(eeg1))
            eeg2 = zscore(common_average_reference(eeg2))
        return self.model(eeg1, eeg2)["logits"]

    def warmup(self, c: int | None = None, t: int = 1024) -> None:
        """Run every bucket once on zeros before serving; ``c`` defaults to
        the model's channel count."""
        c = c or self.model.in_channels
        for b in self.buckets:
            z = torch.zeros((b, c, t), dtype=torch.float32, device=self.device)
            self._forward(z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, eeg1, eeg2) -> Dict[str, np.ndarray]:
        """(N, C, T) pairs, numpy or tensors of any float type, served as
        float32 -> {'logits', 'probs', 'preds', 'labels'} for any N (padded to
        the next bucket, chunked above the largest)."""
        logits = _predict_batched(self._forward, self.buckets, eeg1, eeg2,
                                  device=self.device)
        return _logits_to_output(logits)


class ArtDenoiser:
    """Bucketed denoiser for the ART seq2seq model on one device.

    Serving is label-free: the decoder is fed the noisy signal itself (the
    model's ``tgt = src`` default).  A model whose Reconstructor z-scores over
    the batch (``recon_zscore='batch'``) would give every sample an output
    that depends on the request's other rows and on the zero padding, so it
    is always served one sample at a time: its buckets are ``(1,)`` whatever
    the caller passes.  The model may compute in float32 or bf16
    (``ArtifactRemovalTransformer(dtype=...)``; the JAX ``from_checkpoint``
    serves bf16): requests come in and go out as float32 either way.
    """

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32)):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        if model.config.recon_zscore == "batch":
            batch_buckets = (1,)
        self.buckets = tuple(sorted(batch_buckets))

    @classmethod
    def from_checkpoint(cls, state_path, *, device: torch.device, meta_path=None,
                        **kwargs) -> "ArtDenoiser":
        """The counterpart of the JAX ``ArtDenoiser.from_checkpoint``:
        ``ArtConfig`` from the meta's ``model`` fields that it has, bf16
        compute, the state_dict loaded with ``strict=True``.  A
        ``recon_zscore='batch'`` model is served per sample whatever
        ``batch_buckets`` says (``__init__``).  ``load_checkpoint`` says what
        the paths hold."""
        state, meta = load_checkpoint(state_path, meta_path)
        mc = meta.get("config", {}).get("model", {})
        fields = {f.name for f in dataclasses.fields(ArtConfig)}
        model = ArtifactRemovalTransformer(
            ArtConfig(**{k: v for k, v in mc.items() if k in fields}),
            device=torch.device("cpu"), generator=torch.Generator().manual_seed(0),
            dtype=torch.bfloat16)
        model.load_state_dict(state, strict=True)
        return cls(model, device=device, **kwargs)

    @torch.inference_mode()
    def _forward(self, noisy: torch.Tensor) -> torch.Tensor:
        return self.model(noisy.float())

    def warmup(self, c: int | None = None, t: int | None = None) -> None:
        """Run every bucket once on zeros; ``t`` defaults to the 1024-sample
        window, capped at the positional table's ``max_len``."""
        cfg = self.model.config
        c = c or cfg.in_channels
        t = t or min(1024, cfg.max_len)
        for b in self.buckets:
            self._forward(torch.zeros((b, c, t), dtype=torch.float32, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, noisy) -> Dict[str, np.ndarray]:
        """(N, C, T) noisy EEG, numpy or a tensor -> {'denoised': (N, C_out, T) f32}."""
        return {"denoised": _predict_batched(self._forward, self.buckets, noisy,
                                             device=self.device)}


def _logits_to_output(logits: np.ndarray) -> Dict[str, np.ndarray]:
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    preds = logits.argmax(axis=-1)
    # The canonical 3 classes get their reference names; other class counts
    # get generic names rather than an out-of-range index.
    names = (CLASS_NAMES if logits.shape[-1] == len(CLASS_NAMES)
             else tuple(f"class_{i}" for i in range(logits.shape[-1])))
    return {
        "logits": logits,
        "probs": probs,
        "preds": preds,
        "labels": [names[int(p)] for p in preds],
    }


def _rows(out, off: int, n: int):
    """Rows ``off:off + n`` of a predictor's output: a dict is sliced value by
    value, and an array or a list (``labels``) along its first axis."""
    if isinstance(out, dict):
        return {k: _rows(v, off, n) for k, v in out.items()}
    if isinstance(out, (np.ndarray, list)):
        return out[off:off + n]
    raise TypeError(f"cannot split a predictor output of type {type(out).__name__} by rows")


class DynamicBatcher:
    """Cross-request micro-batching over ``Predictor`` or ``ArtDenoiser``.

    The counterpart of the JAX package's ``DynamicBatcher``: concurrent
    ``predict`` callers (the HTTP threads of ``eyegaze_tpu_torch.serve``)
    enqueue their arrays and block, while one dispatcher thread drains the
    queue, concatenates compatible requests along the batch axis, runs one
    bucketed ``predict`` and hands each caller its own rows.

    - Only requests whose non-batch shapes and dtypes match are coalesced;
      the others dispatch in the same drain, apart.
    - If a coalesced dispatch fails, each member is retried alone, so an
      error reaches only the request that causes it.
    - A caller waits at most ``max_wait_ms`` for co-travellers, and a drain
      takes at most ``max_batch`` rows (default: the predictor's largest
      bucket).
    - A ``recon_zscore='batch'`` ART model stays sound: ``ArtDenoiser``
      serves it with bucket 1, so a coalesced batch still runs sample by
      sample.

    ``stats`` counts requests and dispatches; each dispatch, a failed
    coalesced one included, records its rows in ``dispatch_rows`` (so
    ``dispatches == len(dispatch_rows)`` below the cap of the lists), and
    each request its queue wait (enqueue to the start of its first dispatch)
    and execution (from there until its result is ready, a failed coalesced
    attempt included).  The predictor must not be called from elsewhere
    while the batcher runs: its thread is the device's one caller.
    """

    def __init__(self, predictor, max_wait_ms: float = 5.0, max_batch: Optional[int] = None):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1e3
        self.max_batch = int(max_batch or max(predictor.buckets))
        self.stats = {"requests": 0, "dispatches": 0, "max_coalesced": 0,
                      "queue_wait_ms": [], "exec_ms": [], "dispatch_rows": []}
        self._stats_cap = 100_000  # a bound on the lists of a long-lived server
        self._q: queue.Queue = queue.Queue()
        self._stop = object()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="dynamic-batcher")
        self._thread.start()

    # -- caller side ------------------------------------------------------
    def predict(self, *arrays) -> Dict[str, object]:
        item = {"arrays": [np.asarray(a) for a in arrays], "event": threading.Event(),
                "out": None, "error": None, "t_enq": time.monotonic()}
        self._q.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["out"]

    def close(self) -> None:
        self._q.put(self._stop)
        self._thread.join(timeout=5)

    def public_stats(self) -> Dict[str, object]:
        """The scalar counters and the phase percentiles: what an HTTP
        endpoint sends, without the raw per-request lists."""
        out = {k: v for k, v in self.stats.items() if not isinstance(v, list)}
        out["phase_breakdown"] = self.phase_summary()
        return out

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """p50, p99 and max of each request phase: queue wait (behind an
        in-flight dispatch) and execution (the dispatch itself)."""
        out: Dict[str, Dict[str, float]] = {}
        for k in ("queue_wait_ms", "exec_ms"):
            if self.stats[k]:
                a = np.asarray(self.stats[k])
                out[k] = {"p50": round(float(np.percentile(a, 50)), 2),
                          "p99": round(float(np.percentile(a, 99)), 2),
                          "max": round(float(a.max()), 2)}
        return out

    # -- dispatcher side --------------------------------------------------
    def _drain(self, first) -> list:
        """Requests collected for up to ``max_wait`` seconds or ``max_batch`` rows."""
        batch = [first]
        rows = len(first["arrays"][0])
        deadline = time.monotonic() + self.max_wait
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is self._stop:
                self._q.put(item)  # the loop ends after this drain
                break
            batch.append(item)
            rows += len(item["arrays"][0])
        return batch

    @staticmethod
    def _shape_key(arrays) -> tuple:
        return tuple((a.shape[1:], a.dtype.str) for a in arrays)

    def _count_dispatch(self, group) -> None:
        self.stats["dispatches"] += 1
        self.stats["max_coalesced"] = max(self.stats["max_coalesced"], len(group))
        if len(self.stats["dispatch_rows"]) < self._stats_cap:
            self.stats["dispatch_rows"].append(sum(len(g["arrays"][0]) for g in group))

    def _finish(self, g, t_start: float, out=None, error=None) -> None:
        """Records the request's phases and hands it its result."""
        if len(self.stats["queue_wait_ms"]) < self._stats_cap:
            self.stats["queue_wait_ms"].append((t_start - g["t_enq"]) * 1e3)
            self.stats["exec_ms"].append((time.monotonic() - t_start) * 1e3)
        g["out"], g["error"] = out, error
        g["event"].set()

    def _run_one(self, g, t_start: float) -> None:
        self._count_dispatch([g])
        try:
            out = self.predictor.predict(*g["arrays"])
        except Exception as e:  # noqa: BLE001 — delivered to the caller
            self._finish(g, t_start, error=e)
        else:
            self._finish(g, t_start, out=out)

    def _dispatch(self, group: list) -> None:
        t_start = time.monotonic()
        if len(group) == 1:
            self._run_one(group[0], t_start)
            return
        self._count_dispatch(group)
        joined = [np.concatenate([g["arrays"][i] for g in group])
                  for i in range(len(group[0]["arrays"]))]
        try:
            out = self.predictor.predict(*joined)
        except Exception:  # noqa: BLE001 — each member is retried alone below
            for g in group:
                self._run_one(g, t_start)
            return
        off = 0
        for g in group:
            n = len(g["arrays"][0])
            self._finish(g, t_start, out=_rows(out, off, n))
            off += n

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is self._stop:
                return
            batch = self._drain(item)
            self.stats["requests"] += len(batch)
            groups: Dict[tuple, list] = {}
            for g in batch:
                groups.setdefault(self._shape_key(g["arrays"]), []).append(g)
            for group in groups.values():
                self._dispatch(group)
