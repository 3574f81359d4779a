"""Serving: the DualEEGTransformer, the gaze ViTs, the ART denoiser, the
multimodal composite and HyperEEG on one device behind bucketed batching,
and the dynamic batcher that coalesces concurrent requests.

Port of ``eyegaze_tpu/serving.py::Predictor``, ``GazePredictor``,
``ArtDenoiser``, ``MultimodalPredictor``, ``HyperEEGPredictor`` and
``DynamicBatcher``.  Request batches are zero-padded up to the next bucket
size, so the device sees a fixed set of batch shapes; above the largest
bucket a request is chunked, and padding rows are stripped from the
outputs.  The model runs in ``eval()`` under ``torch.inference_mode()``.

``from_checkpoint`` rebuilds a served model from the reference-named
state_dict that ``scripts/export_torch_checkpoint.py`` writes from an orbax
checkpoint, plus that checkpoint's ``.meta.json`` copied beside it, and
serves it in bf16 compute, as the JAX ``from_checkpoint`` does.

``mesh=`` (JAX's ``_mesh_setup``): every predictor serves on a mesh of the
running group (``parallel.launch``; without a group it raises), ``"dp"``,
``"dpN"``, ``"tpN"`` or ``"dpN,tpM"``.  Every rank runs ``predict`` on the
same request: each dp rank takes its rows of the padded bucket, the tp
ranks of a data rank compute the shards of the Megatron layers
(``parallel/tensor.py``), and the outputs are gathered over dp on every
rank.  Buckets round up to multiples of dp.  ``MeshDispatch`` and
``follow_requests`` carry rank 0's requests to the other ranks (the HTTP
front end, ``serve --mesh``).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.data.image_fusion import (
    fuse_image_pair,
    imagenet_normalize,
    resize_bilinear,
    to_unit_float,
    vit_processor_normalize,
)
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.models.hypereeg import FIELDS as HYPEREEG_FIELDS
from eyegaze_tpu_torch.models.hypereeg import HyperEEGEncoder
from eyegaze_tpu_torch.models.multimodal import FIELDS as MULTIMODAL_FIELDS
from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
from eyegaze_tpu_torch.models.vit import EarlyFusionViT, LateFusionViT, VisionTransformer
from eyegaze_tpu_torch.ops.preprocess import common_average_reference, zscore
from eyegaze_tpu_torch.parallel import tensor

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
    or a dict of tensors with the batch on the leading axis; padding rows
    are stripped (key by key), and the chunks' results are concatenated as
    one numpy array (a dict of them, key by key).
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
        out = forward(*parts)
        if isinstance(out, dict):
            outs.append({k: v[:keep].cpu().numpy() for k, v in out.items()})
        else:
            outs.append(out[:keep].cpu().numpy())
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return np.concatenate(outs)


def _mesh_setup(model: torch.nn.Module, mesh, buckets: Sequence[int]) -> tuple:
    """The buckets of a predictor on ``mesh``, rounded up to multiples of
    dp, with ``model`` cut to the rank's tp shard in place (JAX's
    ``_mesh_setup``); raises without a running group."""
    dp, tp = parallel.join_mesh(mesh)
    if tp > 1:
        tensor.shard_tp_(model, parallel.tp_rank_and_world()[0], tp)
    return tuple(sorted({-(-int(b) // dp) * dp for b in buckets}))


def _dp_rows(forward):
    """``forward`` over this dp rank's rows of a bucket (whose rows divide
    over the dp ranks), its outputs (a tensor or a dict of them) gathered
    over dp on every rank."""

    def run(*parts):
        rank, world = parallel.data_rank_and_world()
        if world == 1:
            return forward(*parts)
        per = len(parts[0]) // world
        out = forward(*[p[rank * per:(rank + 1) * per] for p in parts])
        if isinstance(out, dict):
            return {k: parallel.gather_rows(v) for k, v in out.items()}
        return parallel.gather_rows(out)

    return run


class _Served:
    """What the predictors share: the model on its device in ``eval()``,
    the buckets and, with ``mesh``, the rank's shard and its rows."""

    def _place(self, model: torch.nn.Module, device, buckets: Sequence[int], mesh) -> None:
        self.device = torch.device(device)
        self.mesh = mesh or None
        if self.mesh:
            buckets = _mesh_setup(model, self.mesh, buckets)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(buckets))
        self._run = _dp_rows(self._forward) if self.mesh else self._forward


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


def dual_eeg_config(meta: dict, state, **fallback) -> dict:
    """``DualEEGTransformer``'s fields for a checkpoint: the geometry and
    ablation from the meta's ``model``, ``ablation`` and ``data`` sections
    with the JAX ``Predictor.from_checkpoint``'s keys and defaults,
    ``max_len`` from the rows of the state_dict's positional table.
    ``fallback`` replaces the default of ``in_channels``, ``num_classes``,
    ``d_model``, ``num_layers``, ``num_heads``, ``d_ff`` or
    ``sampling_rate`` where the meta lacks it (``analyze_eeg``'s flags)."""
    config = meta.get("config", {})
    mc, abl, dc = (config.get(k, {}) for k in ("model", "ablation", "data"))
    d = {"in_channels": 32, "num_classes": 3, "d_model": 256, "num_layers": 6, "num_heads": 8,
         "d_ff": 1024, "sampling_rate": 256.0, **fallback}
    return dict(
        in_channels=mc.get("in_channels", d["in_channels"]),
        num_classes=mc.get("num_labels", d["num_classes"]),
        d_model=mc.get("d_model", d["d_model"]),
        num_layers=mc.get("num_layers", d["num_layers"]),
        num_heads=mc.get("num_heads", d["num_heads"]),
        d_ff=mc.get("d_ff", d["d_ff"]),
        max_len=int(state["pos_embed.pos_embed.weight"].shape[0]),
        # The frontend and spectrogram geometry change no parameter shape: a
        # mismatch would load cleanly and predict garbage.
        conv_kernel_size=mc.get("conv_kernel_size", 25),
        conv_stride=mc.get("conv_stride", 4),
        conv_layers=mc.get("conv_layers", 2),
        spec_n_fft=mc.get("spec_n_fft", 128),
        spec_hop_length=mc.get("spec_hop_length", 64),
        spec_freq_bins=mc.get("spec_freq_bins", 64),
        sampling_rate=float(dc.get("sampling_rate", d["sampling_rate"])),
        use_spectrogram=abl.get("use_spectrogram", True),
        use_ibs=abl.get("use_ibs", True),
        use_robust_ibs=abl.get("ibs_mode", "robust") == "robust",
        use_cross_attention=abl.get("use_cross_attention", True),
        ibs_instance_norm=abl.get("ibs_instance_norm", True),
        ibs_feature_type=abl.get("ibs_feature_type", "all"),
    )


def gaze_model(state, meta: dict, dtype: torch.dtype) -> tuple[torch.nn.Module, str]:
    """(model, kind) of a gaze checkpoint, as ``GazePredictor.from_checkpoint``
    reads it (its docstring), weights drawn from seed 0 and not loaded."""
    mc = meta.get("config", {}).get("model", {})
    kind = mc.get("kind") or ("late" if "encoder.cls_token" in state
                              else "early" if "backbone.cls_token" in state else "datafusion")
    if kind not in ("early", "late", "datafusion"):
        raise ValueError(f"unsupported gaze model kind {kind!r} "
                         "(expected early, late or datafusion)")
    prefix = {"early": "backbone.", "late": "encoder.", "datafusion": ""}[kind]
    if f"{prefix}cls_token" not in state:
        raise ValueError(f"the state_dict does not match the meta's kind {kind!r}: no "
                         f"{prefix}cls_token")
    embed_dim = int(state[f"{prefix}cls_token"].shape[-1])
    depth = sum(1 for k in state if k.startswith(f"{prefix}blocks.")
                and k.endswith(".norm1.weight"))
    if depth == 0:
        raise ValueError(f"no ViT blocks under {prefix or 'the root'} in the state_dict")
    common = dict(num_classes=mc.get("num_labels", 3), img_size=mc.get("img_size", 224),
                  embed_dim=embed_dim, depth=depth,
                  num_heads=int(mc.get("vit_num_heads") or max(embed_dim // 64, 4)),
                  device=torch.device("cpu"), generator=torch.Generator().manual_seed(0),
                  dtype=dtype)
    if kind == "datafusion":
        return VisionTransformer(**common), kind
    cls_ = EarlyFusionViT if kind == "early" else LateFusionViT
    return cls_(fusion_mode=mc.get("fusion_mode", "concat"), **common), kind


class Predictor(_Served):
    """Bucketed predictor for the DualEEGTransformer family on one device,
    or on a mesh (module docstring)."""

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32, 128), preprocess: bool = True,
                 mesh=None):
        self.preprocess = preprocess
        self._place(model, device, batch_buckets, mesh)

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
        model = DualEEGTransformer(**dual_eeg_config(meta, state), device=torch.device("cpu"),
                                   generator=torch.Generator().manual_seed(0),
                                   dtype=torch.bfloat16)
        model.load_state_dict(state, strict=True)
        # Serving must preprocess as training did.
        data = meta.get("config", {}).get("data", {})
        kwargs.setdefault("preprocess", bool(data.get("enable_preprocessing", False)))
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
            self._run(z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, eeg1, eeg2) -> Dict[str, np.ndarray]:
        """(N, C, T) pairs, numpy or tensors of any float type, served as
        float32 -> {'logits', 'probs', 'preds', 'labels'} for any N (padded to
        the next bucket, chunked above the largest)."""
        logits = _predict_batched(self._run, self.buckets, eeg1, eeg2, device=self.device)
        return _logits_to_output(logits)


class GazePredictor(_Served):
    """Bucketed predictor for the gaze ViTs (early and late fusion, or a bare
    ViT on data-level fused pairs) on one device.

    Requests are raw (N, 3, H, W) uint8 image pairs, the converted
    datasets' format; ``to_unit_float`` and the normalization
    (``image_norm``: 'imagenet', or 'vit' for the HF processor's [-1, 1])
    run on the device inside the forward.  With ``data_fusion_mode`` the
    model is a bare ``VisionTransformer`` and the pair is fused in image
    space first (``fuse_image_pair``), a paste resized back to the model's
    ``img_size`` (antialiased bilinear).
    """

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32),
                 data_fusion_mode: Optional[str] = None, image_norm: str = "imagenet",
                 mesh=None):
        if image_norm not in ("imagenet", "vit"):
            raise ValueError(f"image_norm must be 'imagenet' or 'vit', got {image_norm!r}")
        self.data_fusion_mode = data_fusion_mode
        self._norm = imagenet_normalize if image_norm == "imagenet" else vit_processor_normalize
        self._place(model, device, batch_buckets, mesh)

    @classmethod
    def from_checkpoint(cls, state_path, *, device: torch.device, meta_path=None,
                        **kwargs) -> "GazePredictor":
        """The counterpart of the JAX ``GazePredictor.from_checkpoint``.  The
        kind is the meta's ``model.kind``, else the state_dict's layout:
        ``backbone.`` (early), ``encoder.`` (late), a root-level ViT
        (datafusion, ``python -m eyegaze_tpu_torch.train_gaze --model
        datafusion``); a meta whose kind the layout contradicts raises.
        ``embed_dim`` comes from the ``cls_token``, the depth from the number
        of blocks, the heads from ``model.vit_num_heads`` (else
        max(embed_dim // 64, 4)), ``fusion_mode``, ``num_labels`` and
        ``img_size`` from the meta (JAX's defaults); a datafusion model's
        ``data_fusion_mode`` and ``image_norm`` default to the meta's (else
        'horizontal' and 'imagenet').  bf16 compute, the state_dict loaded
        with ``strict=True``.  ``load_checkpoint`` says what the paths hold."""
        state, meta = load_checkpoint(state_path, meta_path)
        model, kind = gaze_model(state, meta, torch.bfloat16)
        if kind == "datafusion":
            # The fused pair's preprocessing is part of the model: replay the
            # trainer's (docs/PARITY.md, "datafusion normalization").
            mc = meta.get("config", {}).get("model", {})
            kwargs.setdefault("data_fusion_mode", mc.get("data_fusion_mode", "horizontal"))
            kwargs.setdefault("image_norm", mc.get("image_norm", "imagenet"))
        model.load_state_dict(state, strict=True)
        return cls(model, device=device, **kwargs)

    @torch.inference_mode()
    def _forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        if self.data_fusion_mode is None:
            return self.model(self._norm(to_unit_float(img1)), self._norm(to_unit_float(img2)))
        fused = fuse_image_pair(to_unit_float(img1), to_unit_float(img2), self.data_fusion_mode)
        size = self.model.img_size
        if fused.shape[-2:] != (size, size):  # the paste modes change H or W
            fused = resize_bilinear(fused, size, size)
        return self.model(self._norm(fused))

    def warmup(self) -> None:
        """Run every bucket once on black images of the model's size."""
        s = self.model.img_size
        for b in self.buckets:
            z = torch.zeros((b, 3, s, s), dtype=torch.uint8, device=self.device)
            self._run(z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, img1, img2) -> Dict[str, np.ndarray]:
        """(N, 3, H, W) uint8 pairs (or float images in [0, 1]), numpy or
        tensors -> {'logits', 'probs', 'preds', 'labels'} for any N."""
        logits = _predict_batched(self._run, self.buckets, img1, img2, device=self.device)
        return _logits_to_output(logits)


class ArtDenoiser(_Served):
    """Bucketed denoiser for the ART seq2seq model on one device.

    Serving is label-free: the decoder is fed the noisy signal itself (the
    model's ``tgt = src`` default).  A model whose Reconstructor z-scores over
    the batch (``recon_zscore='batch'``) would give every sample an output
    that depends on the request's other rows and on the zero padding, so it
    is always served one sample at a time: its buckets are ``(1,)`` whatever
    the caller passes.  The model may compute in float32 or bf16
    (``ArtifactRemovalTransformer(dtype=...)``; the JAX ``from_checkpoint``
    serves bf16): requests come in and go out as float32 either way.  Such a
    model serves on a tp-only mesh and refuses dp > 1, whose rounding of the
    buckets would bring the padding back.
    """

    def __init__(self, model: torch.nn.Module, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32), mesh=None):
        if model.config.recon_zscore == "batch":
            batch_buckets = (1,)
            if mesh and parallel.parse_mesh_spec(mesh, parallel.rank_and_world()[1])[0] > 1:
                raise ValueError(
                    "recon_zscore='batch' checkpoints serve per-sample; a "
                    "data-parallel mesh requires batch padding, which would "
                    "corrupt the batch-axis z-score. Use tp-only ('dp1,tpM') "
                    "or no mesh.")
        self._place(model, device, batch_buckets, mesh)

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
            self._run(torch.zeros((b, c, t), dtype=torch.float32, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, noisy) -> Dict[str, np.ndarray]:
        """(N, C, T) noisy EEG, numpy or a tensor -> {'denoised': (N, C_out, T) f32}."""
        return {"denoised": _predict_batched(self._run, self.buckets, noisy,
                                             device=self.device)}


class MultimodalPredictor(_Served):
    """Bucketed predictor for the multimodal fuzzy-gating composite on one
    device.

    Requests are (N, 3, S, S) uint8 image pairs and (N, C, T) float32 EEG
    windows.  ``to_unit_float`` and the ImageNet normalization run on the
    device; the EEG goes to the model as it comes (the composite's forward
    has no CAR or z-score, unlike the flagship ``Predictor``).  The answer
    holds the fused prediction, each modality's logits and the gate's
    ``alpha``, so a client sees which modality the gate trusted per sample.
    """

    def __init__(self, model: MultimodalFusionModel, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32), mesh=None):
        self._place(model, device, batch_buckets, mesh)

    @classmethod
    def from_checkpoint(cls, state_path, *, device: torch.device, meta_path=None,
                        **kwargs) -> "MultimodalPredictor":
        """The counterpart of the JAX ``MultimodalPredictor.from_checkpoint``
        on the reference-named state_dict that ``scripts/export_torch_
        checkpoint.py --kind multimodal`` writes.  The constructor's fields
        come from the meta's ``model.multimodal`` stamp; without it they are
        inferred as JAX infers them: the ViT's width and depth from the gaze
        encoder's ``cls_token`` and blocks, the EEG encoder's ``max_len`` and
        ``d_model`` from its positional table, its layers and ``d_ff`` from
        its encoder, the ablation flags from which submodules are there, the
        head counts from ``model.vit_num_heads`` and ``model.num_heads``
        (else max(width // 64, 4) and max(d_model // 32, 4)), the rest from
        the meta's ``model`` fields and JAX's defaults.  bf16 compute, the
        state_dict loaded with ``strict=True``.  ``load_checkpoint`` says
        what the paths hold."""
        state, meta = load_checkpoint(state_path, meta_path)
        mc = meta.get("config", {}).get("model", {})
        if mc.get("multimodal"):
            kw = {k: v for k, v in mc["multimodal"].items() if k in MULTIMODAL_FIELDS}
        else:
            if "gaze_encoder.backbone.cls_token" not in state:
                raise ValueError("not a multimodal state_dict: no gaze_encoder.backbone.cls_token")
            vit_embed = int(state["gaze_encoder.backbone.cls_token"].shape[-1])
            pos = state["eeg_encoder.pos_embed.pos_embed.weight"]
            d_model = int(pos.shape[-1])

            def count(prefix: str, suffix: str) -> int:
                return sum(1 for k in state if k.startswith(prefix) and k.endswith(suffix))

            def has(prefix: str) -> bool:
                return any(k.startswith(prefix) for k in state)

            kw = dict(
                num_classes=mc.get("num_labels", 3),
                img_size=mc.get("img_size", 224),
                gaze_fusion_mode=mc.get("fusion_mode", "concat"),
                fuzzy_mode=mc.get("fuzzy_mode", "full"),
                vit_embed_dim=vit_embed,
                vit_depth=count("gaze_encoder.backbone.blocks.", ".norm1.weight"),
                vit_num_heads=int(mc.get("vit_num_heads") or max(vit_embed // 64, 4)),
                eeg_in_channels=mc.get("in_channels", 32),
                eeg_d_model=d_model,
                eeg_num_layers=count("eeg_encoder.encoder.layers.", ".ln1.weight"),
                eeg_num_heads=int(mc.get("num_heads") or max(d_model // 32, 4)),
                eeg_d_ff=int(state["eeg_encoder.encoder.layers.0.ffn.linear1.weight"].shape[0]),
                eeg_max_len=int(pos.shape[0]),
                use_spectrogram=has("eeg_encoder.spectrogram_generator."),
                use_ibs=has("eeg_encoder.ibs_generator.") or has("eeg_encoder.ibs_tokenizer."),
                use_robust_ibs=has("eeg_encoder.ibs_tokenizer."),
                use_cross_attention=has("eeg_encoder.cross_attn."),
            )
        model = MultimodalFusionModel(**kw, device=torch.device("cpu"),
                                      generator=torch.Generator().manual_seed(0),
                                      dtype=torch.bfloat16)
        model.load_state_dict(state, strict=True)
        return cls(model, device=device, **kwargs)

    @torch.inference_mode()
    def _forward(self, img1, img2, eeg1, eeg2) -> Dict[str, torch.Tensor]:
        out = self.model(imagenet_normalize(to_unit_float(img1)),
                         imagenet_normalize(to_unit_float(img2)), eeg1.float(), eeg2.float())
        # The batch-leading outputs: aux_info's gate internals and the scalar
        # temp_reg are no rows of an answer.
        return {k: out[k] for k in ("logits", "img_logits", "eeg_logits", "alpha")}

    def warmup(self) -> None:
        """Run every bucket once on black images and zero EEG windows of T =
        min(1024, 4 eeg_max_len), which the positional table covers."""
        m = self.model
        t = min(1024, 4 * m.eeg_max_len)
        for b in self.buckets:
            zi = torch.zeros((b, 3, m.img_size, m.img_size), dtype=torch.uint8,
                             device=self.device)
            ze = torch.zeros((b, m.eeg_in_channels, t), dtype=torch.float32, device=self.device)
            self._run(zi, zi, ze, ze)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, img1, img2, eeg1, eeg2) -> Dict[str, object]:
        """uint8 (N, 3, S, S) pairs and float (N, C, T) pairs, numpy or
        tensors -> {'logits', 'probs', 'preds', 'labels', 'img_logits',
        'eeg_logits', 'alpha'} for any N."""
        out = _predict_batched(self._run, self.buckets, img1, img2, eeg1, eeg2,
                               device=self.device)
        result = _logits_to_output(out["logits"])
        result.update(img_logits=out["img_logits"], eeg_logits=out["eeg_logits"],
                      alpha=out["alpha"])
        return result


class HyperEEGPredictor(_Served):
    """Bucketed predictor for HyperEEG on one device: (N, C, T) windowed EEG
    pairs in, logits out (``python -m eyegaze_tpu_torch.serve --kind
    hypereeg``).  The windows go to the model as they come: HyperEEG's
    forward has no CAR or z-score."""

    def __init__(self, model: HyperEEGEncoder, *, device: torch.device,
                 batch_buckets: Sequence[int] = (1, 8, 32), mesh=None):
        self._place(model, device, batch_buckets, mesh)

    @classmethod
    def from_checkpoint(cls, state_path, *, device: torch.device, meta_path=None,
                        **kwargs) -> "HyperEEGPredictor":
        """The counterpart of the JAX ``HyperEEGPredictor.from_checkpoint`` on
        a port checkpoint (``python -m eyegaze_tpu_torch.train_hypereeg``'s
        ``best_model.pt``).  The constructor's fields come from the meta's
        ``model.hypereeg`` stamp; without it they are inferred as JAX infers
        them: ``embed_dim`` from ``cls1``'s input width, ``num_classes`` from
        ``cls2``'s rows, ``use_graph``, ``use_cross_attn`` and
        ``use_uncertainty`` from whether the submodule is there, ``use_sinc``
        from whether ``temporal.sinc.low_hz`` is, the rest at their defaults.
        bf16 compute, the state_dict loaded with ``strict=True``.
        ``load_checkpoint`` says what the paths hold."""
        state, meta = load_checkpoint(state_path, meta_path)
        mc = meta.get("config", {}).get("model", {})
        if mc.get("hypereeg"):
            kw = {k: v for k, v in mc["hypereeg"].items() if k in HYPEREEG_FIELDS}
        else:
            if "cls1.weight" not in state or "temporal.proj.weight" not in state:
                raise ValueError("not a hypereeg state_dict: no cls1.weight or "
                                 "temporal.proj.weight")

            def has(prefix: str) -> bool:
                return any(k.startswith(prefix) for k in state)

            kw = dict(embed_dim=int(state["cls1.weight"].shape[1]),
                      num_classes=int(state["cls2.weight"].shape[0]),
                      use_graph=has("graph."), use_cross_attn=has("cross."),
                      use_uncertainty=has("fusion."), use_sinc="temporal.sinc.low_hz" in state)
        model = HyperEEGEncoder(**kw, device=torch.device("cpu"),
                                generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
        model.load_state_dict(state, strict=True)
        return cls(model, device=device, **kwargs)

    @torch.inference_mode()
    def _forward(self, eeg1: torch.Tensor, eeg2: torch.Tensor) -> torch.Tensor:
        return self.model(eeg1.float(), eeg2.float())["logits"]

    def warmup(self, c: int | None = None, t: int = 1024) -> None:
        """Run every bucket once on zero (N, c, t) windows, ``c`` the
        model's ``in_channels`` by default."""
        c = c or self.model.in_channels
        for b in self.buckets:
            z = torch.zeros((b, c, t), dtype=torch.float32, device=self.device)
            self._run(z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, eeg1, eeg2) -> Dict[str, np.ndarray]:
        """(N, C, T) windowed pairs, numpy or tensors -> {'logits', 'probs',
        'preds', 'labels'} for any N."""
        logits = _predict_batched(self._run, self.buckets, eeg1, eeg2, device=self.device)
        return _logits_to_output(logits)


# A follower waits for the next request for as long as the server runs.
_REQUEST_TIMEOUT = datetime.timedelta(days=365)


def request_group() -> dist.ProcessGroup:
    """The gloo group that carries rank 0's requests to the other ranks of a
    served mesh (``MeshDispatch``, ``follow_requests``), with a timeout
    that outlasts an idle server.  Collective: every rank calls it, before
    serving."""
    return dist.new_group(backend="gloo", timeout=_REQUEST_TIMEOUT)


def _send(arrays, group) -> None:
    header = None if arrays is None else [(a.shape, a.dtype.str) for a in arrays]
    dist.broadcast_object_list([header], src=0, group=group)
    for a in arrays or ():
        dist.broadcast(torch.from_numpy(np.ascontiguousarray(a)), src=0, group=group)


def _receive(group):
    box = [None]
    dist.broadcast_object_list(box, src=0, group=group)
    if box[0] is None:
        return None
    arrays = []
    for shape, dtype in box[0]:
        t = torch.from_numpy(np.empty(shape, np.dtype(dtype)))
        dist.broadcast(t, src=0, group=group)
        arrays.append(t.numpy())
    return arrays


class MeshDispatch:
    """Rank 0's side of a predictor served on a mesh: ``predict`` sends the
    request to every rank (a header of shapes and dtypes, then the arrays,
    over ``request_group``'s group) and then runs it, as every other rank
    does in ``follow_requests``; ``close`` sends the stop header.  The rest
    is the predictor's."""

    def __init__(self, predictor, group: dist.ProcessGroup):
        self.predictor, self.group = predictor, group

    def __getattr__(self, name):
        return getattr(self.predictor, name)

    def predict(self, *arrays):
        arrays = [np.asarray(a) for a in arrays]
        _send(arrays, self.group)
        return self.predictor.predict(*arrays)

    def close(self) -> None:
        _send(None, self.group)


def follow_requests(predictor, group: dist.ProcessGroup) -> int:
    """A rank but 0 of a served mesh: runs ``predictor.predict`` on every
    request rank 0 sends until its stop header; returns the number of
    requests.  A request that fails here fails on rank 0 too, which answers
    it with an error; the loop goes on."""
    n = 0
    while (arrays := _receive(group)) is not None:
        n += 1
        try:
            predictor.predict(*arrays)
        except Exception as e:  # noqa: BLE001 — rank 0 answers the same request with its error
            print(f"[serve] rank {parallel.rank_and_world()[0]}: request failed: {e}", flush=True)
    return n


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
    """Cross-request micro-batching over any predictor of this module.

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
