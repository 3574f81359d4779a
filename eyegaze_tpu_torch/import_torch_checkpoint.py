"""Import a reference PyTorch checkpoint for the port to serve and analyse.

    python -m eyegaze_tpu_torch.import_torch_checkpoint CKPT --out DIR

The counterpart of the JAX package's ``scripts/import_torch_checkpoint.py``,
with its flags and defaults.  A user arriving from the reference repo has a
``.pt`` that its training loop wrote: a bare state_dict, or one under
``state_dict``, ``model_state_dict`` or ``model``, maybe with DataParallel's
``module.`` prefix.  The port's models already use the reference's parameter
names, so the import unwraps the file, drops the reference's buffers that
carry no learned state (``BUFFER_SUFFIXES`` and the composite's
``fusion.c_reliable``), reads the geometry off the tensor shapes (what the
shapes cannot give comes from the flags), and checks the result against the
port's model: a key the model lacks, or a key of the model the file lacks,
raises and names it.  It writes ``DIR/best_model.pt`` (a bare float32
state_dict) and ``DIR/best_model.meta.json`` (``{"config": ...,
"imported_from": ...}``, the JAX importer's config), which every
``from_checkpoint``, ``python -m eyegaze_tpu_torch.serve`` and
``python -m eyegaze_tpu_torch.analyze_eeg`` read.

Kinds (sniffed from the keys unless ``--kind``): ``dual_eeg``, ``art``,
``multimodal``, ``gaze_early`` and ``gaze_late``.  The import runs on the
host: it reads and writes files and computes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

from eyegaze_tpu_torch import serving
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel

# The reference's buffers that carry no learned state (the JAX package's
# ``models/torch_port.py`` skips the same): sinusoidal tables, the STFT
# window, batch-norm statistics.
BUFFER_SUFFIXES = (".pe", ".window", ".num_batches_tracked", ".running_mean", ".running_var")
COMPOSITE_BUFFERS = ("fusion.c_reliable",)  # a constant 0.0 in the reference's gate
WRAPPERS = ("state_dict", "model_state_dict", "model")
KINDS = ("dual_eeg", "art", "gaze_early", "gaze_late", "multimodal")


def load_state_dict(path: Path) -> dict[str, torch.Tensor]:
    """The file's state_dict on the CPU: unwrapped from the first of
    ``WRAPPERS`` that holds a dict, ``module.`` prefixes stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in WRAPPERS:
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise SystemExit(f"{path}: not a state_dict (got {type(obj).__name__})")
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return out


def sniff_kind(state: dict) -> str:
    keys = state.keys()
    if any(k.startswith("gaze_encoder.") for k in keys):
        return "multimodal"  # the composite wraps eeg_encoder.temporal_conv.*
    if any(k.startswith("temporal_conv.") for k in keys):
        return "dual_eeg"
    if any(k.startswith("reconstructor.") for k in keys):
        return "art"
    if any(k.startswith("backbone.") for k in keys):
        return "gaze_early"
    if any(k.startswith("encoder.patch_embed") for k in keys):
        return "gaze_late"
    raise SystemExit("cannot sniff the model kind from the state_dict keys; pass --kind")


def is_buffer(key: str, kind: str) -> bool:
    return key.endswith(BUFFER_SUFFIXES) or (kind == "multimodal" and key in COMPOSITE_BUFFERS)


def _count(state: dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in state:
        n += 1
    return n


def _shape(state: dict, key: str, axis: int) -> int:
    return int(state[key].shape[axis])


def import_dual_eeg(state: dict, args) -> tuple[torch.nn.Module, dict]:
    conv0 = state["temporal_conv.convs.0.weight"]  # (d, C, k)
    use_robust = "ibs_tokenizer.type_embedding" in state
    use_scalar = "ibs_generator.proj.0.weight" in state
    ftype = "all"
    if use_robust:
        ntok = _shape(state, "ibs_tokenizer.type_embedding", 1)
        ftype = {42: "all", 24: "phase", 18: "amplitude"}[ntok]
    config = {
        "model": {
            "in_channels": int(conv0.shape[1]),
            "num_labels": _shape(state, "classifier.3.weight", 0),
            "d_model": _shape(state, "cls_token", -1),
            "num_layers": _count(state, "encoder.layers.{}.ln1.weight"),
            "num_heads": args.num_heads or 8,
            "d_ff": _shape(state, "encoder.layers.0.ffn.linear1.weight", 0),
            "conv_kernel_size": int(conv0.shape[2]),
            "conv_stride": args.conv_stride,
            "conv_layers": _count(state, "temporal_conv.convs.{}.weight"),
            "spec_n_fft": args.spec_n_fft,
            "spec_hop_length": args.spec_hop_length,
            "spec_freq_bins": 64,
        },
        "ablation": {
            "use_spectrogram": "spectrogram_generator.proj.0.weight" in state,
            "use_ibs": use_robust or use_scalar,
            "ibs_mode": "robust" if use_robust else "scalar",
            "use_cross_attention": "cross_attn.norm.weight" in state,
            "ibs_instance_norm": "ibs_tokenizer.instance_norm.weight" in state,
            "ibs_feature_type": ftype,
        },
        "data": {"sampling_rate": args.sampling_rate, "enable_preprocessing": args.preprocess},
    }
    model = DualEEGTransformer(**serving.dual_eeg_config({"config": config}, state),
                               device=torch.device("cpu"),
                               generator=torch.Generator().manual_seed(0))
    return model, config


def import_art(state: dict, args) -> tuple[torch.nn.Module, dict]:
    learned = "src_embed.1.pos_embed.weight" in state
    if learned:
        max_len = _shape(state, "src_embed.1.pos_embed.weight", 0)
    elif "src_embed.1.pe" in state:
        max_len = _shape(state, "src_embed.1.pe", 1)
    else:
        max_len = args.max_len
    cfg = ArtConfig(
        in_channels=_shape(state, "src_embed.0.conv.weight", 1),
        out_channels=_shape(state, "reconstructor.proj.weight", 0),
        embedding_size=_shape(state, "src_embed.0.conv.weight", 0),
        num_encoder_layers=_count(state, "encoder.layers.{}.ln1.weight"),
        num_decoder_layers=_count(state, "decoder.layers.{}.ln1.weight"),
        num_heads=args.num_heads or 8,
        feedforward_size=_shape(state, "encoder.layers.0.ffn.linear1.weight", 0),
        max_len=max_len,
        pos_mode="learned" if learned else "sinusoidal",
        recon_log_softmax=args.recon_log_softmax,
        recon_zscore=args.recon_zscore or None,
    )
    model = ArtifactRemovalTransformer(cfg, device=torch.device("cpu"),
                                       generator=torch.Generator().manual_seed(0))
    return model, {"model": dataclasses.asdict(cfg)}


def import_multimodal(state: dict, args) -> tuple[torch.nn.Module, dict]:
    """The composite (gaze_encoder.backbone + eeg_encoder + fusion), its
    constructor's fields stamped under ``model.multimodal``, the stamp
    ``MultimodalPredictor.from_checkpoint`` reads."""
    g, e = "gaze_encoder.backbone", "eeg_encoder"
    vit_embed = _shape(state, f"{g}.cls_token", -1)
    n_patches = _shape(state, f"{g}.pos_embed", 1) - 1
    img_size = int(round(math.sqrt(n_patches))) * 16
    if _shape(state, f"{g}.patch_embed.proj.weight", 1) == 6:
        gaze_fusion = "concat"
    elif args.fusion_mode:
        gaze_fusion = args.fusion_mode
    else:
        raise SystemExit("3-channel gaze encoder: pass --fusion-mode")
    use_robust = f"{e}.ibs_tokenizer.type_embedding" in state
    use_scalar = f"{e}.ibs_generator.proj.0.weight" in state
    kwargs = dict(
        num_classes=_shape(state, f"{g}.head.weight", 0),
        gaze_fusion_mode=gaze_fusion,
        fuzzy_mode=args.fuzzy_mode,
        eeg_in_channels=_shape(state, f"{e}.temporal_conv.convs.0.weight", 1),
        eeg_d_model=_shape(state, f"{e}.cls_token", -1),
        eeg_num_layers=_count(state, e + ".encoder.layers.{}.ln1.weight"),
        eeg_num_heads=args.num_heads or 8,
        eeg_d_ff=_shape(state, f"{e}.encoder.layers.0.ffn.linear1.weight", 0),
        eeg_max_len=_shape(state, f"{e}.pos_embed.pos_embed.weight", 0),
        sampling_rate=args.sampling_rate,
        use_spectrogram=f"{e}.spectrogram_generator.proj.0.weight" in state,
        use_ibs=use_robust or use_scalar,
        use_robust_ibs=use_robust,
        use_cross_attention=f"{e}.cross_attn.norm.weight" in state,
        vit_embed_dim=vit_embed,
        vit_depth=_count(state, g + ".blocks.{}.norm1.weight"),
        vit_num_heads=args.num_heads or max(vit_embed // 64, 4),
        img_size=img_size,
    )
    model = MultimodalFusionModel(**kwargs, device=torch.device("cpu"),
                                  generator=torch.Generator().manual_seed(0))
    return model, {"model": {"multimodal": kwargs, "num_labels": kwargs["num_classes"]}}


def import_gaze(state: dict, kind: str, args) -> tuple[torch.nn.Module, dict]:
    prefix = "backbone" if kind == "gaze_early" else "encoder"
    embed = _shape(state, f"{prefix}.cls_token", -1)
    n_patches = _shape(state, f"{prefix}.pos_embed", 1) - 1
    img_size = int(round(math.sqrt(n_patches))) * 16  # the patch-16 family
    # timm's ViTs have 64-wide heads (768 / 12); the reference never changes that.
    heads = args.num_heads or max(embed // 64, 4)
    if kind == "gaze_early":
        if _shape(state, "backbone.patch_embed.proj.weight", 1) == 6:
            if args.fusion_mode not in ("concat", None):
                raise SystemExit("a 6-channel patch embed implies fusion_mode=concat")
            fusion = "concat"
        elif args.fusion_mode:
            fusion = args.fusion_mode
        else:
            raise SystemExit("3-channel early-fusion checkpoint: pass --fusion-mode "
                             "(add/subtract/subtract_abs/multiply: not in the shapes)")
        num_classes, mkind = _shape(state, "backbone.head.weight", 0), "early"
    else:
        num_classes = _shape(state, "classifier.weight", 0)
        ratio = _shape(state, "classifier.weight", 1) // embed
        fusion = {1: args.fusion_mode or "add", 2: "concat", 4: "full"}[ratio]
        mkind = "late"
    config = {"model": {"kind": mkind, "img_size": img_size, "fusion_mode": fusion,
                        "num_labels": num_classes, "vit_num_heads": heads}}
    model, _ = serving.gaze_model(state, {"config": config}, torch.float32)
    return model, config


def check_keys(model: torch.nn.Module, state: dict) -> None:
    """Raise naming every key of ``state`` the model lacks and every key of
    the model ``state`` lacks (the counterpart of the JAX porter's check
    in both directions)."""
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    if extra or missing:
        raise ValueError(
            "the checkpoint does not match the port's model: "
            + (f"keys the model lacks {extra}" if extra else "")
            + ("; " if extra and missing else "")
            + (f"keys the checkpoint lacks {missing}" if missing else ""))
    for k, v in own.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: the model expects {tuple(v.shape)}, the checkpoint "
                             f"provides {tuple(state[k].shape)}")


def import_checkpoint(state: dict, kind: str, args) -> tuple[dict, dict]:
    """(bare float32 state_dict in the model's key order, config) for a
    loaded reference state_dict of ``kind``.  The geometry is read with
    the buffers still there (ART's sinusoidal table gives its ``max_len``)."""
    if kind == "dual_eeg":
        model, config = import_dual_eeg(state, args)
    elif kind == "art":
        model, config = import_art(state, args)
    elif kind == "multimodal":
        model, config = import_multimodal(state, args)
    else:
        model, config = import_gaze(state, kind, args)
    params = {k: v for k, v in state.items() if not is_buffer(k, kind)}
    check_keys(model, params)
    return {k: params[k].to(torch.float32).contiguous() for k in model.state_dict()}, config


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Import a reference torch checkpoint for the port to serve")
    ap.add_argument("checkpoint", type=Path, help=".pt/.pth state_dict file")
    ap.add_argument("--out", type=Path, required=True,
                    help="output directory (gets best_model.pt + best_model.meta.json)")
    ap.add_argument("--kind", default=None, choices=list(KINDS),
                    help="model family (default: sniff from the keys)")
    ap.add_argument("--fuzzy-mode", default="full",
                    choices=["full", "no_temperature", "no_fuzzification", "fixed_weights"],
                    help="multimodal gating mode (not in the shapes)")
    ap.add_argument("--num-heads", type=int, default=None,
                    help="attention heads (not recoverable from shapes); default 8 for "
                         "dual_eeg/art (the reference default), embed_dim/64 for the "
                         "timm-backed gaze ViTs")
    ap.add_argument("--conv-stride", type=int, default=4)
    ap.add_argument("--sampling-rate", type=float, default=256.0)
    ap.add_argument("--spec-n-fft", type=int, default=128)
    ap.add_argument("--spec-hop-length", type=int, default=64)
    ap.add_argument("--preprocess", action="store_true",
                    help="stamp data.enable_preprocessing=True (CAR+z-score at serving "
                         "time; match the training pipeline)")
    ap.add_argument("--max-len", type=int, default=2048, help="ART fallback")
    ap.add_argument("--recon-log-softmax", action="store_true")
    ap.add_argument("--recon-zscore", default=None, choices=[None, "batch", "time"])
    ap.add_argument("--fusion-mode", default=None,
                    help="gaze fusion mode when not shape-inferable (3-channel early modes; "
                         "late add/subtract/multiply)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    state = load_state_dict(args.checkpoint)
    kind = args.kind or sniff_kind(state)
    print(f"[import] {args.checkpoint} kind={kind} ({len(state)} tensors)")
    out_state, config = import_checkpoint(state, kind, args)
    out = args.out.absolute()
    out.mkdir(parents=True, exist_ok=True)
    torch.save(out_state, out / "best_model.pt")
    meta = {"config": config, "imported_from": str(args.checkpoint)}
    (out / "best_model.meta.json").write_text(json.dumps(meta, default=str))
    n = sum(v.numel() for v in out_state.values())
    print(f"[import] wrote {out}/best_model.pt ({n:,} params) + best_model.meta.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
