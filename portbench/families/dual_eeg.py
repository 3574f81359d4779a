"""The flagship DualEEGTransformer: the program's ``Predictor`` (CAR and
z-score on the device, then the model) and its train objective, beside the
plain reference."""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.reference import dual_eeg as reference

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_model(cfg: dict, recipe: dict, device) -> torch.nn.Module:
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer

    model = DualEEGTransformer(
        in_channels=cfg["in_channels"], num_classes=cfg["num_classes"], d_model=cfg["d_model"],
        num_layers=cfg["num_layers"], num_heads=cfg["num_heads"], d_ff=cfg["d_ff"],
        dropout=recipe.get("dropout", 0.0), max_len=cfg["max_len"],
        conv_kernel_size=cfg["conv_kernel_size"], conv_stride=cfg["conv_stride"],
        conv_layers=cfg["conv_layers"], sampling_rate=float(cfg["sampling_rate"]),
        use_spectrogram=cfg["use_spectrogram"], spec_n_fft=cfg["spec_n_fft"],
        spec_hop_length=cfg["spec_hop_length"], spec_freq_bins=cfg["spec_freq_bins"],
        use_robust_ibs=cfg["ibs_mode"] == "robust", use_ibs=cfg["use_ibs"],
        use_cross_attention=cfg["use_cross_attention"],
        ibs_instance_norm=cfg["ibs_instance_norm"], ibs_feature_type=cfg["ibs_feature_type"],
        device=device, generator=torch.Generator().manual_seed(0), dtype=DTYPES[cfg["dtype"]])
    if "dropout" in recipe:
        # The IBS classifier's dropout (0.3) is fixed in the model, not an
        # argument: the recipe's rate is set on every dropout module.
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = recipe["dropout"]
    return model


def predictor(model, mix: dict, device):
    from eyegaze_tpu_torch.serving import Predictor

    return Predictor(model, device=device, batch_buckets=tuple(mix["buckets"]))


def requests(gen: torch.Generator, cfg: dict, rows: int) -> tuple:
    c, t, fs = cfg["in_channels"], cfg["window"], cfg["sampling_rate"]
    return weights.eeg(gen, rows, c, t, fs), weights.eeg(gen, rows, c, t, fs)


def answer(out: dict) -> np.ndarray:
    return out["logits"]


def reference_serve(p: dict, cfg: dict, arrays: tuple, precision: str) -> torch.Tensor:
    return reference.serve(p, cfg, *arrays, precision=precision)


def train_batch(gen: torch.Generator, cfg: dict, rows: int) -> dict:
    eeg1, eeg2 = requests(gen, cfg, rows)
    label = torch.randint(0, cfg["num_classes"], (rows,), generator=gen, device=gen.device)
    return {"eeg1": eeg1, "eeg2": eeg2, "label": label}


def objective(cfg: dict, recipe: dict):
    """The program's objective (``train_dual_eeg.make_objective``) with the
    recipe's loss terms and weights, raw windows in (no preprocessing)."""
    from eyegaze_tpu_torch.config import config_from_dict
    from eyegaze_tpu_torch.train_dual_eeg import make_objective

    w = recipe["loss_weights"]
    training = dict(use_sym_loss=True, use_ibs_loss=True, use_ibs_cls_loss=True,
                    use_ibs_contrastive=True, lambda_sym=w["sym"], lambda_ibs=w["align"],
                    lambda_ibs_cls=w["ibs_ce"], lambda_ibs_contrastive=w["contrastive"])
    raw = {"ablation": {"use_ibs": cfg["use_ibs"]},
           "data": {"enable_preprocessing": False, "sampling_rate": cfg["sampling_rate"]},
           "training": training}
    return make_objective(config_from_dict(raw))[0]


def reference_loss(p: dict, cfg: dict, batch: dict, recipe: dict, precision: str):
    return reference.loss(p, cfg, batch, recipe["loss_weights"], precision)


shapes = reference.param_shapes


def kernel_shapes(cfg: dict, rows: int) -> dict:
    """Launch shapes of the program's kernels in a forward of ``rows`` pairs:
    K1 runs once, on the six bands of every row stacked."""
    return {"k1": (len(reference.BANDS_6) * rows, cfg["in_channels"], cfg["window"])}
