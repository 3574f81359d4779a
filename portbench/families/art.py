"""ART: the program's ``ArtDenoiser`` (the decoder fed the noisy window) and
its teacher-forced train objective, beside the plain reference."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import weights
from portbench.families.dual_eeg import DTYPES
from portbench.reference import art as reference

MODEL_KEYS = ("in_channels", "out_channels", "embedding_size", "num_encoder_layers",
              "num_decoder_layers", "num_heads", "feedforward_size", "max_len", "pos_mode",
              "recon_log_softmax", "recon_zscore", "loss_zscore")


def program_model(cfg: dict, recipe: dict, device) -> torch.nn.Module:
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer

    config = ArtConfig(**{k: cfg[k] for k in MODEL_KEYS},
                       dropout=recipe.get("dropout", cfg["dropout"]),
                       attn_dropout=recipe.get("attn_dropout", cfg["attn_dropout"]))
    return ArtifactRemovalTransformer(config, device=device,
                                      generator=torch.Generator().manual_seed(0),
                                      dtype=DTYPES[cfg["dtype"]])


def predictor(model, mix: dict, device):
    from eyegaze_tpu_torch.serving import ArtDenoiser

    return ArtDenoiser(model, device=device, batch_buckets=tuple(mix["buckets"]))


def _pair(gen: torch.Generator, cfg: dict, rows: int) -> tuple:
    """(noisy, clean): multi-sine EEG, and it plus white noise of std 0.5,
    each window scaled by its own amplitude, log-uniform over 1/8-8: windows
    with artifacts reach tens of times the background's amplitude, and
    recordings differ."""
    clean = weights.eeg(gen, rows, cfg["in_channels"], cfg["window"], cfg["sampling_rate"],
                        noise=0.0)
    noisy = clean + 0.5 * torch.randn(clean.shape, generator=gen, device=gen.device)
    scale = torch.exp(math.log(8.0) * (2 * torch.rand(rows, 1, 1, generator=gen,
                                                      device=gen.device) - 1))
    return noisy * scale, clean * scale


def requests(gen: torch.Generator, cfg: dict, rows: int) -> tuple:
    return (_pair(gen, cfg, rows)[0],)


def answer(out: dict) -> np.ndarray:
    return out["denoised"]


def reference_serve(p: dict, cfg: dict, arrays: tuple, precision: str) -> torch.Tensor:
    return reference.serve(p, cfg, *arrays, precision=precision)


def train_batch(gen: torch.Generator, cfg: dict, rows: int) -> dict:
    noisy, clean = _pair(gen, cfg, rows)
    return {"input_values": noisy, "labels": clean}


def objective(cfg: dict, recipe: dict):
    """The program's objective (``train_art.make_objective``): MSE of the
    teacher-forced reconstruction."""
    from eyegaze_tpu_torch.train_art import make_objective

    return make_objective(cfg["loss_zscore"])[0]


def reference_loss(p: dict, cfg: dict, batch: dict, recipe: dict, precision: str):
    return reference.loss(p, cfg, batch, {}, precision)


shapes = reference.param_shapes
ROW_BLOCK = 16  # the reference's train step in blocks of rows (attention weights of 16 x 8 x 1024^2)


def kernel_shapes(cfg: dict, rows: int) -> dict:
    """Launch shapes (B, H, T, d) of every attention call of a forward (and of
    its backward) of ``rows`` windows: all 18 take the same."""
    h = cfg["num_heads"]
    shape = (rows, h, cfg["window"], cfg["embedding_size"] // h)
    return {"k3": shape, "k4bwd": shape}
