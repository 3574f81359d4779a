"""The multimodal gaze + EEG composite with fuzzy-gating decision fusion.

The port of ``eyegaze_tpu/models/multimodal.py`` (the reference's
``MultimodalFusionModel``, train_multimodal_fuzzy_fusion.py:106-179): the
gaze encoder (``EarlyFusionViT``) gives image logits, the EEG encoder (the
flagship ``DualEEGTransformer``, whose forward launches the phase-metrics
kernel K1 once on a CUDA device) gives EEG logits, and
``FuzzyGatingFusion`` gates the two into the fused logits.

Submodules and state_dict names are the reference's: ``gaze_encoder.``
(the ViT under its ``backbone.``), ``eeg_encoder.``, ``fusion.``, so
``convert.multimodal_state_dict_from_flax`` and the JAX exporter
(``export_torch_checkpoint.py --kind multimodal``) load with
``strict=True``.  ``dtype`` is both encoders' compute type; the gate runs
in float32 on their float32 logits.
"""

from __future__ import annotations

import torch
from torch import nn

from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.models.fuzzy_fusion import FuzzyGatingFusion
from eyegaze_tpu_torch.models.vit import EarlyFusionViT

# The constructor's fields, the JAX module's: what train_multimodal stamps
# into a checkpoint's meta as ``model.multimodal``.
FIELDS = ("num_classes", "gaze_fusion_mode", "fuzzy_mode", "eeg_in_channels", "eeg_d_model",
          "eeg_num_layers", "eeg_num_heads", "eeg_d_ff", "eeg_max_len", "sampling_rate",
          "use_spectrogram", "use_ibs", "use_robust_ibs", "use_cross_attention",
          "vit_embed_dim", "vit_depth", "vit_num_heads", "img_size", "dropout")


class MultimodalFusionModel(nn.Module):
    """``forward(img1, img2, eeg1, eeg2)`` on normalized (B, 3, S, S) image
    pairs and (B, C, T) EEG pairs -> {'logits', 'img_logits',
    'eeg_logits', 'alpha', 'aux_info', 'temp_reg'}.  Weights are drawn from
    ``generator`` (a CPU ``torch.Generator``): the gaze encoder's, then the
    EEG encoder's."""

    def __init__(self, num_classes: int = 3, gaze_fusion_mode: str = "concat",
                 fuzzy_mode: str = "full", eeg_in_channels: int = 32, eeg_d_model: int = 256,
                 eeg_num_layers: int = 6, eeg_num_heads: int = 8, eeg_d_ff: int = 1024,
                 eeg_max_len: int = 256, sampling_rate: float = 256.0,
                 use_spectrogram: bool = True, use_ibs: bool = True,
                 use_robust_ibs: bool = True, use_cross_attention: bool = True,
                 vit_embed_dim: int = 768, vit_depth: int = 12, vit_num_heads: int = 12,
                 img_size: int = 224, dropout: float = 0.1, *, device: torch.device,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        values = locals()
        for name in FIELDS:
            setattr(self, name, values[name])
        self.dtype = dtype
        self.gaze_encoder = EarlyFusionViT(
            num_classes=num_classes, img_size=img_size, fusion_mode=gaze_fusion_mode,
            embed_dim=vit_embed_dim, depth=vit_depth, num_heads=vit_num_heads, dropout=dropout,
            device=device, generator=generator, dtype=dtype)
        self.eeg_encoder = DualEEGTransformer(
            in_channels=eeg_in_channels, num_classes=num_classes, d_model=eeg_d_model,
            num_layers=eeg_num_layers, num_heads=eeg_num_heads, d_ff=eeg_d_ff, dropout=dropout,
            max_len=eeg_max_len, sampling_rate=sampling_rate, use_spectrogram=use_spectrogram,
            use_ibs=use_ibs, use_robust_ibs=use_robust_ibs,
            use_cross_attention=use_cross_attention, device=device, generator=generator,
            dtype=dtype)
        self.fusion = FuzzyGatingFusion(num_classes, fuzzy_mode, device=device)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, eeg1: torch.Tensor,
                eeg2: torch.Tensor) -> dict:
        img_logits = self.gaze_encoder(img1, img2)
        eeg_logits = self.eeg_encoder(eeg1, eeg2)["logits"]
        fused, alpha, aux = self.fusion(img_logits, eeg_logits)
        return {"logits": fused, "img_logits": img_logits, "eeg_logits": eeg_logits,
                "alpha": alpha, "aux_info": aux,
                "temp_reg": self.fusion.temperature_regularization()}
