"""DualEEGTransformer, the flagship EEG hyperscanning model, in PyTorch.

Port of ``eyegaze_tpu/models/dual_eeg.py``.  Token sequence at the full
configuration (C = 32): [CLS | IBS x42 | Spec x32 | conv x64] = 139 tokens.
The connectivity block runs the phase-metrics kernel (K1) on CUDA.  With
``use_robust_ibs=False`` the 42 IBS tokens give way to the legacy scalar IBS
token, one token from 4 bands x 7 global features, which runs no kernel.

Parameter names are the reference torch model's (the names
``eyegaze_tpu.models.torch_port.export_dual_eeg_state_dict`` emits), so a
state_dict from ``eyegaze_tpu_torch.models.convert`` loads with
``strict=True``.

``dtype`` is the compute type, the Flax model's ``dtype`` field (the JAX
``Predictor.from_checkpoint`` serves bfloat16).  Parameters stay float32;
every conv and Dense computes in ``dtype`` (``Conv1d``, ``Conv2d``,
``Dense``); the STFT, the connectivity matrices (K1 included) and the IBS
instance norm run in float32 before their cast; the CLS token, the type
embedding and the positional table are cast to ``dtype``; every LayerNorm
runs in float32 and returns float32, as Flax's ``nn.LayerNorm()`` does; and
every output is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eyegaze_tpu_torch.models.transformer import (
    Conv1d,
    Conv2d,
    Dense,
    LayerNorm,
    MultiHeadAttention,
    PositionalEmbedding,
    TransformerEncoder,
    init_weights_,
    normal_,
)
from eyegaze_tpu_torch.ops.connectivity import (
    FEATURE_NAMES,
    connectivity_matrices,
    connectivity_scalars,
    feature_indices_for,
)
from eyegaze_tpu_torch.ops.spectral import (
    BAND_DEFS_4,
    BAND_DEFS_6,
    hann_window,
    stft_log_magnitude,
)


def adaptive_avg_pool_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """AdaptiveAvgPool2d on (N, C, H, W): bin i covers
    [floor(i * in / out), ceil((i + 1) * in / out)).

    As the JAX package pools: the row bins' means first, then the column
    bins' means of those, each mean taken in float32 and rounded to ``x``'s
    type (``jnp.mean`` on bf16), so a bf16 input rounds twice."""
    rows = F.adaptive_avg_pool2d(x.float(), (out_h, x.shape[-1])).to(x.dtype)
    return F.adaptive_avg_pool2d(rows.float(), (out_h, out_w)).to(x.dtype)


class TemporalConvFrontend(nn.Module):
    """Strided 1-D conv embedding: (B, C, T) -> (B, T', d).

    Conv1d(k, stride, padding k//2) x num_layers, each ReLU + dropout, in
    ``dtype`` from the input on.
    """

    def __init__(self, in_channels: int, d_model: int, kernel_size: int = 25,
                 stride: int = 4, num_layers: int = 2, dropout: float = 0.1, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv1d(in_channels if i == 0 else d_model, d_model, kernel_size, stride,
                   padding=kernel_size // 2, device=device, dtype=dtype)
            for i in range(num_layers)
        ])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in self.convs:
            h = self.dropout(torch.relu(conv(h)))
        return h.transpose(1, 2)


class SpectrogramTokenGenerator(nn.Module):
    """One token per EEG channel from a log-magnitude STFT.

    log|STFT| of the first freq_bins bins -> Conv(32, 3x3) ReLU MaxPool2
    -> Conv(64, 3x3) ReLU -> AdaptiveAvgPool(4, 4) -> MLP 1024 -> 2d -> d.
    The STFT runs in float32; from the first conv on it computes in ``dtype``.
    """

    def __init__(self, d_model: int, n_fft: int = 128, hop_length: int = 64,
                 freq_bins: int = 64, dropout: float = 0.1, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop_length, self.freq_bins = n_fft, hop_length, freq_bins
        self.register_buffer("window", hann_window(n_fft, device), persistent=False)
        self.spec_conv = nn.Sequential(
            Conv2d(1, 32, 3, padding=1, device=device, dtype=dtype), nn.ReLU(), nn.MaxPool2d(2),
            Conv2d(32, 64, 3, padding=1, device=device, dtype=dtype), nn.ReLU(),
        )
        self.proj = nn.Sequential(
            Dense(64 * 4 * 4, d_model * 2, device=device, dtype=dtype), nn.ReLU(),
            nn.Dropout(dropout), Dense(d_model * 2, d_model, device=device, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        mag = stft_log_magnitude(x.reshape(b * c, t).to(torch.float32), self.n_fft,
                                 self.hop_length, self.freq_bins, window=self.window)
        h = adaptive_avg_pool_2d(self.spec_conv(mag[:, None]), 4, 4)
        return self.proj(h.reshape(b * c, -1)).reshape(b, c, -1)


class IBSTokenGenerator(nn.Module):
    """Legacy scalar IBS token: (B, C, T) pairs -> (B, d).

    ``connectivity_scalars`` over 4 bands x 7 features -> Linear 28 -> 2d,
    ReLU, dropout, Linear 2d -> d, in ``dtype`` from the scalars on, then an
    optional LayerNorm (eps 1e-6, the JAX module's; float32 out), which the
    model never turns on.
    """

    def __init__(self, d_model: int, sampling_rate: float = 256.0,
                 use_layernorm: bool = False, dropout: float = 0.1, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sampling_rate = sampling_rate
        features = len(BAND_DEFS_4) * len(FEATURE_NAMES)
        self.proj = nn.Sequential(
            Dense(features, d_model * 2, device=device, dtype=dtype), nn.ReLU(),
            nn.Dropout(dropout), Dense(d_model * 2, d_model, device=device, dtype=dtype),
        )
        self.norm = LayerNorm(d_model, eps=1e-6, device=device) if use_layernorm else None

    def forward(self, eeg1: torch.Tensor, eeg2: torch.Tensor) -> torch.Tensor:
        h = self.proj(connectivity_scalars(eeg1, eeg2, self.sampling_rate, BAND_DEFS_4))
        return h if self.norm is None else self.norm(h)


class RobustIBSTokenizer(nn.Module):
    """Connectivity matrices -> token sequence.

    (B, nb, nf, C, C) -> (B, nb*nf, C*C) -> optional instance norm per C*C
    entry across the token axis (biased variance, eps 1e-5, affine) ->
    Linear C*C -> 64, tanh-GELU, Linear 64 -> d -> + learned type embedding.
    The instance norm runs in float32, the rest in ``dtype``.
    """

    def __init__(self, in_channels: int, d_model: int, use_instance_norm: bool = True,
                 num_features: int = 7, num_bands: int = 6, dropout: float = 0.1, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        entries = in_channels * in_channels
        self.instance_norm = (nn.InstanceNorm1d(entries, eps=1e-5, affine=True, device=device)
                              if use_instance_norm else None)
        self.bottleneck = nn.Sequential(
            Dense(entries, 64, device=device, dtype=dtype), nn.GELU(approximate="tanh"),
            nn.Dropout(dropout), Dense(64, d_model, device=device, dtype=dtype),
        )
        self.type_embedding = nn.Parameter(
            torch.empty(1, num_bands * num_features, d_model, device=device))

    def forward(self, matrices: torch.Tensor) -> torch.Tensor:
        b, nb, nf, c1, c2 = matrices.shape
        x = matrices.reshape(b, nb * nf, c1 * c2)
        if self.instance_norm is not None:
            x = self.instance_norm(x.transpose(1, 2)).transpose(1, 2)
        h = self.bottleneck(x)
        return h + self.type_embedding.to(h.dtype)


class SymmetricFusion(nn.Module):
    """Permutation-invariant fusion: Linear([z1 + z2, z1 * z2, |z1 - z2|]) in ``dtype``."""

    def __init__(self, d_model: int, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(3 * d_model, d_model, device=device, dtype=dtype)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return self.proj(torch.cat([z1 + z2, z1 * z2, (z1 - z2).abs()], dim=-1))


class CrossBrainAttention(nn.Module):
    """Bidirectional cross-attention with shared weights and LayerNorm: the
    attention in ``dtype``, the residual sum and the LayerNorm in float32."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout, device=device,
                                             dtype=dtype)
        self.norm = LayerNorm(d_model, eps=1e-5, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor):
        z1_cross = self.cross_attn(z1, z2, z2)
        z2_cross = self.cross_attn(z2, z1, z1)
        return (self.norm(z1 + self.dropout(z1_cross)),
                self.norm(z2 + self.dropout(z2_cross)))


class DualEEGTransformer(nn.Module):
    """Dual-stream (Siamese) EEG transformer with inter-brain synchrony tokens.

    ``forward(eeg1, eeg2)`` on (B, C, T) pairs returns {'logits', 'cls1',
    'cls2', 'z_fuse'} plus {'ibs_logits', 'ibs_token'} when ``use_ibs``.
    Weights are drawn from ``generator`` (a CPU ``torch.Generator``), so one
    seed gives the same model on every device.  ``mask_band`` >= 0 zeroes
    that band of the connectivity matrices before the tokenizer (the
    frequency-sensitivity analysis); it has no effect on the legacy token.
    ``dtype`` (float32 or bfloat16) is the compute type (module docstring);
    the parameters are float32 in either, so one state_dict loads into both.
    """

    def __init__(
        self,
        in_channels: int = 32,
        num_classes: int = 3,
        d_model: int = 256,
        num_layers: int = 6,
        num_heads: int = 8,
        d_ff: int = 1024,
        dropout: float = 0.1,
        max_len: int = 256,
        conv_kernel_size: int = 25,
        conv_stride: int = 4,
        conv_layers: int = 2,
        sampling_rate: float = 256.0,
        use_spectrogram: bool = True,
        spec_n_fft: int = 128,
        spec_hop_length: int = 64,
        spec_freq_bins: int = 64,
        use_robust_ibs: bool = True,
        use_ibs: bool = True,
        use_cross_attention: bool = True,
        ibs_instance_norm: bool = True,
        ibs_feature_type: str = "all",
        mask_band: int = -1,
        *,
        device: torch.device,
        generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        if mask_band >= len(BAND_DEFS_6):
            raise ValueError(f"mask_band {mask_band} is not a band index below {len(BAND_DEFS_6)}")
        self.in_channels = in_channels
        self.sampling_rate = sampling_rate
        self.ibs_feature_type = ibs_feature_type
        self.mask_band = mask_band
        self.dtype = dtype
        robust = use_ibs and use_robust_ibs
        self.num_ibs_tokens = (len(BAND_DEFS_6) * len(feature_indices_for(ibs_feature_type))
                               if robust else int(use_ibs))

        self.temporal_conv = TemporalConvFrontend(
            in_channels, d_model, conv_kernel_size, conv_stride, conv_layers, dropout,
            device=device, dtype=dtype)
        self.ibs_tokenizer = (RobustIBSTokenizer(
            in_channels, d_model, ibs_instance_norm,
            len(feature_indices_for(ibs_feature_type)), len(BAND_DEFS_6), dropout,
            device=device, dtype=dtype) if robust else None)
        self.ibs_generator = (IBSTokenGenerator(d_model, sampling_rate, dropout=dropout,
                                                device=device, dtype=dtype)
                              if use_ibs and not use_robust_ibs else None)
        self.spectrogram_generator = (SpectrogramTokenGenerator(
            d_model, spec_n_fft, spec_hop_length, spec_freq_bins, dropout, device=device,
            dtype=dtype) if use_spectrogram else None)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d_model, device=device))
        self.pos_embed = PositionalEmbedding(max_len, d_model, "learned", device=device)
        self.encoder = TransformerEncoder(d_model, num_layers, num_heads, d_ff, dropout,
                                          dropout, device=device, dtype=dtype)
        self.cross_attn = (CrossBrainAttention(d_model, num_heads, dropout, device=device,
                                               dtype=dtype)
                           if use_cross_attention else None)
        self.symmetric_fusion = SymmetricFusion(d_model, device=device, dtype=dtype)
        self.classifier = nn.Sequential(
            Dense(3 * d_model, d_model, device=device, dtype=dtype), nn.ReLU(),
            nn.Dropout(dropout), Dense(d_model, num_classes, device=device, dtype=dtype),
        )
        self.ibs_classifier = (nn.Sequential(
            Dense(d_model, d_model // 2, device=device, dtype=dtype), nn.ReLU(),
            nn.Dropout(0.3), Dense(d_model // 2, num_classes, device=device, dtype=dtype),
        ) if use_ibs else None)

        init_weights_(self, generator)
        normal_(self.cls_token, 1.0, generator)
        if self.ibs_tokenizer is not None:
            normal_(self.ibs_tokenizer.type_embedding, 0.02, generator)

    def forward(self, eeg1: torch.Tensor, eeg2: torch.Tensor) -> dict:
        b = eeg1.shape[0]
        h1 = self.temporal_conv(eeg1)  # (B, T', d), shared (Siamese) weights
        h2 = self.temporal_conv(eeg2)
        cls = self.cls_token.expand(b, -1, -1).to(self.dtype)
        seq1, seq2 = [cls], [cls]
        ibs_tokens = None
        if self.ibs_tokenizer is not None:
            matrices = connectivity_matrices(eeg1, eeg2, self.sampling_rate, BAND_DEFS_6,
                                             feature_type=self.ibs_feature_type)
            if self.mask_band >= 0:
                matrices[:, self.mask_band] = 0.0
            ibs_tokens = self.ibs_tokenizer(matrices)
        elif self.ibs_generator is not None:
            ibs_tokens = self.ibs_generator(eeg1, eeg2)[:, None, :]
        if ibs_tokens is not None:
            seq1.append(ibs_tokens)
            seq2.append(ibs_tokens)
        if self.spectrogram_generator is not None:
            seq1.append(self.spectrogram_generator(eeg1))
            seq2.append(self.spectrogram_generator(eeg2))
        seq1.append(h1)
        seq2.append(h2)
        z1 = self.encoder(self.pos_embed(torch.cat(seq1, dim=1)))
        z2 = self.encoder(self.pos_embed(torch.cat(seq2, dim=1)))
        if self.cross_attn is not None:
            z1, z2 = self.cross_attn(z1, z2)
        return self.heads(z1, z2)

    def heads(self, z1: torch.Tensor, z2: torch.Tensor) -> dict:
        """The outputs from the two streams' final token sequences (B, T, d):
        symmetric fusion, the classifier and the IBS classifier."""
        cls1, cls2 = z1[:, 0, :], z2[:, 0, :]
        offset = 1 + self.num_ibs_tokens + (
            self.in_channels if self.spectrogram_generator is not None else 0)
        # The fusion's ``dtype`` output beside the float32 means: float32, as
        # JAX promotes the concatenation.
        z_fuse = torch.cat([self.symmetric_fusion(cls1, cls2).float(),
                            z1[:, offset:, :].mean(dim=1).float(),
                            z2[:, offset:, :].mean(dim=1).float()], dim=-1)
        out = {"logits": self.classifier(z_fuse), "cls1": cls1, "cls2": cls2, "z_fuse": z_fuse}
        if self.ibs_classifier is not None:
            ibs_pooled = z1[:, 1:1 + self.num_ibs_tokens, :].mean(dim=1)
            out["ibs_logits"] = self.ibs_classifier(ibs_pooled)
            out["ibs_token"] = ibs_pooled
        return {k: v.float() for k, v in out.items()}
