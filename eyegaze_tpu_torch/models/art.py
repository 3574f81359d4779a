"""ART, the Artifact Removal Transformer (EEG denoising seq2seq), in PyTorch.

Port of ``eyegaze_tpu/models/art.py``: a 1x1-conv channel embedding plus
positions, a post-LN encoder and decoder, a linear Reconstructor head
with optional log-softmax and batch/time z-score, and the training loss
``art_loss``.  Module names follow the
reference torch model as ``export_art_state_dict`` writes them
(``src_embed.0.conv``, ``src_embed.1.pos_embed``, ``encoder.layers.i``,
``decoder.layers.i``, ``reconstructor.proj``), so the state_dict of
``eyegaze_tpu_torch.models.convert.art_state_dict_from_flax`` loads with
``strict=True``.

``dtype`` is the compute type, the Flax model's ``dtype`` field (the JAX
``ArtDenoiser.from_checkpoint`` serves bfloat16): parameters stay float32,
every Dense (the 1x1 conv, the projections, the FFN, the head) computes in
``dtype``, the positional table is cast to it, every LayerNorm runs in
float32, attention forms f32 scores and rounds P to ``dtype`` (the kernel
route's contract too), the head's log-softmax and z-score run in ``dtype``,
and the output is float32.  ``python -m eyegaze_tpu_torch.train_art`` trains
it in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from eyegaze_tpu_torch.models.transformer import (
    Dense,
    PositionalEmbedding,
    TransformerDecoder,
    TransformerEncoder,
    cast_params,
    init_weights_,
)


@dataclasses.dataclass(frozen=True)
class ArtConfig:
    """The fields and defaults of the JAX package's ``ArtConfig``."""

    in_channels: int = 32
    out_channels: int = 32
    embedding_size: int = 128
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    feedforward_size: int = 2048
    dropout: float = 0.1
    max_len: int = 2048
    pos_mode: str = "sinusoidal"
    recon_log_softmax: bool = False
    recon_zscore: Optional[str] = None  # None | 'batch' | 'time'
    loss_zscore: bool = False
    attn_dropout: Optional[float] = None  # None: attention dropout follows `dropout`


class ExpandConv1x1(nn.Module):
    """Channel expansion with a 1x1 conv: (B, C, T) -> (B, T, E).

    Holds the reference's ``Conv1d(C, E, 1)`` and computes it as a linear
    product on the squeezed weight (cuDNN would pick its own algorithm for a
    1x1 convolution), in ``dtype`` as ``Dense`` does.
    """

    def __init__(self, in_channels: int, out_channels: int, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 1, device=device)
        self.dtype = dtype
        self._cast = (None, None)  # cast_params' cache

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = cast_params(self, (self.conv.weight[:, :, 0], self.conv.bias), self.dtype)
        return nn.functional.linear(x.transpose(1, 2).to(self.dtype), w, b)


class Reconstructor(nn.Module):
    """Linear head + optional log-softmax + optional z-score (unbiased, eps 1e-10)."""

    def __init__(self, d_model: int, out_channels: int, log_softmax: bool = False,
                 zscore: Optional[str] = None, eps: float = 1e-10, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if zscore not in (None, "batch", "time"):
            raise ValueError(f"Unsupported zscore mode: {zscore}")
        self.proj = Dense(d_model, out_channels, device=device, dtype=dtype)
        self.log_softmax = log_softmax
        self.zscore = zscore
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)
        if self.log_softmax:
            y = torch.log_softmax(y, dim=-1)
        if self.zscore is None:
            return y
        axis = 0 if self.zscore == "batch" else 1
        mean = y.mean(dim=axis, keepdim=True)
        n = y.shape[axis]
        var = ((y - mean) ** 2).sum(dim=axis, keepdim=True) / max(n - 1, 1)
        return (y - mean) / (torch.sqrt(var) + self.eps)


class ArtifactRemovalTransformer(nn.Module):
    """Encoder-decoder EEG denoiser.

    ``forward(src (B, C, T), tgt (B, C, T) or None, src_mask, tgt_mask)`` ->
    reconstruction (B, C_out, T) float32.  Without ``tgt`` the decoder is fed
    ``src``, as in serving.  ``src_mask`` (B, Tk) and ``tgt_mask`` (B, Tk) or
    (B, Tq, Tk) are True where a position is masked out.  Weights are drawn
    from ``generator`` (a CPU ``torch.Generator``), so one seed gives the same
    model on every device.  ``dtype`` (float32 or bfloat16) is the compute
    type (module docstring); the parameters are float32 in either, so one
    state_dict loads into both.
    """

    def __init__(self, config: ArtConfig, *, device: torch.device,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        cfg = self.config = config
        self.dtype = dtype
        e = cfg.embedding_size
        ad = cfg.dropout if cfg.attn_dropout is None else cfg.attn_dropout
        for side in ("src", "tgt"):
            self.add_module(f"{side}_embed", nn.Sequential(
                ExpandConv1x1(cfg.in_channels, e, device=device, dtype=dtype),
                PositionalEmbedding(cfg.max_len, e, cfg.pos_mode, device=device),
                nn.Dropout(cfg.dropout)))
        self.encoder = TransformerEncoder(e, cfg.num_encoder_layers, cfg.num_heads,
                                          cfg.feedforward_size, cfg.dropout, ad, device=device,
                                          dtype=dtype)
        self.decoder = TransformerDecoder(e, cfg.num_decoder_layers, cfg.num_heads,
                                          cfg.feedforward_size, cfg.dropout, ad, device=device,
                                          dtype=dtype)
        self.reconstructor = Reconstructor(e, cfg.out_channels, cfg.recon_log_softmax,
                                           cfg.recon_zscore, device=device, dtype=dtype)
        init_weights_(self, generator)

    def forward(self, src: torch.Tensor, tgt: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None,
                tgt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc_mask = None
        if src_mask is not None:  # True = masked out; 0 entries get -1e9
            enc_mask = (~src_mask.bool())[:, None, None, :]
        memory = self.encoder(self.src_embed(src), enc_mask)

        dec_self_mask = None
        if tgt_mask is not None:
            keep = ~tgt_mask.bool()
            dec_self_mask = keep[:, None, :, :] if tgt_mask.dim() == 3 else keep[:, None, None, :]
        out = self.decoder(self.tgt_embed(src if tgt is None else tgt), memory,
                           dec_self_mask, enc_mask)
        return self.reconstructor(out).transpose(1, 2).float()  # (B, C_out, T)


def art_loss(logits: torch.Tensor, labels: torch.Tensor, loss_zscore: bool = False,
             eps: float = 1e-10) -> torch.Tensor:
    """MSE of (B, C, T) reconstructions against clean ``labels``, or with
    ``loss_zscore`` the MSE of both z-scored per channel over time (unbiased
    variance, ``eps`` added to the std), as the JAX ``art_loss``."""
    if not loss_zscore:
        return torch.mean((logits - labels) ** 2)

    def z(x):
        mean = x.mean(dim=2, keepdim=True)
        var = ((x - mean) ** 2).sum(dim=2, keepdim=True) / (x.shape[2] - 1)
        return (x - mean) / (torch.sqrt(var) + eps)

    return torch.mean((z(logits) - z(labels)) ** 2)
