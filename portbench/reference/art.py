"""Plain float32 reference of ART, the Artifact Removal Transformer.

The published encoder-decoder denoiser: a 1x1 convolution embeds the C
channels of each time step into E features, sinusoidal positions are added,
a post-LN encoder reads the noisy window, a post-LN decoder reads the target
(the noisy window itself when served, the clean one when trained,
teacher-forced) with cross-attention to the encoder's output, and a linear
head maps back to C channels.  No masks, no log-softmax, no z-score in the
head: the configurations run ``ArtConfig()``'s defaults.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import layers
from portbench.reference.layers import dense
from portbench.reference.precision import operand


def param_shapes(cfg: dict) -> list:
    c, e, ff = cfg["in_channels"], cfg["embedding_size"], cfg["feedforward_size"]
    out = []
    for side in ("src", "tgt"):
        out += [(f"{side}_embed.0.conv.weight", (e, c, 1), "fan_in"),
                (f"{side}_embed.0.conv.bias", (e,), "bias")]
    out += layers.encoder_shapes("encoder", e, ff, cfg["num_encoder_layers"])
    out += layers.decoder_shapes("decoder", e, ff, cfg["num_decoder_layers"])
    out += layers.dense_shapes("reconstructor.proj", e, cfg["out_channels"])
    return out


def positions(t: int, e: int, device) -> torch.Tensor:
    """Sinusoidal table (t, e): sin at even features, cos at odd ones."""
    pos = torch.arange(t, dtype=torch.float64)[:, None]
    freq = torch.exp(torch.arange(0, e, 2, dtype=torch.float64) * (-math.log(10000.0) / e))
    table = torch.zeros(t, e, dtype=torch.float64)
    table[:, 0::2] = torch.sin(pos * freq)
    table[:, 1::2] = torch.cos(pos * freq)
    return table.float().to(device)


def _embed(p: dict, side: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    w = p[f"{side}_embed.0.conv.weight"][:, :, 0]
    h = F.linear(operand(x.transpose(1, 2), precision), operand(w, precision),
                 p[f"{side}_embed.0.conv.bias"])
    return h + positions(x.shape[-1], w.shape[0], x.device)


def forward(p: dict, cfg: dict, src: torch.Tensor, tgt: torch.Tensor | None = None,
            precision: str = "exact") -> torch.Tensor:
    """(B, C, T) noisy windows (and the decoder's target, ``src`` when None)
    -> (B, C_out, T) reconstructions."""
    heads = cfg["num_heads"]
    memory = layers.encoder(p, "encoder", _embed(p, "src", src, precision),
                            cfg["num_encoder_layers"], heads, precision)
    out = layers.decoder(p, "decoder", _embed(p, "tgt", src if tgt is None else tgt, precision),
                         memory, cfg["num_decoder_layers"], heads, precision)
    return dense(p, "reconstructor.proj", out, precision).transpose(1, 2)


def serve(p: dict, cfg: dict, noisy: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    return forward(p, cfg, noisy, None, precision)


def loss(p: dict, cfg: dict, batch: dict, weights: dict, precision: str = "exact"):
    """Mean squared error of the teacher-forced reconstruction of
    ``input_values`` against the clean ``labels``: (total, {}), one term."""
    recon = forward(p, cfg, batch["input_values"], batch["labels"], precision)
    return ((recon - batch["labels"]) ** 2).mean(), {}
