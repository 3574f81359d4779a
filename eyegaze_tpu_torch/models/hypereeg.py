"""HyperEEG, the dual-stream Siamese hyperscanning classifier, in PyTorch.

Port of ``eyegaze_tpu/models/hypereeg.py``, which builds the documented
architecture (``4_Experiments/experiments_list.md:194-345``):

    EEG x2 (B, C, T)
      -> TemporalBlock (a learnable sinc band-pass bank, shared)  -> (B, C, E)
      -> IntraGraphBlock (self-attention over the channels, shared)
      -> InterBrainCrossAttn (each brain attends to the other, shared)
      -> UncertaintyFusion (w_A = var_B / (var_A + var_B))         -> (B, E)
      -> classifier                                                -> (B, 3)

``ABLATIONS`` switch the modules off (a plain conv for the sinc bank, means
for the fusion), ``PRESETS`` give the documented widths (embed 128, 4
heads, sinc kernel 125: 274,819 parameters) and the "680k" ones (embed 208:
671,459).  ``forward`` returns {'logits', 'fused'} in float32.

State_dict names mirror the Flax parameter paths (``temporal.sinc.low_hz``,
``graph.attn.query.weight``, ``cross.cross.out.weight``, ``fusion.mu``,
``cls1``; ``convert.hypereeg_state_dict_from_flax`` writes them).  Layouts
and roundings are Flax's:

- the sinc bank and its convolution run in float32 whatever ``dtype`` is
  (a cross-correlation padded (K-1)/2 on each side);
- the strided convolutions pad as Flax's ``padding="SAME"`` pads, the lower
  side ``total // 2`` (``down_0``, kernel 15 stride 8 on T = 1024: (3, 4));
- every Dense, Conv and attention computes in ``dtype``; the attentions are
  Flax's ``MultiHeadDotProductAttention`` (``FlaxAttention``, separate
  ``query`` / ``key`` / ``value`` / ``out`` projections, the attention math
  and its broadcast dropout of ``vit.dot_product_attention``), not the
  package's ``MultiHeadAttention``, so no attention kernel runs;
- the LayerNorms (eps 1e-6) normalise and return float32, the means over
  time and channels are float32 sums rounded to the input's type, GELU is
  the tanh form op by op in ``dtype``, and ``exp(logvar)`` is in ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eyegaze_tpu_torch.models.transformer import Conv1d, Dense, LayerNorm, init_weights_, to_region
from eyegaze_tpu_torch.models.vit import dot_product_attention

ABLATIONS = {
    "full": dict(use_sinc=True, use_graph=True, use_cross_attn=True, use_uncertainty=True),
    "baseline": dict(use_sinc=False, use_graph=False, use_cross_attn=False,
                     use_uncertainty=False),
    "no_sinc": dict(use_sinc=False, use_graph=True, use_cross_attn=True, use_uncertainty=True),
    "no_graph": dict(use_sinc=True, use_graph=False, use_cross_attn=True, use_uncertainty=True),
    "no_cross": dict(use_sinc=True, use_graph=True, use_cross_attn=False, use_uncertainty=True),
    "no_uncertainty": dict(use_sinc=True, use_graph=True, use_cross_attn=True,
                           use_uncertainty=False),
}
# The documented hyperparameters, and the widths that land in the
# statistics table's "~680K Total Parameters" (embed 208: 671,459).
PRESETS = {
    "documented": dict(embed_dim=128, num_heads=4, sinc_kernel_size=125),
    "680k": dict(embed_dim=208, num_heads=4, sinc_kernel_size=125),
}
# The constructor's fields that train_hypereeg stamps into a checkpoint's
# meta as ``model.hypereeg``.
FIELDS = ("in_channels", "num_classes", "embed_dim", "num_heads", "sample_rate",
          "sinc_kernel_size", "use_sinc", "use_graph", "use_cross_attn", "use_uncertainty")
SINC_FILTERS = 16
DOWNSAMPLE = ((15, 8), (9, 8))  # (kernel, stride) of down_0 and down_1


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean``: a float32 sum over ``dim`` divided by its size, in
    ``x``'s type."""
    return x.float().mean(dim=dim).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate, Flax's ``nn.gelu`` default) op by op in
    ``x``'s type."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(N, C, T) zero-padded along T as Flax's ``padding="SAME"``: the
    output has ceil(T / stride) samples, the lower side takes total // 2."""
    t = x.shape[-1]
    total = max((math.ceil(t / stride) - 1) * stride + kernel - t, 0)
    return F.pad(x, (total // 2, total - total // 2))


class SincConv1d(nn.Module):
    """A learnable band-pass bank (SincNet): per filter the edges
    ``low = |low_hz| + min_low_hz`` and ``high = clip(low + |band_hz| +
    min_band_hz, min_low_hz, fs / 2)``, the kernel ``2 high sinc(2 high n) -
    2 low sinc(2 low n)`` Hamming-windowed and L1-normalised, convolved with
    every channel: (B, C, T) -> (B, C, F, T), float32."""

    def __init__(self, num_filters: int = SINC_FILTERS, kernel_size: int = 125,
                 sample_rate: float = 250.0, min_low_hz: float = 0.5,
                 min_band_hz: float = 1.0, *, device: torch.device):
        super().__init__()
        self.kernel_size, self.sample_rate = kernel_size, sample_rate
        self.min_low_hz, self.min_band_hz = min_low_hz, min_band_hz
        self.low_hz = nn.Parameter(torch.linspace(min_low_hz, 40.0, num_filters, device=device))
        self.band_hz = nn.Parameter(torch.full((num_filters,), 8.0, device=device))
        window = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(kernel_size) / kernel_size)
        self.register_buffer("window", torch.tensor(window, dtype=torch.float32, device=device),
                             persistent=False)

    def filters(self) -> torch.Tensor:
        """(F, K) float32 kernels."""
        low = torch.abs(self.low_hz) + self.min_low_hz
        high = torch.clip(low + torch.abs(self.band_hz) + self.min_band_hz, self.min_low_hz,
                          self.sample_rate / 2)
        half = (self.kernel_size - 1) // 2
        n = torch.arange(-half, half + 1, dtype=torch.float32,
                         device=low.device) / self.sample_rate
        low, high = low[:, None], high[:, None]
        h = (2 * high * torch.sinc(2 * high * n) - 2 * low * torch.sinc(2 * low * n)) * self.window
        return h / (torch.abs(h).sum(dim=-1, keepdim=True) + 1e-8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        kernels = self.filters()
        out = F.conv1d(x.reshape(b * c, 1, t).float(), kernels[:, None, :],
                       padding=(self.kernel_size - 1) // 2)
        return out.reshape(b, c, kernels.shape[0], t)


class TemporalBlock(nn.Module):
    """(B, C, T) -> (B, C, embed): the sinc bank (or a plain learned conv of
    the same width), two strided convs with ReLU and dropout (T -> T / 64),
    the mean over time, a Dense to ``embed_dim``; shared by the channels."""

    def __init__(self, embed_dim: int = 128, use_sinc: bool = True, sinc_kernel_size: int = 125,
                 sample_rate: float = 250.0, dropout: float = 0.1, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_sinc, self.sinc_kernel_size, self.embed_dim = use_sinc, sinc_kernel_size, embed_dim
        if use_sinc:
            self.sinc = SincConv1d(SINC_FILTERS, sinc_kernel_size, sample_rate, device=device)
        else:
            self.plain_conv = Conv1d(1, SINC_FILTERS, sinc_kernel_size, device=device,
                                     dtype=dtype)
        width = SINC_FILTERS
        for i, (k, s) in enumerate(DOWNSAMPLE):
            setattr(self, f"down_{i}", Conv1d(width, 32 * (i + 1), k, stride=s, device=device,
                                              dtype=dtype))
            width = 32 * (i + 1)
        self.drop = nn.Dropout(dropout)
        self.proj = Dense(width, embed_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        if self.use_sinc:
            h = self.sinc(x).reshape(b * c, SINC_FILTERS, t)
        else:
            h = self.plain_conv(same_pad(x.reshape(b * c, 1, t), self.sinc_kernel_size, 1))
        for i, (k, s) in enumerate(DOWNSAMPLE):
            h = self.drop(torch.relu(getattr(self, f"down_{i}")(same_pad(h, k, s))))
        return self.proj(_mean(h, -1)).reshape(b, c, self.embed_dim)


class FlaxAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` with ``qkv_features`` =
    ``out_features`` = ``embed_dim``: the ``query``, ``key`` and ``value``
    projections (Flax's (E, H, hd) DenseGeneral kernels as (E, E) Dense
    weights), ``vit.dot_product_attention`` and the ``out`` projection, all
    in ``dtype``.  Under tp (``parallel/tensor.py``) it runs the rank's
    heads: the graph block's attention shards, the cross attention stays
    replicated (``parallel/sharding.py``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed dim {embed_dim} is not divisible by num_heads {num_heads}")
        self.num_heads, self.head_dim, self.tp = num_heads, embed_dim // num_heads, 1
        self.dropout = dropout
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(embed_dim, embed_dim, device=device, dtype=dtype))

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor) -> torch.Tensor:
        b, tq, _ = xq.shape
        heads, hd = self.num_heads, self.head_dim
        xq, xkv = to_region(self.tp, xq, xkv)

        def split(x: torch.Tensor) -> torch.Tensor:  # (B, T, H hd) -> (B, H, T, hd)
            return x.reshape(b, x.shape[1], heads, hd).transpose(1, 2)

        o = dot_product_attention(split(self.query(xq)), split(self.key(xkv)),
                                  split(self.value(xkv)), self.dropout if self.training else 0.0)
        return self.out(o.transpose(1, 2).reshape(b, tq, heads * hd))


class IntraGraphBlock(nn.Module):
    """Channels as graph nodes: self-attention (the learned adjacency),
    post-LN, then a GELU feed-forward of width 2E, post-LN."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, dropout: float = 0.1, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = FlaxAttention(embed_dim, num_heads, dropout, device=device, dtype=dtype)
        self.ln1 = LayerNorm(embed_dim, eps=1e-6, device=device)
        self.ff1 = Dense(embed_dim, 2 * embed_dim, device=device, dtype=dtype)
        self.ff2 = Dense(2 * embed_dim, embed_dim, device=device, dtype=dtype)
        self.ln2 = LayerNorm(embed_dim, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, E)
        xd = x.to(self.attn.query.compute_dtype)
        x = self.ln1(x + self.attn(xd, xd))
        return self.ln2(x + self.ff2(_gelu_tanh(self.ff1(x))))


class InterBrainCrossAttn(nn.Module):
    """Each brain's channels attend to the other's, with one shared
    attention and one shared LayerNorm for both directions (each call draws
    its own dropout mask)."""

    def __init__(self, embed_dim: int = 128, num_heads: int = 4, dropout: float = 0.1, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross = FlaxAttention(embed_dim, num_heads, dropout, device=device, dtype=dtype)
        self.ln = LayerNorm(embed_dim, eps=1e-6, device=device)

    def forward(self, za: torch.Tensor, zb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dt = self.cross.query.compute_dtype
        za_out = self.ln(za + self.cross(za.to(dt), zb.to(dt)))
        zb_out = self.ln(zb + self.cross(zb.to(dt), za.to(dt)))
        return za_out, zb_out


class UncertaintyFusion(nn.Module):
    """Inverse-variance fusion of the two channel means: a shared ``mu`` and
    ``logvar`` head, ``w_A = var_B / (var_A + var_B + 1e-8)``, in ``dtype``."""

    def __init__(self, embed_dim: int = 128, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mu = Dense(embed_dim, embed_dim, device=device, dtype=dtype)
        self.logvar = Dense(embed_dim, embed_dim, device=device, dtype=dtype)

    def forward(self, za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:  # (B, C, E) x2
        fa, fb = _mean(za, 1), _mean(zb, 1)
        var_a, var_b = torch.exp(self.logvar(fa)), torch.exp(self.logvar(fb))
        w_a = var_b / (var_a + var_b + 1e-8)
        return w_a * self.mu(fa) + (1.0 - w_a) * self.mu(fb)


class HyperEEGEncoder(nn.Module):
    """``forward(eeg1, eeg2)`` on (B, C, T) pairs -> {'logits' (B,
    num_classes), 'fused' (B, E)}, float32.  Weights are drawn from
    ``generator`` (a CPU ``torch.Generator``) as Flax inits them: kernels
    lecun-normal, biases zero, norms one and zero; the sinc edges start at
    linspace(0.5, 40, 16) Hz with 8 Hz bands."""

    def __init__(self, in_channels: int = 32, num_classes: int = 3, embed_dim: int = 128,
                 num_heads: int = 4, dropout: float = 0.1, sample_rate: float = 250.0,
                 sinc_kernel_size: int = 125, use_sinc: bool = True, use_graph: bool = True,
                 use_cross_attn: bool = True, use_uncertainty: bool = True, *,
                 device: torch.device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        values = locals()
        for name in FIELDS:
            setattr(self, name, values[name])
        self.dropout, self.dtype = dropout, dtype
        kw = dict(device=device, dtype=dtype)
        self.temporal = TemporalBlock(embed_dim, use_sinc, sinc_kernel_size, sample_rate, dropout,
                                      **kw)
        if use_graph:
            self.graph = IntraGraphBlock(embed_dim, num_heads, dropout, **kw)
        if use_cross_attn:
            self.cross = InterBrainCrossAttn(embed_dim, num_heads, dropout, **kw)
        if use_uncertainty:
            self.fusion = UncertaintyFusion(embed_dim, **kw)
        self.cls1 = Dense(embed_dim, embed_dim // 2, **kw)
        self.drop = nn.Dropout(dropout)
        self.cls2 = Dense(embed_dim // 2, num_classes, **kw)
        init_weights_(self, generator)

    def forward(self, eeg1: torch.Tensor, eeg2: torch.Tensor) -> dict:
        za, zb = self.temporal(eeg1), self.temporal(eeg2)
        if self.use_graph:
            za, zb = self.graph(za), self.graph(zb)
        if self.use_cross_attn:
            za, zb = self.cross(za, zb)
        if self.use_uncertainty:
            fused = self.fusion(za, zb)
        else:
            fused = (_mean(za, 1) + _mean(zb, 1)) / 2.0
        logits = self.cls2(self.drop(torch.relu(self.cls1(fused))))
        return {"logits": logits.float(), "fused": fused.float()}


def create_hypereeg_model(ablation: str = "full", preset: str | None = None,
                          **kwargs) -> HyperEEGEncoder:
    """``HyperEEGEncoder`` with the ``ablation``'s module switches and the
    ``preset``'s widths; ``kwargs`` (``device`` and ``generator`` among
    them) override the preset."""
    if ablation not in ABLATIONS:
        raise ValueError(f"ablation must be one of {list(ABLATIONS)}")
    if preset is not None:
        if preset not in PRESETS:
            raise ValueError(f"preset must be one of {list(PRESETS)}")
        kwargs = {**PRESETS[preset], **kwargs}
    return HyperEEGEncoder(**ABLATIONS[ablation], **kwargs)
