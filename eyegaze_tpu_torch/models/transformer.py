"""Post-LN transformer stack, positional tables and parameter initialisation.

Port of ``eyegaze_tpu/models/transformer.py``: multi-head attention as
matmul, float32 softmax, matmul (masks filled with -1e9 where ``mask == 0``);
a ReLU feed-forward; post-LayerNorm encoder and decoder blocks with eps
1e-5; sinusoidal or learned positions.  Parameter names follow the reference
torch model, so state_dicts written by ``eyegaze_tpu_torch.models.convert``
load with ``strict=True``.

On a CUDA device, unmasked attention whose shapes tile runs the port's
attention kernel (``eyegaze_tpu_torch.kernels.attention``) through the route
``attention_route`` picks, the counterpart of the JAX package's
``_flash_eligible`` and ``_headpack_eligible``.

The counterpart of the Flax modules' ``dtype`` field is ``dtype`` here
(float32 by default, as in Flax).  Parameters stay float32, as Flax keeps
them; every ``Dense``, ``Conv1d`` and ``Conv2d`` casts its input, weight
and bias to ``dtype`` and returns ``dtype``, and every ``LayerNorm`` normalises
in float32 and returns float32 whatever its input, as Flax's
``nn.LayerNorm()`` does.  So in bf16 the residual stream is float32 after
the first LayerNorm and each projection recasts it.

Under tensor parallelism (``parallel/tensor.py``) ``MultiHeadAttention`` and
``FeedForward`` hold the rank's heads (``num_heads`` is then the local count)
and the rank's hidden units: each copies its inputs into the tp region, its
column projections give the local heads or hidden, its row projection
reduces over the tp group, and dropout inside the region draws from the
region's generator (``tensor.region_dropout``).  The attention route and
the kernels see H / tp heads.  At ``tp`` 1 (the default) the code path is
unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eyegaze_tpu_torch.kernels import attention


def attention_route(device_type: str, dtype: torch.dtype, tq: int, tk: int, d_k: int, *,
                    has_mask: bool, dropout_active: bool, return_weights: bool) -> str:
    """Which path an attention call takes: 'flash', 'headpacked' or 'plain'.

    The semantic and tileability gates of the JAX package's
    ``_flash_eligible`` and ``_headpack_eligible``, in its order; its
    performance gates, measured on a TPU, and its environment switches are
    not carried over.  Semantic gates: the kernels take no mask, no
    attention-weight dropout and return no weights.  Tileability: the
    flash route (K4) wants ``tq`` and ``tk`` multiples of 128 and
    ``d_k % 128 == 0`` with bf16 operands; the head-packed route (K3) wants
    ``tq % 128 == 0`` and ``tk <= 2048``.  Everything else, and every device
    but CUDA, takes the plain path.  A CUDA call routed to the kernel with a
    head dim or dtype the kernel is not built for raises in the kernel's
    wrapper; it never falls back to the plain path.  Gradients: both kernel
    routes train, through their wrapper's autograd Functions.  In bf16 their
    backward is K4's, written by hand (one kernel or two by shape; the JAX
    package trains its flash route through the stock Pallas backward); in f32 the head-packed
    route recomputes the JAX package's einsum backward in stock ops.  So an
    ART model trained without attention-weight dropout runs K3 in every
    train step, and K4's backward too in bf16.
    """
    if device_type != "cuda" or has_mask or dropout_active or return_weights:
        return "plain"
    if tq % 128 == 0 and tk % 128 == 0 and d_k % 128 == 0 and dtype == torch.bfloat16:
        return "flash"
    if tq % 128 == 0 and tk <= 2048:
        return "headpacked"
    return "plain"


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``, Flax's ``nn.Dense(dtype=...)``:
    the input, the float32 weight and the bias cast to ``dtype``, the output
    in ``dtype``.  Without autograd the cast weight and bias are kept until
    the parameters change (their version or storage), so a served forward
    casts nothing but its input."""

    def __init__(self, in_features: int, out_features: int, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype
        self._cast = (None, None)  # (key of the parameters cast, (weight, bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), *cast_params(self, (self.weight, self.bias), dt))


def cast_params(module: nn.Module, params, dtype: torch.dtype):
    """``params`` cast to ``dtype``; without autograd the casts are kept on
    ``module`` and reused until a parameter changes."""
    if all(p.dtype == dtype for p in params):
        return params
    if torch.is_grad_enabled():
        return tuple(p.to(dtype) for p in params)
    key = tuple((p._version, p.data_ptr()) for p in params)  # in place / replaced
    if module._cast[0] != key:
        module._cast = (key, tuple(p.to(dtype) for p in params))
    return module._cast[1]


class _CastConv:
    """The conv counterpart of ``Dense``, Flax's ``nn.Conv(dtype=...)``: the
    input, the float32 kernel and the bias cast to ``dtype`` (through
    ``cast_params``, so a served forward casts no weight twice), the output
    in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype
        self._cast = (None, None)  # cast_params' cache

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), *cast_params(self, (self.weight, self.bias), dt))


class Conv1d(_CastConv, nn.Conv1d):
    """``nn.Conv1d`` that computes in ``dtype`` (``_CastConv``)."""


class Conv2d(_CastConv, nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` (``_CastConv``)."""


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that normalises in float32 and returns float32, as
    Flax's ``nn.LayerNorm()`` (no dtype) does on a bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def to_region(tp: int, *xs: torch.Tensor) -> tuple:
    """``xs`` copied into the tp region, one copy per distinct tensor
    (``tensor.copy_to_region``); ``xs`` themselves at tp 1."""
    if tp == 1:
        return xs
    from eyegaze_tpu_torch.parallel import tensor  # it imports this module

    copies = {}
    for x in xs:
        if id(x) not in copies:
            copies[id(x)] = tensor.copy_to_region(x)
    return tuple(copies[id(x)] for x in xs)


def region_dropout(tp: int, dropout: nn.Dropout, x: torch.Tensor) -> torch.Tensor:
    """``dropout(x)`` on activations inside a tp region: at tp > 1 drawn
    from the region's generator (``tensor.region_dropout``)."""
    if tp == 1:
        return dropout(x)
    from eyegaze_tpu_torch.parallel import tensor

    return tensor.region_dropout(x, dropout.p, dropout.training)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention with q/k/v/out projections.

    ``attn_mask`` broadcasts against the (B, H, Tq, Tk) scores; where it is
    0 the score becomes -1e9 before the softmax.  The projections compute in
    ``dtype`` (``Dense``).  Under tp (module docstring) it runs the rank's
    ``num_heads`` heads.
    """

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by num_heads {num_heads}")
        self.num_heads, self.head_dim, self.tp = num_heads, d_model // num_heads, 1
        self.q_proj = Dense(d_model, d_model, device=device, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, device=device, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, device=device, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, device=device, dtype=dtype)
        self.dropout = nn.Dropout(dropout)  # on the softmax weights, as the reference

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                attn_mask: torch.Tensor | None = None, return_weights: bool = False):
        b, tq, _ = q.shape
        tk = k.shape[1]
        h, d_k = self.num_heads, self.head_dim
        width = h * d_k
        q, k, v = to_region(self.tp, q, k, v)
        cast = {}  # each distinct input cast once (self-attention passes one)
        for x in (q, k, v):
            if id(x) not in cast:
                cast[id(x)] = x.to(self.q_proj.compute_dtype)
        q, k, v = cast[id(q)], cast[id(k)], cast[id(v)]
        qh = self.q_proj(q).reshape(b, tq, h, d_k)
        kh = self.k_proj(k).reshape(b, tk, h, d_k)
        vh = self.v_proj(v).reshape(b, tk, h, d_k)
        route = attention_route(
            qh.device.type, qh.dtype, tq, tk, d_k, has_mask=attn_mask is not None,
            dropout_active=self.training and self.dropout.p > 0, return_weights=return_weights)
        if route == "flash":  # (B, H, T, d) views: the kernel reads them by their strides
            context = attention.flash_attention(
                qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                1.0 / math.sqrt(d_k)).transpose(1, 2)
        elif route == "headpacked":
            context = attention.headpacked_attention(qh, kh, vh, 1.0 / math.sqrt(d_k))
        if route != "plain":
            return self.out_proj(context.reshape(b, tq, width))

        # (B, H, Tq, Tk) scores from f32 operands, f32 softmax; P in the
        # value dtype for PV with f32 accumulation.
        qh, kh, vh = (x.transpose(1, 2) for x in (qh, kh, vh))
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(d_k)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e9)
        attn = region_dropout(self.tp, self.dropout, torch.softmax(scores, dim=-1))
        context = torch.matmul(attn.to(vh.dtype).float(), vh.float()).to(vh.dtype)
        out = self.out_proj(context.transpose(1, 2).reshape(b, tq, width))
        return (out, attn) if return_weights else out


class FeedForward(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear -> Dropout; under tp on the
    rank's hidden units (module docstring)."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = Dense(d_model, d_ff, device=device, dtype=dtype)
        self.linear2 = Dense(d_ff, d_model, device=device, dtype=dtype)
        self.dropout = nn.Dropout(dropout)
        self.tp = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (x,) = to_region(self.tp, x)
        h = region_dropout(self.tp, self.dropout, torch.relu(self.linear1(x)))
        return self.dropout(self.linear2(h))


class TransformerEncoderBlock(nn.Module):
    """x = LN(x + drop(MHA(x))); x = LN(x + drop(FFN(x)))."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.0,
                 attn_dropout: float = 0.0, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mha = MultiHeadAttention(d_model, num_heads, attn_dropout, device=device, dtype=dtype)
        self.ln1 = LayerNorm(d_model, eps=1e-5, device=device)
        self.ffn = FeedForward(d_model, d_ff, dropout, device=device, dtype=dtype)
        self.ln2 = LayerNorm(d_model, eps=1e-5, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.ln1(x + self.dropout(self.mha(x, x, x, attn_mask)))
        return self.ln2(x + self.dropout(self.ffn(x)))


class TransformerEncoder(nn.Module):
    """Stack of encoder blocks + final LayerNorm."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0, attn_dropout: float = 0.0, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderBlock(d_model, num_heads, d_ff, dropout, attn_dropout,
                                    device=device, dtype=dtype)
            for _ in range(num_layers)
        ])
        self.norm = LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, attn_mask)
        return self.norm(x)


class TransformerDecoderBlock(nn.Module):
    """Post-LN decoder block: self-attention, cross-attention, FFN."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.0,
                 attn_dropout: float = 0.0, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_mha = MultiHeadAttention(d_model, num_heads, attn_dropout, device=device,
                                           dtype=dtype)
        self.ln1 = LayerNorm(d_model, eps=1e-5, device=device)
        self.cross_mha = MultiHeadAttention(d_model, num_heads, attn_dropout, device=device,
                                            dtype=dtype)
        self.ln2 = LayerNorm(d_model, eps=1e-5, device=device)
        self.ffn = FeedForward(d_model, d_ff, dropout, device=device, dtype=dtype)
        self.ln3 = LayerNorm(d_model, eps=1e-5, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_attn_mask: torch.Tensor | None = None,
                cross_attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.ln1(x + self.dropout(self.self_mha(x, x, x, self_attn_mask)))
        x = self.ln2(x + self.dropout(self.cross_mha(x, memory, memory, cross_attn_mask)))
        return self.ln3(x + self.dropout(self.ffn(x)))


class TransformerDecoder(nn.Module):
    """Stack of decoder blocks + final LayerNorm."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0, attn_dropout: float = 0.0, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderBlock(d_model, num_heads, d_ff, dropout, attn_dropout,
                                    device=device, dtype=dtype)
            for _ in range(num_layers)
        ])
        self.norm = LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_attn_mask: torch.Tensor | None = None,
                cross_attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, memory, self_attn_mask, cross_attn_mask)
        return self.norm(x)


def sinusoidal_position_table(max_len: int, d_model: int) -> np.ndarray:
    """Fixed sin/cos table, float32, as the JAX package computes it."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class PositionalEmbedding(nn.Module):
    """Adds sinusoidal or learned positions to (B, T, d).

    'learned' holds an nn.Embedding ``pos_embed``, as the reference;
    'sinusoidal' a fixed table ``pe``, a non-persistent buffer, so it is
    neither in the state_dict nor expected by a strict load.
    """

    def __init__(self, max_len: int, d_model: int, mode: str = "sinusoidal", *,
                 device: torch.device):
        super().__init__()
        self.mode = mode
        if mode == "learned":
            self.pos_embed = nn.Embedding(max_len, d_model, device=device)
        elif mode == "sinusoidal":
            self.register_buffer(
                "pe", torch.from_numpy(sinusoidal_position_table(max_len, d_model)).to(device),
                persistent=False)
        else:
            raise ValueError(f"Unsupported pos_mode: {mode}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = self.pos_embed.weight if self.mode == "learned" else self.pe
        return x + table[: x.shape[1]][None].to(x.dtype)


def _fill(param: torch.Tensor, draw) -> None:
    """Draw on the CPU and copy in, so a seed gives the same weights on any device."""
    with torch.no_grad():
        param.copy_(draw(torch.empty(param.shape, dtype=param.dtype)))


def lecun_normal_(param: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: normal truncated at two std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    _fill(param, lambda t: nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                                 generator=generator))


def normal_(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    _fill(param, lambda t: nn.init.normal_(t, 0.0, std, generator=generator))


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every Linear, Conv, Embedding and norm in ``module`` as the
    JAX package's Flax modules do, from a CPU ``generator``: kernels
    lecun-normal, biases zero, norms one and zero, embeddings normal(1)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0, generator)
        elif isinstance(m, (nn.LayerNorm, nn.InstanceNorm1d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
