"""Post-LN transformer encoder stack and parameter initialisation.

Port of the encoder half of ``eyegaze_tpu/models/transformer.py``:
multi-head attention as matmul, float32 softmax, matmul; a ReLU feed-forward;
post-LayerNorm residual blocks with eps 1e-5; a learned positional table.
Parameter names follow the reference torch model, so state_dicts written by
``eyegaze_tpu_torch.models.convert`` load with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention with q/k/v/out projections (no mask)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, *,
                 device: torch.device):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model, device=device)
        self.k_proj = nn.Linear(d_model, d_model, device=device)
        self.v_proj = nn.Linear(d_model, d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)
        self.dropout = nn.Dropout(dropout)  # on the softmax weights, as the reference

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, tq, d_model = q.shape
        tk = k.shape[1]
        h = self.num_heads
        d_k = d_model // h
        qh = self.q_proj(q).reshape(b, tq, h, d_k).transpose(1, 2)  # (B, H, Tq, d)
        kh = self.k_proj(k).reshape(b, tk, h, d_k).transpose(1, 2)
        vh = self.v_proj(v).reshape(b, tk, h, d_k).transpose(1, 2)
        scores = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(d_k)
        attn = self.dropout(torch.softmax(scores, dim=-1))
        context = torch.matmul(attn.to(vh.dtype), vh)  # (B, H, Tq, d)
        return self.out_proj(context.transpose(1, 2).reshape(b, tq, d_model))


class FeedForward(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear -> Dropout."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0, *,
                 device: torch.device):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ff, device=device)
        self.linear2 = nn.Linear(d_ff, d_model, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(torch.relu(self.linear1(x)))
        return self.dropout(self.linear2(h))


class TransformerEncoderBlock(nn.Module):
    """x = LN(x + drop(MHA(x))); x = LN(x + drop(FFN(x)))."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.0,
                 attn_dropout: float = 0.0, *, device: torch.device):
        super().__init__()
        self.mha = MultiHeadAttention(d_model, num_heads, attn_dropout, device=device)
        self.ln1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.ffn = FeedForward(d_model, d_ff, dropout, device=device)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.dropout(self.mha(x, x, x)))
        return self.ln2(x + self.dropout(self.ffn(x)))


class TransformerEncoder(nn.Module):
    """Stack of encoder blocks + final LayerNorm."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0, attn_dropout: float = 0.0, *, device: torch.device):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderBlock(d_model, num_heads, d_ff, dropout, attn_dropout,
                                    device=device)
            for _ in range(num_layers)
        ])
        self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class PositionalEmbedding(nn.Module):
    """Adds a learned positional table (an nn.Embedding, as the reference)."""

    def __init__(self, max_len: int, d_model: int, *, device: torch.device):
        super().__init__()
        self.pos_embed = nn.Embedding(max_len, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pos_embed.weight[: x.shape[1]][None].to(x.dtype)


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
