"""Transformer pieces shared by the references, on a flat parameter dict.

Post-LN blocks as published: x = LN(x + MHA(x)), x = LN(x + FFN(x)),
LayerNorm eps 1e-5, a ReLU feed-forward, scaled dot-product attention with
the softmax over keys.  Parameter names are the state_dict names of the
reference torch models (``encoder.layers.0.mha.q_proj.weight``, ...), which
is also how the benchmark hands the same weights to the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand


def dense(p: dict, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    return F.linear(operand(x, precision), operand(p[f"{name}.weight"], precision),
                    p[f"{name}.bias"])


def layer_norm(p: dict, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def attention(p: dict, name: str, q_in, kv_in, heads: int, precision: str) -> torch.Tensor:
    b, tq, d = q_in.shape
    tk = kv_in.shape[1]
    dk = d // heads

    def split(x, t):
        return x.reshape(b, t, heads, dk).transpose(1, 2)

    q = split(dense(p, f"{name}.q_proj", q_in, precision), tq)
    k = split(dense(p, f"{name}.k_proj", kv_in, precision), tk)
    v = split(dense(p, f"{name}.v_proj", kv_in, precision), tk)
    scores = operand(q, precision) @ operand(k, precision).transpose(-1, -2) / math.sqrt(dk)
    weights = torch.softmax(scores, dim=-1)
    context = (operand(weights, precision) @ operand(v, precision)).transpose(1, 2)
    return dense(p, f"{name}.out_proj", context.reshape(b, tq, d), precision)


def feed_forward(p: dict, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    return dense(p, f"{name}.linear2", torch.relu(dense(p, f"{name}.linear1", x, precision)),
                 precision)


def encoder(p: dict, name: str, x: torch.Tensor, layers: int, heads: int,
            precision: str) -> torch.Tensor:
    for i in range(layers):
        blk = f"{name}.layers.{i}"
        x = layer_norm(p, f"{blk}.ln1", x + attention(p, f"{blk}.mha", x, x, heads, precision))
        x = layer_norm(p, f"{blk}.ln2", x + feed_forward(p, f"{blk}.ffn", x, precision))
    return layer_norm(p, f"{name}.norm", x)


def decoder(p: dict, name: str, x: torch.Tensor, memory: torch.Tensor, layers: int,
            heads: int, precision: str) -> torch.Tensor:
    for i in range(layers):
        blk = f"{name}.layers.{i}"
        x = layer_norm(p, f"{blk}.ln1",
                       x + attention(p, f"{blk}.self_mha", x, x, heads, precision))
        x = layer_norm(p, f"{blk}.ln2",
                       x + attention(p, f"{blk}.cross_mha", x, memory, heads, precision))
        x = layer_norm(p, f"{blk}.ln3", x + feed_forward(p, f"{blk}.ffn", x, precision))
    return layer_norm(p, f"{name}.norm", x)


def encoder_shapes(name: str, d: int, d_ff: int, layers: int) -> list:
    """(name, shape, init) of an encoder stack's parameters."""
    out = []
    for i in range(layers):
        blk = f"{name}.layers.{i}"
        out += attention_shapes(f"{blk}.mha", d)
        out += norm_shapes(f"{blk}.ln1", d) + ffn_shapes(f"{blk}.ffn", d, d_ff)
        out += norm_shapes(f"{blk}.ln2", d)
    return out + norm_shapes(f"{name}.norm", d)


def decoder_shapes(name: str, d: int, d_ff: int, layers: int) -> list:
    out = []
    for i in range(layers):
        blk = f"{name}.layers.{i}"
        out += attention_shapes(f"{blk}.self_mha", d) + norm_shapes(f"{blk}.ln1", d)
        out += attention_shapes(f"{blk}.cross_mha", d) + norm_shapes(f"{blk}.ln2", d)
        out += ffn_shapes(f"{blk}.ffn", d, d_ff) + norm_shapes(f"{blk}.ln3", d)
    return out + norm_shapes(f"{name}.norm", d)


def dense_shapes(name: str, d_in: int, d_out: int) -> list:
    return [(f"{name}.weight", (d_out, d_in), "fan_in"), (f"{name}.bias", (d_out,), "bias")]


def attention_shapes(name: str, d: int) -> list:
    return [s for proj in ("q_proj", "k_proj", "v_proj", "out_proj")
            for s in dense_shapes(f"{name}.{proj}", d, d)]


def ffn_shapes(name: str, d: int, d_ff: int) -> list:
    return dense_shapes(f"{name}.linear1", d, d_ff) + dense_shapes(f"{name}.linear2", d_ff, d)


def norm_shapes(name: str, d: int) -> list:
    return [(f"{name}.weight", (d,), "norm_weight"), (f"{name}.bias", (d,), "bias")]
