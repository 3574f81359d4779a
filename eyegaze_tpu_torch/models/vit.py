"""Vision Transformer (ViT-B/16 by default) and the early- and late-fusion
gaze-pair models, in PyTorch.

Port of ``eyegaze_tpu/models/vit.py``: a pre-norm ViT (patch-embed conv, CLS
token, learned positions, ``depth`` x [LN -> MHA -> residual, LN -> exact-GELU
MLP -> residual], final LN, LayerNorm eps 1e-6), ``EarlyFusionViT`` (the pair
fused at the input, 6 channels for 'concat') and ``LateFusionViT`` (one
shared encoder, the two CLS features fused before the classifier).  Names are
timm's ``vit_base_patch16_224`` (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.i.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
``norm``, ``head``), under ``backbone.`` (early) or ``encoder.`` plus
``classifier`` (late), so the state_dicts of
``convert.gaze_{early,late}_state_dict_from_flax`` and of the JAX exporter
load with ``strict=True``.  ``load_timm_state_dict`` copies a timm-named
state_dict (such as pretrained ViT-B/16 weights from a local file) into a
``VisionTransformer``.

``dtype`` is the Flax modules' compute type (the JAX ``GazePredictor.
from_checkpoint`` serves bfloat16).  Parameters stay float32; the patch
embed, every Dense, the CLS token and the positions compute in ``dtype``;
each LayerNorm runs in float32 and returns float32 (Flax's with float32
parameters), and the residual stream stays in ``dtype``.  The attention is
Flax's ``dot_product_attention`` (``dot_product_attention`` here), not the
package's ``MultiHeadAttention``: q is divided by sqrt(head dim) in
``dtype`` before the product, and the scores, the softmax and the weights
are in ``dtype``, so in bf16 each is rounded to bf16
(``force_fp32_for_softmax`` is off); in training, dropout falls on those
weights as Flax's ``broadcast_dropout`` drops them: one keep-mask of shape
(1, 1, Tq, Tk) per call, shared by every batch row and head.  Its 197
tokens go to no attention kernel.  Outputs are float32.

Under tensor parallelism (``parallel/tensor.py``) ``Attention`` runs the
rank's heads (its fused ``qkv`` holds their rows in each of the q, k and v
thirds) and ``Mlp`` the rank's hidden units.  The broadcast dropout mask is
shared by every head, so every tp rank draws the same one from the default
generator, as one process does; the MLP's hidden dropout draws the rank's
slice from the region's generator.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eyegaze_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    cast_params,
    init_weights_,
    normal_,
    region_dropout,
    to_region,
)

EARLY_FUSION_MODES = ("concat", "add", "subtract", "subtract_abs", "multiply")
LATE_FUSION_MODES = ("concat", "add", "subtract", "multiply", "full")


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` in the input's dtype: the max subtracted, exp,
    sum and division each rounded to that dtype."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dropout: float = 0.0) -> torch.Tensor:
    """Flax's ``dot_product_attention`` on (B, H, Tq, hd) queries and (B, H,
    Tk, hd) keys and values, all in the compute type: q divided by
    sqrt(hd) in that type, the scores and ``_softmax`` in it, then, where
    ``dropout`` > 0, the weights times ``keep / keep_prob`` (both in the
    compute type, so ``keep_prob`` 0.9 is 0.8984375 in bf16), ``keep`` one
    Bernoulli(``keep_prob``) mask of shape (1, 1, Tq, Tk) drawn from the
    device's default generator (``broadcast_dropout=True``); then the
    product with v.  Pass ``dropout`` 0 outside training."""
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(q.dtype)
    p = _softmax(torch.matmul(q, k.transpose(-1, -2)))  # (B, H, Tq, Tk)
    if dropout > 0.0:
        keep_prob = 1.0 - dropout
        keep = torch.rand(p.shape[-2:], device=p.device) < keep_prob
        p = p * (keep.to(p.dtype) / torch.tensor(keep_prob, dtype=p.dtype, device=p.device))
    return torch.matmul(p, v)


class PatchEmbed(nn.Module):
    """timm's patch embedding: ``proj``, a Conv2d(C, E, p, stride p), on
    (B, C, H, W) -> (B, N, E) patch tokens in row order, in ``dtype`` as
    ``Dense`` computes.  A stride equal to the kernel makes the conv one
    matrix product over the flattened patches, and it is computed so: the
    CPU's bf16 convolution returns wrong sums at this shape (6 channels,
    16 x 16, stride 16), and the product is what Flax's VALID conv sums."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size,
                              device=device)
        self.patch_size, self.dtype = patch_size, dtype
        self._cast = (None, None)  # cast_params' cache

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p  # VALID: a ragged edge is dropped
        patches = x[:, :, :gh * p, :gw * p].reshape(b, c, gh, p, gw, p)
        patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p)
        weight, bias = cast_params(self, (self.proj.weight.flatten(1), self.proj.bias),
                                   self.dtype)
        return F.linear(patches.to(self.dtype), weight, bias)


class Attention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` over one input, with timm's
    fused ``qkv`` and ``proj`` projections; ``dropout`` falls on the
    attention weights in training (``dot_product_attention``)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0, *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} is not divisible by num_heads {num_heads}")
        self.num_heads, self.head_dim, self.tp = num_heads, dim // num_heads, 1
        self.qkv = Dense(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = Dense(dim, dim, device=device, dtype=dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        (x,) = to_region(self.tp, x)
        h, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).reshape(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        o = dot_product_attention(q, k, v, self.dropout if self.training else 0.0)
        return self.proj(o.transpose(1, 2).reshape(b, t, h * hd))


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device, dtype=dtype)
        self.fc2 = Dense(hidden, dim, device=device, dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.tp = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (x,) = to_region(self.tp, x)
        h = self.fc1(x)
        # jax.nn.gelu(approximate=False) in the input's dtype, op by op.
        h = 0.5 * h * torch.erfc(-h * torch.tensor(math.sqrt(0.5), dtype=h.dtype))
        return self.drop(self.fc2(region_dropout(self.tp, self.drop, h)))


class Block(nn.Module):
    """Pre-norm block: x + MHA(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, dropout: float = 0.0,
                 *, device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = Attention(dim, num_heads, dropout, device=device, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """ViT backbone on (B, C, H, W) images; ``num_classes=0`` (or
    ``return_features``) returns the float32 CLS feature, else float32
    logits.  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``): kernels lecun-normal, biases zero, norms one and
    zero, ``cls_token`` zero, ``pos_embed`` normal(0.02), as Flax inits."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_channels: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_classes: int = 3, dropout: float = 0.0, *,
                 device: torch.device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.img_size, self.patch_size, self.in_channels = img_size, patch_size, in_channels
        self.embed_dim, self.num_classes, self.dtype = embed_dim, num_classes, dtype
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size, device=device,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim, device=device))
        self.pos_drop = nn.Dropout(dropout)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, dropout, device=device, dtype=dtype)
            for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, eps=1e-6, device=device)
        if num_classes > 0:
            self.head = Dense(embed_dim, num_classes, device=device, dtype=dtype)
        init_weights_(self, generator)
        normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                return_tokens: bool = False):
        """With ``return_tokens``, (output, tokens): the (B, 1 + P^2, E)
        tokens after the last block and before the final LayerNorm, the
        Grad-CAM target the JAX model sows (``last_block_tokens``), on the
        forward's path, so a gradient can be taken at them."""
        b = x.shape[0]
        h = self.patch_embed(x)  # (B, N, E)
        cls = self.cls_token.to(self.dtype).expand(b, -1, -1)
        h = self.pos_drop(torch.cat([cls, h], dim=1) + self.pos_embed.to(self.dtype))
        for block in self.blocks:
            h = block(h)
        cls_feat = self.norm(h[:, 0])  # the norm is per token: the CLS token's alone
        if return_features or self.num_classes == 0:
            out = cls_feat.float()
        else:
            out = self.head(cls_feat).float()
        return (out, h) if return_tokens else out


def fuse_images(img_a: torch.Tensor, img_b: torch.Tensor, mode: str) -> torch.Tensor:
    """Input-level fusion of two (B, 3, H, W) images; 'multiply' z-scores
    the product per image and channel (unbiased variance, eps 1e-6 on the
    std)."""
    if mode == "concat":
        return torch.cat([img_a, img_b], dim=1)
    if mode == "add":
        return (img_a + img_b) / 2.0
    if mode == "subtract":
        return (img_a - img_b) / 2.0
    if mode == "subtract_abs":
        return torch.abs(img_a - img_b)
    if mode == "multiply":
        prod = img_a * img_b
        flat = prod.reshape(*prod.shape[:2], -1)
        mean = flat.mean(dim=2, keepdim=True)
        var = ((flat - mean) ** 2).sum(dim=2, keepdim=True) / (flat.shape[2] - 1)
        return ((flat - mean) / (torch.sqrt(var) + 1e-6)).reshape(prod.shape)
    raise ValueError(f"fusion_mode must be one of {EARLY_FUSION_MODES}, got {mode!r}")


class EarlyFusionViT(nn.Module):
    """The pair fused at the input (``fuse_images``) -> one ViT
    (``backbone``, 6 input channels for 'concat')."""

    def __init__(self, num_classes: int = 3, img_size: int = 224, fusion_mode: str = "concat",
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 dropout: float = 0.0, *, device: torch.device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fusion_mode not in EARLY_FUSION_MODES:
            raise ValueError(f"bad fusion_mode {fusion_mode!r}")
        self.fusion_mode, self.img_size, self.dtype = fusion_mode, img_size, dtype
        self.backbone = VisionTransformer(
            img_size=img_size, in_channels=6 if fusion_mode == "concat" else 3,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads, num_classes=num_classes,
            dropout=dropout, device=device, generator=generator, dtype=dtype)

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor, return_features: bool = False,
                return_tokens: bool = False):
        """``return_tokens``: (output, the backbone's last-block tokens), as
        ``VisionTransformer.forward``."""
        return self.backbone(fuse_images(img_a, img_b, self.fusion_mode), return_features,
                             return_tokens)


class LateFusionViT(nn.Module):
    """One shared ViT encoder (``encoder``, no head) on each image, the two
    CLS features fused ('full' = [c1, c2, c1 - c2, c1 * c2]) -> dropout ->
    ``classifier``."""

    def __init__(self, num_classes: int = 3, img_size: int = 224, fusion_mode: str = "full",
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 dropout: float = 0.1, *, device: torch.device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fusion_mode not in LATE_FUSION_MODES:
            raise ValueError(f"fusion_mode must be one of {LATE_FUSION_MODES}")
        self.fusion_mode, self.img_size, self.dtype = fusion_mode, img_size, dtype
        self.encoder = VisionTransformer(img_size=img_size, embed_dim=embed_dim, depth=depth,
                                         num_heads=num_heads, num_classes=0, device=device,
                                         generator=generator, dtype=dtype)
        width = {"concat": 2, "full": 4}.get(fusion_mode, 1) * embed_dim
        self.drop = nn.Dropout(dropout)
        self.classifier = Dense(width, num_classes, device=device, dtype=dtype)
        init_weights_(self.classifier, generator)

    def _fuse(self, cls1: torch.Tensor, cls2: torch.Tensor) -> torch.Tensor:
        if self.fusion_mode == "concat":
            return torch.cat([cls1, cls2], dim=1)
        if self.fusion_mode == "add":
            return cls1 + cls2
        if self.fusion_mode == "subtract":
            return cls1 - cls2
        if self.fusion_mode == "multiply":
            return cls1 * cls2
        return torch.cat([cls1, cls2, cls1 - cls2, cls1 * cls2], dim=1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, return_features: bool = False):
        cls1, cls2 = self.encoder(x1), self.encoder(x2)
        fused = self._fuse(cls1, cls2)
        if return_features:
            return {"cls1": cls1, "cls2": cls2, "fused": fused}
        return self.classifier(self.drop(fused)).float()


def load_timm_state_dict(vit: VisionTransformer, state: Mapping[str, np.ndarray],
                         weight_init_strategy: str = "duplicate") -> None:
    """Copies a timm ``vit_base_patch16_224`` state_dict (timm names -> numpy
    arrays, such as the ``.npz`` that ``scripts/export_timm_weights.py``
    writes) into ``vit`` in place: the counterpart of the JAX
    ``load_timm_state_dict``.

    Every parameter of ``vit`` but the head must be in ``state`` with its
    shape, with one exception: a 3-channel patch kernel going into a
    6-channel patch embed (early fusion's 'concat') is widened by the
    reference's rule (early_fusion_vit.py:133-146), 'duplicate' copying the
    RGB kernel into both halves, 'average' filling the second half with its
    channel mean.  The head is copied only where ``state`` has one of
    ``vit``'s shape.  Other keys of ``state`` are ignored.
    """
    if weight_init_strategy not in ("duplicate", "average"):
        raise ValueError(f"weight_init_strategy must be 'duplicate' or 'average', "
                         f"got {weight_init_strategy!r}")
    own = vit.state_dict()
    new = {}
    for k, target in own.items():
        if k.startswith("head."):
            continue
        if k not in state:
            raise KeyError(f"the timm state_dict has no {k!r}")
        v = np.asarray(state[k], np.float32)
        if k == "patch_embed.proj.weight" and target.shape[1] == 6 and v.shape[1] == 3:
            widened = np.zeros(tuple(target.shape), np.float32)
            widened[:, :3] = v
            widened[:, 3:] = v if weight_init_strategy == "duplicate" else v.mean(
                axis=1, keepdims=True)
            v = widened
        if v.shape != tuple(target.shape):
            raise ValueError(f"{k}: the model has shape {tuple(target.shape)}, the timm "
                             f"state_dict {v.shape}")
        new[k] = v
    head = ("head.weight", "head.bias")
    if all(k in own and k in state and np.shape(state[k]) == tuple(own[k].shape) for k in head):
        new.update({k: np.asarray(state[k], np.float32) for k in head})
    with torch.no_grad():
        for k, v in new.items():
            own[k].copy_(torch.from_numpy(v))
