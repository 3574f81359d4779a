"""Loss functions, in the JAX package's forms.

Port of ``eyegaze_tpu/train/losses.py`` (all parity-matched to the
reference trainers):

- cross entropy (+ class-weighted variant, train_gaze_earlyfusion.py:395-400),
- symmetry MSE (dual_eeg_transformer.py:1255-1260),
- InfoNCE IBS alignment (:1262-1304),
- supervised contrastive on IBS tokens (:1306-1371).

The small constants are the JAX package's: ``_l2norm``'s floor 1e-12, the
contrastive loss's two 1e-8 terms and its guard for rows with no positive.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _nll(logits, labels).mean()


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """torch F.cross_entropy(weight=...) parity: weighted mean with weight
    normalization sum(w_y)."""
    w = class_weights[labels.long()]
    return (w * _nll(logits, labels)).sum() / w.sum()


def symmetry_loss(cls1: torch.Tensor, cls2: torch.Tensor) -> torch.Tensor:
    """MSE between the two players' CLS representations."""
    return ((cls1 - cls2) ** 2).mean()


def _l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def ibs_alignment_loss(ibs_token: torch.Tensor, cls1: torch.Tensor, cls2: torch.Tensor,
                       temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE: each IBS token's positive is its own cls1 among all 2B cls
    tokens (dual_eeg_transformer.py:1262-1304 'simplified' variant)."""
    ibs_n = _l2norm(ibs_token)
    all_cls = torch.cat([_l2norm(cls1), _l2norm(cls2)], dim=0)  # (2B, d)
    sim = (ibs_n @ all_cls.T) / temperature  # (B, 2B)
    return cross_entropy(sim, torch.arange(ibs_token.shape[0], device=ibs_token.device))


def ibs_contrastive_loss(ibs_tokens: torch.Tensor, labels: torch.Tensor,
                         temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss on normalized IBS tokens
    (dual_eeg_transformer.py:1306-1371): -log(sum_pos exp(sim) / sum_all
    exp(sim)), averaged over samples that have >=1 positive; 0 when none has."""
    b = ibs_tokens.shape[0]
    z = _l2norm(ibs_tokens)
    sim = (z @ z.T) / temperature
    same = (labels[:, None] == labels[None, :]).to(sim.dtype)
    off_diag = 1.0 - torch.eye(b, dtype=sim.dtype, device=sim.device)
    pos_mask = same * off_diag
    exp_sim = torch.exp(sim) * off_diag
    pos_sim = (exp_sim * pos_mask).sum(dim=1)
    all_sim = exp_sim.sum(dim=1)
    loss = -torch.log(pos_sim / (all_sim + 1e-8) + 1e-8)
    has_pos = pos_mask.sum(dim=1) > 0
    denom = has_pos.sum().clamp_min(1)
    mean = torch.where(has_pos, loss, torch.zeros_like(loss)).sum() / denom
    return torch.where(has_pos.any(), mean, torch.zeros_like(mean))
