"""Global-norm clipping and AdamW, written out.

Clip: g * min(1, max_norm / ||g||), the norm over every parameter, in the
form ``g`` below the limit and ``g / norm * max_norm`` at or above it.
AdamW (decoupled weight decay, as published by Loshchilov and Hutter, and as
torch.optim.AdamW applies it): p <- p (1 - lr wd), then the Adam step
lr * m_hat / (sqrt(v_hat) + eps) with bias-corrected moments, betas
(0.9, 0.999), eps 1e-8.
"""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params: dict, lr: float, weight_decay: float, max_norm: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.max_norm, self.betas, self.eps = lr, weight_decay, max_norm, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = self.max_norm / norm if norm >= self.max_norm else 1.0
        clipped = {k: g * scale for k, g in grads.items()}
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = clipped[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return clipped
