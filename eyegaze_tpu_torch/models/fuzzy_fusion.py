"""FuzzyGatingFusion: uncertainty-aware fuzzy gating of two modalities'
logits.

The port of ``eyegaze_tpu/models/fuzzy_fusion.py`` (the reference's
``fuzzy_gating_fusion.py:23-428``), elementwise on (B, num_classes) logits:

1. temperature scaling, T = softplus(tau) + 0.1, learned per modality
   (initial T_img 1.5, T_eeg 1.0);
2. the Shannon entropy of each modality's scaled softmax;
3. Gaussian memberships "reliable" (centre 0) and "unreliable" (learned
   centre) of each entropy, learned log-widths;
4. four rules, product T-norm: img reliable & EEG unreliable, the reverse,
   both reliable, both unreliable;
5. alpha = the firing-strength-weighted mean of sigmoid(beta), clipped to
   [0, 1];
6. fused = alpha z_img + (1 - alpha) z_eeg.

Modes: 'full', 'no_temperature' (T = 1), 'no_fuzzification' (alpha from
normalized confidences, no rules) and 'fixed_weights' (T = 1, alpha 0.5).
The parameters are the reference's names (``tau_img``, ``tau_eeg``,
``c_unreliable_{img,eeg}``, ``log_sigma_{reliable,unreliable}_{img,eeg}``,
``beta``), float32 scalars and one (4,) vector; the reliable centre is the
constant 0 and no buffer, so the exported state_dict loads with
``strict=True``.  ``aux_info`` holds detached copies, as JAX's
``stop_gradient`` does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

VALID_MODES = ("full", "no_temperature", "no_fuzzification", "fixed_weights")
PARAM_NAMES = (
    "tau_img", "tau_eeg", "c_unreliable_img", "c_unreliable_eeg",
    "log_sigma_reliable_img", "log_sigma_reliable_eeg",
    "log_sigma_unreliable_img", "log_sigma_unreliable_eeg", "beta",
)


def inverse_softplus(x: float) -> float:
    """log(exp(x) - 1), the inverse of softplus."""
    if x <= 0:
        raise ValueError("inverse_softplus requires x > 0")
    return math.log(math.expm1(x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _entropy(logits: torch.Tensor, eps: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return -(probs * torch.log(probs + eps)).sum(dim=-1)


class FuzzyGatingFusion(nn.Module):
    def __init__(self, num_classes: int = 3, mode: str = "full", eps_temp: float = 0.1,
                 eps_log: float = 1e-8, eps_div: float = 1e-8, *, device: torch.device):
        super().__init__()
        if mode not in VALID_MODES:
            raise ValueError(f"Invalid mode {mode!r}; must be one of {VALID_MODES}")
        self.num_classes, self.mode = num_classes, mode
        self.eps_temp, self.eps_log, self.eps_div = eps_temp, eps_log, eps_div
        self.max_entropy = math.log(num_classes)
        log_sigma = math.log(self.max_entropy * 0.3)
        init = {
            "tau_img": inverse_softplus(1.5 - eps_temp),
            "tau_eeg": inverse_softplus(1.0 - eps_temp),
            "c_unreliable_img": self.max_entropy * 0.8,
            "c_unreliable_eeg": self.max_entropy * 0.8,
            "log_sigma_reliable_img": log_sigma,
            "log_sigma_reliable_eeg": log_sigma,
            "log_sigma_unreliable_img": log_sigma,
            "log_sigma_unreliable_eeg": log_sigma,
            # Rule consequents: R1 favours img (0.8), R2 EEG (0.2), R3 slightly
            # img (0.6), R4 neither (0.5).
            "beta": [math.log(0.8 / 0.2), math.log(0.2 / 0.8), math.log(0.6 / 0.4), 0.0],
        }
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(
                torch.tensor(init[name], dtype=torch.float32, device=device)))

    @property
    def temp_img(self) -> torch.Tensor:
        return _softplus(self.tau_img) + self.eps_temp

    @property
    def temp_eeg(self) -> torch.Tensor:
        return _softplus(self.tau_eeg) + self.eps_temp

    def _gaussian_membership(self, x, center, log_sigma):
        sigma = torch.exp(log_sigma)
        return torch.exp(-((x - center) ** 2) / (2 * sigma ** 2 + self.eps_div))

    def forward(self, img_logits: torch.Tensor, eeg_logits: torch.Tensor):
        """(B, C) logits of each modality -> (fused (B, C), alpha (B,), aux_info)."""
        b = img_logits.shape[0]
        dev = img_logits.device
        aux = {}
        if self.mode in ("no_temperature", "fixed_weights"):
            t_img = t_eeg = torch.ones((), device=dev)
            z_img, z_eeg = img_logits, eeg_logits
        else:
            t_img, t_eeg = self.temp_img, self.temp_eeg
            z_img, z_eeg = img_logits / t_img, eeg_logits / t_eeg
        aux["temperatures"] = {"img": t_img.detach(), "eeg": t_eeg.detach()}

        h_img = _entropy(z_img, self.eps_log)
        h_eeg = _entropy(z_eeg, self.eps_log)
        aux["entropies"] = {"img": h_img.detach(), "eeg": h_eeg.detach()}

        aux["membership"] = aux["firing_strengths"] = aux["consequents"] = None
        if self.mode == "fixed_weights":
            alpha = torch.full((b,), 0.5, device=dev)
        elif self.mode == "no_fuzzification":
            conf_img = torch.clip(1.0 - h_img / (self.max_entropy + self.eps_div), min=0.0)
            conf_eeg = torch.clip(1.0 - h_eeg / (self.max_entropy + self.eps_div), min=0.0)
            alpha = torch.clip(conf_img / (conf_img + conf_eeg + self.eps_div), 0.0, 1.0)
        else:
            mu_img_rel = self._gaussian_membership(h_img, 0.0, self.log_sigma_reliable_img)
            mu_img_unrel = self._gaussian_membership(h_img, self.c_unreliable_img,
                                                     self.log_sigma_unreliable_img)
            mu_eeg_rel = self._gaussian_membership(h_eeg, 0.0, self.log_sigma_reliable_eeg)
            mu_eeg_unrel = self._gaussian_membership(h_eeg, self.c_unreliable_eeg,
                                                     self.log_sigma_unreliable_eeg)
            aux["membership"] = {
                "img": {"rel": mu_img_rel.detach(), "unrel": mu_img_unrel.detach()},
                "eeg": {"rel": mu_eeg_rel.detach(), "unrel": mu_eeg_unrel.detach()},
            }
            w = torch.stack([
                mu_img_rel * mu_eeg_unrel,    # R1: img reliable, EEG unreliable
                mu_img_unrel * mu_eeg_rel,    # R2: img unreliable, EEG reliable
                mu_img_rel * mu_eeg_rel,      # R3: both reliable
                mu_img_unrel * mu_eeg_unrel,  # R4: both unreliable
            ], dim=-1)
            consequents = torch.sigmoid(self.beta)
            aux["firing_strengths"] = w.detach()
            aux["consequents"] = consequents.detach()
            alpha = (w * consequents).sum(dim=-1) / (w.sum(dim=-1) + self.eps_div)
            alpha = torch.clip(alpha, 0.0, 1.0)

        aux["fuzz_params"] = {
            "c_unreliable": {"img": self.c_unreliable_img.detach(),
                             "eeg": self.c_unreliable_eeg.detach()},
            "sigma_reliable": {"img": torch.exp(self.log_sigma_reliable_img).detach(),
                               "eeg": torch.exp(self.log_sigma_reliable_eeg).detach()},
            "sigma_unreliable": {"img": torch.exp(self.log_sigma_unreliable_img).detach(),
                                 "eeg": torch.exp(self.log_sigma_unreliable_eeg).detach()},
        }
        fused = alpha[:, None] * z_img + (1.0 - alpha[:, None]) * z_eeg
        return fused, alpha, aux

    def temperature_regularization(self, t_min: float = 0.5, t_max: float = 5.0):
        """ReLU range penalty on both temperatures (fuzzy_gating_fusion.py:392-419)."""
        t_img, t_eeg = self.temp_img, self.temp_eeg
        return (torch.relu(t_img - t_max) + torch.relu(t_min - t_img)
                + torch.relu(t_eeg - t_max) + torch.relu(t_min - t_eeg))
