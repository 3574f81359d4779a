"""Plain float32 reference of the DualEEGTransformer and its training loss.

The published architecture (Siamese EEG transformer with inter-brain
synchrony tokens) on a flat parameter dict named as the reference torch
model's state_dict.  Each stream's tokens are [CLS | 42 IBS | one spectrogram
token per channel | strided-conv tokens] plus learned positions, through a
post-LN encoder shared by both streams, then bidirectional cross-attention
with shared weights and a LayerNorm, then symmetric fusion and the two
classifiers.  The connectivity features are written out from their
definitions: for six bands (broadband, delta, theta, alpha, beta, gamma)
an FFT-mask bandpass with inclusive edges and its FFT-Hilbert quadrature,
then per channel pair PLV, PLI, wPLI, coherence, band-power and band-signal
Pearson correlations, and the mean absolute raw phase difference.

Definitions kept as the model defines them: the phase difference is not
wrapped; coherence is mean over all rfft bins of the band mask times
P1 P2 / (P1 P2 + eps); the correlations divide the sum of z-score products
by T, with the unbiased std plus eps in the z-scores; wPLI weights are
(p1_i + p2_j) / 2 with the separable denominator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import layers
from portbench.reference.layers import dense, layer_norm
from portbench.reference.precision import operand

BANDS_6 = ((0.5, 45.0), (0.5, 4.0), (4.0, 8.0), (8.0, 13.0), (13.0, 30.0), (30.0, 45.0))
EPS = 1e-8


def param_shapes(cfg: dict) -> list:
    """(name, shape, init) of every parameter, in a fixed order."""
    c, d, dff = cfg["in_channels"], cfg["d_model"], cfg["d_ff"]
    k, nb, nf = cfg["conv_kernel_size"], len(BANDS_6), 7
    out = [("cls_token", (1, 1, d), "normal")]
    for i in range(cfg["conv_layers"]):
        out += [(f"temporal_conv.convs.{i}.weight", (d, c if i == 0 else d, k), "fan_in"),
                (f"temporal_conv.convs.{i}.bias", (d,), "bias")]
    out += [("ibs_tokenizer.type_embedding", (1, nb * nf, d), "small"),
            ("ibs_tokenizer.instance_norm.weight", (c * c,), "norm_weight"),
            ("ibs_tokenizer.instance_norm.bias", (c * c,), "bias")]
    out += layers.dense_shapes("ibs_tokenizer.bottleneck.0", c * c, 64)
    out += layers.dense_shapes("ibs_tokenizer.bottleneck.3", 64, d)
    out += [("spectrogram_generator.spec_conv.0.weight", (32, 1, 3, 3), "fan_in"),
            ("spectrogram_generator.spec_conv.0.bias", (32,), "bias"),
            ("spectrogram_generator.spec_conv.3.weight", (64, 32, 3, 3), "fan_in"),
            ("spectrogram_generator.spec_conv.3.bias", (64,), "bias")]
    out += layers.dense_shapes("spectrogram_generator.proj.0", 64 * 4 * 4, 2 * d)
    out += layers.dense_shapes("spectrogram_generator.proj.3", 2 * d, d)
    out += [("pos_embed.pos_embed.weight", (cfg["max_len"], d), "normal")]
    out += layers.encoder_shapes("encoder", d, dff, cfg["num_layers"])
    out += layers.attention_shapes("cross_attn.cross_attn", d)
    out += layers.norm_shapes("cross_attn.norm", d)
    out += layers.dense_shapes("symmetric_fusion.proj", 3 * d, d)
    out += layers.dense_shapes("classifier.0", 3 * d, d)
    out += layers.dense_shapes("classifier.3", d, cfg["num_classes"])
    out += layers.dense_shapes("ibs_classifier.0", d, d // 2)
    out += layers.dense_shapes("ibs_classifier.3", d // 2, cfg["num_classes"])
    return out


# -- connectivity -------------------------------------------------------------

def _band_masks(t: int, fs: float, device) -> tuple:
    freqs = np.fft.rfftfreq(t, d=1.0 / fs)
    masks = np.stack([(freqs >= lo) & (freqs <= hi) for lo, hi in BANDS_6]).astype(np.float32)
    interior = np.ones_like(freqs, dtype=np.float32)
    interior[0] = 0.0
    if t % 2 == 0:
        interior[-1] = 0.0
    return (torch.as_tensor(masks, device=device),
            torch.as_tensor(masks * interior, device=device))


def _zscore_rows(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    std = ((x - mean) ** 2).sum(-1, keepdim=True).div(x.shape[-1] - 1).sqrt()
    return (x - mean) / (std + EPS)


def connectivity(eeg1: torch.Tensor, eeg2: torch.Tensor, fs: float,
                 pair_rows: int = 4) -> torch.Tensor:
    """(B, C, T) pairs -> (B, 6 bands, 7 features, C, C) float32.

    Features in the order PLV, PLI, wPLI, Coherence, Power_Corr, Phase_Diff,
    Time_Corr.  The pairwise sums over time run ``pair_rows`` channels of
    player 1 at a time, so memory holds (B, 6, pair_rows, C, T)."""
    b, c, t = eeg1.shape
    masks, qmasks = _band_masks(t, fs, eeg1.device)
    spec1, spec2 = torch.fft.rfft(eeg1, dim=-1), torch.fft.rfft(eeg2, dim=-1)
    pw1, pw2 = spec1.abs() ** 2, spec2.abs() ** 2  # (B, C, F)
    coh = torch.empty(b, len(BANDS_6), c, c, device=eeg1.device)
    for i in range(0, c, pair_rows):
        prod = pw1[:, i:i + pair_rows, None, :] * pw2[:, None, :, :]  # (B, r, C, F)
        ratio = prod / (prod + EPS)
        coh[:, :, i:i + pair_rows] = torch.einsum("brcf,nf->bnrc", ratio, masks) / masks.shape[1]

    def analytic(spec):  # (B, 6, C, T) band signal and its quadrature
        band = torch.fft.irfft(spec[:, None] * masks[None, :, None], n=t, dim=-1)
        quad = torch.fft.irfft(spec[:, None] * qmasks[None, :, None] * (-1j), n=t, dim=-1)
        return band, quad

    band1, quad1 = analytic(spec1)
    band2, quad2 = analytic(spec2)
    ph1, ph2 = torch.atan2(quad1, band1), torch.atan2(quad2, band2)
    p1, p2 = band1 ** 2, band2 ** 2
    e1 = torch.polar(torch.ones_like(ph1), ph1)
    e2 = torch.polar(torch.ones_like(ph2), ph2)
    plv = (e1 @ e2.conj().transpose(-1, -2)).abs() / t  # |mean_t exp(i(phi1_i - phi2_j))|
    pli = torch.empty(b, len(BANDS_6), c, c, device=eeg1.device)
    wpli, pdiff = torch.empty_like(pli), torch.empty_like(pli)
    for i in range(0, c, pair_rows):
        dphi = ph1[:, :, i:i + pair_rows, None, :] - ph2[:, :, None, :, :]
        sgn = torch.sign(dphi)
        w = (p1[:, :, i:i + pair_rows, None, :] + p2[:, :, None, :, :]) * 0.5
        pli[:, :, i:i + pair_rows] = sgn.mean(-1).abs()
        wpli[:, :, i:i + pair_rows] = ((sgn * w).sum(-1) / (w.sum(-1) + EPS)).abs()
        pdiff[:, :, i:i + pair_rows] = dphi.abs().mean(-1)
        del dphi, sgn, w
    pcorr = _zscore_rows(p1) @ _zscore_rows(p2).transpose(-1, -2) / t
    tcorr = _zscore_rows(band1) @ _zscore_rows(band2).transpose(-1, -2) / t
    return torch.stack([plv, pli, wpli, coh, pcorr, pdiff, tcorr], dim=2)


# -- token generators -----------------------------------------------------------

def _conv_tokens(p: dict, x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    h = x
    k, s = cfg["conv_kernel_size"], cfg["conv_stride"]
    for i in range(cfg["conv_layers"]):
        w = p[f"temporal_conv.convs.{i}.weight"]
        h = torch.relu(F.conv1d(operand(h, precision), operand(w, precision),
                                p[f"temporal_conv.convs.{i}.bias"], stride=s, padding=k // 2))
    return h.transpose(1, 2)


def _spectrogram_tokens(p: dict, x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    b, c, t = x.shape
    n_fft, hop, bins = cfg["spec_n_fft"], cfg["spec_hop_length"], cfg["spec_freq_bins"]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32).to(x.device)
    spec = torch.stft(x.reshape(b * c, t), n_fft, hop, window=window, center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    mag = torch.log(spec.abs()[:, :bins] + EPS)[:, None]  # (B*C, 1, F, frames)
    pre = "spectrogram_generator"

    def conv(h, i):
        return F.conv2d(operand(h, precision), operand(p[f"{pre}.spec_conv.{i}.weight"], precision),
                        p[f"{pre}.spec_conv.{i}.bias"], padding=1)

    h = F.max_pool2d(torch.relu(conv(mag, 0)), 2)
    h = F.adaptive_avg_pool2d(torch.relu(conv(h, 3)), (4, 4)).reshape(b * c, -1)
    h = dense(p, f"{pre}.proj.3", torch.relu(dense(p, f"{pre}.proj.0", h, precision)), precision)
    return h.reshape(b, c, -1)


def _ibs_tokens(p: dict, matrices: torch.Tensor, precision: str) -> torch.Tensor:
    b, nb, nf, c, _ = matrices.shape
    x = matrices.reshape(b, nb * nf, c * c)
    mean = x.mean(1, keepdim=True)  # instance norm of each entry over the tokens
    var = ((x - mean) ** 2).mean(1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + 1e-5)
    x = x * p["ibs_tokenizer.instance_norm.weight"] + p["ibs_tokenizer.instance_norm.bias"]
    h = F.gelu(dense(p, "ibs_tokenizer.bottleneck.0", x, precision), approximate="tanh")
    return dense(p, "ibs_tokenizer.bottleneck.3", h, precision) + p["ibs_tokenizer.type_embedding"]


def forward(p: dict, cfg: dict, eeg1: torch.Tensor, eeg2: torch.Tensor,
            precision: str = "exact") -> dict:
    """The model's outputs on (B, C, T) float32 pairs: logits, cls1, cls2,
    ibs_logits, ibs_token."""
    b, c, _ = eeg1.shape
    heads, n_layers = cfg["num_heads"], cfg["num_layers"]
    ibs = _ibs_tokens(p, connectivity(eeg1, eeg2, float(cfg["sampling_rate"])), precision)
    cls = p["cls_token"].expand(b, 1, -1)

    def stream(x):
        seq = torch.cat([cls, ibs, _spectrogram_tokens(p, x, cfg, precision),
                         _conv_tokens(p, x, cfg, precision)], dim=1)
        seq = seq + p["pos_embed.pos_embed.weight"][:seq.shape[1]]
        return layers.encoder(p, "encoder", seq, n_layers, heads, precision)

    z1, z2 = stream(eeg1), stream(eeg2)
    a = "cross_attn"
    z1, z2 = (layer_norm(p, f"{a}.norm", z1 + layers.attention(p, f"{a}.cross_attn", z1, z2,
                                                               heads, precision)),
              layer_norm(p, f"{a}.norm", z2 + layers.attention(p, f"{a}.cross_attn", z2, z1,
                                                               heads, precision)))
    cls1, cls2 = z1[:, 0], z2[:, 0]
    fused = dense(p, "symmetric_fusion.proj",
                  torch.cat([cls1 + cls2, cls1 * cls2, (cls1 - cls2).abs()], -1), precision)
    first = 1 + ibs.shape[1] + c  # the conv tokens
    z_fuse = torch.cat([fused, z1[:, first:].mean(1), z2[:, first:].mean(1)], -1)
    logits = dense(p, "classifier.3", torch.relu(dense(p, "classifier.0", z_fuse, precision)),
                   precision)
    ibs_token = z1[:, 1:1 + ibs.shape[1]].mean(1)
    ibs_logits = dense(p, "ibs_classifier.3",
                       torch.relu(dense(p, "ibs_classifier.0", ibs_token, precision)), precision)
    return {"logits": logits, "cls1": cls1, "cls2": cls2, "ibs_logits": ibs_logits,
            "ibs_token": ibs_token}


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """Serving's preprocessing: common average reference over channels, then
    each channel z-scored over time (biased std, eps 1e-8 added)."""
    x = x - x.mean(-2, keepdim=True)
    mean = x.mean(-1, keepdim=True)
    std = ((x - mean) ** 2).mean(-1, keepdim=True).sqrt()
    return (x - mean) / (std + EPS)


def serve(p: dict, cfg: dict, eeg1: torch.Tensor, eeg2: torch.Tensor,
          precision: str = "exact") -> torch.Tensor:
    """Served logits of raw (B, C, T) pairs: preprocessing, then the model."""
    return forward(p, cfg, preprocess(eeg1), preprocess(eeg2), precision)["logits"]


# -- the training objective -------------------------------------------------------

def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, -1).gather(-1, labels[:, None]).mean()


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def loss(p: dict, cfg: dict, batch: dict, weights: dict, precision: str = "exact"):
    """The five-term objective on a batch {eeg1, eeg2, label}: cross entropy
    + w_sym * MSE(cls1, cls2) + w_align * InfoNCE(IBS token against the 2B
    CLS tokens, its own cls1 positive, temperature 0.07) + w_ibs_ce * IBS
    cross entropy + w_contrastive * supervised contrastive loss of the IBS
    tokens (temperature 0.07, over the rows that have a positive).  Returns
    (total, {term: value}), the terms named as the program reports them."""
    out = forward(p, cfg, batch["eeg1"], batch["eeg2"], precision)
    y = batch["label"].long()
    b = len(y)
    tok = _unit(out["ibs_token"])
    sim = tok @ tok.T / 0.07
    off = 1.0 - torch.eye(b, device=y.device)
    pos = (y[:, None] == y[None, :]).float() * off
    e = torch.exp(sim) * off
    per_row = -torch.log((e * pos).sum(1) / (e.sum(1) + 1e-8) + 1e-8)
    has = pos.sum(1) > 0
    cls = torch.cat([_unit(out["cls1"]), _unit(out["cls2"])])
    terms = {
        "loss_ce": _cross_entropy(out["logits"], y),
        "loss_sym": ((out["cls1"] - out["cls2"]) ** 2).mean(),
        "loss_ibs_align": _cross_entropy(tok @ cls.T / 0.07, torch.arange(b, device=y.device)),
        "loss_ibs_cls": _cross_entropy(out["ibs_logits"], y),
        "loss_contrastive": (per_row * has).sum() / has.sum().clamp_min(1),
    }
    total = (terms["loss_ce"] + weights["sym"] * terms["loss_sym"]
             + weights["align"] * terms["loss_ibs_align"]
             + weights["ibs_ce"] * terms["loss_ibs_cls"]
             + weights["contrastive"] * terms["loss_contrastive"])
    return total, terms
