"""Work counts and peaks: the yardstick of the rooflines and of ``mfu``.

Every count follows from shapes and from the mathematics, never from how a
kernel is written, so a later kernel that does the same work with fewer
instructions still reads at most 100% of its bound.  Bytes count each input
read once and each output written once.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM3.  They
hold at the card's full 700 W; the run reports the card's power limit beside
them.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1 per channel pair and sample: the phase difference, its sign and its
# absolute value, the two running sums of those, the pair's power sum
# p1_i + p2_j, and the sign-weighted sum of it (a multiply and an add).
K1_OPS_PER_PAIR_SAMPLE = 8


def bound_s(ops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: operations over the peak or
    bytes over the bandwidth, whichever is larger."""
    return max(ops / peak_flops, nbytes / PEAK_BYTES)


def k1(n: int, c: int, t: int) -> dict:
    """K1 on (N, C, T) phases and powers of two players -> three (N, C, C)
    float32 sums (sign mean, weighted sign sum, mean |dphi|)."""
    ops = K1_OPS_PER_PAIR_SAMPLE * n * c * c * t
    nbytes = 4 * n * c * t * 4 + 3 * n * c * c * 4
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes, PEAK_F32_FLOPS)}


def k3(b: int, h: int, t: int, d: int, tk: int | None = None) -> dict:
    """K3-bf16, softmax(Q K^T / sqrt(d)) V on (B, T, H, d) bf16: the two
    products, 2 B H Tq Tk d operations each; Q, K, V read and O written."""
    tk = t if tk is None else tk
    ops = 4 * b * h * t * tk * d
    nbytes = 2 * (2 * b * h * t * d + 2 * b * h * tk * d)
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes, PEAK_BF16_FLOPS)}


def k4_backward(b: int, h: int, t: int, d: int, tk: int | None = None) -> dict:
    """K4's backward: its five products (S = Q K^T again, dV = P^T dO,
    dP = dO V^T, dQ = dS K, dK = dS^T Q), 2 B H Tq Tk d operations each;
    Q, K, V, O, dO (bf16) and the rows' log-sum-exp (float32) read, dQ, dK,
    dV (bf16) written."""
    tk = t if tk is None else tk
    ops = 10 * b * h * t * tk * d
    nbytes = 2 * (3 * b * h * t * d + 2 * b * h * tk * d) + 4 * b * h * t \
        + 2 * (b * h * t * d + 2 * b * h * tk * d)
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes, PEAK_BF16_FLOPS)}


def _encoder_layer(n: int, d: int, d_ff: int) -> int:
    return 4 * 2 * n * d * d + 2 * 2 * n * n * d + 2 * 2 * n * d * d_ff


def _attention(nq: int, nk: int, d: int) -> int:
    return 2 * 2 * nq * d * d + 2 * 2 * nk * d * d + 2 * 2 * nq * nk * d


def dual_eeg_flops(cfg: dict) -> int:
    """Forward operations of the flagship per window pair: every matrix
    product, convolution and attention product (2 per multiply-add).  Left
    out: the FFTs, K1's pairwise sums (their own roofline), pooling, norms
    and elementwise work."""
    c, t, d, dff = cfg["in_channels"], cfg["window"], cfg["d_model"], cfg["d_ff"]
    k, s = cfg["conv_kernel_size"], cfg["conv_stride"]
    ops, t_in, c_in = 0, t, c
    for _ in range(cfg["conv_layers"]):
        t_out = (t_in + 2 * (k // 2) - k) // s + 1
        ops += 2 * t_out * c_in * k * d
        t_in, c_in = t_out, d
    conv_tokens = t_in
    frames, bins = 1 + t // cfg["spec_hop_length"], cfg["spec_freq_bins"]
    spec = 2 * bins * frames * 9 * 32 + 2 * (bins // 2) * (frames // 2) * 9 * 32 * 64
    spec += 2 * (64 * 4 * 4 * 2 * d + 2 * d * d)
    per_stream = ops + c * spec
    bands, features = 6, 7
    rfft_bins = t // 2 + 1
    connectivity = bands * (12 * c * c * t + 2 * c * c * rfft_bins)
    ibs = bands * features * 2 * (c * c * 64 + 64 * d)
    n = 1 + bands * features + c + conv_tokens
    encoder = cfg["num_layers"] * _encoder_layer(n, d, dff)
    cross = 2 * _attention(n, n, d)
    heads = 2 * (3 * d * d) * 2 + 2 * d * cfg["num_classes"] \
        + 2 * d * (d // 2) + 2 * (d // 2) * cfg["num_classes"]
    return 2 * (per_stream + encoder) + connectivity + ibs + cross + heads


def art_flops(cfg: dict) -> int:
    """Forward operations of ART per window (the same rule)."""
    c, t, e, ff = cfg["in_channels"], cfg["window"], cfg["embedding_size"], cfg["feedforward_size"]
    embed = 2 * 2 * t * c * e
    encoder = cfg["num_encoder_layers"] * _encoder_layer(t, e, ff)
    decoder = cfg["num_decoder_layers"] * (2 * _attention(t, t, e) + 2 * 2 * t * e * ff)
    return embed + encoder + decoder + 2 * t * e * cfg["out_channels"]


FORWARD_FLOPS = {"dual_eeg": dual_eeg_flops, "art": art_flops}


def flops_per_window(cfg: dict, training: bool) -> int:
    """Model operations per window; a train step's backward counts as twice
    its forward's products."""
    forward = FORWARD_FLOPS[cfg["family"]](cfg)
    return 3 * forward if training else forward
