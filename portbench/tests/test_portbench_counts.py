"""The work counts on hand-worked shapes."""

from __future__ import annotations

import pytest

from portbench import counts


def test_k1():
    c = counts.k1(2, 3, 4)
    assert c["ops"] == 8 * 2 * 3 * 3 * 4 == 576
    # Four (2, 3, 4) float32 inputs read, three (2, 3, 3) outputs written.
    assert c["bytes"] == 4 * 96 + 3 * 72 == 600
    assert c["bound_s"] == pytest.approx(max(576 / 67e12, 600 / 3.35e12))


def test_k3():
    c = counts.k3(1, 2, 128, 16)
    assert c["ops"] == 2 * (2 * 2 * 128 * 128 * 16) == 2_097_152  # Q K^T and P V
    assert c["bytes"] == 4 * (2 * 128 * 16) * 2 == 32_768  # Q, K, V in and O out, bf16
    assert c["bound_s"] == pytest.approx(32_768 / 3.35e12)  # bytes bound this small shape


def test_k4_backward():
    c = counts.k4_backward(1, 1, 4, 2)
    assert c["ops"] == 5 * (2 * 4 * 4 * 2) == 320
    # Q, K, V, O, dO (8 bf16 each) and 4 float32 LSE in; dQ, dK, dV out.
    assert c["bytes"] == 5 * 16 + 16 + 3 * 16 == 144


def test_art_flops():
    cfg = dict(family="art", in_channels=2, out_channels=2, window=4, embedding_size=2,
               feedforward_size=4, num_encoder_layers=1, num_decoder_layers=1)
    embed = 2 * (2 * 4 * 2 * 2)  # two 1x1 convs, T x C x E multiply-adds each
    enc = 4 * 2 * 4 * 2 * 2 + 2 * 2 * 4 * 4 * 2 + 2 * 2 * 4 * 2 * 4  # projections, QK PV, FFN
    dec = 2 * (4 * 2 * 4 * 2 * 2 + 2 * 2 * 4 * 4 * 2) + 2 * 2 * 4 * 2 * 4
    head = 2 * 4 * 2 * 2
    assert embed + enc + dec + head == 1120
    assert counts.art_flops(cfg) == 1120
    assert counts.flops_per_window(cfg, training=True) == 3 * 1120


def test_dual_eeg_flops():
    cfg = dict(family="dual_eeg", in_channels=2, window=8, d_model=4, d_ff=8, conv_kernel_size=3,
               conv_stride=2, conv_layers=1, spec_hop_length=4, spec_freq_bins=4, num_layers=1,
               num_classes=3)
    conv = 2 * 4 * 2 * 3 * 4  # 4 output steps x 2 in x 3 taps x 4 out
    spec = (2 * 4 * 3 * 9 * 32  # conv1 on 4 bins x 3 frames
            + 2 * 2 * 1 * 9 * 32 * 64  # conv2 after the 2 x 2 max pool
            + 2 * (1024 * 8 + 8 * 4))  # the projection 1024 -> 8 -> 4
    stream = conv + 2 * spec  # per stream: 2 channels' spectrogram tokens
    connectivity = 6 * (12 * 2 * 2 * 8 + 2 * 2 * 2 * 5)  # PLV + 2 correlations, coherence
    ibs = 42 * 2 * (2 * 2 * 64 + 64 * 4)
    n = 1 + 42 + 2 + 4  # CLS, IBS, spectrogram and conv tokens
    encoder = 4 * 2 * n * 16 + 2 * 2 * n * n * 4 + 2 * 2 * n * 4 * 8
    cross = 2 * (2 * 2 * n * 16 * 2 + 2 * 2 * n * n * 4)
    heads = 2 * (3 * 4 * 4) * 2 + 2 * 4 * 3 + 2 * 4 * 2 + 2 * 2 * 3
    total = 2 * (stream + encoder) + connectivity + ibs + cross + heads
    assert total == 625_828
    assert counts.dual_eeg_flops(cfg) == 625_828
