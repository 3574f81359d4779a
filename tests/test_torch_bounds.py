"""The least times ``chip_smoke.py`` reports for the phase-metrics kernels.

Each FP32 instruction of K1's and K2's work takes one lane-cycle, as an FMA
does, so it counts as the 2 operations an FMA counts for in the card's
67 TFLOP/s float32 peak: 14 operations per pair and sample for K1, 22 for
K2 (plus a sin and a cos of each phase sample).
"""

import pytest

import chip_smoke


@pytest.mark.parametrize("shape, plv, ms, by", [
    ((768, 32, 1024), False, 0.1683, "operations"),
    ((48, 32, 1024), False, 0.0105, "operations"),
    ((192, 32, 1024), False, 0.0421, "operations"),
    ((64, 32, 1024), True, 0.0222, "operations"),
    ((768, 32, 1024), True, 0.2659, "operations"),
], ids=["k1-n768", "k1-n48", "k1-n192", "k2-n64", "k2-n768"])
def test_phase_bound(shape, plv, ms, by):
    got, got_by = chip_smoke.phase_bound(shape, plv)
    assert got == pytest.approx(ms, abs=5e-5)
    assert got_by == by


def test_phase_bound_bytes_at_n768():
    """Four (768, 32, 1024) inputs read once and three outputs written once:
    412 MB at 3.35 TB/s, under K1's operation bound."""
    n, c, t = 768, 32, 1024
    ms, by = chip_smoke.bound(4 * (4 * n * c * t + 3 * n * c * c), 0, chip_smoke.F32_OPS_PER_S)
    assert ms == pytest.approx(0.1230, abs=5e-5) and by == "bytes"
