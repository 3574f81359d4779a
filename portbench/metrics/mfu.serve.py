"""Model operations of the measured window (counts.flops_per_window) over its length and the 989 TFLOP/s bf16 peak."""

from portbench import readers

LAYER = "model step (models/dual_eeg.py, models/art.py, models/transformer.py, ops/)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "serve_windows_per_s"


def read(run):
    return readers.mfu(run, "serve")
