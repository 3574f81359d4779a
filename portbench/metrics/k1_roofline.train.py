"""K1's share of its roofline bound (counts.k1 at N = 6 x rows, C, T against 67 TFLOP/s f32 and 3.35 TB/s) over its device time in the train trace."""

from portbench import readers

LAYER = "kernel K1 (kernels/phase_metrics.py, csrc/phase_metrics.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(run):
    return readers.roofline(run, "train", "k1")
