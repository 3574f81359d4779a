"""K3-bf16's share of its roofline bound (counts.k3: 4 B H T^2 d at 989 TFLOP/s) over its device time in the train trace."""

from portbench import readers

LAYER = "kernel K3-bf16 (kernels/attention.py, csrc/attention.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(run):
    return readers.roofline(run, "train", "k3")
