"""Share of the window's kernel time in kernels launched inside torch.optim's Optimizer.step#AdamW.step range."""

from portbench import readers

LAYER = "trainer and optimizer (train/trainer.py, train/optim.py)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(run):
    return readers.optimizer_pct(run)
