"""Share of the traced window with no kernel, copy or set running on the card."""

from portbench import readers

LAYER = "device (one H100)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "serve_windows_per_s"


def read(run):
    return readers.idle_pct(run, "serve")
