"""Mean host time of a dispatch, the upload to the results on the host, over the window's requests (the batcher's own stats['exec_ms'])."""

from portbench import readers

LAYER = "predictor (serving.Predictor, serving.ArtDenoiser, _predict_batched)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "serve_windows_per_s"


def read(run):
    return readers.batcher_mean(run, "exec_ms")
