"""Mean wait of a request in the batcher's queue, enqueue to the start of its dispatch, over the window's requests (the batcher's own stats['queue_wait_ms'])."""

from portbench import readers

LAYER = "serving batcher (serving.DynamicBatcher)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "serve_p95_ms"


def read(run):
    return readers.batcher_mean(run, "queue_wait_ms")
