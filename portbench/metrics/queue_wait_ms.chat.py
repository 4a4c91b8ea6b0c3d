"""Mean of the runner's `decode.queue_wait` record over the window, ms: a
chunk's wait for a slot."""
from portbench import readers


def read(rec):
    return readers.span_mean_ms(rec, "decode.queue_wait")
