"""Device time of a decode step, ms: the runner's `decode.block_device`
device spans (CUDA-event time of each decode block's program) over the
steps of those blocks (`decode.block_steps`), from the program's span
totals over the traced part of the window."""
from portbench import timeline


def read(rec):
    return timeline.span_total_ratio(rec, "decode.block_device", "decode.block_steps", 1e3)
