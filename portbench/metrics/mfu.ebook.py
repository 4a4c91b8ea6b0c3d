"""The whole step's share of the bf16 peak, in %: the operations of the
window's work (each finished request's prompts, decoded tokens and vocoder
frames, times the share of its life inside the window; flops.py) over the
window's seconds x 989 TFLOP/s."""
from portbench import readers


def read(rec):
    return readers.mfu_percent(rec)
