"""Kernel K3's share of its roofline in the traced sub-window, in %
(readers.k3_percent): the MRF stages' least time for the frames of the
audio that arrived in it, over the `mrf_conv*` kernels' device time.
Bound by operations at the bf16 peak."""
from portbench import readers


def read(rec):
    return readers.k3_percent(rec)
