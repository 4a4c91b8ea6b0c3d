"""Kernel K3's share of its roofline in the row vocoder, in %
(readers.k3_rows_percent): the MRF stages' least time for the frames of the
chunks whose decoding ended in the traced sub-window, over the
`mrf_conv*` kernels' device time. Bound by operations at the bf16 peak."""
from portbench import readers


def read(rec):
    return readers.k3_rows_percent(rec)
