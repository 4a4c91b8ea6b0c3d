"""Kernel K2's share of its roofline in the traced sub-window, in %
(readers.k2_percent): the least time to read the K and V rows the live
slots' decode steps needed, over the `flash_decode*` kernels' device time.
Bound by bytes at 3.35 TB/s."""
from portbench import readers


def read(rec):
    return readers.k2_percent(rec)
