"""Kernel K2's share of its roofline in the traced sub-window, in %
(readers.k2_percent): the least time to read the K and V rows that the
decode steps in the sub-window needed (each active slot's rows at each
step; the rows of idle slots that K2 reads anyway are not counted), over
the device time of the K2 kernels (`flash_decode*`) in it. A chunk's
tokens are placed evenly between its submission and its end. Bound by
bytes at 3.35 TB/s."""
from portbench import readers


def read(rec):
    return readers.k2_percent(rec)
