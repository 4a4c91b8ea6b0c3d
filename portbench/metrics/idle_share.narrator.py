"""The device's idle share in %, from the first to the last section sent
inside the traced sub-window: whole cycles of the one narrator's sections,
so the reading does not depend on where in a cycle the sub-window starts."""
from portbench import readers


def read(rec):
    return readers.idle_percent_whole_cycles(rec)
