"""Share of the traced sub-window in which no device operation runs, in %."""
from portbench import readers


def read(rec):
    return readers.idle_percent(rec)
