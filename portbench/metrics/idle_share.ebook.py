"""Share of the traced sub-window in which no device operation runs, in %:
32 clients keep the runner busy, so any stretch of the window reads alike."""
from portbench import readers


def read(rec):
    return readers.idle_percent(rec)
