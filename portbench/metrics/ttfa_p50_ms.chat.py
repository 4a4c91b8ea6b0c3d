"""Median, over the requests due in the window of the open-loop chat cell,
of the time from each one's due time to its first audio (host clock); a
failed or unfinished request counts as the end of the drain."""
from portbench import readers


def read(rec):
    return readers.due_latency_p50_ms(rec, "first")
