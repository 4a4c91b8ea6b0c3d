"""95th percentile (nearest rank), over the requests due in the window, of
the time from each one's due time to its first audio (host clock); a
failed or unfinished request counts as the end of the drain. Read only
with 200 requests or more, so that ten or more lie beyond it."""
from portbench import readers


def read(rec):
    return readers.due_latency_p95_ms(rec, "first")
