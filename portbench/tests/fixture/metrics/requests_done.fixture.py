"""A fixture metric: the requests completed in the window."""


def read(rec):
    return float(sum(1 for r in rec["requests"] if r["done"] is not None))
