"""The decode runner's slot occupancy over the window in the e-book cell:
the mean of its owned slots, sampled every 50 ms, over its slot count."""


def read(rec):
    r = rec["runner"]
    return r["occupied_mean"] / r["num_slots"] if r["occupied_mean"] is not None else None
