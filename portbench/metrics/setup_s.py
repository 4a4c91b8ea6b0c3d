"""Process start to the start of the load's ramp, in seconds (host clock)."""


def read(rec):
    return rec["setup_s"]
