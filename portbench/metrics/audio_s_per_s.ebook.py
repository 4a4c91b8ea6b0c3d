"""Seconds of audio served per second of the window in the e-book cell
(host clock), counted as `audio_s_per_s` counts it."""
from portbench import readers


def read(rec):
    return readers.audio_s_per_s(rec)
