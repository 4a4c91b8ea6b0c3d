"""Seconds of audio served per second of the window (host clock): each
finished request's audio, times the share of its life (sent to last audio)
that lies inside the window. Requests still in flight at the window's end
are followed to their end, so the window's part of their work counts."""
from portbench import readers


def read(rec):
    return readers.audio_s_per_s(rec)
