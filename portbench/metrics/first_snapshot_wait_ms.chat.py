"""Mean of the engine's `phase2.first_snapshot_wait` record over the
window, ms: a stream's wait for its first latent snapshot."""
from portbench import readers


def read(rec):
    return readers.span_mean_ms(rec, "phase2.first_snapshot_wait")
