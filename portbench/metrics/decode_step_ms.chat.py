"""The window's seconds over the decode steps the runner dispatched in it,
ms; a block that straddles an edge of the window counts pro rata
(`readers.steps_at`)."""
from portbench import readers


def read(rec):
    return readers.decode_step_ms(rec)
