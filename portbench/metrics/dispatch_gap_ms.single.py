"""Mean device idle between a decode block's end and the runner's next
pass's first device work while a slot is owned, ms: the part of that
interval that no device span of the program covers (timeline.dispatch_gaps;
stderr splits the idle by the runner's host turn at each gap's middle and
gives the program's own idle share beside the profiler's)."""
from portbench import timeline


def read(rec):
    return timeline.dispatch_gaps(rec)
