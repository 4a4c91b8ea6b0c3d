"""Mean of the scheduler's `sched.admission_wait` record over the window,
ms: a request's wait for one of the facade's `max_concurrency` places."""
from portbench import readers


def read(rec):
    return readers.span_mean_ms(rec, "sched.admission_wait")
