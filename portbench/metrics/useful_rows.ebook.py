"""Share of the K/V rows the decode programs read that belong to a slot
still generating, in %: the runner's `decode.rows_live` over its
`decode.rows_read` counter (host arithmetic per block, settled at harvest)
over the window. With most slots live it nears 100%."""
from portbench import timeline


def read(rec):
    return timeline.span_total_ratio(rec, "decode.rows_live", "decode.rows_read", 100.0)
