"""Kernel K2's share of its roofline in the traced sub-window, in %: the
least time to read the K and V rows that the decode steps in the
sub-window needed (each active slot's rows at each step; the rows of idle
slots that K2 reads anyway are not counted), over the device time of the
K2 kernels (`flash_decode*`) in it. A chunk's tokens are placed evenly
between its submission and its end. Bound by bytes at 3.35 TB/s."""
import sys

from portbench import flops, readers


def read(rec):
    tr, cfg = rec.get("trace"), rec["config"]
    seconds = readers.kernel_seconds(rec, "flash_decode")
    if not tr or not seconds:
        return None
    rows = steps = 0
    for r in rec["requests"]:
        for c in r["chunks"]:
            if c["t_done"] is None or c["n"] < 2:
                continue
            t0, span = c["t_submit"], c["t_done"] - c["t_submit"]
            for j in range(1, c["n"]):
                if tr["host_start"] <= t0 + span * j / c["n"] < tr["host_end"]:
                    rows += c["prompt_len"] + j
                    steps += 1
    if not steps:
        return None
    ms, by = flops.bound(flops.decode_attention_bytes(cfg, rows, steps),
                         flops.decode_attention_ops(cfg, rows), "bf16")
    print(f"[k2_roofline] bound by {by}, {steps} slot-steps over {rows} rows, K2 "
          f"{seconds:.6f} s on the device; card {rec['device']['kind']}, power limit "
          f"{rec['device']['power_limit']}", file=sys.stderr)
    return ms / 1e3 / seconds * 100
