"""idle_pct.sim: the share of the traced sweep window (rank 0's) in which
no kernel, copy or set ran on the card, in percent (yardstick/trace.py)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_pct(ctx, "sweep")
