"""idle_pct.decode: the share of the traced decode window in which no
kernel, copy or set ran on the card, in percent (yardstick/trace.py)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_pct(ctx, "decode")
