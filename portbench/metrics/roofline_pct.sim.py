"""roofline_pct.sim: the least time the card could take for the sweep
work of the traced window (rank 0's frames: each frame's draw and decode
counted from the code's shapes, yardstick/opcount.py, and its counters'
bytes, at the published peaks) over the time in it that kernels ran, in
percent. It reads the same work whatever kernels do it."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline_pct(ctx, "sweep")
