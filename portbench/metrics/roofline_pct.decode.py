"""roofline_pct.decode: the least time the card could take for the decode
work of the traced window (each frame's decode counted from the code's
shapes, yardstick/opcount.py, and its LLRs and outputs once, at the
published peaks) over the time in it that kernels ran, in percent."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline_pct(ctx, "decode")
