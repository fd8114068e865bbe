"""roofline_pct.eager: roofline_pct.sim's reading, in the sweeps whose
decoder walks its op program in eager PyTorch ops (moving
sim_cw_per_s.eager)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline_pct(ctx, "sweep")
