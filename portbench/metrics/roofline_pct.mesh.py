"""roofline_pct.mesh: roofline_pct.sim's reading, in the sweeps over
several cards, of rank 0's frames and kernels (moving
sim_cw_per_s.mesh)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline_pct(ctx, "sweep")
