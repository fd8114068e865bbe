"""roofline_pct.m1024: roofline_pct.sim's reading in the sweeps of the
mixed-kernel code at N=1024, L=32, where the fused step runs K5 at its
capacity-32 l > 2 instance (`scl_mc_counters_big_c32`: the fork table of
32 paths, tail tables and trellis): the least time of the window's work
at the published peaks over the kernels' busy time (moving
sim_cw_per_s)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline_pct(ctx, "sweep")
