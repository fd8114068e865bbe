"""roofline_pct.bch: roofline_pct.sim's reading in the sweeps of the 16x16
eBCH code, where every DOWN is an l > 2 node: the fused step's l > 2 body
(K5 at its `big` instance: tail tables and trellis) against the least
time of the window's work (moving sim_cw_per_s)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.roofline_pct(ctx, "sweep")
