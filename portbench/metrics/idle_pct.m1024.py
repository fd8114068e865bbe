"""idle_pct.m1024: idle_pct.sim's reading in the sweeps of the
mixed-kernel code at N=1024, L=32: the card idles at each point's drain,
at the pass edges and wherever the host holds it back (moving
sim_cw_per_s)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_pct(ctx, "sweep")
