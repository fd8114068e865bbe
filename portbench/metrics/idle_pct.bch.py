"""idle_pct.bch: idle_pct.sim's reading in the sweeps of the 16x16 eBCH
code over several SNR points: the card idles at each point's drain, at
the pass edges and wherever the host holds it back (moving
sim_cw_per_s)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_pct(ctx, "sweep")
