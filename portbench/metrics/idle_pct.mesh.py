"""idle_pct.mesh: idle_pct.sim's reading, in the sweeps over several
cards, on rank 0 (moving sim_cw_per_s.mesh)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_pct(ctx, "sweep")
