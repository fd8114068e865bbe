"""idle_pct.eager: idle_pct.sim's reading, in the sweeps whose decoder
walks its op program in eager PyTorch ops (moving sim_cw_per_s.eager)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.idle_pct(ctx, "sweep")
