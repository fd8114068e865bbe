"""dispatch_ms.bch: dispatch_ms.sim's reading in the sweeps of the 16x16
eBCH code: the host side of a call, which the first call of each pass
lengthens by the step's kernel tables (moving sim_cw_per_s)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.span_ms(ctx, "sweep", "run_sweep.dispatch")
