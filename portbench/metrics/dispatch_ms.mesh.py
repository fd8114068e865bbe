"""dispatch_ms.mesh: dispatch_ms.sim's reading, in the sweeps over several
cards, on rank 0 (moving sim_cw_per_s.mesh)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.span_ms(ctx, "sweep", "run_sweep.dispatch")
