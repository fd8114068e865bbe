"""dispatch_ms.eager: dispatch_ms.sim's reading, in the sweeps whose
decoder walks its op program in eager PyTorch ops: it holds the walk's
launches (moving sim_cw_per_s.eager)."""
from portbench.yardstick import readers


def read(ctx):
    return readers.span_ms(ctx, "sweep", "run_sweep.dispatch")
