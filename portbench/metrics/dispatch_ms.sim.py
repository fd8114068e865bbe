"""dispatch_ms.sim: the mean host time inside the harness's
`run_sweep.dispatch` spans (polar_tpu_torch/sim/harness.py) of the traced
window, per call, in milliseconds."""
from portbench.yardstick import readers


def read(ctx):
    return readers.span_ms(ctx, "sweep", "run_sweep.dispatch")
