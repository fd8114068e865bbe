"""pass_setup_ms.sim: the mean host time inside the harness's
`run_sweep.setup` spans (polar_tpu_torch/sim/harness.py: the step built,
its tables uploaded, the state read, the counters' pinned buffers) of the
traced window, per pass, in milliseconds, on one card (moving
sim_cw_per_s). None where the program has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "run_sweep.setup")
