"""pass_setup_ms.m1024: pass_setup_ms.sim's reading in the sweeps of the
mixed-kernel code at N=1024, L=32 (the `run_sweep.setup` span: the step
built with its plain decoder, a pass's state and buffers), on one card
(moving sim_cw_per_s). None where the program has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "run_sweep.setup")
