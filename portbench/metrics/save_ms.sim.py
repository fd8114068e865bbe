"""save_ms.sim: the mean host time inside the harness's `run_sweep.save`
spans (the sweep state's JSON written and renamed after every fetch) of
the traced window, per save, in milliseconds, on one card (moving
sim_cw_per_s). None where the program has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "run_sweep.save")
