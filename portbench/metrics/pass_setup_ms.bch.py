"""pass_setup_ms.bch: pass_setup_ms.sim's reading in the sweeps of the
16x16 eBCH code, where the set-up builds the step's plain decoder with
its l > 2 stage processors (moving sim_cw_per_s). None where the program
has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "run_sweep.setup")
