"""pass_setup_ms.eager: pass_setup_ms.sim's reading in the sweeps whose
decoder walks its op program in eager PyTorch ops, where the set-up
builds the walk's host tables (moving sim_cw_per_s.eager)."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "run_sweep.setup")
