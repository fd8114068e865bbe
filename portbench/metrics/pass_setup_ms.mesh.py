"""pass_setup_ms.mesh: pass_setup_ms.sim's reading in the sweeps over
several cards, on rank 0, where the set-up also holds the state's
broadcast to the other ranks (moving sim_cw_per_s.mesh)."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) < 2:
        return None
    return readers.span_ms(ctx, "sweep", "run_sweep.setup")
