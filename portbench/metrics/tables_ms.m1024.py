"""tables_ms.m1024: tables_ms.bch's reading in the sweeps of the
mixed-kernel code at N=1024, L=32: the mean host time inside the
`scl.tables` spans (the capacity-32 l > 2 kernel tables built on the host
and uploaded, once a pass), in milliseconds, on one card (moving
sim_cw_per_s). None where the program has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "scl.tables")
