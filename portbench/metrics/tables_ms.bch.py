"""tables_ms.bch: the mean host time inside the `scl.tables` spans
(polar_tpu_torch/ops/cuda_scl.py SclKernels.device_tables: a kernel's
tables, the l > 2 tail tables among them, built on the host and uploaded
to the card, once an instance and device) of the traced window, per
span, in milliseconds, on one card (moving sim_cw_per_s). The harness
builds a new step each pass, so it holds one span a pass. None where
the program has no such span."""
from portbench.yardstick import readers


def read(ctx):
    if len(ctx.get("ranks") or ()) != 1:
        return None
    return readers.span_ms(ctx, "sweep", "scl.tables")
