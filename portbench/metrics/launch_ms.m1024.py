"""launch_ms.m1024: the mean host time inside the `mc_step.launch` spans
(polar_tpu_torch/ops/mc.py McStep._launch: one fused call's launch on the
host, its plan, tables, chunks and library calls, one span a call) of the
traced window, in milliseconds, in the sweeps of the mixed-kernel code at
N=1024, L=32 (moving sim_cw_per_s). None where the program has no such
span."""
from portbench.yardstick import readers


def read(ctx):
    return readers.span_ms(ctx, "sweep", "mc_step.launch")
