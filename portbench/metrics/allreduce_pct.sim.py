"""allreduce_pct.sim: the time NCCL kernels ran on rank 0's card as a
share of its traced sweep window, in percent (moving sim_cw_per_s.mesh).
A wait for a slower rank shows inside that kernel."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "sweep" or not t or len(ctx.get("ranks", ())) < 2:
        return None
    return 100.0 * t["nccl_us"] / t["window_us"]
