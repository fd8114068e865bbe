"""draw_ms.eager: the host time inside the harness's `mc_step.draw`
spans (polar_tpu_torch/sim/harness.py make_mc_step: the frames of a call
drawn, encoded and sent through the channel by mc_draw) of the traced
window over the count of its `run_sweep.dispatch` spans, in milliseconds
a call (moving sim_cw_per_s.eager). None where the program has no such
span."""


def read(ctx):
    spans = (ctx.get("trace") or {}).get("spans") or {}
    part, calls = spans.get("mc_step.draw"), spans.get("run_sweep.dispatch")
    if (ctx["kind"] != "sweep" or len(ctx.get("ranks") or ()) != 1
            or not part or not part["count"] or not calls
            or not calls["count"]):
        return None
    return part["us"] / calls["count"] * 1e-3
