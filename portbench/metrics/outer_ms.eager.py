"""outer_ms.eager: the host time inside the eager walk's `walk.outer` spans
(polar_tpu_torch/ops/scl.py build_plain_scl_decoder) of the traced
window over the count of its decodes (`scl.decode` spans), in
milliseconds a decode: the runs of outer eager ops between the children,
the stage-kernel (K6) launches among them (moving sim_cw_per_s.eager).
None where the program has no such span."""


def read(ctx):
    spans = (ctx.get("trace") or {}).get("spans") or {}
    part, calls = spans.get("walk.outer"), spans.get("scl.decode")
    if (ctx["kind"] != "sweep" or len(ctx.get("ranks") or ()) != 1
            or not part or not part["count"] or not calls
            or not calls["count"]):
        return None
    return part["us"] / calls["count"] * 1e-3
