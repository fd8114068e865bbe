"""What the per-layer metrics read from a traced run's context: the trace
summary of rank 0 (`trace`, yardstick/trace.py), its work counted from the
code's shapes (`work`), and every rank's summary (`ranks`). Each returns
None where the run holds nothing to read."""
from __future__ import annotations

from portbench.yardstick.opcount import bound_s


def idle_pct(ctx, kind: str):
    """The share of the traced window in which no kernel, copy or set ran
    on the card, in percent."""
    if ctx["kind"] != kind or not ctx.get("trace"):
        return None
    return 100.0 * ctx["trace"]["idle_share"]


def roofline_pct(ctx, kind: str):
    """The least time the card could take for the window's work at the
    published peaks over the time in it that kernels ran, in percent."""
    if ctx["kind"] != kind or not ctx.get("trace"):
        return None
    busy = ctx["trace"]["kernel_busy_us"] * 1e-6
    work = ctx["work"]
    if busy <= 0 or not work["frames"]:
        return None
    return 100.0 * bound_s(work["ops"], work["bytes"]) / busy


def span_ms(ctx, kind: str, name: str):
    """The mean host time inside the spans `name`, in milliseconds."""
    span = (ctx.get("trace") or {}).get("spans", {}).get(name)
    if ctx["kind"] != kind or not span or not span["count"]:
        return None
    return span["us"] / span["count"] * 1e-3
