"""The device's activity in a torch.profiler Chrome trace.

`summary` is a frozen copy of polar_tpu_torch/sim/kernel_times.py
`trace_summary`: the window from the first device activity's start to the
last one's end; busy, the union of its kernel, memcpy and memset intervals
over every stream; the top kernels by total time; and the longest idle
stretches with the host ops that overlap them most. It adds what the
benchmark's per-layer metrics read: the union of the kernel intervals
alone, the time of the NCCL kernels, and each named host span's count and
total time. Times in microseconds.
"""
from __future__ import annotations

import json
import pathlib

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
SPAN_CAT = "user_annotation"


def load_events(path) -> list[dict]:
    """The complete ("X") events of a Chrome trace file."""
    return [e for e in json.loads(pathlib.Path(path).read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _union(intervals) -> list[list[float]]:
    merged: list[list[float]] = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _span(e) -> tuple[float, float]:
    s = float(e["ts"])
    return s, s + float(e.get("dur", 0))


def summary(events: list[dict], top: int = 10, gaps: int = 10) -> dict:
    """What the trace says of the device: see the module's docstring.
    Raises ValueError where no operation ran on the device."""
    dev = sorted((*_span(e), e) for e in events if e.get("cat") in DEVICE_CATS)
    if not dev:
        raise ValueError("the trace holds no device activity")
    busy = _union((s, t) for s, t, _ in dev)
    window = busy[-1][1] - busy[0][0]
    busy_us = sum(t - s for s, t in busy)
    kernel_busy = _union((s, t) for s, t, e in dev if e["cat"] == "kernel")
    nccl = _union((s, t) for s, t, e in dev
                  if e["cat"] == "kernel" and "nccl" in e["name"].lower())
    ops: dict = {}
    for s, t, e in dev:
        k = ops.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += t - s
    spans: dict = {}
    for e in events:
        if e.get("cat") == SPAN_CAT:
            s, t = _span(e)
            k = spans.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += t - s
    host = [(*_span(e), e["name"]) for e in events
            if e.get("cat") in HOST_CATS]
    holes = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                   reverse=True)[:gaps]
    out_gaps = []
    for us, s, t in holes:
        over: dict = {}
        for hs, ht, name in host:
            if min(ht, t) > max(hs, s):
                over[name] = over.get(name, 0.0) + min(ht, t) - max(hs, s)
        out_gaps.append({"us": us, "at_us": s - busy[0][0], "host_ops": dict(
            sorted(over.items(), key=lambda kv: -kv[1])[:5])})
    return {"window_us": window, "busy_us": busy_us,
            "busy_share": busy_us / window, "idle_share": 1 - busy_us / window,
            "kernel_busy_us": sum(t - s for s, t in kernel_busy),
            "nccl_us": sum(t - s for s, t in nccl),
            "device_ops": [{"name": n, "launches": c, "us": u} for n, (c, u) in
                           sorted(ops.items(), key=lambda kv: -kv[1][1])[:top]],
            "spans": {n: {"count": c, "us": u} for n, (c, u) in spans.items()},
            "gaps": out_gaps}


def breakdown(s: dict) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps, each gap named by the host ops over it
    (the one that overlaps it most first), in seconds."""
    return {"device_ops": [[o["name"], o["us"] * 1e-6]
                           for o in s["device_ops"][:10]],
            "idle_gaps": [[" + ".join(list(g["host_ops"])[:2]) or "(no host op)",
                           g["us"] * 1e-6] for g in s["gaps"][:10]]}
