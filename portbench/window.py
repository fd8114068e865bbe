"""The measured window and its trace, shared by the kinds."""
from __future__ import annotations

import contextlib
import random
import time
import traceback


def run_units(unit, seconds: float, stop=None) -> dict:
    """Run unit(i) for i = 0, 1, ... back to back until `seconds` have
    passed at the end of one. `stop(done)`, where given, turns this rank's
    `done` into the decision every rank takes (a collective). A unit that
    raises ends the window and counts as failed.

    Returns {"units": units completed, "failed": 0 or 1, "error": the
    traceback or None, "seconds": the window's wall time, "wall_start":
    its start on the host clock (time.time())}."""
    wall_start = time.time()
    t0 = time.perf_counter()
    units = failed = 0
    error = None
    while True:
        try:
            unit(units)
        except Exception:                       # a call of the program raised
            failed, error = 1, traceback.format_exc()
            break
        units += 1
        done = time.perf_counter() - t0 >= seconds
        if stop(done) if stop else done:
            break
    return {"units": units, "failed": failed, "error": error,
            "seconds": time.perf_counter() - t0, "wall_start": wall_start}


@contextlib.contextmanager
def traced(on: bool, path):
    """torch.profiler over the block (host ops and the card's activity),
    exported as a Chrome trace to `path`; nothing where `on` is false."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


class Reservoir:
    """A uniform sample of `keep` of the items offered one by one, drawn by
    a generator seeded with the run's seed (the same on every rank that is
    offered the same sequence). `make` builds an item only where the draw
    keeps it."""

    def __init__(self, seed: int, keep: int):
        self.rng = random.Random(int(seed))
        self.keep = int(keep)
        self.items: list = []
        self.offered = 0

    def offer(self, make) -> None:
        i = self.offered
        self.offered += 1
        if len(self.items) < self.keep:
            self.items.append(make(i))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.items[j] = make(i)


def pm_gap(pm, ref) -> float:
    """The widest gap between two [B] path metrics, as a share of the
    reference's (at least 1): inf where either is not finite."""
    import torch

    pm, ref = pm.double(), ref.double()
    gap = (pm - ref).abs() / ref.abs().clamp_min(1.0)
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    return float(gap.max()) if gap.numel() else 0.0
