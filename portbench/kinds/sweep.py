"""Kind `sweep`: passes of the program's Monte-Carlo FER sweep,
polar_tpu_torch.sim.harness.run_sweep, closed loop, back to back.

Each pass is one `run_sweep` call with the arguments `sweep_cli` would
pass for the cell's traffic: its SNR points, frames a point, batch a
card, backend, decoder routes and pipeline depth, a fresh state file
under TMPDIR (saved after every fetch), and the seed `(seed << 20) |
pass`. The window closes at the end of the pass in which its seconds run
out; on several cards rank 0 decides and every rank follows.

What the window's calls produce is kept for the comparison: every call's
counters as the harness got them (summed over the ranks), and the outputs
a frame of a sample of calls, drawn from the seed the same way on every
rank. For the `fused` backend those are the per-frame frame and bit error
counts of the fused step (`McStep.counts`); for the `torch` backend the
decoder's u and path metric of each frame. They are taken by wrapping the
names the harness calls (`build_mc_step`, `build_scl_decoder`, `mc_draw`,
`sharded_mc_step`) for the window only; the wrappers pass every argument
and result through unchanged.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import window as win
from portbench.core import ROOT
from portbench.ref.channel import ebn0_to_sigma
from portbench.ref.model import Reference, code_spec
from portbench.yardstick import opcount
from portbench.yardstick import trace as tr

WARM_PASS = (1 << 20) - 1        # the warm-up's pass index in its seed
COUNTER_BYTES = 8                # a frame's output: int32 frame and bit errors


def pass_seed(seed: int, p: int) -> int:
    """The sweep seed of pass p (p < 2^20)."""
    return (int(seed) << 20) | p


def program_preset(config: dict, traffic: dict):
    """The program's Preset of the cell: the configuration's code with the
    traffic's points, frames a pass and batch."""
    from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
    from polar_tpu_torch.models.presets import Preset

    code = config["code"]
    mask = np.load(ROOT / code["frozen_set"])
    crc = CrcSpec(**code["crc"]) if code.get("crc") else None
    spec = CodeSpec(N=code["N"], K=code["K"], factors=tuple(code["factors"]),
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)
    return Preset(config["name"], spec, int(config["list_size"]),
                  tuple(float(s) for s in traffic["ebn0_db"]),
                  int(traffic["frames_per_pass"]), int(traffic["batch_per_card"]))


class CallLog:
    """The window's calls: `calls` (pass, SNR index, step, the counters
    the harness got, summed over the ranks) for every call in order, and
    `sample`, a reservoir of `keep` calls' per-frame outputs with the key
    and sigma the program drew them with."""

    def __init__(self, seed: int, keep: int):
        self.sample = win.Reservoir(seed, keep)
        self.calls: list[tuple[int, int, int, torch.Tensor]] = []
        self.pass_index = 0
        self.drawn = None            # (key, sigma, batch) of the torch draw

    def offer(self, key, sigma: float, batch: int, **outputs) -> None:
        self.sample.offer(lambda i: {"index": i,
                                     "key": tuple(int(k) for k in key),
                                     "sigma": float(sigma),
                                     "batch": int(batch), **outputs})


@contextlib.contextmanager
def recording(log: CallLog):
    """Wrap the names polar_tpu_torch.sim.harness calls so that each call's
    outputs reach `log`; restored on exit."""
    from polar_tpu_torch.sim import harness

    orig = {n: getattr(harness, n) for n in
            ("build_mc_step", "build_scl_decoder", "mc_draw", "sharded_mc_step")}

    def build_mc_step(spec, list_size, device="cuda", counters=False):
        step = orig["build_mc_step"](spec, list_size, device, counters=counters)
        inner = step.counts

        def counts(seed, sigma, batch, noise=None):
            cnt = inner(seed, sigma, batch, noise)
            log.offer(seed, sigma, batch, counts=cnt)
            return cnt

        step.counts = counts
        if step.device.type == "cpu" and counters:
            # the CPU (the tests) runs the plain step, which sums in place:
            # route it through `counts`, as the card's counters mode runs
            def plain(seed, sigma, batch, noise=None):
                cnt = step.counts(seed, sigma, batch, noise)
                return cnt[0].sum(), cnt[1].sum(), None, None

            step.plain = plain
        return step

    def build_scl_decoder(*args, **kwargs):
        decoder = orig["build_scl_decoder"](*args, **kwargs)

        def decode(llrs):
            res = decoder(llrs)
            log.offer(*log.drawn, u=res.u, pm=res.pm)
            return res

        return decode

    def mc_draw(spec, seed, sigma, batch, device=None, noise=None):
        log.drawn = (seed, sigma, batch)
        return orig["mc_draw"](spec, seed, sigma, batch, device, noise)

    def sharded_mc_step(step_fn, mesh):
        step = orig["sharded_mc_step"](step_fn, mesh)

        def logged(seed, snr_index, rng_step, sigma, batch):
            out = step(seed, snr_index, rng_step, sigma, batch)
            log.calls.append((log.pass_index, snr_index, rng_step,
                              out["counts"]))
            return out

        return logged

    wrapped = {"build_mc_step": build_mc_step,
               "build_scl_decoder": build_scl_decoder, "mc_draw": mc_draw,
               "sharded_mc_step": sharded_mc_step}
    try:
        for n, fn in wrapped.items():
            setattr(harness, n, fn)
        yield log
    finally:
        for n, fn in orig.items():
            setattr(harness, n, fn)


def _agree(mesh):
    """stop(done): rank 0's `done`, broadcast to every rank."""
    import torch.distributed as dist

    def stop(done: bool) -> bool:
        flag = torch.tensor([int(done)], device=mesh.device)
        dist.broadcast(flag, src=0, group=mesh.group)
        return bool(flag.item())

    return stop


def run(cell, seed: int, seconds: float, trace: bool, tmp, mesh=None,
        device="cuda", control: bool = False) -> dict:
    """One run of a sweep cell on this rank: set-up, warm-up, the window
    and the comparison of its sample. `control`: the reference in
    bfloat16 takes the program's place in the comparison."""
    from polar_tpu_torch.parallel.mesh import make_batch_mesh
    from polar_tpu_torch.sim import harness

    t = cell.traffic
    preset = program_preset(cell.config, t)
    mesh = mesh or make_batch_mesh(device=device)
    dev = mesh.device
    batch = int(t["batch_per_card"])
    if t["frames_per_pass"] % (batch * mesh.size):
        raise ValueError(f"{cell.name}: frames_per_pass is not a whole number "
                         f"of calls of {batch} x {mesh.size} frames")
    common = dict(per_device_batch=batch, device=dev, steps_per_call=1,
                  backend=t["backend"], big_stage_backend=t["big_stage_backend"],
                  subtree_backend=t["subtree_backend"],
                  pipeline_depth=int(t["pipeline_depth"]), mesh=mesh,
                  progress=False)
    # warm-up: two calls at every point, through the window's own path
    harness.run_sweep(preset, frames=2 * batch * mesh.size,
                      seed=pass_seed(seed, WARM_PASS),
                      state_path=str(tmp / "warm.json"), **common)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    log = CallLog(seed, t["check_calls"])
    passes: list[list[dict]] = []

    def one_pass(p: int) -> None:
        log.pass_index = p
        state = tmp / f"pass{p}.json"
        passes.append(harness.run_sweep(preset, seed=pass_seed(seed, p),
                                        state_path=str(state), **common))
        state.unlink(missing_ok=True)

    length = min(seconds, t["trace_seconds"]) if trace else seconds
    with recording(log), win.traced(trace, tmp / "trace.json"):
        w = win.run_units(one_pass, length,
                          _agree(mesh) if mesh.group is not None else None)
    frames = sum(r["frames"] for recs in passes for r in recs)
    out = {"values": {t.get("rate_metric", "sim_cw_per_s"): frames / w["seconds"]},
           "wall_start": w["wall_start"], "attempted": len(log.calls),
           "raised": w["failed"], "error": w["error"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    if trace:
        ref_spec = code_spec(cell.config)
        L = int(cell.config["list_size"])
        per_frame = opcount.element_ops(ref_spec, L) + opcount.prologue_ops(ref_spec)
        mine = frames // mesh.size
        out["trace"] = tr.summary(tr.load_events(tmp / "trace.json"))
        out["work"] = {"frames": mine, "ops": mine * per_frame,
                       "bytes": mine * COUNTER_BYTES}
        (tmp / "trace.json").unlink()
    started = time.perf_counter()
    out["check"] = check(cell, seed, mesh.rank, log, passes, dev, control)
    out["check_s"] = time.perf_counter() - started
    return out


def check(cell, seed: int, rank: int, log: CallLog, passes, dev,
          control: bool) -> dict:
    """This rank's part of the comparison, once the window has closed.

    Each sampled call's frames are drawn again by the reference from the
    key the call's place in the sweep gives (pass, SNR index, step, rank)
    and the sigma of its SNR point, and decoded; a call that drew with
    another key or sigma counts all its frames off. Each pass's records
    are held to the sum of its calls' counters.

    Returns {"calls": {call index: {"off": frames whose output differs,
    "gap": the widest path-metric gap or None, "ref_sum": the reference's
    [frame errors, bit errors], "logged": the counters the harness got
    (under `control`: this rank's own sum)}}, "passes_off": passes whose
    frames or counters differ from their calls', "frames": frames
    compared, "control"}."""
    calls = log.calls
    logged = (torch.stack([c[3] for c in calls]).cpu().tolist()
              if calls else [])
    places = [c[:3] for c in calls]
    log.calls = []
    passes_off = 0
    for p, recs in enumerate(passes):
        for si, rec in enumerate(recs):
            got = [c for (q, s, _), c in zip(places, logged) if (q, s) == (p, si)]
            sums = [sum(c[0] for c in got), sum(c[1] for c in got)]
            if (rec["frames"] != cell.traffic["frames_per_pass"]
                    or [rec["frame_errors"], rec["bit_errors"]] != sums):
                passes_off += 1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(cell.config, dev)
    lower = Reference(cell.config, dev, torch.bfloat16) if control else None
    grid = cell.traffic["ebn0_db"]
    out, frames = {}, 0
    for rec in log.sample.items:
        if rec["index"] >= len(places):
            raise RuntimeError("a sampled call has no counters: the window's "
                               "calls and their outputs do not line up")
        p, si, step = places[rec["index"]]
        key = Reference.key(pass_seed(seed, p), si, step, rank)
        sigma = ebn0_to_sigma(grid[si], ref.spec.rate)
        with torch.no_grad():
            u_true, llr = ref.draw(key, sigma, rec["batch"])
            res = ref.decode(llr)
            cnt = ref.count(res.u, u_true)
            prog = rec
            if lower is not None:
                low = lower.decode(llr)
                prog = ({"counts": lower.count(low.u, u_true)}
                        if "counts" in rec else {"u": low.u, "pm": low.pm})
            if "counts" in prog:
                off = (prog["counts"] != cnt).any(0)
                gap, mine = None, prog["counts"].sum(1)
            else:
                off = (prog["u"] != res.u).any(1)
                gap = win.pm_gap(prog["pm"], res.pm)
                mine = ref.count(prog["u"], u_true).sum(1)
            off = int(off.sum())
            if lower is None and (rec["key"] != tuple(key) or
                                  rec["sigma"] != sigma):
                off = rec["batch"]
        out[rec["index"]] = {
            "off": off, "gap": gap, "ref_sum": cnt.sum(1).tolist(),
            "logged": mine.tolist() if lower is not None else logged[rec["index"]]}
        frames += rec["batch"]
    return {"calls": out, "passes_off": passes_off, "frames": frames,
            "control": control}
