"""Monte-Carlo BER/FER harness: Eb/N0 sweep, sharded batches, resume
(PyTorch).

Counterpart of polar_tpu/sim/harness.py, on one device (the card unless
the caller asks for the CPU) or on a mesh of cards, one process a card
(parallel/mesh.py):

- A step draws a batch of frames, decodes it and counts errors on the
  device: random data bits -> CRC -> encode -> BPSK-AWGN -> LLR -> decode.
  Backend "torch" draws with ops/mc.py `mc_draw` and decodes with
  `build_scl_decoder` (the CUDA decode kernel on the card); backend
  "fused" runs the whole step in one kernel launch (ops/mc.py, counters
  mode). Both draw the same frames from the same Philox keys, so on one
  seed they count the same errors: the knob trades speed only.
- Batch `step` of SNR point `i` takes the key `step_seed(seed, i, step,
  sub, rank)` (ops/philox.py) for its sub-step `sub` on mesh rank `rank`,
  so a resumed sweep draws the frames it would have drawn.
- The SNR loop stays on the host. Each call's counters (summed over the
  mesh) are copied to the host as they are dispatched, and a fetch waits
  for that copy alone, so `pipeline_depth` calls overlap. Sweep state
  (per-SNR frame/error counters and the step count) persists to JSON
  after every fetch; records stream to stdout and JSONL, with the JAX
  package's keys.
- Under a torch.profiler profile, host spans (utils/spans.py) mark a
  sweep's set-up (`run_sweep.setup`) and each call's dispatch, fetch,
  state save and draw (`run_sweep.*`, `mc_step.draw`); untraced they
  cost a flag check.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time

import torch
import torch.distributed as dist

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.models.presets import Preset
from polar_tpu_torch.ops.mc import build_mc_step, count_errors, mc_draw
from polar_tpu_torch.ops.philox import step_seed
from polar_tpu_torch.ops.scl import (BIG_STAGE_BACKENDS, SUBTREE_BACKENDS,
                                     build_scl_decoder)
from polar_tpu_torch.parallel.mesh import make_batch_mesh, sharded_mc_step
from polar_tpu_torch.sim.channel import ebn0_to_sigma
from polar_tpu_torch.utils.device import resolve_device
from polar_tpu_torch.utils.spans import span

BACKENDS = ("torch", "fused")


def make_mc_step(spec: CodeSpec, list_size: int, steps_per_call: int = 1,
                 backend: str = "torch", device="cuda",
                 big_stage_backend: str = "xla", subtree_backend: str = "none"):
    """Monte-Carlo step: step(seed, snr_index, rng_step, sigma, batch,
    rank=0) -> {"frames": int, "frame_errors": tensor, "bit_errors":
    tensor}, the counters as device tensors (fetching them is the caller's
    sync).

    steps_per_call > 1 chains that many batches per call, sub-step `sub`
    keyed by step_seed(seed, snr_index, rng_step, sub, rank); the counters
    are summed on the device. `rank`: the mesh rank whose frames are drawn
    (parallel/mesh.py `sharded_mc_step` passes it). backend: "torch"
    (mc_draw + build_scl_decoder) or "fused" (the one-kernel step,
    build_mc_step counters mode).
    big_stage_backend, subtree_backend: passed to build_scl_decoder by the
    "torch" backend ("pallas": the hybrid decoder with the CUDA stage
    kernel; the subtree route with one CUDA subtree-kernel launch a
    depth-1 child, mixed_scl32's route); the "fused" step has its own l > 2
    code and ignores both, as the JAX package's ignores big_stage_backend."""
    if big_stage_backend not in BIG_STAGE_BACKENDS:
        raise ValueError(f"unknown big_stage_backend {big_stage_backend!r}")
    if subtree_backend not in SUBTREE_BACKENDS:
        raise ValueError(f"unknown subtree_backend {subtree_backend!r}")
    dev = resolve_device(device)
    if backend == "fused":
        fused = build_mc_step(spec, list_size, dev, counters=True)

        def one(key, sigma, batch):
            fe, be, _, _ = fused(key, sigma, batch)
            return fe, be
    elif backend == "torch":
        decode = build_scl_decoder(spec, list_size, device=dev,
                                   big_stage_backend=big_stage_backend,
                                   subtree_backend=subtree_backend)

        def one(key, sigma, batch):
            with span("mc_step.draw"):
                u_true, llr = mc_draw(spec, key, sigma, batch, dev)
            cnt = count_errors(spec, decode(llr).u, u_true)
            return cnt[0].sum(), cnt[1].sum()
    else:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")

    def step(seed: int, snr_index: int, rng_step: int, sigma: float,
             batch: int, rank: int = 0) -> dict:
        fe = be = 0
        for sub in range(steps_per_call):
            f, b = one(step_seed(seed, snr_index, rng_step, sub, rank), sigma,
                       batch)
            fe, be = fe + f, be + b
        return {"frames": batch * steps_per_call, "frame_errors": fe,
                "bit_errors": be}

    return step


def wilson_ci(errors: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for the FER estimate."""
    if n == 0:
        return (0.0, 1.0)
    p = errors / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


@dataclasses.dataclass
class SweepState:
    """Resumable per-sweep counters, persisted as JSON (the JAX package's
    fields, so either package reads the other's file)."""
    preset: str
    snr_db: list[float]
    frames: list[int]
    frame_errors: list[int]
    bit_errors: list[int]
    rng_step: list[int]
    seed: int

    @classmethod
    def fresh(cls, name: str, grid, seed: int) -> "SweepState":
        n = len(grid)
        return cls(name, [float(s) for s in grid], [0] * n, [0] * n,
                   [0] * n, [0] * n, seed)

    def save(self, path: pathlib.Path) -> None:
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(dataclasses.asdict(self)))
        tmp.replace(path)

    @classmethod
    def load(cls, path: pathlib.Path) -> "SweepState":
        return cls(**json.loads(path.read_text()))


@dataclasses.dataclass
class InFlight:
    """One dispatched call: its frames and the host copy of its counters,
    ready once `event` (None on the CPU) has passed."""
    frames: int
    host: torch.Tensor
    event: "torch.cuda.Event | None"

    def counts(self) -> tuple[int, int]:
        """(frame errors, bit errors), waiting for this call's copy alone."""
        if self.event is not None:
            self.event.synchronize()
        fe, be = self.host.tolist()
        return fe, be


class CounterCopies:
    """Host buffers for the counters of the calls in flight: a ring of
    `depth + 1`, so that no buffer is written again while its copy is in
    flight. On the card each copy is a non-blocking copy into pinned memory
    followed by an event on the stream; on the CPU the copy is done at
    once."""

    def __init__(self, depth: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ring = [torch.zeros(2, dtype=torch.int64, pin_memory=self.cuda)
                     for _ in range(depth + 1)]
        self.next = 0

    def start(self, frames: int, counts: torch.Tensor) -> InFlight:
        """Start the copy of one call's counts (int64 [2])."""
        host = self.ring[self.next]
        self.next = (self.next + 1) % len(self.ring)
        host.copy_(counts, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(counts.device))
        return InFlight(frames, host, event)


def run_sweep(preset: Preset, frames: int | None = None,
              per_device_batch: int | None = None, seed: int = 0,
              device="cuda", state_path: str | None = None,
              jsonl_path: str | None = None, min_frame_errors: int = 0,
              progress: bool = True, steps_per_call: int = 1,
              backend: str = "torch", big_stage_backend: str = "xla",
              subtree_backend: str = "none", pipeline_depth: int = 2,
              mesh=None) -> list[dict]:
    """Run the Monte-Carlo FER sweep for a preset on `device` (the card
    unless the caller asks for the CPU). Returns per-SNR records.

    min_frame_errors: optional early stop once a SNR point has this many
    frame errors AND at least frames/10 frames.

    pipeline_depth: calls kept in flight before the host fetches counters
    (launches are asynchronous; a fetch waits for its own call's counters
    only). Counters are fetched, and the state persisted, strictly in
    dispatch order, so resume semantics do not depend on it; 1 fetches
    after every call.

    mesh: a parallel/mesh.py BatchMesh (default: `make_batch_mesh(device=
    device)`, every rank of the process group where one is up, else this
    process alone on `device`). Each rank draws `per_device_batch` frames
    a batch (default: the preset's batch over the mesh size) on the mesh's
    device, keyed by its rank, and fetches the counters summed over the
    mesh, so every rank takes the same decisions. Rank 0 alone reads the
    state file (and sends it to the others), saves it, writes JSONL and
    prints.
    """
    with span("run_sweep.setup"):
        mesh = mesh or make_batch_mesh(device=device)
        n_dev = mesh.size
        frames = frames or preset.frames
        pdb = per_device_batch or max(1, preset.batch // n_dev)
        global_batch = pdb * n_dev
        raw_step = make_mc_step(preset.spec, preset.list_size,
                                steps_per_call=steps_per_call,
                                backend=backend, device=mesh.device,
                                big_stage_backend=big_stage_backend,
                                subtree_backend=subtree_backend)
        step = sharded_mc_step(raw_step, mesh)
        lead = mesh.rank == 0

        state = None
        spath = pathlib.Path(state_path) if state_path else None
        if lead and spath and spath.exists():
            state = SweepState.load(spath)
            if state.preset != preset.name or state.snr_db != [
                    float(s) for s in preset.ebn0_grid]:
                state = None
        if mesh.group is not None:
            box = [state]
            dist.broadcast_object_list(box, src=0, group=mesh.group,
                                       device=mesh.device)
            state = box[0]
        if state is None:
            state = SweepState.fresh(preset.name, preset.ebn0_grid, seed)

        records = []
        jfile = open(jsonl_path, "a") if jsonl_path and lead else None
        depth = max(1, pipeline_depth)
        copies = CounterCopies(depth, mesh.device)
    for si, snr in enumerate(state.snr_db):
        sigma = float(ebn0_to_sigma(snr, preset.spec.rate))
        t0 = time.time()
        t_frames = 0
        # steady-state rate: the clock starts when the first call's
        # counters land (it includes the kernel build and the first
        # launch) and excludes its frames
        t_rate = None
        f_rate = 0
        frames_per_call = global_batch * steps_per_call
        pending: list[InFlight] = []     # dispatched, not fetched: FIFO

        def fetch_one():
            nonlocal t_frames, t_rate, f_rate
            with span("run_sweep.fetch"):
                call = pending.pop(0)
                fe, be = call.counts()
                state.rng_step[si] += 1
                state.frames[si] += call.frames
                state.frame_errors[si] += fe
                state.bit_errors[si] += be
                t_frames += call.frames
                if t_rate is None:
                    t_rate = time.time()
                    f_rate = t_frames
                if spath and lead:
                    with span("run_sweep.save"):
                        state.save(spath)

        while True:
            done = state.frames[si] + len(pending) * frames_per_call
            early = (min_frame_errors and
                     state.frame_errors[si] >= min_frame_errors and
                     state.frames[si] >= frames // 10)
            if done >= frames or early:
                break
            with span("run_sweep.dispatch"):
                out = step(state.seed, si, state.rng_step[si] + len(pending),
                           sigma, pdb)
                pending.append(copies.start(out["frames"], out["counts"]))
            if len(pending) >= depth:
                fetch_one()
        while pending:
            fetch_one()
        dt = max(time.time() - t0, 1e-9)
        if t_rate is not None and t_frames > f_rate:
            rate = (t_frames - f_rate) / max(time.time() - t_rate, 1e-9)
        else:
            rate = t_frames / dt if t_frames else None
        n, fe, be = state.frames[si], state.frame_errors[si], state.bit_errors[si]
        lo, hi = wilson_ci(fe, n)
        rec = {
            "preset": preset.name, "ebn0_db": snr, "frames": n,
            "frame_errors": fe, "bit_errors": be,
            "fer": fe / max(n, 1), "ber": be / max(n * preset.spec.K, 1),
            "fer_ci95": [lo, hi],
            "codewords_per_s": rate,
            "n_devices": n_dev, "global_batch": global_batch,
        }
        records.append(rec)
        if progress and lead:
            print(json.dumps(rec), flush=True)
        if jfile:
            jfile.write(json.dumps(rec) + "\n")
            jfile.flush()
    if jfile:
        jfile.close()
    return records
