"""Monte-Carlo BER/FER harness: Eb/N0 sweep, resume (PyTorch).

Counterpart of polar_tpu/sim/harness.py on one device (the card unless the
caller asks for the CPU):

- A step draws a batch of frames, decodes it and counts errors on the
  device: random data bits -> CRC -> encode -> BPSK-AWGN -> LLR -> decode.
  Backend "torch" draws with ops/mc.py `mc_draw` and decodes with
  `build_scl_decoder` (the CUDA decode kernel on the card); backend
  "fused" runs the whole step in one kernel launch (ops/mc.py, counters
  mode). Both draw the same frames from the same Philox keys, so on one
  seed they count the same errors: the knob trades speed only.
- Batch `step` of SNR point `i` takes the key `step_seed(seed, i, step,
  sub)` (ops/philox.py) for its sub-step `sub`, so a resumed sweep draws
  the frames it would have drawn.
- The SNR loop stays on the host. Sweep state (per-SNR frame/error
  counters and the step count) persists to JSON after every fetch; records
  stream to stdout and JSONL, with the JAX package's keys.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time

import torch

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.models.presets import Preset
from polar_tpu_torch.ops.mc import build_mc_step, count_errors, mc_draw
from polar_tpu_torch.ops.philox import step_seed
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.sim.channel import ebn0_to_sigma
from polar_tpu_torch.utils.device import resolve_device

BACKENDS = ("torch", "fused")


def make_mc_step(spec: CodeSpec, list_size: int, steps_per_call: int = 1,
                 backend: str = "torch", device="cuda",
                 big_stage_backend: str = "xla"):
    """Monte-Carlo step: step(seed, snr_index, rng_step, sigma, batch) ->
    {"frames": int, "frame_errors": tensor, "bit_errors": tensor}, the
    counters as device tensors (fetching them is the caller's sync).

    steps_per_call > 1 chains that many batches per call, sub-step `sub`
    keyed by step_seed(seed, snr_index, rng_step, sub); the counters are
    summed on the device. backend: "torch" (mc_draw + build_scl_decoder)
    or "fused" (the one-kernel step, build_mc_step counters mode)."""
    if big_stage_backend != "xla":
        raise NotImplementedError(
            f"big_stage_backend={big_stage_backend!r}: kernels of size > 2 "
            "are not ported yet (ROADMAP Queue 1 item 6)")
    dev = resolve_device(device)
    if backend == "fused":
        fused = build_mc_step(spec, list_size, dev, counters=True)

        def one(key, sigma, batch):
            fe, be, _, _ = fused(key, sigma, batch)
            return fe, be
    elif backend == "torch":
        decode = build_scl_decoder(spec, list_size, device=dev)

        def one(key, sigma, batch):
            u_true, llr = mc_draw(spec, key, sigma, batch, dev)
            cnt = count_errors(spec, decode(llr).u, u_true)
            return cnt[0].sum(), cnt[1].sum()
    else:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")

    def step(seed: int, snr_index: int, rng_step: int, sigma: float,
             batch: int) -> dict:
        fe = be = 0
        for sub in range(steps_per_call):
            f, b = one(step_seed(seed, snr_index, rng_step, sub), sigma, batch)
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


def run_sweep(preset: Preset, frames: int | None = None,
              per_device_batch: int | None = None, seed: int = 0,
              device="cuda", state_path: str | None = None,
              jsonl_path: str | None = None, min_frame_errors: int = 0,
              progress: bool = True, steps_per_call: int = 1,
              backend: str = "torch", big_stage_backend: str = "xla",
              pipeline_depth: int = 2, mesh=None) -> list[dict]:
    """Run the Monte-Carlo FER sweep for a preset on `device` (the card
    unless the caller asks for the CPU). Returns per-SNR records.

    min_frame_errors: optional early stop once a SNR point has this many
    frame errors AND at least frames/10 frames.

    pipeline_depth: calls kept in flight before the host fetches counters
    (launches are asynchronous; each fetch is one host sync). Counters are
    fetched, and the state persisted, strictly in dispatch order, so
    resume semantics do not depend on it; 1 fetches after every call.

    mesh: multi-device sweeps are not ported yet (ROADMAP Queue 1 item 9).
    """
    if mesh is not None:
        raise NotImplementedError("multi-device run_sweep is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    dev = resolve_device(device)
    frames = frames or preset.frames
    batch = per_device_batch or preset.batch
    step = make_mc_step(preset.spec, preset.list_size,
                        steps_per_call=steps_per_call, backend=backend,
                        device=dev, big_stage_backend=big_stage_backend)

    state = None
    spath = pathlib.Path(state_path) if state_path else None
    if spath and spath.exists():
        state = SweepState.load(spath)
        if state.preset != preset.name or state.snr_db != [float(s) for s in
                                                          preset.ebn0_grid]:
            state = None
    if state is None:
        state = SweepState.fresh(preset.name, preset.ebn0_grid, seed)

    records = []
    jfile = open(jsonl_path, "a") if jsonl_path else None
    for si, snr in enumerate(state.snr_db):
        sigma = float(ebn0_to_sigma(snr, preset.spec.rate))
        t0 = time.time()
        t_frames = 0
        # steady-state rate: the clock starts when the first call's
        # counters land (it includes the kernel build and the first
        # launch) and excludes its frames
        t_rate = None
        f_rate = 0
        frames_per_call = batch * steps_per_call
        pending: list = []     # dispatched-but-unfetched outs, FIFO

        def fetch_one():
            nonlocal t_frames, t_rate, f_rate
            out = pending.pop(0)
            fe, be = (int(v) for v in torch.stack([
                torch.as_tensor(out["frame_errors"]),
                torch.as_tensor(out["bit_errors"])]).cpu())
            state.rng_step[si] += 1
            state.frames[si] += out["frames"]
            state.frame_errors[si] += fe
            state.bit_errors[si] += be
            t_frames += out["frames"]
            if t_rate is None:
                t_rate = time.time()
                f_rate = t_frames
            if spath:
                state.save(spath)

        while True:
            done = state.frames[si] + len(pending) * frames_per_call
            early = (min_frame_errors and
                     state.frame_errors[si] >= min_frame_errors and
                     state.frames[si] >= frames // 10)
            if done >= frames or early:
                break
            pending.append(step(state.seed, si,
                                state.rng_step[si] + len(pending), sigma,
                                batch))
            if len(pending) >= max(1, pipeline_depth):
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
            "n_devices": 1, "global_batch": batch,
        }
        records.append(rec)
        if progress:
            print(json.dumps(rec), flush=True)
        if jfile:
            jfile.write(json.dumps(rec) + "\n")
            jfile.flush()
    if jfile:
        jfile.close()
    return records
