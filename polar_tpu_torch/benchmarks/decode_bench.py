"""Decode throughput of any preset through any backend, on the card.

Counterpart of benchmarks/decode_bench.py. Prints one JSON line:

    python -m polar_tpu_torch.benchmarks.decode_bench --preset ca_scl \
        --batch 8192 --backend pallas
    python -m polar_tpu_torch.benchmarks.decode_bench --preset bch_sc \
        --big-stage pallas
    python -m polar_tpu_torch.benchmarks.decode_bench --preset mixed_scl32 \
        --batch 256 --subtree pallas --big-stage pallas
    python -m polar_tpu_torch.benchmarks.decode_bench --preset ca_scl \
        --backend fused --device cpu --batch 4 --reps 1

Backends (the JAX package's names):
- xla: `build_scl_decoder(spec, L, device, llr_dtype=..., big_stage_backend=
  ..., subtree_backend=...)`, the route that function picks (the decode
  kernels at the defaults, the hybrid with --big-stage pallas, the subtree
  route with --subtree pallas, the op program with --llr-dtype bfloat16);
- pallas: ops/cuda_scl.py `SclDecoder`, the decode kernels alone;
- fused: ops/mc.py `build_mc_step(counters=True)`, the whole Monte-Carlo
  step (draw, CRC, encode, channel, decode, count) at Eb/N0 = 2.0 dB with
  keys (1 + i, 17) for step i. It measures more work than a decode of the
  given LLRs, so its rows say `"measures": "mc_step"`.

Timing: the LLRs (standard normal, from a seeded generator on the device)
are made once, outside the timed window. One warm-up call builds the
kernels (nvcc), uploads their tables and sets their shared memory; its
wall time is `build_s`. Then `--reps` calls are issued back to back on the
current stream between two CUDA events, with one synchronize at the end:
`ms_per_decode` is the window over `reps`. The events span the whole
stream, so a route whose host work outpaces its kernels pays for the
card's idle gaps, as its user does. On the CPU (`--device cpu`, the plain
PyTorch version) the same loop is timed by the host clock. `launches`
counts each kernel's launches inside the window (ops/cuda_scl.py and
ops/cuda_stage.py `LAUNCHES`); `card` is nvidia-smi's name and power
limit of the card.

`--batch-tile` (the TPU kernels' codewords a grid step) has no
counterpart: the CUDA kernels run one block a codeword.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from polar_tpu_torch.models.presets import PRESETS, get_preset
from polar_tpu_torch.ops import cuda_scl, cuda_stage
from polar_tpu_torch.ops.cuda_scl import SclDecoder
from polar_tpu_torch.ops.mc import build_mc_step
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.sim.channel import ebn0_to_sigma
from polar_tpu_torch.utils.device import resolve_device

FUSED_EBN0_DB = 2.0
LLR_SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="ca_scl", choices=sorted(PRESETS))
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--backend", choices=("xla", "pallas", "fused"),
                   default="xla")
    p.add_argument("--list-size", type=int, default=None)
    p.add_argument("--llr-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--big-stage", choices=("xla", "pallas"), default="xla",
                   help="xla backend: the l > 2 DOWN ops in the decode "
                        "kernels (xla) or the hybrid, one stage-kernel "
                        "launch each (pallas)")
    p.add_argument("--subtree", choices=("none", "pallas"), default="none",
                   help="xla backend: each depth-1 child one subtree-kernel "
                        "launch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the plain PyTorch version")
    args = p.parse_args(argv)
    if args.batch < 1 or args.reps < 1:
        p.error("--batch and --reps must be positive")
    return args


def card_name(device: torch.device) -> str | None:
    """nvidia-smi's name and power limit of the card, or None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _launches() -> dict:
    return {**cuda_scl.LAUNCHES, **cuda_stage.LAUNCHES}


def timed(call, reps: int, device: torch.device) -> dict:
    """Time `call(i)` for i = 1..reps after one warm-up `call(0)`:
    {"build_s": the warm-up's wall s, "ms": ms a call over the window,
    "launches": each kernel's launches inside the window (non-zero only)}."""
    t0 = time.perf_counter()
    call(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    before = _launches()
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(1, reps + 1):
            call(i)
        e1.record()
        torch.cuda.synchronize(device)
        ms = e0.elapsed_time(e1) / reps
    else:
        t0 = time.perf_counter()
        for i in range(1, reps + 1):
            call(i)
        ms = (time.perf_counter() - t0) * 1e3 / reps
    after = _launches()
    return {"build_s": build_s, "ms": ms,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}


def run(argv=None) -> dict:
    """The benchmark's record (the JSON line `main` prints)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    preset = get_preset(args.preset)
    spec = preset.spec
    L = args.list_size or preset.list_size
    B = args.batch
    frame_errors = None
    if args.backend == "fused":
        step = build_mc_step(spec, L, device=dev, counters=True)
        sigma = float(ebn0_to_sigma(FUSED_EBN0_DB, spec.rate))
        frame_errors = torch.zeros((), dtype=torch.int64, device=dev)
        route = "fused step"

        def call(i):
            frame_errors.add_(step((1 + i, 17), sigma, B)[0])
    else:
        if args.backend == "pallas":
            decode = SclDecoder(spec, L, dev)
        else:
            decode = build_scl_decoder(spec, L, device=dev,
                                       llr_dtype=getattr(torch, args.llr_dtype),
                                       big_stage_backend=args.big_stage,
                                       subtree_backend=args.subtree)
        route = decode.route
        gen = torch.Generator(device=dev).manual_seed(LLR_SEED)
        llr = torch.randn((B, spec.N), generator=gen, device=dev)

        def call(i):
            decode(llr)
    t = timed(call, args.reps, dev)
    xla = args.backend == "xla"
    return {
        "preset": args.preset, "backend": args.backend, "batch": B,
        "big_stage": args.big_stage if xla else None,
        "subtree": args.subtree if xla else None,
        "measures": "mc_step" if args.backend == "fused" else "decode",
        "route": route, "list_size": L, "ms_per_decode": t["ms"],
        "codewords_per_s": B / t["ms"] * 1e3, "build_s": t["build_s"],
        # the fused step's frame errors in its reps + 1 steps (the warm-up's
        # too), summed on the device and fetched after the window
        "frame_errors": None if frame_errors is None else int(frame_errors),
        "launches": t["launches"],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card_name(dev),
    }


def main(argv=None) -> None:
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
