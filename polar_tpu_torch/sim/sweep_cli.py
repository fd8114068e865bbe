"""CLI entry point for Monte-Carlo FER sweeps (PyTorch).

Counterpart of polar_tpu/sim/sweep_cli.py, on one device: the card unless
`--device cpu` is given (the plain PyTorch version). Usage:

    python -m polar_tpu_torch.sim.sweep_cli --preset sweep --backend fused \
        --frames 1000000 --state sweep_state.json --jsonl results.jsonl

`--big-stage pallas` (the JAX package's name, kept) decodes the `torch`
backend's frames with the hybrid decoder: the op program in PyTorch on
the card, every l > 2 trellis/table DOWN op one launch of the CUDA stage
kernel (ops/cuda_stage.py). For eBCH and mixed presets:

    python -m polar_tpu_torch.sim.sweep_cli --preset bch_sc --backend fused
    python -m polar_tpu_torch.sim.sweep_cli --preset bch_sc --big-stage pallas

`mixed_scl32` (N=4096, L=32) does not fit one thread block: the JAX
package's route is the hybrid, and `--subtree pallas` (the JAX
`subtree_backend` knob) adds one CUDA subtree-kernel launch a depth-1
child:

    python -m polar_tpu_torch.sim.sweep_cli --preset mixed_scl32 \
        --backend torch --big-stage pallas [--subtree pallas]

Not ported yet: `--profile` (ROADMAP Queue 1 item 10); it raises
NotImplementedError.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.sim.harness import BACKENDS, run_sweep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="ca_scl",
                   help="named preset (see polar_tpu_torch.models.presets)")
    p.add_argument("--frames", type=int, default=None,
                   help="frames per SNR point (default: preset value)")
    p.add_argument("--per-device-batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr", type=float, nargs="*", default=None,
                   help="override the Eb/N0 grid (dB)")
    p.add_argument("--list-size", type=int, default=None,
                   help="override the preset list size")
    p.add_argument("--state", default=None, help="resumable state JSON path")
    p.add_argument("--jsonl", default=None, help="append results here")
    p.add_argument("--min-frame-errors", type=int, default=0,
                   help="early-stop a point after this many frame errors")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="batches chained per call, counters summed on the "
                        "device (see harness.make_mc_step)")
    p.add_argument("--backend", choices=BACKENDS, default="torch",
                   help="torch = draw in PyTorch, decode with the CUDA "
                        "decode kernel; fused = the whole step (RNG, CRC, "
                        "encode, channel, decode, count) in one kernel; "
                        "both draw the same frames")
    p.add_argument("--big-stage", choices=("xla", "pallas"), default="xla",
                   help="l>2 kernel-input LLRs of the torch backend: xla = "
                        "in the CUDA decode kernel; pallas = the hybrid "
                        "decoder, one CUDA stage-kernel launch per l>2 "
                        "DOWN op (the fused backend ignores it)")
    p.add_argument("--subtree", choices=("none", "pallas"), default="none",
                   help="torch backend: pallas = each depth-1 child of the "
                        "code one CUDA subtree-kernel launch (the fused "
                        "backend ignores it)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="calls in flight before fetching counters "
                        "(1 = fetch every call)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch version)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="not ported yet (a torch.profiler trace)")
    args = p.parse_args(argv)
    if args.profile:
        raise NotImplementedError("--profile is not ported yet (ROADMAP "
                                  "Queue 1 item 10: torch.profiler)")

    preset = get_preset(args.preset)
    if args.snr:
        preset = dataclasses.replace(preset, ebn0_grid=tuple(args.snr))
    if args.list_size:
        preset = dataclasses.replace(preset, list_size=args.list_size)
    recs = run_sweep(preset, frames=args.frames,
                     per_device_batch=args.per_device_batch, seed=args.seed,
                     device=args.device, state_path=args.state,
                     jsonl_path=args.jsonl,
                     min_frame_errors=args.min_frame_errors,
                     steps_per_call=args.steps_per_call, backend=args.backend,
                     big_stage_backend=args.big_stage,
                     subtree_backend=args.subtree,
                     pipeline_depth=args.pipeline_depth)
    print(json.dumps({"summary": [
        {"ebn0_db": r["ebn0_db"], "fer": r["fer"], "ber": r["ber"],
         "frames": r["frames"]} for r in recs]}))


if __name__ == "__main__":
    main()
