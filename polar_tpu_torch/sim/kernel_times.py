"""Time the decode kernels of this checkout on the card, by CUDA events.

    python -m polar_tpu_torch.sim.kernel_times [--reps 5] [--batch 8192]

For `ca_scl` (L=8): K1 (`scl_decode`) on channel LLRs at 2.0 dB and K5
(`scl_mc_counters`, the whole Monte-Carlo step); for `arikan_sc` (L=1): K2
(`scl_decode_traj`); for `bch_sc` (L=1), where the checkout decodes it: K2
and K5. Each time is the
mean of 20 launches after 2 warm-up launches, repeated `--reps` times.
Prints one JSON line a kernel and preset, with the card's name and power
limit. It uses only entry points that earlier versions of the port have,
so two checkouts can be compared in one call on one card (run it in each,
in the order A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops.cuda_scl import SclDecoder
from polar_tpu_torch.ops.mc import build_mc_step
from polar_tpu_torch.sim.channel import channel_llrs, ebn0_to_sigma
from polar_tpu_torch.ops.encode import encode


def _ms(fn, iters: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    B = args.batch
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, kernels in (("ca_scl", ("scl_decode", "scl_mc_counters")),
                          ("arikan_sc", ("scl_decode_traj",)),
                          ("bch_sc", ("scl_decode_traj", "scl_mc_counters"))):
        preset = get_preset(name)
        spec, L = preset.spec, preset.list_size
        try:
            dec = SclDecoder(spec, L, dev)
        except NotImplementedError as exc:
            print(json.dumps({"preset": name, "skipped": str(exc)}))
            continue
        info = torch.randint(0, 2, (B, spec.K), generator=gen, device=dev)
        payload = info
        if spec.crc is not None:
            from polar_tpu_torch.ops.crc import crc_append
            payload = crc_append(spec.crc, info)
        llr = channel_llrs(encode(spec, payload), 2.0, spec.rate, generator=gen)
        step = build_mc_step(spec, L, device=dev, counters=True)
        sigma = float(ebn0_to_sigma(2.0, spec.rate))
        fns = {"scl_decode": lambda: dec.kernel(llr),
               "scl_decode_traj": lambda: dec.trajectory(llr),
               "scl_mc_counters": lambda: step.counts((11, 12), sigma, B)}
        for k in kernels:
            ms = [_ms(fns[k]) for _ in range(args.reps)]
            print(json.dumps({"preset": name, "kernel": k, "batch": B,
                              "ms": ms, "min_ms": min(ms), "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
