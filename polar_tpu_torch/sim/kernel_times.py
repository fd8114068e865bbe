"""Time the decode kernels of this checkout on the card, by CUDA events.

    python -m polar_tpu_torch.sim.kernel_times [--reps 5] [--batch 8192]
        [--only ca_scl,arikan_sc,...]
    python -m polar_tpu_torch.sim.kernel_times --split [--batch 8192]

Rows (one JSON line each, with the card's name and power limit):
`ca_scl` (L=8): K1 (`scl_decode`) on channel LLRs at 2.0 dB and K5
(`scl_mc_counters`, the whole Monte-Carlo step); `arikan_sc` (L=1): K2
(`scl_decode_traj`); `bch_sc` (L=1): K2 and K5, and K1 at L=8; `L32`:
K1 and K2 at L=32 on (2,)*7 with CRC-8 and on the mixed (16,2,2); and
`mixed_scl32` (L=32, its batch of 256): K3 as the 13 subtree-kernel
launches of one decode (inputs captured from the K3 route) and K6 as its
15 outer stage-kernel launches. Each time is the mean of 20 launches
(2 for the mixed_scl32 rows) after 2 warm-up launches, repeated `--reps`
times; `min_ms` is the least. It uses only entry points that earlier
versions of the port have, so two checkouts can be compared in one call
on one card (run it in each, in the order A, B, B, A).

`--split` instead launches K5 and K1 at ca_scl once each through the
op-kind clock build of csrc/scl_decode.cu (`-DSCL_CLOCK`, ops/cuda_scl.py
`clock_build`) and prints the cycles a block spends in each kind of op,
as thread 0 of the first 128 blocks sees them.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops.crc import crc_append
from polar_tpu_torch.ops.cuda_scl import SclDecoder
from polar_tpu_torch.ops.encode import encode
from polar_tpu_torch.ops.mc import build_mc_step
from polar_tpu_torch.sim.channel import channel_llrs, ebn0_to_sigma

ROWS = ("ca_scl", "arikan_sc", "bch_sc", "L32", "mixed_scl32")


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


def _mixed_spec(factors, K: int, crc, seed: int = 1) -> CodeSpec:
    """A mixed-kernel spec with a deterministic frozen set (index order
    plus jitter), as chip_smoke.py makes its small specs."""
    N = int(np.prod(factors))
    r = np.random.default_rng(seed)
    nk = K + (crc.width if crc else 0)
    mask = np.ones(N, np.uint8)
    mask[np.argsort(r.random(N) + np.linspace(0, 1, N))[-nk:]] = 0
    return CodeSpec(N=N, K=K, factors=tuple(factors),
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)


def _channel(spec: CodeSpec, B: int, gen, dev) -> torch.Tensor:
    payload = torch.randint(0, 2, (B, spec.K), generator=gen, device=dev)
    if spec.crc is not None:
        payload = crc_append(spec.crc, payload)
    return channel_llrs(encode(spec, payload), 2.0, spec.rate, generator=gen)


def _decode_rows(name, spec, L, kernels, B, gen, dev):
    """(row name, kernel, fn) of K1 / K2 / K5 at one spec."""
    llr = _channel(spec, B, gen, dev)
    out = []
    for k in kernels:
        if k == "scl_decode":
            d = SclDecoder(spec, L, dev, select=True)
            out.append((name, k, L, lambda d=d: d.kernel(llr)))
        elif k == "scl_decode_traj":
            d = SclDecoder(spec, L, dev, select=False)
            out.append((name, k, L, lambda d=d: d.trajectory(llr)))
        else:
            step = build_mc_step(spec, L, device=dev, counters=True)
            sigma = float(ebn0_to_sigma(2.0, spec.rate))
            out.append((name, k, L, lambda s=step: s.counts((11, 12), sigma, B)))
    return out


def _mixed_rows(dev):
    """K3 (the 13 launches of one mixed_scl32 decode) and K6 (its 15
    outer launches), on inputs captured from the K3 route at B=256."""
    from polar_tpu_torch.ops import cuda_stage
    from polar_tpu_torch.ops.cuda_scl import SubtreeKernel
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.ops.program import build_program
    from polar_tpu_torch.ops.schedule import build_schedule
    from polar_tpu_torch.ops.scl import build_scl_decoder

    preset = get_preset("mixed_scl32")
    spec, P, B = preset.spec, preset.list_size, preset.batch
    sigma = float(ebn0_to_sigma(1.25, spec.rate))
    route = build_scl_decoder(spec, P, device=dev, subtree_backend="pallas",
                              big_stage_backend="pallas")
    _, llr = mc_draw(spec, step_seed(2026, 98, 0, B), sigma, B, dev)
    calls = []
    call = SubtreeKernel.__call__

    def spy(core, lam1, pm):
        calls.append((core, lam1.clone(), pm.clone()))
        return call(core, lam1, pm)
    SubtreeKernel.__call__ = spy
    try:
        route(llr)
    finally:
        SubtreeKernel.__call__ = call
    # the outer stage-1 DOWN ops with i < 15 (a DOWN_FRESH at one path)
    digits = build_schedule(spec).digits
    n1 = spec.block_sizes[1]
    outer = []
    for op in build_program(spec, scl=True).ops:
        if op.kind in ("DOWN_FRESH", "DOWN_DYN") and op.level == 1:
            i = 0 if op.kind == "DOWN_FRESH" else int(digits[op.t0, 0])
            if i < 15:
                outer.append((i, 1 if op.kind == "DOWN_FRESH" else P))
    gen = torch.Generator(device=dev).manual_seed(22)
    views = {p: 2.0 * torch.randn((p, 16, n1, B), generator=gen, device=dev)
             for p in {p for _, p in outer}}
    fns = [(cuda_stage.build_down_kernel(spec.kernels[0], i, p, n1), views[p])
           for i, p in outer]
    return [("mixed_scl32", f"scl_subtree x{len(calls)}", P,
             lambda: [c.kernel(l1, pm) for c, l1, pm in calls]),
            ("mixed_scl32", f"stage_down x{len(fns)}", P,
             lambda: [f(v) for f, v in fns])], B


def split(B: int, dev, card: str) -> None:
    """The op-kind clock of K5 and K1 at ca_scl, through the clock
    build."""
    from polar_tpu_torch.ops import cuda_scl

    preset = get_preset("ca_scl")
    spec, L = preset.spec, preset.list_size
    gen = torch.Generator(device=dev).manual_seed(7)
    llr = _channel(spec, B, gen, dev)
    dec = SclDecoder(spec, L, dev, select=True)
    step = build_mc_step(spec, L, device=dev, counters=True)
    sigma = float(ebn0_to_sigma(2.0, spec.rate))
    fns = {"scl_mc_counters": lambda: step.counts((11, 12), sigma, B),
           "scl_decode": lambda: dec.kernel(llr)}
    for k, fn in fns.items():
        fn()                       # the tables, outside the clock
        with cuda_scl.clock_build() as lib:
            fn()
            clk = cuda_scl.read_clock(lib)
        blocks = clk.pop("blocks")
        total = sum(clk.values())
        print(json.dumps({
            "preset": "ca_scl", "kernel": k, "batch": B,
            "blocks_measured": blocks,
            "cycles_per_block": total / blocks,
            "split": {s: {"cycles_per_block": c / blocks, "share": c / total}
                      for s, c in clk.items()},
            "card": card}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--only", default=",".join(ROWS),
                    help=f"comma-separated rows of {ROWS}")
    ap.add_argument("--split", action="store_true",
                    help="the op-kind clock of K5 and K1 at ca_scl instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    B = args.batch
    if args.split:
        split(B, dev, card)
        return
    gen = torch.Generator(device=dev).manual_seed(7)
    only = args.only.split(",")
    crc8 = CrcSpec(8, 0x07, 0)
    groups = {
        "ca_scl": lambda: _decode_rows("ca_scl", get_preset("ca_scl").spec, 8,
                                       ("scl_decode", "scl_mc_counters"), B, gen, dev),
        "arikan_sc": lambda: _decode_rows("arikan_sc", get_preset("arikan_sc").spec,
                                          1, ("scl_decode_traj",), B, gen, dev),
        "bch_sc": lambda: (
            _decode_rows("bch_sc", get_preset("bch_sc").spec, 1,
                         ("scl_decode_traj", "scl_mc_counters"), B, gen, dev)
            + _decode_rows("bch_sc", get_preset("bch_sc").spec, 8,
                           ("scl_decode",), B, gen, dev)),
        "L32": lambda: (
            _decode_rows("L32 (2,)*7", _mixed_spec((2,) * 7, 56, crc8), 32,
                         ("scl_decode", "scl_decode_traj"), B, gen, dev)
            + _decode_rows("L32 (16,2,2)", _mixed_spec((16, 2, 2), 20, crc8), 32,
                           ("scl_decode", "scl_decode_traj"), B, gen, dev)),
    }
    for group in only:
        if group == "mixed_scl32":
            rows, batch = _mixed_rows(dev)
            iters = 2
        else:
            rows, batch, iters = groups[group](), B, 20
        for name, k, L, fn in rows:
            ms = [_ms(fn, iters) for _ in range(args.reps)]
            print(json.dumps({"preset": name, "kernel": k, "L": L, "batch": batch,
                              "ms": ms, "min_ms": min(ms), "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
