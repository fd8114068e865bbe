"""Time the decode kernels of this checkout on the card, by CUDA events.

    python -m polar_tpu_torch.sim.kernel_times [--reps 5] [--batch 8192]
        [--only ca_scl,arikan_sc,...] [--mixed-batch 256]
    python -m polar_tpu_torch.sim.kernel_times --split [--batch 8192]
        [--only ca_scl,bch_sc,L32,mixed_scl32]

Rows (one JSON line each, with the card's name and power limit):
`ca_scl` (L=8): K1 (`scl_decode`) on channel LLRs at 2.0 dB and K5
(`scl_mc_counters`, the whole Monte-Carlo step), then K2 and K4 (the
full-mode step) at L=8; `arikan_sc` (L=1): K2
(`scl_decode_traj`); `bch_sc` (L=1): K2, K4 (`scl_mc_traj`) and K5, and
K1 at L=8; `golden_mixed` (the spec of results/golden_mixed_scl_b128.npz,
N=512, (16,2,2,2,2,2): the one spec whose layout can take the general
body's two-warp instances): K5 and K1 at L = 4..8; `L32`:
K1 and K2 at L=32 on (2,)*7 with CRC-8 and on the mixed (16,2,2); and
`mixed_scl32` (L=32, `--mixed-batch` codewords, the preset's 256 by
default): K3 as the 13 subtree-kernel launches of one decode (inputs
captured from the K3 route), K6 as its 15 outer stage-kernel launches, the
whole decode through the K3 route, and
K6 alone at each input i < 15 of the 16x16 kernel at the outer shape
(P=32, n=256; and input 0 at one path, P=1); the `bch_sc` rows end with K6
alone at each trellis input at bch_sc's hybrid shapes ((P, n) = (1, 16)
and (1, 1)). Each time is the mean of 20 launches
(2 for the mixed_scl32 rows) after 2 warm-up launches, repeated `--reps`
times; `min_ms` is the least. It uses only entry points that earlier
versions of the port have, so two checkouts can be compared in one call
on one card (run it in each, in the order A, B, B, A).

`--split` instead launches K5 and K1 at ca_scl once each, K5 at bch_sc
(L=1) and K1 at bch_sc L=8, K1 at L=32 on
the two `L32` specs (`--batch` codewords), and K3 as the 13 launches of one
mixed_scl32 decode (the captured inputs above), through the op-kind clock
build of csrc/scl_decode.cu (`-DSCL_CLOCK`, ops/cuda_scl.py
`clock_build`) and prints the cycles a block spends in each kind of op,
as thread 0 of the first 128 blocks of each launch sees them; the l > 2
DOWN ops have slots of their own (the last input, the syndrome trellis,
the tail table). `split_by_stage` gives the general body's cycles a block
by the stage of the op (its level; key 0 the set-up, prologue and
epilogue). It also prints the R1/SPC fork rounds a block ran and
the chain's cycles a round: the rounds follow from the op program alone
(`fork_rounds`), and a clock build that counts them (its `R1/SPC rounds`
slot) must agree. Beside each decode kernel's split: the instance,
threads and codewords a block and shared memory of its launch plan
(`occupancy`), the blocks an SM (the occupancy API), and
its registers and spilled bytes from ptxas's report of the main build
(`ptxas_report`). `--only` picks the runs (`ca_scl`, `bch_sc`, `L32`,
`mixed_scl32`).

`--slots` runs csrc/warp_slots.cu, a probe that records the SM and warp
slot of every warp of a launch that fills the SMs with blocks of the
Arikan capacity-8 body's shapes at ca_scl (K5: 128 threads, 8 blocks an
SM; K1: 64 threads, 10), and prints the slots of the blocks on a few SMs
and how the leader-warp rule (`cuda_scl.leader_warp`) spreads the leaders
over the four sub-partitions, beside warp 0.

`--chunks` times K5 (`scl_mc_counters`) over one batch as one device
launch and as back-to-back launches of R = 1, 2 and 4 rounds (a round: the
codewords every SM holds at once by the launch plan), on one stream with
no sync between them: bch_sc (L=1, `_big_t32_cw2`) at its cell's
B = 32768 and ca_scl (L=8, `_t128`) at B = 8192, in the order one launch,
R = 1, 2, 4, 4, 2, 1, one launch, `--reps` times; every chunking's counters
must equal the one launch's (or it raises). `plan_chunk` is the chunk the
launch plan takes (ops/cuda_scl.py K5_CHUNK_ROUNDS).

`--k6-lanes` times K6 alone at each trellis input of the 16x16 kernel at
every lane count (R = S / lanes states a lane), beside the count the rule
(`cuda_stage.lanes_for`) picks, at mixed_scl32's outer shapes and bch_sc's
hybrid shapes.

`--sass-against DIR` prints which kernel instances of csrc/scl_decode.cu
compile to the same SASS here and in the checkout DIR (cuobjdump of each
checkout's built library, whitespace and the anonymous namespace's hash
left out): instances whose source did not change should all be equal.

`trace_summary` reads a torch.profiler Chrome trace (sim/sweep_cli.py
`--profile`): the device's busy and idle share of the traced window, the
kernels that take the most time, and the longest idle gaps with the host
ops that overlap them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
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
from polar_tpu_torch.sim.golden import load_golden

ROWS = ("ca_scl", "arikan_sc", "bch_sc", "golden_mixed", "L32", "mixed_scl32")
GOLDEN_MIXED = pathlib.Path(__file__).resolve().parents[2] / "results" / "golden_mixed_scl_b128.npz"
SPLIT_RUNS = ("ca_scl", "bch_sc", "L32", "mixed_scl32")


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
            counters = k == "scl_mc_counters"
            step = build_mc_step(spec, L, device=dev, counters=counters)
            sigma = float(ebn0_to_sigma(2.0, spec.rate))
            fn = step.counts if counters else step.trajectory
            out.append((name, k, L, lambda f=fn: f((11, 12), sigma, B)))
    return out


def fork_rounds(spec: CodeSpec, P: int) -> int:
    """The R1/SPC fork rounds of one decode of `spec` at list size P (a
    property of the op program: min(P - 1, n) an R1 node, min(P, n - 1)
    an SPC node, none at P = 1)."""
    from polar_tpu_torch.ops.program import build_program

    if P == 1:
        return 0
    n_of = spec.block_sizes
    return sum(min(P - 1, n_of[op.level]) if op.kind == "R1"
               else min(P, n_of[op.level] - 1)
               for op in build_program(spec, scl=True).ops
               if op.kind in ("R1", "SPC"))


def _instance(mangled: str) -> str:
    """A kernel's own name from its mangled one (_ZN <namespace> <name> E)."""
    ns = re.match(r"_ZN(\d+)", mangled)
    if not ns:
        return mangled
    rest = mangled[ns.end() + int(ns.group(1)):]
    k = re.match(r"\d+", rest)
    return rest[k.end():k.end() + int(k.group())]


def ptxas_report(text: str) -> dict:
    """{kernel instance: {"registers", "spill_bytes"}} from nvcc's
    `-Xptxas -v` report (spill_bytes counts the stores)."""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = _instance(m.group(1))
            out[entry] = {"registers": None, "spill_bytes": 0}
        elif entry is not None:
            r = re.search(r"Used (\d+) registers", line)
            if r:
                out[entry]["registers"] = int(r.group(1))
            s = re.search(r"(\d+) bytes spill stores", line)
            if s:
                out[entry]["spill_bytes"] = int(s.group(1))
    return out


def instance_name(spec: CodeSpec, P: int, kernel: str) -> str:
    """The library's instance that runs `kernel` for (spec, P) on an H100:
    its launch plan's (`cuda_scl.launch_plan`). In checkouts without one,
    the name rebuilt from their rule: the Arikan capacity-8 body's with
    `_t64` / `_t128` by its threads (the kernel's own name before that
    body's second redesign); the general body's with `_big` (l > 2 kernels
    or the subtree kernel), then `_t32` / `_t64` by its threads at capacity
    8 (`_t32_cw2` where a warp decodes two codewords) or `_c32` at capacity
    32."""
    from polar_tpu_torch.ops import cuda_scl

    if hasattr(cuda_scl, "launch_plan"):
        return cuda_scl.launch_plan(spec, P, kernel).instance
    if cuda_scl.arikan8(spec, P, kernel):
        # by threads a codeword since the body's second redesign
        threads = getattr(cuda_scl, "fast_threads", None)
        return f"{kernel}_t{threads(spec, P, kernel)}" if threads else kernel
    big = any(f > 2 for f in spec.factors)
    base = kernel + ("_big" if big and kernel != "scl_subtree" else "")
    if P > 8:
        return base + "_c32"
    codewords = getattr(cuda_scl, "general_codewords", None)
    if codewords is not None and codewords(spec, P, kernel) == 2:
        return base + "_t32_cw2"
    return f"{base}_t{cuda_scl.general_threads(spec, P, kernel)}"


def occupancy(kern, kernel: str, dev) -> dict:
    """Instance, threads and codewords a block, blocks an SM (occupancy
    API) and (dynamic, static) shared memory of `kernel` on the SclKernels
    `kern`: its launch plan's on `dev`, or in checkouts without one the
    library's answers and `instance_name`."""
    if hasattr(kern, "plan"):
        plan = kern.plan(kernel, dev)
        return {"instance": plan.instance, "threads": plan.threads,
                "codewords": plan.codewords,
                "blocks_per_sm": kern.blocks_per_sm(kernel, dev),
                "smem_bytes": [plan.smem, plan.static]}
    return {"instance": instance_name(kern.spec, kern.P, kernel),
            "threads": kern.block_threads(kernel, dev),
            "blocks_per_sm": kern.blocks_per_sm(kernel, dev),
            "smem_bytes": list(kern.smem_bytes(kernel, dev))}


def _mixed_capture(dev, B: int):
    """(calls, outer, decode): the (core, lam1, pm) of the 13 K3 launches
    of one mixed_scl32 decode of B codewords through the K3 route, the (i,
    paths) of its 15 outer K6 launches, and that decode."""
    from polar_tpu_torch.ops.cuda_scl import SubtreeKernel
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.ops.program import build_program
    from polar_tpu_torch.ops.schedule import build_schedule
    from polar_tpu_torch.ops.scl import build_scl_decoder

    preset = get_preset("mixed_scl32")
    spec, P = preset.spec, preset.list_size
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
        route.walk(llr)     # eager: a replayed graph calls no Python
    finally:
        SubtreeKernel.__call__ = call
    # the outer stage-1 DOWN ops with i < 15 (a DOWN_FRESH at one path)
    digits = build_schedule(spec).digits
    outer = []
    for op in build_program(spec, scl=True).ops:
        if op.kind in ("DOWN_FRESH", "DOWN_DYN") and op.level == 1:
            i = 0 if op.kind == "DOWN_FRESH" else int(digits[op.t0, 0])
            if i < 15:
                outer.append((i, 1 if op.kind == "DOWN_FRESH" else P))
    return calls, outer, lambda: route(llr)


def _mixed_rows(dev, B: int):
    """K3 (the 13 launches of one mixed_scl32 decode of B codewords) and K6
    (its 15 outer launches), on inputs captured from the K3 route, and K6
    alone at each table input i of the 16x16 kernel at the outer shape
    (P=32, n=256)."""
    from polar_tpu_torch.ops import cuda_stage

    calls, outer, decode = _mixed_capture(dev, B)
    preset = get_preset("mixed_scl32")
    spec, P = preset.spec, preset.list_size
    n1 = spec.block_sizes[1]
    gen = torch.Generator(device=dev).manual_seed(22)
    views = {p: 2.0 * torch.randn((p, 16, n1, B), generator=gen, device=dev)
             for p in {p for _, p in outer} | {P}}
    fns = [(cuda_stage.build_down_kernel(spec.kernels[0], i, p, n1), views[p])
           for i, p in outer]
    rows = [("mixed_scl32", f"scl_subtree x{len(calls)}", P,
             lambda: [c.kernel(l1, pm) for c, l1, pm in calls]),
            ("mixed_scl32", f"stage_down x{len(fns)}", P,
             lambda: [f(v) for f, v in fns]),
            ("mixed_scl32", "K3 route decode", P, decode)]
    for i in range(15):
        f = cuda_stage.build_down_kernel(spec.kernels[0], i, P, n1)
        rows.append(("mixed_scl32", f"stage_down i={i}", P,
                     lambda f=f: f(views[P])))
    # the one outer launch at one path: input 0 (a trellis input)
    f = cuda_stage.build_down_kernel(spec.kernels[0], 0, 1, n1)
    rows.append(("mixed_scl32", "stage_down i=0 P=1", 1, lambda: f(views[1])))
    return rows


def _bch_stage_rows(B: int, dev):
    """K6 alone at each trellis input of the 16x16 kernel at bch_sc's
    hybrid shapes, (P, n) = (1, 16) and (1, 1), B codewords."""
    from polar_tpu_torch.ops import cuda_stage

    spec = get_preset("bch_sc").spec
    K = spec.kernels[0]
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for n in (16, 1):
        x = 2.0 * torch.randn((1, 16, n, B), generator=gen, device=dev)
        for i in range(15):
            if cuda_stage.big_kernel(K).states[i]:
                f = cuda_stage.build_down_kernel(K, i, 1, n)
                rows.append(("bch_sc", f"stage_down i={i} n={n}", 1,
                             lambda f=f, x=x: f(x)))
    return rows


def k6_lanes(dev, card: str, reps: int) -> None:
    """K6 alone at each trellis input of the 16x16 kernel at every lane
    count (1 .. S: R = S / lanes states a lane), beside the count that
    `cuda_stage.lanes_for` picks, at mixed_scl32's outer shapes (P = 1, 32;
    n = 256; B = 256) and bch_sc's hybrid shapes ((1, 16) and (1, 1),
    B = 8192)."""
    from polar_tpu_torch.ops import cuda_stage

    K = get_preset("bch_sc").spec.kernels[0]
    bk = cuda_stage.big_kernel(K)
    gen = torch.Generator(device=dev).manual_seed(24)
    for paths, n, B in ((1, 256, 256), (32, 256, 256), (1, 16, 8192), (1, 1, 8192)):
        x = 2.0 * torch.randn((paths, 16, n, B), generator=gen, device=dev)
        for i in range(15):
            S = int(bk.states[i])
            if not S:
                continue
            f = cuda_stage.build_down_kernel(K, i, paths, n)
            lanes, ms = 1, {}
            while lanes <= S:
                ms[lanes] = min(_ms(lambda: f.kernel_call(x, lanes))
                                for _ in range(reps))
                lanes *= 2
            print(json.dumps({"kernel": "stage_down", "i": i, "states": S,
                              "P": paths, "n": n, "batch": B,
                              "rule_lanes": cuda_stage.lanes_for(bk, i, paths * n * B),
                              "min_ms_by_lanes": ms, "card": card}), flush=True)


CHUNK_ROUNDS = (1, 2, 4)
CHUNK_RUNS = (("bch_sc", 1, 32768), ("ca_scl", 8, 8192))


def chunks(dev, card: str, reps: int) -> None:
    """K5 over one batch as one device launch against back-to-back chunks
    of CHUNK_ROUNDS rounds, at bch_sc and ca_scl (CHUNK_RUNS); a JSON line
    each with the mean ms a call of 20 calls, `reps` times in the order A
    B B A."""
    from polar_tpu_torch.ops import cuda_scl

    for preset, L, B in CHUNK_RUNS:
        spec = get_preset(preset).spec
        step = build_mc_step(spec, L, device=dev, counters=True)
        kern = step.decoder.kernels
        plan = kern.plan("scl_mc_counters", dev)
        sms = cuda_scl.device_limits(cuda_scl._device_index(dev)).sms
        rnd = plan.blocks_per_sm * sms * plan.codewords
        sigma = float(np.float32(ebn0_to_sigma(2.0, spec.rate)))
        cnt = torch.empty((2, B), dtype=torch.int32, device=dev)
        sizes = {"one": B, **{f"R={r}": r * rnd for r in CHUNK_ROUNDS}}

        def run(chunk):
            kern.launch("scl_mc_counters", B, dev, chunk=chunk, noise=None, seed0=11,
                        seed1=12, sigma=sigma, counters=cnt)
        run(B)
        ref = cnt.clone()
        for chunk in sizes.values():
            cnt.zero_()
            run(chunk)
            if not torch.equal(cnt, ref):
                raise RuntimeError(f"{preset}: K5 in chunks of {chunk} differs from one launch")
        order = list(sizes) + list(sizes)[::-1]
        ms = {k: [] for k in sizes}
        for _ in range(reps):
            for k in order:
                ms[k].append(_ms(lambda c=sizes[k]: run(c)))
        one = min(ms["one"])
        print(json.dumps({
            "preset": preset, "kernel": "scl_mc_counters", "instance": plan.instance,
            "L": L, "batch": B, "round": rnd, "plan_chunk": plan.chunk,
            "launches": {k: len(cuda_scl.launch_chunks(B, c)) for k, c in sizes.items()},
            "ms": ms, "min_ms": {k: min(v) for k, v in ms.items()},
            "vs_one": {k: one / min(v) for k, v in ms.items()},
            "card": card}), flush=True)


def split(B: int, dev, card: str, only=SPLIT_RUNS) -> None:
    """The op-kind clock of K5 and K1 at ca_scl (B codewords), of K5 at
    bch_sc (L=1) and K1 at bch_sc L=8 (B codewords), of K1 at L=32 on the
    `L32` specs (B codewords) and of K3 on the 13 children of one
    mixed_scl32 decode (B=256), through the clock build."""
    from polar_tpu_torch.ops import cuda_build, cuda_scl

    # older checkouts' clock builds have no round count
    rounds_slot = getattr(cuda_scl, "ROUNDS_SLOT", None)
    runs = []       # (preset, kernel, batch, fn, (fork rounds, launches))
    if "ca_scl" in only:
        preset = get_preset("ca_scl")
        spec, L = preset.spec, preset.list_size
        gen = torch.Generator(device=dev).manual_seed(7)
        llr = _channel(spec, B, gen, dev)
        dec = SclDecoder(spec, L, dev, select=True)
        step = build_mc_step(spec, L, device=dev, counters=True)
        sigma = float(ebn0_to_sigma(2.0, spec.rate))
        rounds = (fork_rounds(spec, L), 1)
        runs += [("ca_scl", "scl_mc_counters", B,
                  lambda st=step, sg=sigma: st.counts((11, 12), sg, B), rounds,
                  (spec, L)),
                 ("ca_scl", "scl_decode", B, lambda d=dec, x=llr: d.kernel(x),
                  rounds, (spec, L))]
    if "bch_sc" in only:
        spec = get_preset("bch_sc").spec
        gen = torch.Generator(device=dev).manual_seed(7)
        llr = _channel(spec, B, gen, dev)
        dec = SclDecoder(spec, 8, dev, select=True)
        step = build_mc_step(spec, 1, device=dev, counters=True)
        sigma = float(ebn0_to_sigma(2.0, spec.rate))
        runs += [("bch_sc", "scl_mc_counters", B,
                  lambda st=step, sg=sigma: st.counts((11, 12), sg, B),
                  (fork_rounds(spec, 1), 1), (spec, 1)),
                 ("bch_sc L=8", "scl_decode", B, lambda d=dec, x=llr: d.kernel(x),
                  (fork_rounds(spec, 8), 1), (spec, 8))]
    if "L32" in only:
        gen = torch.Generator(device=dev).manual_seed(7)
        crc8 = CrcSpec(8, 0x07, 0)
        for name, spec in (("L32 (2,)*7", _mixed_spec((2,) * 7, 56, crc8)),
                           ("L32 (16,2,2)", _mixed_spec((16, 2, 2), 20, crc8))):
            runs.append((name, "scl_decode", B,
                         lambda d=SclDecoder(spec, 32, dev, select=True),
                         x=_channel(spec, B, gen, dev): d.kernel(x),
                         (fork_rounds(spec, 32), 1), (spec, 32)))
    if "mixed_scl32" in only:
        Bm = get_preset("mixed_scl32").batch
        calls, _, _ = _mixed_capture(dev, Bm)
        rounds = (sum(fork_rounds(c.spec, c.P) for c, _, _ in calls), len(calls))
        runs.append(("mixed_scl32", f"scl_subtree x{len(calls)}", Bm,
                     lambda: [c.kernel(l1, pm) for c, l1, pm in calls], rounds,
                     None))
    cuda_scl.load_library()        # the main build: its ptxas report
    ptxas = ptxas_report(cuda_build.build_info.get("scl_decode.cu", {}).get("ptxas", ""))
    for preset, k, batch, fn, (rounds, launches), shape in runs:
        fn()                       # the tables, outside the clock
        with cuda_scl.clock_build() as lib:
            fn()
            clk = cuda_scl.read_clock(lib)
        blocks = clk.pop("blocks")
        stages = {key: {s: c for s, c in row.items() if s != rounds_slot}
                  for key, row in clk.pop("stages").items()}
        counted = clk.pop(rounds_slot, None)
        # every launch measures the same number of blocks
        if counted is not None and counted * launches != rounds * blocks:
            raise RuntimeError(f"{preset} {k}: the clock counted {counted} fork "
                               f"rounds, the program gives "
                               f"{rounds * blocks / launches}")
        total = sum(clk.values())
        per_block = rounds / launches
        occ = {}
        if shape is not None:
            occ = occupancy(cuda_scl.SclKernels(*shape), k, dev)
            occ.update(ptxas.get(occ["instance"], {}))
        print(json.dumps({
            "preset": preset, "kernel": k, "batch": batch, **occ,
            "blocks_measured": blocks,
            "cycles_per_block": total / blocks,
            "fork_rounds_per_block": per_block,
            "rounds_from": "program" if counted is None else "program == clock",
            "chain_cycles_per_round": (clk.get("R1/SPC chain", 0) / blocks / per_block
                                       if rounds else None),
            "split": {s: {"cycles_per_block": c / blocks, "share": c / total}
                      for s, c in clk.items() if c},
            "split_by_stage": {
                f"stage {key}" if key < cuda_scl.CLOCK_STAGES - 1
                else f"stage {key}+": {
                    "cycles_per_block": sum(row.values()) / blocks,
                    "share": sum(row.values()) / total,
                    "slots": {s: c / blocks for s, c in row.items()}}
                for key, row in stages.items()},
            "card": card}), flush=True)


def slots(dev, card: str, spin: int = 2_000_000) -> None:
    """Warp slots of blocks resident together (csrc/warp_slots.cu), at the
    Arikan capacity-8 body's ca_scl shapes; the leader rule's sub-partitions."""
    import collections
    import ctypes

    from polar_tpu_torch.ops import cuda_build, cuda_scl

    lib = ctypes.CDLL(str(cuda_build.build("warp_slots.cu")))
    lib.warp_slots_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spec = get_preset("ca_scl").spec
    for kernel in ("scl_mc_counters", "scl_decode"):
        plan = cuda_scl.SclKernels(spec, 8).plan(kernel, dev)
        T, per_sm, smem = plan.threads, plan.blocks_per_sm, plan.smem + plan.static
        W, B = T // 32, sms * per_sm
        out = torch.zeros(B * W * 2, dtype=torch.int32, device=dev)
        if lib.warp_slots_launch(out.data_ptr(), B, T, smem, spin) != 0:
            raise RuntimeError("warp_slots launch failed")
        o = out.view(B, W, 2).cpu().tolist()
        lead = collections.Counter(o[b][cuda_scl.leader_warp([w[1] for w in o[b]], W)][1] & 3
                                   for b in range(B))
        warp0 = collections.Counter(o[b][0][1] & 3 for b in range(B))
        print(json.dumps({
            "kernel": kernel, "threads": T, "blocks_per_sm": per_sm, "blocks": B,
            "slots_on_sm": {sm: [[w[1] for w in o[b]] for b in range(B) if o[b][0][0] == sm]
                            for sm in (0, 1)},
            "warp0_subpartitions": dict(sorted(warp0.items())),
            "leader_subpartitions": dict(sorted(lead.items())),
            "card": card}), flush=True)


def sass_functions(library) -> dict:
    """{instance: its SASS lines} of a built library (cuobjdump -sass;
    whitespace and the anonymous namespace's hash left out)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = _instance(m.group(1))
            out[cur] = []
        elif cur is not None:
            out[cur].append(" ".join(re.sub(r"_GLOBAL__N__\w+?_", "_NS_", line).split()))
    return out


def sass_against(other: str) -> None:
    """Instances of scl_decode.cu with equal SASS here and in checkout
    `other` (each built there with its own sources)."""
    from polar_tpu_torch.ops import cuda_build

    here = sass_functions(cuda_build.build("scl_decode.cu"))
    lib = subprocess.run(
        ["python", "-c", "from polar_tpu_torch.ops import cuda_build; "
         "print(cuda_build.build('scl_decode.cu'))"],
        cwd=other, capture_output=True, text=True, check=True).stdout.strip()
    there = sass_functions(lib)
    both = sorted(set(here) & set(there))
    print(json.dumps({
        "identical": [k for k in both if here[k] == there[k]],
        "differ": [k for k in both if here[k] != there[k]],
        "only_here": sorted(set(here) - set(there)),
        "only_there": sorted(set(there) - set(here))}), flush=True)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def trace_summary(path, top: int = 5, gaps: int = 3) -> dict:
    """The device's activity in a torch.profiler Chrome trace: the window
    from its first device activity's start to its last one's end; busy, the
    union of its kernel, memcpy and memset intervals over every stream, and
    the busy and idle shares of the window; the `top` kernels by total time
    with their launches; and the `gaps` longest stretches of the window
    without device activity, each with the host ops that overlap it most
    (name: microseconds of overlap). Times in microseconds."""
    events = [e for e in json.loads(pathlib.Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e)
                 for e in events if e.get("cat") in DEVICE_CATS)
    if not dev:
        raise ValueError(f"{path}: the trace holds no device activity")
    busy = []                       # merged [start, end] intervals
    for s, t, _ in dev:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    window = busy[-1][1] - busy[0][0]
    busy_us = sum(t - s for s, t in busy)
    kernels: dict = {}
    for s, t, e in dev:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += t - s
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
            for e in events if e.get("cat") in HOST_CATS]
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
            "kernels": [{"name": n, "launches": c, "us": u} for n, (c, u) in
                        sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]],
            "gaps": out_gaps}


def parse_args(argv=None) -> argparse.Namespace:
    """The command line; `--only` must name rows (or, with --split, runs)
    this script has."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--only", default=None,
                    help=f"comma-separated rows of {ROWS} (default: all), or "
                         f"with --split runs of {SPLIT_RUNS}")
    ap.add_argument("--mixed-batch", type=int, default=256,
                    help="codewords of the mixed_scl32 rows (the preset's 256)")
    ap.add_argument("--split", action="store_true",
                    help="the op-kind clock of K5 and K1 at ca_scl and bch_sc, "
                         "of K1 at L=32 and of K3 at mixed_scl32 instead")
    ap.add_argument("--slots", action="store_true",
                    help="the warp slots of the Arikan body's blocks and the "
                         "leader rule's sub-partitions instead")
    ap.add_argument("--chunks", action="store_true",
                    help="K5 as one launch against chunks of 1, 2, 4 rounds instead")
    ap.add_argument("--k6-lanes", action="store_true",
                    help="K6 at every lane count of each trellis input instead")
    ap.add_argument("--sass-against", metavar="DIR", default=None,
                    help="compare scl_decode.cu's SASS with checkout DIR's instead")
    args = ap.parse_args(argv)
    known = SPLIT_RUNS if args.split else ROWS
    args.only = args.only or ",".join(known)
    unknown = [o for o in args.only.split(",") if o not in known]
    if unknown:
        ap.error(f"--only {','.join(unknown)}: not one of {known}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    B = args.batch
    only = args.only.split(",")
    if args.slots:
        slots(dev, card)
        return
    if args.sass_against:
        sass_against(args.sass_against)
        return
    if args.k6_lanes:
        k6_lanes(dev, card, args.reps)
        return
    if args.chunks:
        chunks(dev, card, args.reps)
        return
    if args.split:
        split(B, dev, card, only)
        return
    gen = torch.Generator(device=dev).manual_seed(7)
    crc8 = CrcSpec(8, 0x07, 0)
    groups = {
        "ca_scl": lambda: _decode_rows("ca_scl", get_preset("ca_scl").spec, 8,
                                       ("scl_decode", "scl_mc_counters",
                                        "scl_decode_traj", "scl_mc_traj"), B, gen, dev),
        "arikan_sc": lambda: _decode_rows("arikan_sc", get_preset("arikan_sc").spec,
                                          1, ("scl_decode_traj",), B, gen, dev),
        "bch_sc": lambda: (
            _decode_rows("bch_sc", get_preset("bch_sc").spec, 1,
                         ("scl_decode_traj", "scl_mc_traj", "scl_mc_counters"),
                         B, gen, dev)
            + _decode_rows("bch_sc", get_preset("bch_sc").spec, 8,
                           ("scl_decode",), B, gen, dev)
            + _bch_stage_rows(B, dev)),
        "golden_mixed": lambda: [
            row for L in range(4, 9)
            for row in _decode_rows("golden_mixed", load_golden(GOLDEN_MIXED)[0], L,
                                    ("scl_mc_counters", "scl_decode"), B, gen, dev)],
        "L32": lambda: (
            _decode_rows("L32 (2,)*7", _mixed_spec((2,) * 7, 56, crc8), 32,
                         ("scl_decode", "scl_decode_traj"), B, gen, dev)
            + _decode_rows("L32 (16,2,2)", _mixed_spec((16, 2, 2), 20, crc8), 32,
                           ("scl_decode", "scl_decode_traj"), B, gen, dev)),
    }
    for group in only:
        if group == "mixed_scl32":
            batch = args.mixed_batch
            rows, iters = _mixed_rows(dev, batch), 2
        else:
            rows, batch, iters = groups[group](), B, 20
        for name, k, L, fn in rows:
            ms = [_ms(fn, iters) for _ in range(args.reps)]
            print(json.dumps({"preset": name, "kernel": k, "L": L, "batch": batch,
                              "ms": ms, "min_ms": min(ms), "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()
