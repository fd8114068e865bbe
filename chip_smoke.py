"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Main paths: the flagship `ca_scl` code (N=1024, K=512 + CRC-16, Arikan,
list size 8) decoded at B=8192 codewords per call through the
hand-written CUDA kernels of polar_tpu_torch/csrc/scl_decode.cu, and the
Monte-Carlo FER sweep of the `sweep` preset (ca_scl on the 8-point Eb/N0
grid) through polar_tpu_torch.sim.harness. Phases (any failure exits
non-zero):

1. device: name, count, nvidia-smi name and power limit;
2. build: nvcc build of the four kernels, its seconds and ptxas report;
3. golden replay: results/golden_ca_scl_b256.npz (256 frames recorded
   from the independent C++ decoder) through scl_decode, 0 mismatches;
4. scl_decode == plain PyTorch version on the card, bit for bit (u,
   payload, crc_ok and pm): ca_scl on 1024 channel frames at 2.0 dB and
   small Arikan specs with L in {1, 3, 4, 8}, Gaussian and integer LLRs;
5. decode main path end to end: info bits -> crc_append -> encode ->
   channel_llrs (2.0 dB) -> decode, 32 batches of 8192 for each seed
   (two by default, `--seeds N` for more); the first seed's Wilson 95%
   interval must overlap the recorded points in results/, and the pooled
   frame errors must agree with each by a two-proportion z-test, |z| < 3;
6. scl_decode == plain bit for bit at the main path's batch (B=8192, and
   16384); times by CUDA events at B=8192: kernel, plain version, bound;
7. scl_decode_traj (K2) == plain bit for bit: trajectory bits, span
   permutations, path metrics and the DecodeResult after scl_epilogue, on
   the small specs of phase 4 with L in {1, 3, 4, 8} and ca_scl at B=8192;
8. scl_mc_traj (K4) and scl_mc_counters (K5) == plain bit for bit with
   injected noise (trajectory, pm, u_true, per-codeword frame and bit
   errors), small specs with and without CRC (L in {1, 4, 8}) and ca_scl
   at B=8192, at 2.0 and 1.0 dB;
9. the same with the in-kernel Philox draw: u_true bit for bit, frames
   whose decisions or counts differ at most 1 in 10^4, and K5's totals
   equal to K4's + scl_epilogue's on the same seed;
10. sweep main path: run_sweep of the `sweep` preset, 2^20 frames a point
   on all 8 points through the `fused` backend (K5); two-proportion z-test
   against both recorded 10M-frame sweeps at each point with >= 500
   recorded frame errors, |z| < 4; a resume adds no frame; the `torch`
   backend (K1) at 1.0 dB on the same keys counts what `fused` counts, and
   at 2.0 dB for 2^20 frames for its rate; build_mc_step in full mode
   (K4 + scl_epilogue) for 4 batches at 2.0 dB counts what counters mode
   counts; an `arikan_sc` (L=1, K2) point at 2.0 dB, |z| < 4 against the
   recorded point. Each kernel's launches are counted on its own path's
   run (fused sweep K5, torch sweep K1, full-mode step K4, arikan_sc
   point K2), with the counts set to 0 just before it;
11. times by CUDA events at B=8192 of each kernel and its plain version,
   each kernel's bound, and the sweep's end-to-end cw/s per backend: all
   frames over all wall time, and the harness's steady-state rate.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one card and no network.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
EBN0_DB = 2.0
BATCH = 8192
MAIN_BATCHES = 32
FIRST_SEED = 2026
# recorded FER points of ca_scl at 2.0 dB: the CPU run (16,384 frames) and
# the 16.8M-frame fused-kernel sweep. The first seed's interval must
# overlap both; the pooled count over all seeds must agree with each by a
# two-proportion z-test
REF_FILES = ("ca_scl_cpu.jsonl", "fused_ca_scl_tpu.jsonl")
Z_LIMIT = 3.0
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# H100 SXM float32 outside the tensor cores is 67 TFLOP/s with an FMA
# counted as two; the decode's compares, min, abs, selects and XORs issue
# one a lane a cycle, half that rate
PEAK_ELEM_OPS_PER_S = 67e12 / 2
SOURCE = "polar_tpu_torch/csrc/scl_decode.cu"
# kernel -> the TPU kernel (pallas_call site) it replaces
KERNELS = {
    "scl_decode": "polar_tpu/ops/pallas_scl.py:1493",
    "scl_decode_traj": "polar_tpu/ops/pallas_scl.py:1523",
    "scl_mc_traj": "polar_tpu/ops/pallas_scl.py:1397",
    "scl_mc_counters": "polar_tpu/ops/pallas_scl.py:1374",
}
SWEEP_FRAMES = 1 << 20
SWEEP_SEED = 2026
SWEEP_REFS = ("sweep_tpu_fused_r3.jsonl", "sweep_tpu.jsonl")
SWEEP_Z_LIMIT = 4.0
SWEEP_MIN_REF_ERRORS = 500
DIFF_LIMIT = 1e-4           # in-kernel Philox: differing frames allowed
FULL_STEPS = 4              # batches of the full-mode step's main path


def two_proportion_z(e1: int, n1: int, e2: int, n2: int) -> float:
    p = (e1 + e2) / (n1 + n2)
    if p in (0.0, 1.0):
        return 0.0
    return (e1 / n1 - e2 / n2) / math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))


def reference_points() -> list[dict]:
    out = []
    for name in REF_FILES:
        for line in (ROOT / "results" / name).read_text().splitlines():
            rec = json.loads(line)
            if rec.get("preset") == "ca_scl" and rec["ebn0_db"] == EBN0_DB:
                out.append(dict(rec, file=name))
    if len(out) != len(REF_FILES):
        raise SystemExit("recorded FER points not found")
    return out


def element_ops(spec, P: int, epilogue: bool = True) -> int:
    """Least element operations of one codeword's decode, counted from the
    shapes of the fast-SSCL program, whatever the kernel does beyond them.
    Per path and output element: f 4 (2 abs, min, sign), g 2 (conditional
    negate, add), UP 1 (xor); per path and input: R0 2 (relu, add), REP 4
    (two relus, two adds); R1/SPC: a hard decision and an abs per input,
    the n_min least reliable inputs selected at ceil(log2(n_min + 1))
    compares per input, one flip per selected position, n/2 log2(n) XORs
    of re-encode and, for SPC, n XORs of parity. A 2P -> P fork: 2P adds
    of candidate metrics and 2P log2(2P) compares to rank them (survivors
    leave in rank order). Epilogue per path (only where the kernel runs
    it: `epilogue`): one word XOR of a CRC generator mask per unfrozen
    bit, one compare of the argmin."""
    from polar_tpu_torch.ops.program import build_program

    ns = spec.block_sizes
    total = 0
    fork = 2 * P + 2 * P * int(math.log2(2 * P)) if P > 1 else 0
    for op in build_program(spec, scl=P > 1).ops:
        n = ns[op.level]
        if op.kind == "DOWN_FRESH":
            total += 4 * P * n
        elif op.kind == "DOWN_DYN":
            total += 2 * P * n
        elif op.kind == "UP":
            total += P * n
        elif op.kind == "R0":
            total += 2 * P * n
        elif op.kind == "REP":
            total += 4 * P * n + fork
        elif op.kind == "LEAF":
            total += 2 * P + (0 if spec.frozen[op.t0] else fork)
        else:
            spc = op.kind == "SPC"
            rounds = (0 if P == 1 else min(P, n - 1)) if spc else min(P - 1, n)
            n_min = rounds + 1 if spc else rounds
            select = n * math.ceil(math.log2(n_min + 1)) if n_min else 0
            total += (P * (2 * n + select + n_min + (n // 2) * int(math.log2(n))
                           + (n if spc else 0)) + rounds * fork)
    return total + (P * (spec.n_payload_slots + 1) if epilogue else 0)


def prologue_ops(spec) -> int:
    """Least element operations of one codeword's Monte-Carlo prologue,
    from the shapes: Philox4x32-10 gives 4 words a call and 2N words are
    drawn, at 10 rounds of 2 multiply-high, 2 multiply-low and 4 XORs (the
    key schedule is shared by the batch); K data bits masked, K CRC mask
    XORs, N/2 log2(N) encode XORs; Box-Muller per pair of rows: 2 shifts,
    2 converts, an add, 2 scalings, log, a multiply, sqrt, a multiply,
    cos, sin, 2 multiplies (transcendentals counted as one operation
    each); the channel per row: 2x, 1 - 2x, sigma g, an add, the LLR
    scaling."""
    N, K = spec.N, spec.K
    philox = (2 * N // 4) * 10 * 8
    return philox + 2 * K + (N // 2) * int(math.log2(N)) + 15 * (N // 2) + 5 * N


def table_bytes(spec, P: int) -> int:
    """Bytes of the kernels' host tables (op table, span rows, payload
    rows, CRC masks), each read once."""
    from polar_tpu_torch.ops.cuda_scl import build_tables

    t = build_tables(spec, P)
    return sum(t[k].nbytes for k in ("ops", "qrow", "pidx", "gmask"))


def bound(bytes_moved: int, ops: int) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_ELEM_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "t_bytes": t_bytes, "ops": ops,
            "t_ops": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def fields_equal(a, b) -> tuple[bool, float]:
    """All four DecodeResult fields equal; max |difference| over them."""
    err = 0.0
    same = True
    for f in ("u", "payload", "crc_ok", "pm"):
        x, y = getattr(a, f), getattr(b, f)
        same &= bool(torch.equal(x, y))
        err = max(err, float((x.double() - y.double()).abs().max()))
    return same, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2,
                    help="main-path seeds, each 32 batches of 8192 frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from polar_tpu_torch.construction.ga import construct_ga
    from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
    from polar_tpu_torch.models.presets import ca_scl
    from polar_tpu_torch.ops import cuda_scl
    from polar_tpu_torch.ops.crc import crc_append
    from polar_tpu_torch.ops.encode import encode
    from polar_tpu_torch.ops.scl import build_scl_decoder
    from polar_tpu_torch.sim.channel import channel_llrs
    from polar_tpu_torch.sim.golden import load_golden
    from polar_tpu_torch.sim.harness import wilson_ci

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"card: {card}")

    # ---- 2. build ----
    cuda_scl.load_library()
    info = cuda_scl.build_info
    print(f"build: {info['seconds']:.2f} s -> {info['library']}")
    entry = "?"
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in sorted(KERNELS, key=len, reverse=True)
                          if k in line), "?")
        if "registers" in line or "spill" in line:
            print(f"ptxas: {entry}: {line.strip()}")

    preset = ca_scl()
    spec, L = preset.spec, preset.list_size
    dec = build_scl_decoder(spec, L, device=dev)

    # ---- 3. golden replay through the kernel ----
    gspec, gl, llrs, u_ref = load_golden(ROOT / "results" / "golden_ca_scl_b256.npz")
    gdec = build_scl_decoder(gspec, gl, device=dev)
    gout = gdec(llrs)
    torch.cuda.synchronize()
    mism = int((gout.u.cpu().numpy() != u_ref).any(axis=1).sum())
    print(f"golden replay: frames={llrs.shape[0]} mismatch_frames={mism}")
    if mism:
        raise SystemExit("golden replay mismatch")

    # ---- 4. kernel == plain on the card ----
    gen = torch.Generator(device=dev).manual_seed(1234)
    max_err = 0.0
    cases = []
    info_bits = torch.randint(0, 2, (1024, spec.K), generator=gen, device=dev)
    x = encode(spec, crc_append(spec.crc, info_bits))
    cases.append(("ca_scl L=8 2.0dB", dec,
                  channel_llrs(x, EBN0_DB, spec.rate, generator=gen)))
    rng = np.random.default_rng(7)
    small_specs = []        # with CRC-8, CRC-16 and without: phases 7-9
    for N, K, crc, lst in [(64, 28, CrcSpec(8, 0x07, 0), (1, 3, 4, 8)),
                           (128, 56, CrcSpec(16, 0x1021, 0), (1, 3, 4, 8)),
                           (256, 128, None, (3, 8))]:
        mask = tuple(int(v) for v in construct_ga(
            N, K + (crc.width if crc else 0), 2.0))
        small = CodeSpec(N=N, K=K, factors=(2,) * int(math.log2(N)),
                         frozen_mask=mask, crc=crc)
        small_specs.append(small)
        for lsz in lst:
            sdec = build_scl_decoder(small, lsz, device=dev)
            for quant in (False, True):
                v = 3.0 * rng.standard_normal((1024, N))
                if quant:
                    v = np.round(v)      # integer LLRs force metric ties
                cases.append((f"N={N} L={lsz} {'int' if quant else 'gauss'}",
                              sdec, torch.as_tensor(v, dtype=torch.float32,
                                                    device=dev)))
    for name, d, v in cases:
        same, err = fields_equal(d.kernel(v), d.plain(v))
        torch.cuda.synchronize()
        max_err = max(max_err, err)
        if not same:
            raise SystemExit(f"kernel != plain on {name} (max abs err {err})")
    print(f"kernel == plain: {len(cases)} cases bit-exact "
          f"(u, payload, crc_ok, pm), max_abs_err={max_err}")

    # ---- 5. decode main path end to end, two seeds ----
    for name in cuda_scl.LAUNCHES:
        cuda_scl.LAUNCHES[name] = 0
    refs = reference_points()
    frames = errors = 0
    t0 = time.perf_counter()
    for seed in range(FIRST_SEED, FIRST_SEED + args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        seed_errors = 0
        for _ in range(MAIN_BATCHES):
            info_bits = torch.randint(0, 2, (BATCH, spec.K), generator=gen,
                                      device=dev, dtype=torch.int8)
            x = encode(spec, crc_append(spec.crc, info_bits))
            out = dec(channel_llrs(x, EBN0_DB, spec.rate, generator=gen))
            seed_errors += int(
                (out.payload[:, :spec.K] != info_bits).any(dim=1).sum())
        n = MAIN_BATCHES * BATCH
        lo, hi = wilson_ci(seed_errors, n)
        print(f"main path seed {seed}: frames={n} frame_errors={seed_errors} "
              f"fer={seed_errors / n} ci95=({lo}, {hi})")
        if seed == FIRST_SEED:
            for r in refs:
                rlo, rhi = r["fer_ci95"]
                if hi < rlo or lo > rhi:
                    raise SystemExit(f"FER interval does not overlap {r['file']}")
        frames += n
        errors += seed_errors
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_scl.LAUNCHES)
    lo, hi = wilson_ci(errors, frames)
    zs = {r["file"]: two_proportion_z(errors, frames, r["frame_errors"],
                                      r["frames"]) for r in refs}
    print(f"main path: ca_scl {EBN0_DB} dB frames={frames} "
          f"frame_errors={errors} fer={errors / frames} ci95=({lo}, {hi}) "
          f"z_vs_recorded={zs} end_to_end_cw_per_s={frames / wall} "
          f"launches={launches} [{card}]")
    if launches["scl_decode"] < 1:
        raise SystemExit("the decode main path launched no scl_decode")
    for name, z in zs.items():
        if abs(z) >= Z_LIMIT:
            raise SystemExit(f"FER differs from {name}: z = {z}")

    # ---- 6. kernel == plain and times at the main path's batch ----
    v2 = channel_llrs(encode(spec, crc_append(spec.crc, torch.randint(
        0, 2, (2 * BATCH, spec.K), generator=gen, device=dev))),
        EBN0_DB, spec.rate, generator=gen)
    v = v2[:BATCH].contiguous()
    for vb in (v, v2):
        same, err = fields_equal(dec.kernel(vb), dec.plain(vb))
        max_err = max(max_err, err)
        if not same:
            raise SystemExit(f"kernel != plain on ca_scl B={vb.shape[0]} "
                             f"(max abs err {err})")
    print(f"kernel == plain: ca_scl B={BATCH} and B={2 * BATCH} bit-exact "
          f"(u, payload, crc_ok, pm), max_abs_err={max_err}")
    ms = time_ms(lambda: dec.kernel(v), iters=20)
    plain_ms = time_ms(lambda: dec.plain(v), iters=2, warmup=1)
    # one block per codeword: time against batch shows the waves of blocks
    for b in (1024, 2048, 4096, 16384):
        vb = v2[:b].contiguous()
        print(f"kernel sweep: B={b} ms={time_ms(lambda: dec.kernel(vb), 10)} "
              f"[{card}]")
    k1_bound = bound(BATCH * (4 * spec.N + spec.N + 5), BATCH * element_ops(spec, L))
    print(f"kernel: scl_decode ca_scl B={BATCH} ms={ms} "
          f"cw_per_s={BATCH / ms * 1e3} [{card}]")
    print(f"plain: scl_decode ca_scl B={BATCH} ms={plain_ms} [{card}]")
    print(f"bound: scl_decode {k1_bound} [{card}]")
    rows = {"scl_decode": dict(k1_bound, max_abs_err=max_err, ms=ms,
                               plain_ms=plain_ms)}

    from polar_tpu_torch.models.presets import get_preset
    from polar_tpu_torch.ops.cuda_scl import SclDecoder
    from polar_tpu_torch.ops.mc import build_mc_step, count_errors
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    from polar_tpu_torch.sim.harness import SweepState, make_mc_step, run_sweep

    # ---- 7. scl_decode_traj (K2) == plain ----
    err = {name: 0.0 for name in KERNELS}

    def check(name: str, what: str, a, b) -> None:
        """a == b bit for bit (tuples of tensors); the largest difference
        joins the kernel's max_abs_err."""
        for i, (x, y) in enumerate(zip(a, b)):
            d = float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
            err[name] = max(err[name], d)
            if not torch.equal(x, y):
                raise SystemExit(f"{name} != plain on {what}, output {i} "
                                 f"(max abs err {d})")

    ca_traj = SclDecoder(spec, L, dev, select=False)
    traj_cases = [(f"ca_scl L={L} B={BATCH}", ca_traj, v)]
    for sp in small_specs:
        for lsz in (1, 3, 4, 8):
            tdec = SclDecoder(sp, lsz, dev, select=False)
            for quant in (False, True):
                x = 3.0 * rng.standard_normal((1024, sp.N))
                if quant:
                    x = np.round(x)
                traj_cases.append((f"N={sp.N} L={lsz} {'int' if quant else 'gauss'}",
                                   tdec, torch.as_tensor(x, dtype=torch.float32,
                                                         device=dev)))
    for what, tdec, x in traj_cases:
        traj = tdec.trajectory(x)
        check("scl_decode_traj", what, traj, tdec.plain_trajectory(x))
        check("scl_decode_traj", what + " epilogue", tdec.epilogue(*traj),
              tdec.plain(x))
    torch.cuda.synchronize()
    print(f"scl_decode_traj == plain: {len(traj_cases)} cases bit-exact "
          f"(traj_bit, traj_perm, pm, DecodeResult), "
          f"max_abs_err={err['scl_decode_traj']}")

    # ---- 8. scl_mc_traj (K4), scl_mc_counters (K5) == plain, noise in ----
    mc_cases = [(sp, lsz, 1024) for sp in small_specs for lsz in (1, 4, 8)]
    mc_cases.append((spec, L, BATCH))
    ngen = torch.Generator(device=dev).manual_seed(88)
    for sp, lsz, b in mc_cases:
        step = build_mc_step(sp, lsz, device=dev)
        for ebn0 in (2.0, 1.0):
            what = f"N={sp.N} L={lsz} B={b} {ebn0} dB noise in"
            sigma = float(ebn0_to_sigma(ebn0, sp.rate))
            seed = tuple(int(w) for w in rng.integers(0, 2**32, 2))
            noise = torch.randn((b, sp.N), generator=ngen, device=dev)
            check("scl_mc_traj", what, step.trajectory(seed, sigma, b, noise),
                  step.plain_trajectory(seed, sigma, b, noise))
            check("scl_mc_counters", what, [step.counts(seed, sigma, b, noise)],
                  [step.plain_counts(seed, sigma, b, noise)])
    torch.cuda.synchronize()
    print(f"scl_mc_traj, scl_mc_counters == plain with injected noise: "
          f"{2 * len(mc_cases)} cases each bit-exact (traj_bit, traj_perm, pm, "
          f"u_true; per-codeword fe/be), max_abs_err="
          f"{max(err['scl_mc_traj'], err['scl_mc_counters'])}")

    # ---- 9. the same with the in-kernel Philox draw ----
    frames9 = differ9 = 0
    for sp, lsz, b in mc_cases:
        step = build_mc_step(sp, lsz, device=dev)
        for ebn0 in (2.0, 1.0):
            what = f"N={sp.N} L={lsz} B={b} {ebn0} dB philox"
            sigma = float(ebn0_to_sigma(ebn0, sp.rate))
            seed = tuple(int(w) for w in rng.integers(0, 2**32, 2))
            k4 = step.trajectory(seed, sigma, b)
            p4 = step.plain_trajectory(seed, sigma, b)
            if not torch.equal(k4[3], p4[3]):
                raise SystemExit(f"scl_mc_traj u_true != plain on {what}")
            k5 = step.counts(seed, sigma, b)
            p5 = step.plain_counts(seed, sigma, b)
            frame_differs = ((k4[0] != p4[0]).any(0).any(0)
                             | (k4[1] != p4[1]).any(0).any(0)
                             | (k4[2] != p4[2]).any(0) | (k5 != p5).any(0))
            frames9 += b
            differ9 += int(frame_differs.sum())
            for name, k, p in (("scl_mc_traj", k4, p4), ("scl_mc_counters", [k5], [p5])):
                for x, y in zip(k, p):
                    err[name] = max(err[name],
                                    float((x.double() - y.double()).abs().max()))
            k4_counts = count_errors(sp, step.decoder.epilogue(*k4[:3]).u, k4[3])
            if not torch.equal(k4_counts.sum(1), k5.sum(1)):
                raise SystemExit(f"scl_mc_counters totals {k5.sum(1).tolist()} "
                                 f"!= scl_mc_traj + epilogue "
                                 f"{k4_counts.sum(1).tolist()} on {what}")
    print(f"in-kernel Philox: u_true bit-exact on {frames9} frames; frames "
          f"whose decisions or counts differ from the plain version: "
          f"{differ9} of {frames9}; scl_mc_counters totals == scl_mc_traj + "
          f"scl_epilogue totals")
    if differ9 > DIFF_LIMIT * frames9:
        raise SystemExit(f"{differ9} of {frames9} frames differ "
                         f"(limit {DIFF_LIMIT})")

    # ---- 10. the sweep main path ----
    sweep = get_preset("sweep")
    state = ROOT / "build" / "smoke_sweep_state.json"
    state.parent.mkdir(parents=True, exist_ok=True)
    state.unlink(missing_ok=True)
    refs = {name: {json.loads(line)["ebn0_db"]: json.loads(line) for line in
                   (ROOT / "results" / name).read_text().splitlines()}
            for name in SWEEP_REFS}
    sweep_args = dict(frames=SWEEP_FRAMES, per_device_batch=BATCH,
                      seed=SWEEP_SEED, device=dev, progress=False)
    # launches of each kernel on its own main path: the counts are set to
    # 0 just before that path runs and read just after; the checks against
    # other backends and modes run outside these windows
    main_launches = {}

    def main_path(kernel: str, what: str, fn):
        for name in cuda_scl.LAUNCHES:
            cuda_scl.LAUNCHES[name] = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(cuda_scl.LAUNCHES)
        print(f"launches: {counts} in the {what} run")
        if counts[kernel] < 1:
            raise SystemExit(f"the {what} run launched no {kernel}")
        main_launches[kernel] = counts[kernel]
        return out, wall

    recs, wall_f = main_path(
        "scl_mc_counters", "fused sweep",
        lambda: run_sweep(sweep, backend="fused", state_path=str(state),
                          **sweep_args))
    n_tests = 0
    for rec in recs:
        zs = {}
        for name in SWEEP_REFS:
            r = refs[name][rec["ebn0_db"]]
            zs[name] = two_proportion_z(rec["frame_errors"], rec["frames"],
                                        r["frame_errors"], r["frames"])
            if r["frame_errors"] >= SWEEP_MIN_REF_ERRORS:
                n_tests += 1
                if abs(zs[name]) >= SWEEP_Z_LIMIT:
                    raise SystemExit(f"sweep FER at {rec['ebn0_db']} dB "
                                     f"differs from {name}: z = {zs[name]}")
        print(f"sweep fused: ebn0={rec['ebn0_db']} frames={rec['frames']} "
              f"frame_errors={rec['frame_errors']} bit_errors={rec['bit_errors']} "
              f"fer={rec['fer']} ci95={rec['fer_ci95']} z_vs_recorded={zs} "
              f"cw_per_s={rec['codewords_per_s']} [{card}]")
    if n_tests != 12:
        raise SystemExit(f"{n_tests} z-tests against the recorded sweeps, not 12")
    saved = SweepState.load(state)
    again = run_sweep(sweep, backend="fused", state_path=str(state), **sweep_args)
    if (SweepState.load(state) != saved
            or [r["frames"] for r in again] != [r["frames"] for r in recs]):
        raise SystemExit("resuming a finished sweep changed its state")
    print(f"sweep resume: state {state.name} reloaded, no frame added "
          f"(frames {saved.frames[0]} x {len(saved.frames)})")
    # the torch backend on the sweep's own keys at 1.0 dB
    si = sweep.ebn0_grid.index(1.0)
    sigma1 = float(ebn0_to_sigma(1.0, spec.rate))
    by_backend = {}
    for backend in ("torch", "fused"):
        step = make_mc_step(spec, L, backend=backend, device=dev)
        outs = [step(SWEEP_SEED, si, k, sigma1, BATCH) for k in range(4)]
        by_backend[backend] = [sum(int(o[f]) for o in outs)
                               for f in ("frame_errors", "bit_errors")]
    print(f"sweep backends at 1.0 dB, 4 x {BATCH} frames on the same keys: "
          f"torch (frame_errors, bit_errors) = {by_backend['torch']}, "
          f"fused = {by_backend['fused']}")
    if abs(by_backend["torch"][0] - by_backend["fused"][0]) > DIFF_LIMIT * 4 * BATCH:
        raise SystemExit("torch and fused backends count different frame errors")
    recs_t, wall_t = main_path(
        "scl_decode", "torch sweep at 2.0 dB",
        lambda: run_sweep(dataclasses.replace(sweep, ebn0_grid=(2.0,)),
                          backend="torch", **sweep_args))
    rec_t = recs_t[0]
    zs = {name: two_proportion_z(rec_t["frame_errors"], rec_t["frames"],
                                 refs[name][2.0]["frame_errors"],
                                 refs[name][2.0]["frames"]) for name in SWEEP_REFS}
    print(f"sweep torch: ebn0=2.0 frames={rec_t['frames']} "
          f"frame_errors={rec_t['frame_errors']} fer={rec_t['fer']} "
          f"z_vs_recorded={zs} cw_per_s={rec_t['codewords_per_s']} [{card}]")
    if max(abs(z) for z in zs.values()) >= SWEEP_Z_LIMIT:
        raise SystemExit("torch-backend FER at 2.0 dB differs from the records")
    # the full-mode step (scl_mc_traj + scl_epilogue: decisions and u_true
    # beside the counts) on the sweep's keys at 2.0 dB; counters mode must
    # count the same
    sigma2 = float(ebn0_to_sigma(2.0, spec.rate))
    full = build_mc_step(spec, L, device=dev)
    counters = build_mc_step(spec, L, device=dev, counters=True)
    keys = [step_seed(SWEEP_SEED, sweep.ebn0_grid.index(2.0), k, 0)
            for k in range(FULL_STEPS)]
    full_counts, _ = main_path(
        "scl_mc_traj", "full-mode step",
        lambda: [[int(t) for t in full(key, sigma2, BATCH)[:2]] for key in keys])
    for key, a in zip(keys, full_counts):
        b = [int(t) for t in counters(key, sigma2, BATCH)[:2]]
        if a != b:
            raise SystemExit(f"full mode {a} != counters mode {b}")
    print(f"build_mc_step full mode == counters mode on {FULL_STEPS} sweep "
          f"batches at 2.0 dB: (frame_errors, bit_errors) = {full_counts}")
    # an SC point (L=1): the decoder's default there is scl_decode_traj
    arikan = get_preset("arikan_sc")
    recs_a, _ = main_path(
        "scl_decode_traj", "arikan_sc torch sweep at 2.0 dB",
        lambda: run_sweep(dataclasses.replace(arikan, ebn0_grid=(2.0,)),
                          backend="torch", **dict(sweep_args, frames=1 << 18)))
    rec_a = recs_a[0]
    ref_a = [json.loads(line) for line in
             (ROOT / "results" / "arikan_sc_tpu.jsonl").read_text().splitlines()
             if json.loads(line)["ebn0_db"] == 2.0][0]
    z_a = two_proportion_z(rec_a["frame_errors"], rec_a["frames"],
                           ref_a["frame_errors"], ref_a["frames"])
    print(f"sweep arikan_sc torch: ebn0=2.0 frames={rec_a['frames']} "
          f"frame_errors={rec_a['frame_errors']} fer={rec_a['fer']} "
          f"z_vs_recorded={z_a} cw_per_s={rec_a['codewords_per_s']} [{card}]")
    if abs(z_a) >= SWEEP_Z_LIMIT:
        raise SystemExit("arikan_sc FER at 2.0 dB differs from the record")

    # ---- 11. times at B=8192 ----
    va = channel_llrs(encode(arikan.spec, torch.randint(
        0, 2, (BATCH, arikan.spec.K), generator=gen, device=dev)),
        2.0, arikan.spec.rate, generator=gen)
    sc = SclDecoder(arikan.spec, 1, dev)
    check("scl_decode_traj", f"arikan_sc B={BATCH}", sc.trajectory(va),
          sc.plain_trajectory(va))
    nq = len(sc.spans)
    rows["scl_decode_traj"] = dict(
        bound(table_bytes(arikan.spec, 1)
              + BATCH * (4 * arikan.spec.N + arikan.spec.N + nq + 4),
              BATCH * element_ops(arikan.spec, 1, epilogue=False)),
        ms=time_ms(lambda: sc.trajectory(va), iters=20),
        plain_ms=time_ms(lambda: sc.plain_trajectory(va), iters=2, warmup=1))
    ca_traj_ms = time_ms(lambda: ca_traj.trajectory(v), iters=10)
    print(f"kernel: scl_decode_traj ca_scl L={L} B={BATCH} ms={ca_traj_ms} [{card}]")
    key = step_seed(SWEEP_SEED, 99, 0, 0)
    nq = len(full.decoder.spans)
    rows["scl_mc_traj"] = dict(
        bound(table_bytes(spec, L)
              + BATCH * (spec.N * L + nq * L + 4 * L + spec.N),
              BATCH * (element_ops(spec, L, epilogue=False) + prologue_ops(spec))),
        ms=time_ms(lambda: full.trajectory(key, sigma2, BATCH), iters=20),
        plain_ms=time_ms(lambda: full.plain_trajectory(key, sigma2, BATCH),
                         iters=2, warmup=1))
    rows["scl_mc_counters"] = dict(
        bound(table_bytes(spec, L) + BATCH * 8,
              BATCH * (element_ops(spec, L) + prologue_ops(spec) + 2 * spec.K)),
        ms=time_ms(lambda: counters.counts(key, sigma2, BATCH), iters=20),
        plain_ms=time_ms(lambda: counters.plain_counts(key, sigma2, BATCH),
                         iters=2, warmup=1))
    for name in KERNELS:
        r = rows[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err[name])
        shape = "arikan_sc L=1" if name == "scl_decode_traj" else f"ca_scl L={L}"
        print(f"time: {name} {shape} B={BATCH} ms={r['ms']} "
              f"cw_per_s={BATCH / r['ms'] * 1e3} plain_ms={r['plain_ms']} "
              f"bound_ms={r['bound_ms']} ({r['bound_by']}: bytes={r['bytes']} "
              f"{r['t_bytes']} ms, element_ops={r['ops']} {r['t_ops']} ms) "
              f"launches={main_launches[name]} [{card}]")
    fused_rates = [r["codewords_per_s"] for r in recs]
    fused_frames = sum(r["frames"] for r in recs)
    print(f"sweep end to end, all frames over all wall time: fused "
          f"{fused_frames} frames in {wall_f} s = {fused_frames / wall_f} "
          f"cw_per_s (8 points); torch {rec_t['frames']} frames in {wall_t} s "
          f"= {rec_t['frames'] / wall_t} cw_per_s (ca_scl 2.0 dB) [{card}]")
    print(f"sweep steady state (per-point rate, first fetch left out): fused "
          f"mean={sum(fused_rates) / len(fused_rates)} per point={fused_rates}; "
          f"torch={rec_t['codewords_per_s']} (ca_scl 2.0 dB) [{card}]")
    print("library: no single PyTorch call computes an SCL decode or the "
          "Monte-Carlo step (library_ms null)")
    print(f"smoke seconds: {time.perf_counter() - t_start:.1f}")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCE,
        "replaces": KERNELS[name],
        "launches": main_launches[name],
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": None,
    } for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
