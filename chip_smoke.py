"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Main path: the flagship `ca_scl` code (N=1024, K=512 + CRC-16, Arikan,
list size 8) decoded at B=8192 codewords per call through the hand-written
CUDA kernel polar_tpu_torch/csrc/scl_decode.cu. Phases (any failure exits
non-zero):

1. device: name, count, nvidia-smi name and power limit;
2. build: nvcc build of the kernel, its seconds and ptxas report;
3. golden replay: results/golden_ca_scl_b256.npz (256 frames recorded
   from the independent C++ decoder) through the kernel, 0 mismatches;
4. kernel == plain PyTorch version on the card, bit for bit (u, payload,
   crc_ok and pm): ca_scl on 1024 channel frames at 2.0 dB and small
   Arikan specs with L in {1, 3, 4, 8}, Gaussian and integer LLRs;
5. main path end to end: info bits -> crc_append -> encode ->
   channel_llrs (2.0 dB) -> decode, 32 batches of 8192 for each seed
   (two by default, `--seeds N` for more); the first seed's Wilson 95%
   interval must overlap the recorded points in results/, and the pooled
   frame errors must agree with each by a two-proportion z-test, |z| < 3;
6. kernel == plain PyTorch version bit for bit at the main path's batch
   (B=8192, and 16384); times by CUDA events at B=8192: kernel, plain
   version, bound.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one card and no network.
"""
from __future__ import annotations

import argparse
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


def wilson_ci(errors: int, n: int, z: float = 1.96) -> tuple[float, float]:
    p = errors / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def two_proportion_z(e1: int, n1: int, e2: int, n2: int) -> float:
    p = (e1 + e2) / (n1 + n2)
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


def element_ops(spec, P: int) -> int:
    """Least element operations of one codeword's decode, counted from the
    shapes of the fast-SSCL program, whatever the kernel does beyond them.
    Per path and output element: f 4 (2 abs, min, sign), g 2 (conditional
    negate, add), UP 1 (xor); per path and input: R0 2 (relu, add), REP 4
    (two relus, two adds); R1/SPC: a hard decision and an abs per input,
    the n_min least reliable inputs selected at ceil(log2(n_min + 1))
    compares per input, one flip per selected position, n/2 log2(n) XORs
    of re-encode and, for SPC, n XORs of parity. A 2P -> P fork: 2P adds
    of candidate metrics and 2P log2(2P) compares to rank them (survivors
    leave in rank order). Epilogue per path: one word XOR of a CRC
    generator mask per unfrozen bit, one compare of the argmin."""
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
    return total + P * (spec.n_payload_slots + 1)


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
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

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
    for N, K, crc, lst in [(64, 28, CrcSpec(8, 0x07, 0), (1, 3, 4, 8)),
                           (128, 56, CrcSpec(16, 0x1021, 0), (1, 3, 4, 8)),
                           (256, 128, None, (3, 8))]:
        mask = tuple(int(v) for v in construct_ga(
            N, K + (crc.width if crc else 0), 2.0))
        small = CodeSpec(N=N, K=K, factors=(2,) * int(math.log2(N)),
                         frozen_mask=mask, crc=crc)
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

    # ---- 5. main path end to end, two seeds ----
    cuda_scl.LAUNCHES["scl_decode"] = 0
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
    launches = cuda_scl.LAUNCHES["scl_decode"]
    lo, hi = wilson_ci(errors, frames)
    zs = {r["file"]: two_proportion_z(errors, frames, r["frame_errors"],
                                      r["frames"]) for r in refs}
    print(f"main path: ca_scl {EBN0_DB} dB frames={frames} "
          f"frame_errors={errors} fer={errors / frames} ci95=({lo}, {hi}) "
          f"z_vs_recorded={zs} end_to_end_cw_per_s={frames / wall} "
          f"launches={launches} [{card}]")
    if launches < 1:
        raise SystemExit("the main path launched no kernel")
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
    bytes_moved = BATCH * (4 * spec.N + spec.N + 5)
    ops = BATCH * element_ops(spec, L)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_ELEM_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"kernel: scl_decode ca_scl B={BATCH} ms={ms} "
          f"cw_per_s={BATCH / ms * 1e3} [{card}]")
    print(f"plain: ca_scl B={BATCH} ms={plain_ms} [{card}]")
    print(f"bound: bytes={bytes_moved} ({t_bytes} ms) element_ops={ops} "
          f"({t_ops} ms) bound_ms={bound_ms} [{card}]")
    print("library: no single PyTorch call computes an SCL decode "
          "(library_ms null)")
    print(f"launches: scl_decode={launches} in the main-path run")
    print(f"smoke seconds: {time.perf_counter() - t_start:.1f}")

    print(json.dumps({"kernels": [{
        "name": "scl_decode",
        "route": "cuda",
        "source": "polar_tpu_torch/csrc/scl_decode.cu",
        "replaces": "polar_tpu/ops/pallas_scl.py:1493",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
