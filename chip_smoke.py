"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Main paths: the flagship `ca_scl` code (N=1024, K=512 + CRC-16, Arikan,
list size 8) decoded at B=8192 codewords per call through the
hand-written CUDA kernels of polar_tpu_torch/csrc/scl_decode.cu; the
Monte-Carlo FER sweep of the `sweep` preset (ca_scl on the 8-point Eb/N0
grid) through polar_tpu_torch.sim.harness; the eBCH code `bch_sc`
through the same kernels' l > 2 branch, the fused sweep, and the hybrid
decoder with the stage kernel of polar_tpu_torch/csrc/stage_down.cu; and
`mixed_scl32` (N=4096, L=32) through the subtree kernel of
scl_decode.cu, one launch a depth-1 child. Arikan specs at list sizes
<= 8 decode through the redesigned Arikan capacity-8 body of
scl_decode.cu (64 or 128 threads a codeword by a rule of its layout,
stage 1 read through the channel row, packed bits, forks in registers),
every other spec through its general body (at L <= 8 a warp a path:
bch_sc's K2, K4 and K5 at L=1 two codewords a warp, a half-warp each).
Phases (any failure exits non-zero):

1. device: name, count, nvidia-smi name and power limit;
2. build: one nvcc a source, and one for the op-kind clock build of
   scl_decode.cu (phase 23), all started together; seconds, ptxas's
   registers and spills of each instance (any instance that spills fails:
   the general body's and the Arikan body's), threads a block of the
   Arikan instances at ca_scl and arikan_sc, and at bch_sc for L = 1..8
   threads, codewords a block and blocks an SM (occupancy API), at ca_scl
   blocks an SM;
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
   16384); times by CUDA events at B=8192: kernel, plain version, bound,
   and the time before the Arikan body's second redesign (PERF.md);
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
   each kernel's bound (K2, K4, K5 beside their times before the Arikan
   body's second redesign), and the sweep's end-to-end cw/s per backend:
   all frames over all wall time, and the harness's steady-state rate;
12. bch_sc (N=256 = 16 x 16 eBCH, K=128, SC; BASELINE config 3): the
   stage kernel stage_down (K6, csrc/stage_down.cu) == its plain version
   bit for bit for every input i < 15 of the 16x16 kernel at bch_sc's
   shapes (P, n) = (1, 16), (1, 1), (8, 16), (8, 1), B=8192, the trellis
   inputs (i < 5) also on integer, huge (+-1e30, 4e30) and +-inf inputs
   (NaN where the plain version gives NaN);
13. the decode body's l > 2 branch == plain bit for bit: K1, K2, K4, K5
   (K4/K5 with injected noise) on mixed specs with and without CRC at
   B=1024, at bch_sc L = 1..8 at B=1024, and at bch_sc B=8192: K2 at L=1,
   K4/K5 at L=1, K1 at L=8, and
   on integer (tied) and huge (+-1e30, 4e30) LLRs and noise K1 at L=8, K2
   at L=1, K4/K5 at L=1 and 8; the in-kernel Philox draw at bch_sc (u_true
   exact, <= 1 frame in 10^4);
14. the bch_sc sweep through `fused` (K5) at 1.0..3.0 dB, 2^18 frames a
   point (the size of the record), two-proportion z-test against
   results/bch_sc_tpu.jsonl at each point, |z| < 4;
15. bch_sc at 2.0 dB, 4 batches of 8192 on the same keys through `fused`,
   `torch` (K2) and the hybrid (`big_stage_backend="pallas"`: K6, 105
   launches a decode): identical counts; `--list-size 8` through `torch`
   (K1) and the full-mode step (K4, equal to counters mode); each path's
   launches counted from 0;
16. times by CUDA events at bch_sc, B=8192 and the preset's 2048: K1 (L=8),
   K2, K4, K5 (L=1), and K6 as the 105 launches of one hybrid decode, each
   with its plain version and bound, K1-K5 at B=8192 beside their times
   before the syndrome-trellis redesign (PERF.md §6); the hybrid
   decode's own time;
17. list capacity 32: K1, K2, K4, K5 == plain bit for bit at L = 16 and 32
   on small Arikan and mixed specs, on Gaussian LLRs and noise and on huge
   ones (+-1e30, 4e30, one +-inf a codeword on the Arikan spec; noise
   1e32); K1 and K2 timed at L=32, B=8192;
18. the subtree kernel scl_subtree (K3, one depth-1 child a launch) ==
   its plain version bit for bit on every child of small Arikan and mixed
   specs at L = 1, 4, 32, on path-bound inputs with diverged metrics:
   Gaussian, integer (tied metrics and inputs) and huge (+-1e30, 4e30,
   on sorted metrics);
19. mixed_scl32 (N=4096 = 16 x 16 x 2^4, K=2048 + CRC-16, L=32; BASELINE
   config 4): K6 == plain bit for bit at its outer launches' shapes, (P,
   n, B) = (1, 256, 256) and (32, 256, 256), every i < 15, the trellis
   inputs also on integer, huge and +-inf inputs; at the
   preset's batch 256 and 1.25 dB: one decode through the
   K3 route (`subtree_backend="pallas"`, `big_stage_backend="pallas"`)
   launches 13 K3 and 15 K6; K3 == plain on the 13 children's inputs
   captured from it, and holds 2 blocks an SM on each (occupancy API);
   the route == the hybrid without K3 == the plain route (u, payload,
   crc_ok, pm);
20. results/golden_mixed_scl_b128.npz (128 frames of N=512, (16,2,2,2,2,2),
   L=8, from the independent C++ decoder) through K1 and the K3 route,
   0 mismatches;
21. the FER of mixed_scl32 at 1.25 dB through the K3 route (`run_sweep`,
   `torch` backend, 2^15 frames at B=256: cut from the record's 2^17 for
   time), the main path of K3, its launches counted from 0; its z against
   results/mixed_scl32_tpu_r3.jsonl is printed and must be < 4 (not worse
   than the record; the record is ~10x worse than the port's decoder,
   ROADMAP Queue 3); the hybrid counts the same errors on the sweep's
   first 4 batches; on the sweep's frames, frame errors fall with the list
   size: L=8 (K1) > L=16 (K1, capacity 32) > L=32 (the K3 route);
22. times at mixed_scl32, B=256 and 2048: the 13 K3 launches, the 15 outer
   K6 launches (each with plain version and bound; at B=256 beside their
   times before the syndrome-trellis redesign) and the whole decode
   through the K3 route and through the hybrid; K3 == plain on the 13
   children's inputs captured at B=2048;
23. the op-kind split of K5 and K1 at ca_scl, B=8192, of K5 at bch_sc
   (L=1) and K1 at bch_sc L=8, B=8192, of K1 at L=32 on
   (2,)*7 and (16,2,2), B=8192, and of K3 on the 13 children of one
   mixed_scl32 decode (B=256), through the op-kind clock build of
   scl_decode.cu (-DSCL_CLOCK, sim/kernel_times.py `split`): cycles a
   block by op kind, the l > 2 DOWN ops by method, the R1/SPC fork
   rounds a block (the clock's count == the op program's) and the
   chain's cycles a round;
24. the sweep's fetch and its trace: the fetch of call n returns while
   call n+1 (~50 ms of torch.cuda._sleep) still runs; `sweep_cli
   --profile` over a short steady window of the ca_scl fused sweep (K5),
   the bch_sc fused sweep and the mixed_scl32 K3 route (B=256), each read
   by sim/kernel_times.py `trace_summary`: the device's busy and idle
   share, the five kernels that take the most time, the three longest idle
   gaps with the host ops that overlap them; phase 10's all-frames rate
   of the fused sweep beside K5's own rate (phase 11);
25. the multi-card sweep (`sweep` preset, `fused`, 2 points, B=8192 a
   rank): n = min(cards, 4) ranks over NCCL, one card each, launched by
   torchrun (2 ranks on the one card over gloo where there is one card):
   4 steps a point, each rank's counts recomputed here with
   step_seed(..., rank=r) and summed; resumed to 2^20 frames a point
   (the n-card rate); a resume that adds no frame; the same sweep on one
   card in one process (the one-card rate); entry.dryrun_multichip(n).
   `--multi` runs phases 1, 2 and 25 alone (for a call with several
   cards);
26. the decoder knobs and construct_mc: (a) ca_scl (L=8) and bch_sc (L=1
   and 8) through each knob alone (genie at L=1, fast=False,
   fast_r1_scl=False, unroll=False, f_mode="exact", pm_mode="smooth",
   llr_dtype=bfloat16; bch_sc with big_stage_backend="pallas"): the op
   program on the card == the same knob on the CPU on 256 frames at 2.0
   dB (min-sum knobs bit for bit; exact, smooth, bfloat16: u, payload,
   crc_ok, pm within allclose(rtol=1e-5, atol=1e-4)), K1 and K2 launched
   0 times, K6 as often as the knob's program has l > 2 min-sum DOWN
   ops, each route's ms at B=8192; (b) bfloat16 at full width: ca_scl L=8,
   2^17 `mc_draw` frames through the bfloat16 route and through K1:
   frame errors |z| < 4 against results/bf16_ab.jsonl's bfloat16 arm and
   against K1, the share of frames whose u equals K1's, both cw/s; (c)
   construct_mc of the committed bch_n256_k128 and mixed_n4096_k2064
   (the Monte-Carlo rows of polar_tpu_torch/scripts/gen_sequences.py
   `SPECS`, the JAX script's: 2.0 dB, 2^15 frames, seed 0; B=8192), K6
   launches counted from 0: the unfrozen count, and every leaf on which
   the mask and the committed artifact disagree within 4 binomial sd of
   the port's cut; 4,096 bch_n256 frames from the same
   Philox keys on the card and the CPU (at most 1 frame in 10^4 differs);
   K6 timed at the genie decode's 255 launches;
27. independent goldens (polar_tpu_torch/records/, decisions of the C++
   codec polar_tpu_torch/csrc/polar_ref.cpp): (a) the codec built here
   with g++ re-records the first 8 frames of golden_c32_subtree.npz to
   its committed decisions; (b) each record through each route of its
   `sim/golden.py` RECORDS entry, and the two records of results/ (ca_scl
   through K1, mixed N=512 through K1 and the K3 route), each by
   `replay_check` with 0 mismatching frames and its route's kernel
   launched (counts from 0 just before the replay): bch_sc L=1 (K2; the
   hybrid, K6), bch_sc L=8 (K1), (2,)*7 L=32 (K1), (2,16,2) L=32 (K1; the
   K3 route; the hybrid, K6); (c) each replay's wall ms and its decode's
   ms by CUDA events (at L=1 also K2's alone);
28. the entry points: `polar_tpu_torch.bench` (the flagship, ca_scl L=8
   at B=8192 through K1) and `polar_tpu_torch.benchmarks.decode_bench`
   rows, run in-process on the card as a user runs them (`ENTRY_ROWS`:
   ca_scl `fused` (K5), arikan_sc `pallas` (K2 + scl_epilogue), bch_sc
   `xla` at L=1 (K2 + scl_epilogue) and L=8 (K1), the bch_sc hybrid (K6,
   105 launches a decode), mixed_scl32 through the K3 route at B=256 (13
   K3, 15 K6)): each line parses and has its fields, each row's launches
   in its timed window are `reps` x its decode's and no other kernel
   launched, the flagship launched K1 reps + 1 times (its warm-up too) and
   nothing else, and its rate is at most 1.05 x K1's own (phase 6; below
   0.9 x it is printed as a finding), beside its rate before the Arikan
   body's second redesign; each row's rate beside its kernels' own time
   in this run; gen_sequences' SPECS (used by phase 26(c)).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Needs one card and no network.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import re
import shutil
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
SCL_SOURCE = "polar_tpu_torch/csrc/scl_decode.cu"
# kernel -> (its source, the TPU kernel (pallas_call site) it replaces)
KERNELS = {
    "scl_decode": (SCL_SOURCE, "polar_tpu/ops/pallas_scl.py:1493"),
    "scl_decode_traj": (SCL_SOURCE, "polar_tpu/ops/pallas_scl.py:1523"),
    "scl_mc_traj": (SCL_SOURCE, "polar_tpu/ops/pallas_scl.py:1397"),
    "scl_mc_counters": (SCL_SOURCE, "polar_tpu/ops/pallas_scl.py:1374"),
    "stage_down": ("polar_tpu_torch/csrc/stage_down.cu",
                   "polar_tpu/ops/pallas_stage.py:161"),
    "scl_subtree": (SCL_SOURCE, "polar_tpu/ops/pallas_scl.py:1436"),
}
SWEEP_FRAMES = 1 << 20
SWEEP_SEED = 2026
SWEEP_REFS = ("sweep_tpu_fused_r3.jsonl", "sweep_tpu.jsonl")
SWEEP_Z_LIMIT = 4.0
SWEEP_MIN_REF_ERRORS = 500
DIFF_LIMIT = 1e-4           # in-kernel Philox: differing frames allowed
BCH_REF = "bch_sc_tpu.jsonl"    # 262,144 frames a point, 1.0..3.0 dB
BCH_FRAMES = 1 << 18
BCH_STEPS = 4                   # batches of each bch_sc route's main path
FULL_STEPS = 4              # batches of the full-mode step's main path
MIXED_REF = "mixed_scl32_tpu_r3.jsonl"   # 131,072 frames a point, 1.0..1.5 dB
MIXED_EBN0 = 1.25
MIXED_FRAMES = 1 << 15      # the FER point through the K3 route (cut from 2^17)
MIXED_SEED = 2026
MIXED_BATCH = 256           # the FER point's batch (the preset's)
MIXED_BATCH_LARGE = 2048    # the second batch timed
MIXED_SAME_KEYS = 4         # batches decoded by both mixed_scl32 routes
SMALL_BATCH = 1024          # kernel == plain on small specs (phases 17, 18)
SLEEP_CYCLES = 100_000_000  # ~50 ms of torch.cuda._sleep (phase 24)
TRACE_FRAMES = 1 << 18      # the traced steady window of each fused sweep
TRACE_BATCHES = 4           # batches of the traced mixed_scl32 window
MULTI_SNR = ("1.0", "2.0")  # the points of the multi-card sweep
MULTI_STEPS = 4             # steps a point recomputed rank by rank
MULTI_TIMEOUT = 600         # seconds for each multi-rank run
KNOB_FRAMES = 64            # frames of each knob route on the card and the CPU
                            # (256 cut for time: the CPU side)
KNOB_SEED = 2026
BF16_REF = "bf16_ab.jsonl"  # the TPU A/B: its frame counts, not its speeds
BF16_BATCHES = 16           # 2^17 frames of the bfloat16 A/B
CONSTRUCT_SD = 4.0          # a leaf the masks disagree on: within 4 sd of the cut
CONSTRUCT_SAME_FRAMES = 4096    # bch_n256's genie decode on the card and the CPU
# phase 28: decode_bench rows (arguments after the defaults: B=8192, 8
# reps) and the kernels one call of each launches
ENTRY_ROWS = (
    (("--preset", "ca_scl", "--backend", "fused"), {"scl_mc_counters": 1},
     "K5 ca_scl"),
    (("--preset", "arikan_sc", "--backend", "pallas"), {"scl_decode_traj": 1},
     "K2 arikan_sc"),
    (("--preset", "bch_sc", "--backend", "xla"), {"scl_decode_traj": 1},
     "K2 bch_sc"),
    (("--preset", "bch_sc", "--backend", "xla", "--list-size", "8"),
     {"scl_decode": 1}, "K1 bch_sc L=8"),
    (("--preset", "bch_sc", "--backend", "xla", "--big-stage", "pallas"),
     {"stage_down": 105}, "K6 x105 bch_sc"),
    (("--preset", "mixed_scl32", "--backend", "xla", "--subtree", "pallas",
      "--big-stage", "pallas", "--batch", "256"),
     {"scl_subtree": 13, "stage_down": 15}, "K3 x13 + K6 x15 mixed_scl32"),
)
ENTRY_REPS = 8          # both entry points' default reps
ENTRY_FIELDS = {"preset", "backend", "batch", "big_stage", "subtree", "measures",
                "route", "list_size", "ms_per_decode", "codewords_per_s",
                "build_s", "frame_errors", "launches", "device", "card"}
FLAGSHIP_MAX = 1.05     # the flagship bench's rate over K1's own: at most
FLAGSHIP_LOW = 0.9      # below it: printed as a finding
# the rows the syndrome-trellis redesign changed, before it (PERF.md §6:
# sim/kernel_times.py on an NVIDIA H100 80GB HBM3, 700 W, the mean of
# two runs of the parent tree): bch_sc at B=8192 (K1 at L=8, the others at
# L=1), printed beside phase 16's times; mixed_scl32's 13 K3 and 15 outer
# K6 launches of a decode at B=256, beside phase 22's
TRELLIS_PARENT_MS = {("scl_decode", "bch_sc"): 10.7762,
                     ("scl_decode_traj", "bch_sc"): 2.4337,
                     ("scl_mc_traj", "bch_sc"): 2.5203,
                     ("scl_mc_counters", "bch_sc"): 2.5213,
                     ("scl_subtree", "mixed_scl32"): 14.9692,
                     ("stage_down", "mixed_scl32"): 8.3942}
# the Arikan capacity-8 instances at B=8192 before the body's second
# redesign (PERF.md: sim/kernel_times.py on an NVIDIA H100 80GB HBM3, 700 W;
# K1, K2, K4, K5 at ca_scl L=8, and K2 at arikan_sc L=1), printed beside
# phases 6 and 11's times
ARIKAN_PARENT_MS = {("scl_decode", "ca_scl"): 5.8631,
                    ("scl_decode_traj", "ca_scl"): 6.1418,
                    ("scl_mc_traj", "ca_scl"): 6.1785,
                    ("scl_mc_counters", "ca_scl"): 5.8185,
                    ("scl_decode_traj", "arikan_sc"): 1.6348}
# the flagship bench's line before it (PERF.md: phase 28 of this script on
# an NVIDIA H100 80GB HBM3, 700 W)
FLAGSHIP_PARENT = 1_396_876


def beside_parent(kernel: str, preset: str, ms: float) -> str:
    """`ms` beside the Arikan instance's time before the body's second
    redesign, or the l > 2 row's before the trellis redesign."""
    parent = ARIKAN_PARENT_MS.get((kernel, preset))
    if parent:
        return f" (before the second Arikan redesign: {parent} ms, x{parent / ms:.3f})"
    parent = TRELLIS_PARENT_MS.get((kernel, preset))
    return (f" (before the trellis redesign: {parent} ms, x{parent / ms:.3f})"
            if parent else "")


def all_launches() -> dict:
    """Each kernel's launch count since the counts were last zeroed."""
    from polar_tpu_torch.ops import cuda_scl, cuda_stage
    return {**cuda_scl.LAUNCHES, **cuda_stage.LAUNCHES}


def zero_launches() -> None:
    from polar_tpu_torch.ops import cuda_scl, cuda_stage
    for counts in (cuda_scl.LAUNCHES, cuda_stage.LAUNCHES):
        for name in counts:
            counts[name] = 0


def huge_values(x: np.ndarray, rng, inf: bool) -> np.ndarray:
    """x with ~30% of its entries at +-1e30 (the selection's kBig), 5% at
    +-4e30 and, if `inf`, one +-inf a row (Arikan specs only: an l > 2
    marginal of an infinite input gives inf - inf)."""
    pick = rng.random(x.shape)
    x = np.where(pick < 0.3, np.sign(x) * 1e30, x)
    x = np.where((pick > 0.3) & (pick < 0.35), np.sign(x) * 4e30, x)
    if inf:
        rows = x.reshape(-1, x.shape[-1])
        rows[np.arange(rows.shape[0]), rng.integers(0, x.shape[-1], rows.shape[0])] = (
            np.inf * np.sign(rng.standard_normal(rows.shape[0])))
    return x


def trellis_cases(dev, gen, paths: int, n: int, b: int):
    """(kind, lam [paths, 16, n, b]) of K6's trellis checks: Gaussian,
    integer, huge (~30% at +-1e30, 5% at +-4e30) and +-inf (the huge ones
    with one +-inf a (path, position, codeword): where both hypotheses cost
    inf, the marginal is inf - inf, NaN in the kernel and the plain version
    alike)."""
    g = 2.0 * torch.randn((paths, 16, n, b), generator=gen, device=dev)
    pick = torch.rand(g.shape, generator=gen, device=dev)
    huge = torch.where(pick < 0.3, torch.sign(g) * 1e30, g)
    huge = torch.where((pick > 0.3) & (pick < 0.35), torch.sign(g) * 4e30, huge)
    at = torch.randint(0, 16, (paths, 1, n, b), generator=gen, device=dev)
    sign = torch.where(torch.rand((paths, 1, n, b), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    inf = huge.scatter(1, at, sign * math.inf)
    return [("gauss", g), ("int", torch.round(g)), ("huge", huge), ("inf", inf)]


def same_nan(got: torch.Tensor, ref: torch.Tensor) -> tuple[bool, float]:
    """got == ref bit for bit, NaN where ref is NaN; the largest
    difference elsewhere."""
    nan = torch.isnan(ref)
    ok = torch.equal(nan, torch.isnan(got)) and torch.equal(got[~nan], ref[~nan])
    fin = ~nan & torch.isfinite(ref) & torch.isfinite(got)
    d = float((got[fin].double() - ref[fin].double()).abs().max()) if fin.any() else 0.0
    return ok, d


def two_proportion_z(e1: int, n1: int, e2: int, n2: int) -> float:
    p = (e1 + e2) / (n1 + n2)
    if p in (0.0, 1.0):
        return 0.0
    return (e1 / n1 - e2 / n2) / math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))


def ulp_flips(decode, x: torch.Tensor) -> int:
    """Frames whose decisions change when every input LLR moves one ulp up
    (the decoder's own sensitivity to its inputs' last bit)."""
    up = torch.nextafter(x, torch.full_like(x, math.inf))
    return int((decode(x).u != decode(up).u).any(dim=1).sum())


def rate_z(p: float, q: float, n: int) -> float:
    """p - q in standard deviations of the difference of two binomial
    estimates over n frames each (0 where both are 0 or 1)."""
    sd = math.sqrt((p * (1 - p) + q * (1 - q)) / n)
    return (p - q) / sd if sd else 0.0


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


def _xors(t) -> int:
    """XORs of x' = x T over GF(2) for one vector: weight - 1 a column."""
    return int(sum(max(int(c.sum()) - 1, 0) for c in np.asarray(t).T))


def half_tables(l: int) -> int:
    """Adds that build the fixed tree's two half-subtree tables of an l x l
    kernel level by level, one add an entry: pairs, quads, ... halves (608
    at l = 16)."""
    tables, w = 0, 2
    while w <= l // 2:                  # subtree tables of w inputs
        tables += (l // w) * (1 << w)
        w *= 2
    return tables


def stage_down_ops(kernel, i: int, shared: bool = False) -> int:
    """Least element operations of input i of an l x l kernel (l > 2) for
    one (path, position), from its coset-adjusted LLRs, that give the
    reference's floats: i = l-1 a weighted correlation (l multiplies,
    l - 1 adds); the syndrome trellis one pass for both hypotheses (read
    at states 0 and s1 = H row_i), per section 2 relus and per state 2
    adds and a min (two passes, the reference's, were l (1 + 2 (2 + 3S)));
    the tail table
    over the columns that must be walked (half of them where row l-1 is
    all ones: a column and its complement give |corr|), the cheaper of
    (a) the `half_tables`, then per column one parity XOR and per
    hypothesis one add of the two halves and one max, and (b) per column
    one parity XOR and per hypothesis l - 1 adds and a max; then a
    subtraction and a halving. This is one launch of the stage kernel
    (K6), whose input is one i. `shared`: the tables are built elsewhere
    (once for every input of a node, `element_ops`) and not counted."""
    from polar_tpu_torch.ops.cuda_stage import big_kernel, processor

    l = kernel.shape[0]
    if i == l - 1:
        return 2 * l - 1
    proc = processor(kernel)
    if proc.backend[i] == "trellis":
        return l * (2 + 3 * proc.syn[i][0])
    walk = int(big_kernel(kernel).walk[i])
    if shared:
        return walk * 5 + 2
    return min(half_tables(l) + walk * 5, walk * (1 + 2 * l)) + 2


def node_ops(kernel, inputs, P: int, rows: int) -> int:
    """Least element operations, per position, of the DOWN ops of one node
    of an l > 2 stage (its inputs i, all from one block of parent LLRs)
    at P paths, the parent block holding `rows` distinct rows. The tail
    tables of the raw parent LLRs depend only on the row and the position,
    and a prior decisions' coset is an XOR of the lookup index, so the
    `half_tables` are built once a row and read by every table input; each
    table input costs its shared walk and one XOR of the coset (i > 0),
    or, where cheaper, its `stage_down_ops` alone. The trellis and the
    last input take the coset as l sign selects (i > 0)."""
    from polar_tpu_torch.ops.cuda_stage import processor

    l = kernel.shape[0]
    proc = processor(kernel)
    table = [i for i in inputs if i < l - 1 and proc.backend[i] != "trellis"]
    other = sum(stage_down_ops(kernel, i) + (l if i else 0)
                for i in inputs if i not in table)
    alone = sum(stage_down_ops(kernel, i) + (1 if i else 0) for i in table)
    shared = sum(stage_down_ops(kernel, i, shared=True) + (1 if i else 0)
                 for i in table)
    return P * other + min(rows * half_tables(l) + P * shared, P * alone)


def inverse_xors(spec, d: int) -> int:
    """XORs of u = x (K_{d+1} (x) ... (x) K_m)^-1 for one path."""
    from polar_tpu_torch.ops.program import staged_inverse_kernels

    ns = spec.block_sizes
    if all(f == 2 for f in spec.factors[d:]):
        return (ns[d] // 2) * int(math.log2(ns[d]))
    inv = staged_inverse_kernels(spec)
    return sum(ns[d] // spec.factors[s] * _xors(inv[s])
               for s in range(d, len(spec.factors)))


def element_ops(spec, P: int, epilogue: bool = True, root_rows: int = 1) -> int:
    """Least element operations of one codeword's decode, counted from the
    shapes of the fast-SSCL program, whatever the kernel does beyond them.
    Per path and output element: f 4 (2 abs, min, sign), g 2 (conditional
    negate, add), UP 1 (xor); at an l > 2 stage the DOWN ops of each node
    together (`node_ops`: tail tables once a row of the parent block, at
    stage 1 `root_rows` rows, else P) and UP's GF(2) products; per
    path and input: R0 2 (relu, add), REP 4 (two relus, two adds); R1/SPC:
    a hard decision and an abs per input, the n_min least reliable inputs
    selected at ceil(log2(n_min + 1)) compares per input, one flip per
    selected position, the XORs of the inverse transform below
    (`inverse_xors`) and, for SPC, n XORs of parity. A 2P -> P fork: 2P
    adds of candidate metrics and 2P log2(2P) compares to rank them
    (survivors leave in rank order). Epilogue per path (only where the
    kernel runs it: `epilogue`): one word XOR of a CRC generator mask per
    unfrozen bit, one compare of the argmin. `root_rows`: rows of the
    block stage 1 reads (1 for the channel LLRs, P for a child's
    path-bound input)."""
    from polar_tpu_torch.ops.program import build_program
    from polar_tpu_torch.ops.schedule import build_schedule

    ns = spec.block_sizes
    digits = build_schedule(spec).digits
    total = 0
    fork = 2 * P + 2 * P * int(math.log2(2 * P)) if P > 1 else 0
    nodes = []              # (level, the inputs i of its DOWN ops), l > 2
    for op in build_program(spec, scl=P > 1).ops:
        n = ns[op.level]
        if op.kind in ("DOWN_FRESH", "DOWN_DYN"):
            kernel = spec.kernels[op.level - 1]
            l = kernel.shape[0]
            if l == 2:
                total += (4 if op.kind == "DOWN_FRESH" else 2) * P * n
            elif op.kind == "DOWN_FRESH":
                nodes.append((op.level, [0]))
            else:
                node = next(nd for nd in reversed(nodes) if nd[0] == op.level)
                node[1].append(int(digits[op.t0, op.level - 1]))
        elif op.kind == "UP":
            total += P * n * (1 if spec.factors[op.level - 1] == 2 else
                              _xors(spec.kernels[op.level - 1]))
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
            total += (P * (2 * n + select + n_min + inverse_xors(spec, op.level)
                           + (n if spc else 0)) + rounds * fork)
    for level, inputs in nodes:
        total += ns[level] * node_ops(spec.kernels[level - 1], inputs, P,
                                      root_rows if level == 1 else P)
    return total + (P * (spec.n_payload_slots + 1) if epilogue else 0)


def prologue_ops(spec) -> int:
    """Least element operations of one codeword's Monte-Carlo prologue,
    from the shapes: Philox4x32-10 gives 4 words a call and 2N words are
    drawn, at 10 rounds of 2 multiply-high, 2 multiply-low and 4 XORs (the
    key schedule is shared by the batch); K data bits masked, K CRC mask
    XORs, the encode's XORs (`inverse_xors` of the transform itself);
    Box-Muller per pair of rows: 2 shifts, 2 converts, an add, 2 scalings,
    log, a multiply, sqrt, a multiply, cos, sin, 2 multiplies
    (transcendentals counted as one operation each); the channel per row:
    2x, 1 - 2x, sigma g, an add, the LLR scaling."""
    N, K = spec.N, spec.K
    philox = (2 * N // 4) * 10 * 8
    if all(f == 2 for f in spec.factors):
        enc = (N // 2) * int(math.log2(N))
    else:
        enc = sum(N // f * _xors(k) for f, k in zip(spec.factors, spec.kernels))
    return philox + 2 * K + enc + 15 * (N // 2) + 5 * N


def table_bytes(spec, P: int) -> int:
    """Bytes of the kernels' host tables (op table, span rows, payload
    rows, CRC masks, stage tables), each read once."""
    from polar_tpu_torch.ops.cuda_scl import build_tables

    t = build_tables(spec, P)
    return sum(t[k].nbytes for k in ("ops", "qrow", "pidx", "gmask", "st"))


def bound(bytes_moved: int, ops: int) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_ELEM_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "t_bytes": t_bytes, "ops": ops,
            "t_ops": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, iters: int, warmup: int = 2, reps: int = 1) -> float:
    """Mean ms of `iters` calls by CUDA events; with reps > 1 the least of
    `reps` such windows (a window the shared host stalls in reads long:
    short kernels wait on the Python that launches them)."""
    for _ in range(warmup):
        fn()
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / iters
        best = ms if best is None else min(best, ms)
    return best


def fields_equal(a, b) -> tuple[bool, float]:
    """All four DecodeResult fields equal; max |difference| over them."""
    err = 0.0
    same = True
    for f in ("u", "payload", "crc_ok", "pm"):
        x, y = getattr(a, f), getattr(b, f)
        same &= bool(torch.equal(x, y))
        err = max(err, float((x.double() - y.double()).abs().max()))
    return same, err


def stage_launch_set(spec, P: int, level: int | None = None, **knobs
                     ) -> list[tuple[int, int, int]]:
    """(i, paths, n) of every stage-kernel launch of one hybrid decode: each
    l > 2 DOWN op with i < l-1 (a stage-1 DOWN_FRESH runs at one path);
    `level`: only the DOWN ops of that stage; `knobs`: build_program's
    (classify, fast_r1_scl, genie) for a decode with decoder knobs."""
    from polar_tpu_torch.ops.program import build_program
    from polar_tpu_torch.ops.schedule import build_schedule

    digits = build_schedule(spec).digits
    out = []
    for op in build_program(spec, scl=P > 1, **knobs).ops:
        if (op.kind not in ("DOWN_FRESH", "DOWN_DYN")
                or level not in (None, op.level)):
            continue
        l = spec.factors[op.level - 1]
        i = 0 if op.kind == "DOWN_FRESH" else int(digits[op.t0, op.level - 1])
        if l > 2 and i < l - 1:
            paths = 1 if (op.level == 1 and op.kind == "DOWN_FRESH") else P
            out.append((i, paths, spec.block_sizes[op.level]))
    return out


def subtree_bound(sub, P: int, batch: int) -> dict:
    """The least time of one subtree-kernel launch over `batch` codewords
    of child `sub`: its input block, metrics in and out, span bits and
    perms, net map and root re-encode, each moved once, plus the tables;
    the child's program (`element_ops`) and the root re-encode's XORs."""
    from polar_tpu_torch.ops.scl import trajectory_spans

    N, n1 = sub.N, sub.block_sizes[1]
    Q = len(trajectory_spans(sub, P))
    moved = 4 * P * N + 4 * P + N * P + Q * P + P + P * N + 4 * P
    ops = (element_ops(sub, P, epilogue=False, root_rows=P)
           + P * n1 * _xors(sub.kernels[0]))
    return bound(table_bytes(sub, P) + batch * moved, batch * ops)


def mixed_phases(dev, card, rng, check, err, main_path, rows, main_launches):
    """Phases 17-22: list sizes up to 32 in the decode kernels, and
    mixed_scl32 (N=4096 = 16 x 16 x 2^4, K=2048 + CRC-16, L=32) through
    the subtree kernel (K3). Fills rows / main_launches for scl_subtree;
    returns the mixed_scl32 and L=32 numbers of the other kernels."""
    from polar_tpu_torch.models.polar import CrcSpec
    from polar_tpu_torch.models.presets import get_preset
    from polar_tpu_torch.ops import cuda_scl, cuda_stage
    from polar_tpu_torch.ops.cuda_scl import SclDecoder, SubtreeKernel
    from polar_tpu_torch.ops.mc import build_mc_step, count_errors, mc_draw
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.ops.program import (build_program, subtree_items,
                                             subtree_spec)
    from polar_tpu_torch.ops.scl import (build_plain_scl_decoder,
                                         build_scl_decoder)
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    from polar_tpu_torch.sim.golden import jittered_spec, load_golden
    from polar_tpu_torch.sim.harness import run_sweep

    crc8 = CrcSpec(8, 0x07, 0)
    extra = {}
    sgen = torch.Generator(device=dev).manual_seed(320)

    # ---- 17. list capacity 32: K1, K2, K4, K5 == plain on small specs ----
    small = [jittered_spec((2,) * 7, 56, crc8), jittered_spec((16, 2, 2), 20, crc8),
             jittered_spec((2, 16, 2), 14, None)]
    n17 = 0
    for sp in small:
        for lsz in (16, 32):
            for kind in ("gauss", "huge"):
                what = f"{sp.factors} L={lsz} B={SMALL_BATCH} {kind}"
                v = 2.0 * rng.standard_normal((SMALL_BATCH, sp.N)) + 0.5
                g = rng.standard_normal((SMALL_BATCH, sp.N))
                if kind == "huge":
                    v = huge_values(v, rng, inf=set(sp.factors) == {2})
                    g = np.where(rng.random(g.shape) < 0.3, 1e32, g)
                x = torch.as_tensor(v, dtype=torch.float32, device=dev)
                d1 = SclDecoder(sp, lsz, dev, select=True)
                check("scl_decode", what, tuple(d1.kernel(x)), tuple(d1.plain(x)))
                d2 = SclDecoder(sp, lsz, dev, select=False)
                traj = d2.trajectory(x)
                check("scl_decode_traj", what, traj, d2.plain_trajectory(x))
                check("scl_decode_traj", what + " epilogue", tuple(d2.epilogue(*traj)),
                      tuple(d2.plain(x)))
                step = build_mc_step(sp, lsz, device=dev)
                noise = torch.as_tensor(g, dtype=torch.float32, device=dev)
                seed = tuple(int(w) for w in rng.integers(0, 2**32, 2))
                check("scl_mc_traj", what + " noise in",
                      step.trajectory(seed, 0.8, SMALL_BATCH, noise),
                      step.plain_trajectory(seed, 0.8, SMALL_BATCH, noise))
                check("scl_mc_counters", what + " noise in",
                      [step.counts(seed, 0.8, SMALL_BATCH, noise)],
                      [step.plain_counts(seed, 0.8, SMALL_BATCH, noise)])
                n17 += 1
    torch.cuda.synchronize()
    print(f"capacity 32: scl_decode, scl_decode_traj, scl_mc_traj, "
          f"scl_mc_counters == plain bit for bit on {n17} spec x L x kind cases "
          f"((2,)*7 CRC-8, (16,2,2) CRC-8, (2,16,2); L = 16, 32; Gaussian and "
          f"huge: +-1e30, 4e30, one +-inf a codeword on (2,)*7, noise 1e32; "
          f"B={SMALL_BATCH})")
    for sp in small[:2]:
        x = torch.as_tensor(2.0 * rng.standard_normal((BATCH, sp.N)) + 1.0,
                            dtype=torch.float32, device=dev)
        d1 = SclDecoder(sp, 32, dev, select=True)
        d2 = SclDecoder(sp, 32, dev, select=False)
        nq = len(d2.spans)
        for name, fn, pfn, bd in (
                ("scl_decode", lambda: d1.kernel(x), lambda: d1.plain(x),
                 bound(table_bytes(sp, 32) + BATCH * (4 * sp.N + sp.N + 5),
                       BATCH * element_ops(sp, 32))),
                ("scl_decode_traj", lambda: d2.trajectory(x),
                 lambda: d2.plain_trajectory(x),
                 bound(table_bytes(sp, 32)
                       + BATCH * (4 * sp.N + sp.N * 32 + nq * 32 + 4 * 32),
                       BATCH * element_ops(sp, 32, epilogue=False)))):
            r = dict(bd, ms=time_ms(fn, iters=10, reps=3),
                     plain_ms=time_ms(pfn, 1, 1))
            key = "x".join(str(f) for f in sp.factors)
            extra.setdefault(name, {})[f"L32_{key}"] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
            print(f"time: {name} {sp.factors} L=32 B={BATCH} ms={r['ms']} "
                  f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} "
                  f"({r['bound_by']}) [{card}]")

    # ---- 18. the subtree kernel (K3) == plain on small specs ----
    n18 = 0
    for factors, K, crc in (((2, 2, 2, 2, 2), 12, None), ((2, 16, 2), 14, crc8),
                            ((16, 2, 2, 2), 40, crc8)):
        sp = jittered_spec(factors, K, crc)
        for lsz in (1, 4, 32):
            for item in subtree_items(build_program(sp, scl=lsz > 1), sp):
                if item[0] != "sub":
                    continue
                core = SubtreeKernel(subtree_spec(sp, item[2]), lsz)
                lam = 2.5 * torch.randn((lsz, core.spec.N, SMALL_BATCH), generator=sgen,
                                        device=dev)
                pm = 3.0 * torch.rand((lsz, SMALL_BATCH), generator=sgen, device=dev)
                big = torch.as_tensor(huge_values(lam.cpu().numpy(), rng, inf=False),
                                      device=dev)
                for kind, x, m in (("gauss", lam, pm),
                                   ("tied", torch.round(lam), torch.round(pm)),
                                   ("huge", big, pm.sort(dim=0).values)):
                    check("scl_subtree", f"{factors} L={lsz} child t0={item[1]} {kind}",
                          core.kernel(x, m), core.plain(x, m))
                    n18 += 1
    torch.cuda.synchronize()
    print(f"scl_subtree == plain: {n18} child x kind cases bit-exact (Arikan "
          f"(2,2,2,2,2), mixed (2,16,2) and (16,2,2,2); L = 1, 4, 32; B={SMALL_BATCH}; "
          f"path-bound input, diverged metrics: Gaussian, integer with ties, huge "
          f"(+-1e30, 4e30) on sorted metrics), max_abs_err={err['scl_subtree']}")

    # ---- 19. mixed_scl32: the K3 route, the hybrid and the plain route ----
    mixed = get_preset("mixed_scl32")
    mspec, P = mixed.spec, mixed.list_size
    sigma = float(ebn0_to_sigma(MIXED_EBN0, mspec.rate))
    subs = [it for it in subtree_items(build_program(mspec, scl=True), mspec)
            if it[0] == "sub"]
    route = build_scl_decoder(mspec, P, device=dev, subtree_backend="pallas",
                              big_stage_backend="pallas")
    hybrid = build_scl_decoder(mspec, P, device=dev, big_stage_backend="pallas")
    plain = build_plain_scl_decoder(mspec, P)

    def captured(llr):
        """The route's eager walk of llr (a replayed graph calls no
        Python), and the (core, lam1, pm) of each of its subtree-kernel
        calls."""
        calls = []
        call = SubtreeKernel.__call__

        def spy(core, lam1, pm):
            calls.append((core, lam1.clone(), pm.clone()))
            return call(core, lam1, pm)
        SubtreeKernel.__call__ = spy
        try:
            out = route.walk(llr)
        finally:
            SubtreeKernel.__call__ = call
        return out, calls

    # K6 at the outer launches' shapes, every input i < 15
    n1 = mspec.block_sizes[1]
    n_k6 = 0
    for paths in (1, P):
        lam = 2.0 * torch.randn((paths, 16, n1, mixed.batch), generator=sgen,
                                device=dev)
        for i in range(15):
            fn = cuda_stage.build_down_kernel(mspec.kernels[0], i, paths, n1)
            check("stage_down", f"mixed_scl32 outer i={i} P={paths} n={n1} "
                  f"B={mixed.batch}", [fn(lam)], [fn.plain(lam)])
            n_k6 += 1
        for kind, lam in trellis_cases(dev, sgen, paths, n1, mixed.batch):
            for i in range(5):
                fn = cuda_stage.build_down_kernel(mspec.kernels[0], i, paths, n1)
                ok, d = same_nan(fn(lam), fn.plain(lam))
                err["stage_down"] = max(err["stage_down"], d)
                if not ok:
                    raise SystemExit(f"stage_down != plain on mixed_scl32 trellis "
                                     f"input i={i} P={paths} {kind}")
                n_k6 += 1
    torch.cuda.synchronize()
    print(f"stage_down == plain at mixed_scl32's outer shapes: {n_k6} cases "
          f"bit-exact (every i < 15; the trellis inputs i < 5 also on integer, "
          f"huge and +-inf inputs; P = 1, {P}; n={n1}; B={mixed.batch})")
    _, llr = mc_draw(mspec, step_seed(MIXED_SEED, 99, 0, 0), sigma, mixed.batch, dev)
    zero_launches()
    out_route, calls = captured(llr)
    torch.cuda.synchronize()
    per_decode = all_launches()
    print(f"launches: {per_decode} in one mixed_scl32 decode through the K3 "
          f"route (B={mixed.batch})")
    if (per_decode["scl_subtree"], per_decode["stage_down"]) != (len(subs), 15):
        raise SystemExit(f"the K3 route launched {per_decode['scl_subtree']} "
                         f"K3 and {per_decode['stage_down']} K6, not "
                         f"{len(subs)} and 15")
    for core, lam1, pm in calls:
        check("scl_subtree", f"mixed_scl32 child N={core.spec.N} K={core.spec.K}",
              core.kernel(lam1, pm), core.plain(lam1, pm))
    occupancy = {core.kernels.blocks_per_sm("scl_subtree", dev) for core, _, _ in calls}
    print(f"scl_subtree blocks an SM (occupancy API) on the {len(calls)} children: "
          f"{sorted(occupancy)}")
    if occupancy != {2}:
        raise SystemExit(f"scl_subtree holds {sorted(occupancy)} blocks an SM, not 2")
    out_h = hybrid(llr)
    out_p = plain(llr)
    # the route's own calls: the first walks and captures, the second replays
    out_first, out_replay = route(llr), route(llr)
    for other, name in ((out_h, "the hybrid"), (out_p, "the plain route"),
                        (out_first, "the route's first call"),
                        (out_replay, "the route's replay")):
        same, d = fields_equal(out_route, other)
        if not same:
            raise SystemExit(f"mixed_scl32: the K3 route != {name} (max abs err {d})")
    torch.cuda.synchronize()
    print(f"mixed_scl32 B={mixed.batch} at {MIXED_EBN0} dB: scl_subtree == plain "
          f"on all {len(calls)} children (inputs captured from the decode); "
          f"K3 route == hybrid == plain route (u, payload, crc_ok, pm); "
          f"crc_ok {int(out_route.crc_ok.sum())} of {mixed.batch}")

    # ---- 20. the mixed golden replay through K1 and the K3 route ----
    gspec, gl, gllrs, u_ref = load_golden(ROOT / "results" / "golden_mixed_scl_b128.npz")
    for label, kw in (("K1", {}), ("K3 route", dict(subtree_backend="pallas",
                                                    big_stage_backend="pallas"))):
        gout = build_scl_decoder(gspec, gl, device=dev, **kw)(gllrs)
        mism = int((gout.u.cpu().numpy() != u_ref).any(axis=1).sum())
        print(f"golden mixed replay ({gspec.factors}, L={gl}) through {label}: "
              f"frames={gllrs.shape[0]} mismatch_frames={mism}")
        if mism:
            raise SystemExit(f"golden mixed replay mismatch through {label}")

    # ---- 21. FER through the K3 route: the main path of scl_subtree ----
    ref = [json.loads(line) for line in
           (ROOT / "results" / MIXED_REF).read_text().splitlines()
           if json.loads(line)["ebn0_db"] == MIXED_EBN0][0]
    point = dataclasses.replace(mixed, ebn0_grid=(MIXED_EBN0,))
    recs, wall = main_path(
        "scl_subtree", f"mixed_scl32 K3-route sweep at {MIXED_EBN0} dB",
        lambda: run_sweep(point, frames=MIXED_FRAMES, per_device_batch=MIXED_BATCH,
                          seed=MIXED_SEED, device=dev, progress=False,
                          backend="torch", big_stage_backend="pallas",
                          subtree_backend="pallas"))
    rec = recs[0]
    z = two_proportion_z(rec["frame_errors"], rec["frames"], ref["frame_errors"],
                         ref["frames"])
    print(f"sweep mixed_scl32 K3 route: ebn0={MIXED_EBN0} frames={rec['frames']} "
          f"frame_errors={rec['frame_errors']} bit_errors={rec['bit_errors']} "
          f"fer={rec['fer']} ci95={rec['fer_ci95']} z_vs_{MIXED_REF}={z} "
          f"batch={MIXED_BATCH} end_to_end_cw_per_s={rec['frames'] / wall} "
          f"steady_cw_per_s={rec['codewords_per_s']} [{card}]")
    # The recorded TPU point is no two-sided yardstick: the port's decoder
    # equals the JAX package's bit for bit (CPU tests, incl. (16,16,2) at
    # L=32) and its FER here is ~10x below the record's (ROADMAP Queue 3).
    # The gates: not worse than the record; the hybrid (the JAX CLI's
    # route) counts the same errors on the sweep's first keys; and the
    # list sizes order the FER, L = 8 (K1) > 16 (K1, capacity 32) > 32
    # (the K3 route), on the sweep's own keys.
    if z >= SWEEP_Z_LIMIT:
        raise SystemExit(f"mixed_scl32 FER at {MIXED_EBN0} dB is worse than "
                         f"{MIXED_REF}: z = {z}")
    keys = range(MIXED_SAME_KEYS)

    def count(decode, keys):
        fe = be = 0
        for k in keys:
            u_true, llr = mc_draw(mspec, step_seed(MIXED_SEED, 0, k, 0), sigma,
                                  MIXED_BATCH, dev)
            c = count_errors(mspec, decode(llr).u, u_true)
            fe, be = fe + int(c[0].sum()), be + int(c[1].sum())
        return fe, be

    same_keys = {"K3 route": count(route, keys), "hybrid": count(hybrid, keys)}
    print(f"mixed_scl32 at {MIXED_EBN0} dB, the sweep's first {MIXED_SAME_KEYS} "
          f"batches of {MIXED_BATCH}: (frame_errors, bit_errors) {same_keys}")
    if same_keys["K3 route"] != same_keys["hybrid"]:
        raise SystemExit("mixed_scl32: the K3 route and the hybrid count "
                         "different errors on the same keys")
    by_list = {}
    for lsz in (8, 16):
        dec = build_scl_decoder(mspec, lsz, device=dev)
        by_list[lsz] = count(dec, range(MIXED_FRAMES // MIXED_BATCH))[0]
    by_list[P] = rec["frame_errors"]
    print(f"mixed_scl32 frame errors by list size at {MIXED_EBN0} dB on the "
          f"same {MIXED_FRAMES} frames: {by_list} (L=8, 16 through "
          f"scl_decode) [{card}]")
    if not by_list[8] > by_list[16] > by_list[P]:
        raise SystemExit(f"mixed_scl32 frame errors do not fall with the list "
                         f"size: {by_list}")

    # ---- 22. times at B = 256 (the preset's) and 2048 ----
    K16 = mspec.kernels[0]
    outer = stage_launch_set(mspec, P, level=1)
    for b in (mixed.batch, MIXED_BATCH_LARGE):
        tag = "" if b == mixed.batch else f"_b{b}"
        _, llr = mc_draw(mspec, step_seed(MIXED_SEED, 98, 0, b), sigma, b, dev)
        _, calls = captured(llr)
        k3_bound = [subtree_bound(core.spec, P, b) for core, _, _ in calls]
        r = dict(bound(sum(x["bytes"] for x in k3_bound),
                       sum(x["ops"] for x in k3_bound)),
                 ms=time_ms(lambda: [c.kernel(l1, p) for c, l1, p in calls],
                            iters=3, warmup=1))
        if b == mixed.batch:
            r["plain_ms"] = time_ms(lambda: [c.plain(l1, p) for c, l1, p in calls],
                                    iters=1, warmup=0)
            rows["scl_subtree"] = r
        else:
            rows["scl_subtree"]["ms" + tag] = r["ms"]
            rows["scl_subtree"]["bound_ms" + tag] = r["bound_ms"]
            for core, lam1, pm in calls:
                check("scl_subtree", f"mixed_scl32 child N={core.spec.N} "
                      f"K={core.spec.K} B={b}", core.kernel(lam1, pm),
                      core.plain(lam1, pm))
            print(f"scl_subtree == plain on all {len(calls)} children at B={b} "
                  f"(inputs captured from the decode)")
        parent = beside_parent("scl_subtree", "mixed_scl32", r["ms"]) if not tag else ""
        print(f"time: scl_subtree mixed_scl32 L=32, the {len(calls)} launches of "
              f"a decode, B={b} ms={r['ms']}{parent} plain_ms={r.get('plain_ms')} "
              f"bound_ms={r['bound_ms']} ({r['bound_by']}: bytes={r['bytes']} "
              f"{r['t_bytes']} ms, element_ops={r['ops']} {r['t_ops']} ms) [{card}]")
        views = {paths: 2.0 * torch.randn((paths, 16, outer[0][2], b),
                                          generator=sgen, device=dev)
                 for paths in {p for _, p, _ in outer}}
        fns = [(cuda_stage.build_down_kernel(K16, i, paths, n), views[paths])
               for i, paths, n in outer]
        r6 = dict(bound(sum(4 * 17 * paths * n * b for _, paths, n in outer),
                        sum(paths * n * b * stage_down_ops(K16, i)
                            for i, paths, n in outer)),
                  ms=time_ms(lambda: [f(v) for f, v in fns], iters=3, warmup=1))
        if b == mixed.batch:
            r6["plain_ms"] = time_ms(lambda: [f.plain(v) for f, v in fns], 1, 0)
        extra.setdefault("stage_down", {}).update(
            {k + tag: r6[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")
             if k in r6})
        parent = beside_parent("stage_down", "mixed_scl32", r6["ms"]) if not tag else ""
        print(f"time: stage_down mixed_scl32, the {len(outer)} outer launches of a "
              f"decode, B={b} ms={r6['ms']}{parent} plain_ms={r6.get('plain_ms')} "
              f"bound_ms={r6['bound_ms']} ({r6['bound_by']}) [{card}]")
        for label, fn in (("K3 route", route), ("hybrid", hybrid)):
            ms = time_ms(lambda: fn(llr), iters=2, warmup=1)
            key = "route" if fn is route else "hybrid"
            extra.setdefault("scl_subtree", {})[f"{key}_decode_ms{tag}"] = ms
            print(f"time: mixed_scl32 decode through the {label} B={b} ms={ms} "
                  f"cw_per_s={b / ms * 1e3} [{card}]")
    return extra


def bch_phases(dev, card, rng, check, err, main_path, rows, main_launches):
    """Phases 12-16: bch_sc (N=256 = 16 x 16 eBCH, K=128, SC) and mixed
    specs through the l > 2 code. Fills rows / main_launches for the stage
    kernel; returns bch_sc's rows and launches of K1/K2/K4/K5."""
    from polar_tpu_torch.models.polar import CrcSpec
    from polar_tpu_torch.models.presets import get_preset
    from polar_tpu_torch.ops import cuda_stage
    from polar_tpu_torch.ops.cuda_scl import SclDecoder
    from polar_tpu_torch.ops.mc import build_mc_step, count_errors
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.ops.scl import build_scl_decoder
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    from polar_tpu_torch.sim.golden import jittered_spec
    from polar_tpu_torch.sim.harness import make_mc_step, run_sweep

    bch = get_preset("bch_sc")
    bspec = bch.spec
    K16 = bspec.kernels[0]
    sgen = torch.Generator(device=dev).manual_seed(16)

    # ---- 12. the stage kernel (K6) == plain, every i < 15 ----
    n_k6 = 0
    for paths, n in ((1, 16), (1, 1), (8, 16), (8, 1)):
        lam = 2.0 * torch.randn((paths, 16, n, BATCH), generator=sgen, device=dev)
        for i in range(15):
            fn = cuda_stage.build_down_kernel(K16, i, paths, n)
            check("stage_down", f"i={i} P={paths} n={n} B={BATCH}", [fn(lam)],
                  [fn.plain(lam)])
            n_k6 += 1
    # the trellis inputs (i < 5) on tied, huge and infinite inputs too
    for paths, n in ((1, 16), (1, 1), (8, 16), (8, 1)):
        for kind, lam in trellis_cases(dev, sgen, paths, n, BATCH):
            for i in range(5):
                fn = cuda_stage.build_down_kernel(K16, i, paths, n)
                ok, d = same_nan(fn(lam), fn.plain(lam))
                err["stage_down"] = max(err["stage_down"], d)
                if not ok:
                    raise SystemExit(f"stage_down != plain on trellis input i={i} "
                                     f"P={paths} n={n} B={BATCH} {kind}")
                n_k6 += 1
    torch.cuda.synchronize()
    print(f"stage_down == plain: {n_k6} cases bit-exact (every i < 15 of the "
          f"16x16 kernel; P, n = (1, 16), (1, 1), (8, 16), (8, 1); B={BATCH}; "
          f"the trellis inputs i < 5 also on integer, huge and +-inf inputs, "
          f"NaN where the plain version gives NaN), "
          f"max_abs_err={err['stage_down']}")

    # ---- 13. the decode body's l > 2 branch == plain ----
    crc8 = CrcSpec(8, 0x07, 0)
    cases = []
    for factors, K, crc, lists in (((16,), 6, None, (1, 4)), ((4, 4), 6, None, (3,)),
                                   ((16, 2), 12, None, (1, 2)),
                                   ((2, 16), 10, crc8, (1, 4)),
                                   ((16, 2, 2), 20, crc8, (8,))):
        for lsz in lists:
            cases.append((f"{factors} L={lsz} B=1024", jittered_spec(factors, K, crc),
                          lsz, 1024, ("K1", "K2", "K4K5")))
    cases += [(f"bch_sc L=1 B={BATCH}", bspec, 1, BATCH, ("K2", "K4K5")),
              (f"bch_sc L=8 B={BATCH}", bspec, 8, BATCH, ("K1",))]
    cases += [(f"bch_sc L={lsz} B=1024", bspec, lsz, 1024, ("K1", "K2", "K4K5"))
              for lsz in range(1, 9)]
    ngen = torch.Generator(device=dev).manual_seed(256)
    for what, sp, lsz, b, kernels in cases:
        x = torch.as_tensor(2.0 * rng.standard_normal((b, sp.N)) + 0.5,
                            dtype=torch.float32, device=dev)
        if "K1" in kernels:
            d = SclDecoder(sp, lsz, dev, select=True)
            check("scl_decode", what, tuple(d.kernel(x)), tuple(d.plain(x)))
        if "K2" in kernels:
            d = SclDecoder(sp, lsz, dev, select=False)
            traj = d.trajectory(x)
            check("scl_decode_traj", what, traj, d.plain_trajectory(x))
            check("scl_decode_traj", what + " epilogue", tuple(d.epilogue(*traj)),
                  tuple(d.plain(x)))
        if "K4K5" in kernels:
            step = build_mc_step(sp, lsz, device=dev)
            sigma = float(ebn0_to_sigma(2.0, sp.rate))
            seed = tuple(int(w) for w in rng.integers(0, 2**32, 2))
            noise = torch.randn((b, sp.N), generator=ngen, device=dev)
            check("scl_mc_traj", what + " noise in",
                  step.trajectory(seed, sigma, b, noise),
                  step.plain_trajectory(seed, sigma, b, noise))
            check("scl_mc_counters", what + " noise in",
                  [step.counts(seed, sigma, b, noise)],
                  [step.plain_counts(seed, sigma, b, noise)])
    # bch_sc at B=8192 on integer LLRs (tied metrics and positions) and
    # huge ones (+-1e30, 4e30; no +-inf: an l > 2 marginal of an infinite
    # input is inf - inf), noise integer and at 1e32: K1 at L=8, K2 at L=1,
    # K4/K5 at L=1 and 8
    g = 3.0 * rng.standard_normal((BATCH, bspec.N))
    hard = {"int": np.round(g), "huge": huge_values(g, rng, False)}
    ng = rng.standard_normal((BATCH, bspec.N))
    hard_noise = {"int": np.round(1.5 * ng),
                  "huge": np.where(rng.random(ng.shape) < 0.3, 1e32, ng)}
    for label, v in hard.items():
        x = torch.as_tensor(v, dtype=torch.float32, device=dev)
        d = SclDecoder(bspec, 8, dev, select=True)
        check("scl_decode", f"bch_sc L=8 {label}", tuple(d.kernel(x)), tuple(d.plain(x)))
        d = SclDecoder(bspec, 1, dev, select=False)
        check("scl_decode_traj", f"bch_sc L=1 {label}", d.trajectory(x),
              d.plain_trajectory(x))
        noise = torch.as_tensor(hard_noise[label], dtype=torch.float32, device=dev)
        for lsz in (1, 8):
            step = build_mc_step(bspec, lsz, device=dev)
            check("scl_mc_traj", f"bch_sc L={lsz} {label} noise",
                  step.trajectory((5, 6), 1.0, BATCH, noise),
                  step.plain_trajectory((5, 6), 1.0, BATCH, noise))
            check("scl_mc_counters", f"bch_sc L={lsz} {label} noise",
                  [step.counts((5, 6), 1.0, BATCH, noise)],
                  [step.plain_counts((5, 6), 1.0, BATCH, noise)])
    torch.cuda.synchronize()
    # the in-kernel Philox draw at bch_sc: u_true exact, decisions and
    # counts at most 1 frame in 10^4 apart (libdevice logf/sinf/cosf)
    step = build_mc_step(bspec, 1, device=dev)
    sigma = float(ebn0_to_sigma(2.0, bspec.rate))
    k4 = step.trajectory((2026, 3), sigma, BATCH)
    p4 = step.plain_trajectory((2026, 3), sigma, BATCH)
    k5 = step.counts((2026, 3), sigma, BATCH)
    p5 = step.plain_counts((2026, 3), sigma, BATCH)
    if not torch.equal(k4[3], p4[3]):
        raise SystemExit("scl_mc_traj u_true != plain on bch_sc")
    differ = int(((k4[0] != p4[0]).any(0).any(0) | (k5 != p5).any(0)).sum())
    if differ > DIFF_LIMIT * BATCH:
        raise SystemExit(f"bch_sc in-kernel Philox: {differ} frames differ")
    print(f"l > 2 decode body == plain: {len(cases)} specs x kernels bit-exact "
          f"(mixed (16,), (4,4), (16,2), (2,16) CRC-8, (16,2,2) CRC-8 at B=1024; "
          f"bch_sc K2 L=1, K4/K5 L=1 noise in, K1 L=8 at B={BATCH}, K1, K2, "
          f"K4/K5 at L = 1..8, B=1024; bch_sc "
          f"on integer and huge LLRs and noise: K1 L=8, K2 L=1, K4/K5 L=1 and 8); "
          f"bch_sc in-kernel Philox: u_true exact, {differ} of {BATCH} frames "
          f"differ")

    # ---- 14. the bch_sc sweep through the fused step (K5) ----
    ref = {json.loads(line)["ebn0_db"]: json.loads(line) for line in
           (ROOT / "results" / BCH_REF).read_text().splitlines()}
    bsweep = dataclasses.replace(bch, ebn0_grid=tuple(sorted(ref)))
    bch_launches = {}
    recs, wall = main_path(
        "scl_mc_counters", "bch_sc fused sweep",
        lambda: run_sweep(bsweep, frames=BCH_FRAMES, per_device_batch=BATCH,
                          seed=SWEEP_SEED, device=dev, progress=False,
                          backend="fused"), into=bch_launches)
    for rec in recs:
        r = ref[rec["ebn0_db"]]
        z = two_proportion_z(rec["frame_errors"], rec["frames"],
                             r["frame_errors"], r["frames"])
        print(f"sweep bch_sc fused: ebn0={rec['ebn0_db']} frames={rec['frames']} "
              f"frame_errors={rec['frame_errors']} fer={rec['fer']} "
              f"ci95={rec['fer_ci95']} z_vs_{BCH_REF}={z} "
              f"cw_per_s={rec['codewords_per_s']} [{card}]")
        if abs(z) >= SWEEP_Z_LIMIT:
            raise SystemExit(f"bch_sc FER at {rec['ebn0_db']} dB differs from "
                             f"{BCH_REF}: z = {z}")
    frames = sum(r["frames"] for r in recs)
    print(f"sweep bch_sc fused end to end: {frames} frames in {wall} s = "
          f"{frames / wall} cw_per_s (5 points) [{card}]")

    # ---- 15. the three routes on the same keys; each path's launches ----
    si = bsweep.ebn0_grid.index(2.0)
    keys = list(range(BCH_STEPS))
    counted = {}
    walls = {}
    for label, kernel, kw in (("fused", "scl_mc_counters", dict(backend="fused")),
                              ("torch", "scl_decode_traj", dict(backend="torch")),
                              ("hybrid", "stage_down", dict(
                                  backend="torch", big_stage_backend="pallas"))):
        step_fn = make_mc_step(bspec, 1, device=dev, **kw)
        # the fused window only checks the counts: K5's launches stay the
        # sweep's
        into = {"fused": {}, "torch": bch_launches, "hybrid": main_launches}
        outs, walls[label] = main_path(
            kernel, f"bch_sc {label} at 2.0 dB ({BCH_STEPS} x {BATCH})",
            lambda: [step_fn(SWEEP_SEED, si, k, sigma, BATCH) for k in keys],
            into=into[label])
        counted[label] = [sum(int(o[f]) for o in outs)
                          for f in ("frame_errors", "bit_errors")]
    print(f"bch_sc routes at 2.0 dB on the same keys, (frame_errors, "
          f"bit_errors): {counted}; end to end cw/s: "
          f"{ {k: BCH_STEPS * BATCH / w for k, w in walls.items()} } [{card}]")
    if not counted["torch"] == counted["hybrid"] == counted["fused"]:
        raise SystemExit("bch_sc routes count different errors")
    l8 = make_mc_step(bspec, 8, device=dev, backend="torch")
    outs, _ = main_path("scl_decode", "bch_sc --list-size 8 torch at 2.0 dB",
                        lambda: [l8(SWEEP_SEED, si, k, sigma, BATCH) for k in keys],
                        into=bch_launches)
    full = build_mc_step(bspec, 1, device=dev)
    fkeys = [step_seed(SWEEP_SEED, si, k, 0) for k in keys]
    fc, _ = main_path("scl_mc_traj", "bch_sc full-mode step",
                      lambda: [[int(t) for t in full(k, sigma, BATCH)[:2]]
                               for k in fkeys], into=bch_launches)
    if [sum(c[0] for c in fc), sum(c[1] for c in fc)] != counted["fused"]:
        raise SystemExit("bch_sc full-mode step counts differ from counters mode")
    print(f"bch_sc L=8 (K1) at 2.0 dB: frame_errors="
          f"{sum(int(o['frame_errors']) for o in outs)} of {BCH_STEPS * BATCH}; "
          f"full mode (K4) == counters mode")

    # ---- 16. times at bch_sc, B = 8192 and the preset's 2048 ----
    bch_rows = {}
    hybrid = build_scl_decoder(bspec, 1, device=dev, big_stage_backend="pallas")
    for b in (BATCH, bch.batch):
        x = torch.as_tensor(2.0 * rng.standard_normal((b, bspec.N)) + 1.0,
                            dtype=torch.float32, device=dev)
        tag = "" if b == BATCH else f"_b{b}"
        d1 = SclDecoder(bspec, 8, dev, select=True)
        d2 = SclDecoder(bspec, 1, dev, select=False)
        nq1, nq8 = len(d2.spans), len(d1.spans)
        key = step_seed(SWEEP_SEED, 98, 0, 0)
        timed = {
            "scl_decode": (lambda: d1.kernel(x), lambda: d1.plain(x),
                           bound(table_bytes(bspec, 8) + b * (4 * bspec.N + bspec.N + 5),
                                 b * element_ops(bspec, 8))),
            "scl_decode_traj": (lambda: d2.trajectory(x), lambda: d2.plain_trajectory(x),
                                bound(table_bytes(bspec, 1)
                                      + b * (4 * bspec.N + bspec.N + nq1 + 4),
                                      b * element_ops(bspec, 1, epilogue=False))),
            "scl_mc_traj": (lambda: full.trajectory(key, sigma, b),
                            lambda: full.plain_trajectory(key, sigma, b),
                            bound(table_bytes(bspec, 1)
                                  + b * (bspec.N + nq1 + 4 + bspec.N),
                                  b * (element_ops(bspec, 1, epilogue=False)
                                       + prologue_ops(bspec)))),
            "scl_mc_counters": (lambda: step.counts(key, sigma, b),
                                lambda: step.plain_counts(key, sigma, b),
                                bound(table_bytes(bspec, 1) + b * 8,
                                      b * (element_ops(bspec, 1) + prologue_ops(bspec)
                                           + 2 * bspec.K))),
        }
        # the stage kernel: the launches of one hybrid decode, replayed on
        # inputs of their shapes
        launches = stage_launch_set(bspec, 1)
        fns = [(cuda_stage.build_down_kernel(K16, i, paths, n),
                2.0 * torch.randn((paths, 16, n, b), generator=sgen, device=dev))
               for i, paths, n in launches]
        timed["stage_down"] = (
            lambda: [f(v) for f, v in fns], lambda: [f.plain(v) for f, v in fns],
            bound(sum(4 * 17 * paths * n * b for _, paths, n in launches),
                  sum(paths * n * b * stage_down_ops(K16, i)
                      for i, paths, n in launches)))
        for name, (kfn, pfn, bd) in timed.items():
            r = dict(bd, ms=time_ms(kfn, iters=10, reps=3),
                     plain_ms=time_ms(pfn, iters=1, warmup=1))
            shape = f"bch_sc L={8 if name == 'scl_decode' else 1} B={b}"
            parent = (beside_parent(name, "bch_sc", r["ms"])
                      if name != "stage_down" and b == BATCH else "")
            print(f"time: {name} {shape} ms={r['ms']}{parent} "
                  f"cw_per_s={b / r['ms'] * 1e3} "
                  f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} "
                  f"({r['bound_by']}: bytes={r['bytes']} {r['t_bytes']} ms, "
                  f"element_ops={r['ops']} {r['t_ops']} ms) [{card}]")
            if name == "stage_down" and b == BATCH:
                rows[name] = r
            elif name != "stage_down":
                keep = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                bch_rows.setdefault(name, {}).update(
                    {k + tag: v for k, v in keep.items()})
            else:
                rows[name]["ms" + tag] = r["ms"]
        hy_ms = time_ms(lambda: hybrid(x), iters=3, warmup=1)
        print(f"time: hybrid decode (big_stage_backend='pallas') bch_sc L=1 "
              f"B={b} ms={hy_ms} cw_per_s={b / hy_ms * 1e3} [{card}]")
    return bch_rows, bch_launches


def fetch_and_trace(dev, card, fused_all_rate: float, k5_rate: float) -> None:
    """Phase 24: the fetch waits for its own call; the device's busy and
    idle share of three traced sweeps."""
    from polar_tpu_torch.sim import sweep_cli
    from polar_tpu_torch.sim.harness import CounterCopies
    from polar_tpu_torch.sim.kernel_times import trace_summary

    copies = CounterCopies(2, dev)
    first = torch.tensor([3, 4], dtype=torch.int64, device=dev)
    second = torch.tensor([5, 6], dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call_n = copies.start(1, first)
    torch.cuda._sleep(SLEEP_CYCLES)
    call_n1 = copies.start(1, second + 0)
    got = call_n.counts()
    t_n = time.perf_counter() - t0
    running = not call_n1.event.query()
    got1 = call_n1.counts()
    t_n1 = time.perf_counter() - t0
    print(f"fetch: call n's counters {got} after {t_n * 1e3} ms, call n+1 "
          f"still running: {running}; call n+1's {got1} after {t_n1 * 1e3} ms "
          f"[{card}]")
    if got != (3, 4) or got1 != (5, 6) or not running:
        raise SystemExit("the fetch of call n waited for call n+1")

    paths = (
        ("ca_scl_fused", "ca_scl fused sweep (K5) at 2.0 dB",
         ["--preset", "sweep", "--backend", "fused", "--snr", "2.0",
          "--frames", str(TRACE_FRAMES), "--per-device-batch", str(BATCH)]),
        ("bch_sc_fused", "bch_sc fused sweep (K5) at 2.0 dB",
         ["--preset", "bch_sc", "--backend", "fused", "--snr", "2.0",
          "--frames", str(TRACE_FRAMES), "--per-device-batch", str(BATCH)]),
        ("mixed_scl32_k3", f"mixed_scl32 K3 route at {MIXED_EBN0} dB",
         ["--preset", "mixed_scl32", "--backend", "torch", "--big-stage",
          "pallas", "--subtree", "pallas", "--snr", str(MIXED_EBN0),
          "--frames", str(TRACE_BATCHES * MIXED_BATCH),
          "--per-device-batch", str(MIXED_BATCH)]))
    for slug, label, args in paths:
        out = ROOT / "build" / "traces" / slug
        shutil.rmtree(out, ignore_errors=True)
        sweep_cli.main(args + ["--seed", str(SWEEP_SEED), "--profile", str(out)])
        s = trace_summary(out / "trace_rank0.json")
        print(f"trace: {label}: window {s['window_us']} us, device busy "
              f"{s['busy_us']} us, busy share {s['busy_share']}, idle share "
              f"{s['idle_share']} [{card}]")
        for k in s["kernels"]:
            print(f"trace: {label}: kernel {k['name'][:80]} launches="
                  f"{k['launches']} us={k['us']}")
        for g in s["gaps"]:
            print(f"trace: {label}: idle gap {g['us']} us at {g['at_us']} us, "
                  f"host ops overlapping (us): {g['host_ops']}")
    print(f"sweep ca_scl fused, all frames over all wall time (phase 10) "
          f"{fused_all_rate} cw_per_s; K5 alone (phase 11) {k5_rate} cw_per_s; "
          f"ratio {fused_all_rate / k5_rate} [{card}]")


def knob_phases(dev, card, main_path) -> dict:
    """Phase 26: the decoder knobs through the op program on the card, the
    bfloat16 A/B at full width, and Monte-Carlo construction of the
    committed BCH and mixed codes. Returns the stage kernel's numbers of
    this phase for the kernel table."""
    from polar_tpu_torch.construction import montecarlo
    from polar_tpu_torch.models.presets import get_preset
    from polar_tpu_torch.ops import cuda_stage
    from polar_tpu_torch.ops.mc import count_errors, mc_draw
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.ops.scl import build_scl_decoder
    from polar_tpu_torch.scripts import gen_sequences
    from polar_tpu_torch.sim.channel import ebn0_to_sigma

    cpu = torch.device("cpu")
    # ---- 26(a). each knob alone through the op program, card against CPU ----
    knobs = (({"genie": True}, True), ({"fast": False}, True),
             ({"fast_r1_scl": False}, True), ({"unroll": False}, True),
             ({"f_mode": "exact"}, False), ({"pm_mode": "smooth"}, False),
             ({"llr_dtype": torch.bfloat16}, False))
    n_routes = 0
    for pname, L in (("ca_scl", 8), ("bch_sc", 1), ("bch_sc", 8)):
        spec = get_preset(pname).spec
        sigma = float(ebn0_to_sigma(EBN0_DB, spec.rate))
        _, llr = mc_draw(spec, step_seed(KNOB_SEED, 0, L, 0), sigma, KNOB_FRAMES, dev)
        _, llr_b = mc_draw(spec, step_seed(KNOB_SEED, 1, L, 0), sigma, BATCH, dev)
        big = "pallas" if any(f > 2 for f in spec.factors) else "xla"
        for kw, exact in knobs:
            if kw.get("genie") and L != 1:
                continue
            label = " ".join(f"{k}={v}" for k, v in kw.items())
            dec = build_scl_decoder(spec, L, device=dev, big_stage_backend=big, **kw)
            ref = build_scl_decoder(spec, L, device=cpu, big_stage_backend=big, **kw)
            zero_launches()
            out = dec(llr)
            torch.cuda.synchronize()
            launches = all_launches()
            minsum = "f_mode" not in kw
            program = dict(classify=kw.get("fast", True) and minsum
                           and "pm_mode" not in kw,
                           fast_r1_scl=kw.get("fast_r1_scl", True),
                           genie=kw.get("genie", False))
            want_k6 = (len(stage_launch_set(spec, L, **program))
                       if big == "pallas" and minsum else 0)
            if (launches["scl_decode"], launches["scl_decode_traj"],
                    launches["stage_down"]) != (0, 0, want_k6):
                raise SystemExit(f"{pname} L={L} {label}: launches {launches}, "
                                 f"not K1/K2 0 and K6 {want_k6}")
            x = llr.cpu()
            want = ref(x)
            agree = ((out.u.cpu() == want.u).all(dim=1)
                     & (out.payload.cpu() == want.payload).all(dim=1)
                     & (out.crc_ok.cpu() == want.crc_ok))
            differ = int((~agree).sum())
            # f_mode="exact": the reference's f cancels for small inputs, so
            # its decisions move with libm's last ulp; the card may differ
            # on as many frames as a 1-ulp change of the input flips on the
            # CPU, twice over, plus 1% of the frames
            allowed = (2 * ulp_flips(ref, x) + math.ceil(0.01 * KNOB_FRAMES)
                       if "f_mode" in kw else 0)
            diff = float((out.pm.cpu()[agree].double()
                          - want.pm[agree].double()).abs().max()) if agree.any() else 0.0
            pm_ok = (torch.equal(out.pm.cpu(), want.pm) if exact else
                     torch.allclose(out.pm.cpu()[agree], want.pm[agree],
                                    rtol=1e-5, atol=1e-4))
            if differ > allowed or not pm_ok:
                raise SystemExit(f"{pname} L={L} {label}: card != CPU (frames "
                                 f"whose u, payload or crc_ok differ {differ}, "
                                 f"allowed {allowed}; pm max abs err {diff})")
            # the decode above warmed the route; its first call at B=8192
            # also grows the caching allocator (ms against 100s of ms)
            ms = time_ms(lambda: dec(llr_b), iters=1, warmup=0)
            n_routes += 1
            print(f"knob route: {pname} L={L} {label}: route {dec.route!r}; "
                  f"card against CPU on {KNOB_FRAMES} frames at {EBN0_DB} dB "
                  f"({'bit for bit' if exact else 'u, payload, crc_ok; pm'} "
                  f"max abs err {diff}; frames differing {differ}, allowed "
                  f"{allowed}); launches K1 0, K2 0, K6 "
                  f"{launches['stage_down']}; B={BATCH} ms={ms} "
                  f"cw_per_s={BATCH / ms * 1e3} [{card}]")

    # ---- 26(b). bfloat16 at full width: ca_scl L=8, the bf16 route and K1 ----
    spec = get_preset("ca_scl").spec
    sigma = float(ebn0_to_sigma(EBN0_DB, spec.rate))
    rec16 = [json.loads(line) for line in
             (ROOT / "results" / BF16_REF).read_text().splitlines()
             if json.loads(line)["arm"] == "bfloat16"][0]
    keys = [step_seed(KNOB_SEED, 2, k, 0) for k in range(BF16_BATCHES)]

    def run(dec):
        errors, us = 0, []
        for key in keys:
            u_true, llr = mc_draw(spec, key, sigma, BATCH, dev)
            out = dec(llr)
            errors = errors + count_errors(spec, out.u, u_true)[0].sum()
            us.append(out.u)
        return int(errors), us

    bf16 = build_scl_decoder(spec, 8, device=dev, llr_dtype=torch.bfloat16)
    zero_launches()
    t = time.perf_counter()
    fe16, u16 = run(bf16)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t
    launches = all_launches()
    print(f"launches: {launches} in the bf16 A/B's bfloat16 route")
    if launches["scl_decode"] or launches["scl_decode_traj"]:
        raise SystemExit("the bfloat16 route launched K1 or K2")
    (fe32, u32), wall32 = main_path("scl_decode", "bf16 A/B, K1 (float32)",
                                    lambda: run(build_scl_decoder(spec, 8, device=dev)),
                                    into={})
    n = BF16_BATCHES * BATCH
    same = sum(int((a == b).all(dim=1).sum()) for a, b in zip(u16, u32))
    z_rec = two_proportion_z(fe16, n, rec16["frame_errors"], rec16["frames"])
    z_k1 = two_proportion_z(fe16, n, fe32, n)
    print(f"bf16 A/B: ca_scl L=8 {EBN0_DB} dB, {n} frames (mc_draw): bfloat16 "
          f"route ({bf16.route!r}) frame_errors={fe16} fer={fe16 / n}, K1 "
          f"float32 frame_errors={fe32} fer={fe32 / n}; z vs {BF16_REF} "
          f"bfloat16 arm ({rec16['frame_errors']}/{rec16['frames']}) {z_rec}, "
          f"z vs K1 {z_k1}; frames whose u equals K1's {same} of {n} "
          f"({same / n}); cw_per_s incl. mc_draw: bfloat16 route {n / wall16}, "
          f"K1 {n / wall32} [{card}]")
    if abs(z_rec) >= SWEEP_Z_LIMIT or abs(z_k1) >= SWEEP_Z_LIMIT:
        raise SystemExit(f"bf16 A/B: |z| >= {SWEEP_Z_LIMIT} ({z_rec}, {z_k1})")

    # ---- 26(c). construct_mc of the committed BCH and mixed codes ----
    k6 = {}
    frames = gen_sequences.MC_FRAMES
    for name, (factors, n_unf, snr, method) in gen_sequences.SPECS.items():
        if method != "mc":
            continue
        N = int(np.prod(factors))
        k6[name] = {}
        err, wall = main_path(
            "stage_down", f"construct_mc {name}",
            lambda: montecarlo.mc_leaf_error_rates(
                factors, snr, n_unf / N, frames=frames, batch=BATCH,
                seed=gen_sequences.MC_SEED, device=dev), into=k6[name])
        mask = montecarlo.frozen_from_rates(err, n_unf)
        committed = np.load(ROOT / "polar_tpu_torch" / "models" / "sequences"
                            / f"{name}.npy")
        order = np.argsort(err, kind="stable")
        cut = float(0.5 * (err[order[n_unf - 1]] + err[order[n_unf]]))
        off = np.nonzero(mask != committed)[0]
        z = {int(i): rate_z(float(err[i]), cut, frames) for i in off}
        far = [i for i, zi in z.items() if abs(zi) > CONSTRUCT_SD]
        print(f"construct_mc {name} {factors} at {snr} dB: {frames} frames "
              f"(batch {BATCH}, seed {gen_sequences.MC_SEED}) in {wall} s = "
              f"{frames / wall} frames_per_s; "
              f"unfrozen {N - int(mask.sum())}; leaves disagreeing with the "
              f"committed artifact {off.size}: cut {cut} ({cut * frames} errors); "
              f"(leaf, errors, frozen in the artifact, z) "
              f"{[(i, round(float(err[i]) * frames), int(committed[i]), round(z[i], 2)) for i in z]}; "
              f"beyond {CONSTRUCT_SD} sd: {far}; sd at the cut alone "
              f"{math.sqrt(cut * (1 - cut) / frames)}; K6 launches "
              f"{k6[name]['stage_down']} [{card}]")
        if N - int(mask.sum()) != n_unf or far:
            raise SystemExit(f"construct_mc {name}: wrong count or leaves beyond "
                             f"{CONSTRUCT_SD} sd of the cut: {far}")
    # the same Philox keys on the card and on the CPU
    N = 256
    sigma = float(ebn0_to_sigma(EBN0_DB, 0.5))
    llr = montecarlo.genie_llrs(N, sigma, 0, 0, CONSTRUCT_SAME_FRAMES, dev)
    u_card = montecarlo.genie_decoder((16, 16), dev)(llr).u.cpu()
    u_cpu = montecarlo.genie_decoder((16, 16), cpu)(
        montecarlo.genie_llrs(N, sigma, 0, 0, CONSTRUCT_SAME_FRAMES, cpu)).u
    differ = int((u_card != u_cpu).any(dim=1).sum())
    print(f"construct_mc bch_n256 genie decode, {CONSTRUCT_SAME_FRAMES} frames "
          f"from the same Philox keys on the card and on the CPU: {differ} "
          f"frames differ; leaf error counts {int(u_card.sum())} / "
          f"{int(u_cpu.sum())}")
    if differ > math.ceil(DIFF_LIMIT * CONSTRUCT_SAME_FRAMES):
        raise SystemExit(f"construct_mc: {differ} frames differ between card "
                         f"and CPU")

    # K6 alone at the genie program's launches (bch_n256, B=8192)
    K16 = get_preset("bch_sc").spec.kernels[0]
    launches = stage_launch_set(get_preset("bch_sc").spec, 1, classify=False,
                                genie=True)
    sgen = torch.Generator(device=dev).manual_seed(26)
    fns = [(cuda_stage.build_down_kernel(K16, i, paths, n),
            2.0 * torch.randn((paths, 16, n, BATCH), generator=sgen, device=dev))
           for i, paths, n in launches]
    r = dict(bound(sum(4 * 17 * paths * n * BATCH for _, paths, n in launches),
                   sum(paths * n * BATCH * stage_down_ops(K16, i)
                       for i, paths, n in launches)),
             ms=time_ms(lambda: [f(v) for f, v in fns], iters=3, reps=3),
             plain_ms=time_ms(lambda: [f.plain(v) for f, v in fns], 1, 1))
    print(f"time: stage_down, the {len(launches)} launches of one genie bch_n256 "
          f"decode (construct_mc), B={BATCH} ms={r['ms']} plain_ms="
          f"{r['plain_ms']} bound_ms={r['bound_ms']} ({r['bound_by']}: "
          f"bytes={r['bytes']} {r['t_bytes']} ms, element_ops={r['ops']} "
          f"{r['t_ops']} ms) [{card}]")
    return {"launches": {name: k6[name]["stage_down"] for name in k6},
            "launches_a_genie_decode": len(launches),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def golden_phase(dev, card) -> None:
    """Phase 27: the independent golden records through every route."""
    from polar_tpu_torch.ops.scl import build_scl_decoder
    from polar_tpu_torch.sim.golden import (RECORDS, load_golden,
                                            record_golden, record_path,
                                            replay_check)

    # ---- 27(a). the host codec built on this machine ----
    name = "golden_c32_subtree"
    spec, L, llrs, u_ref = load_golden(record_path(name))
    out = ROOT / "build" / "smoke_golden_rerecord.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    u = record_golden(spec, L, llrs[:8], out)
    print(f"golden codec: g++ build and re-record of {name} frames 0-7 "
          f"(L={L}) in {time.perf_counter() - t:.2f} s: "
          f"{'equal to' if np.array_equal(u, u_ref[:8]) else 'NOT equal to'} "
          f"the committed u_ref")
    if not np.array_equal(u, u_ref[:8]):
        raise SystemExit(f"the host codec built here disagrees with {name}")

    # ---- 27(b), (c). every record through every route of its row ----
    cases = [(record_path(n), label, kw, kernel) for n, rec in RECORDS.items()
             for label, kw, kernel in rec.routes]
    k3 = dict(subtree_backend="pallas", big_stage_backend="pallas")
    cases += [(ROOT / "results" / "golden_ca_scl_b256.npz", "default", {},
               "scl_decode"),
              (ROOT / "results" / "golden_mixed_scl_b128.npz", "default", {},
               "scl_decode"),
              (ROOT / "results" / "golden_mixed_scl_b128.npz", "subtree", k3,
               "scl_subtree")]
    for path, label, kw, kernel in cases:
        zero_launches()
        t = time.perf_counter()
        res = replay_check(path, device=dev, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        counts = {k: v for k, v in all_launches().items() if v}
        spec, L, llrs, _ = load_golden(path)
        dec = build_scl_decoder(spec, L, device=dev, **kw)
        x = torch.as_tensor(np.asarray(llrs, np.float32), device=dev)
        ms = time_ms(lambda: dec(x), iters=3, warmup=1)
        # at L=1 the decode is K2 and the eager scl_epilogue: K2's own share
        k2 = (f" of it scl_decode_traj_ms="
              f"{time_ms(lambda: dec.trajectory(x), iters=3, warmup=1)}"
              if kernel == "scl_decode_traj" else "")
        print(f"golden replay {path.name} ({spec.factors}, L={L}) through "
              f"{label} {kernel}: frames={res['frames']} "
              f"mismatch_frames={res['mismatch_frames']} "
              f"mismatch_bits={res['mismatch_bits']} launches={counts} "
              f"replay_ms={wall_ms} decode_ms={ms}{k2} [{card}]")
        if res["mismatch_frames"]:
            raise SystemExit(f"golden replay mismatch: {path.name} through "
                             f"{label}")
        if counts.get(kernel, 0) < 1:
            raise SystemExit(f"the {path.name} replay through {label} "
                             f"launched no {kernel}")


def _one_json_line(fn) -> dict:
    """The JSON object `fn()` prints as its one line of output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    lines = out.getvalue().splitlines()
    if len(lines) != 1:
        raise SystemExit(f"an entry point printed {len(lines)} lines, not one: "
                         f"{lines}")
    return json.loads(lines[0])


def entry_phase(card, kind, k1_ms: float, alone: dict) -> dict:
    """Phase 28: the flagship bench and the decode bench's rows on the card,
    at their defaults. `alone` maps each row's last ENTRY_ROWS field to the
    ms of its kernels alone in this run. Returns each kernel's rows for the
    kernel table."""
    from polar_tpu_torch import bench
    from polar_tpu_torch.benchmarks import decode_bench
    from polar_tpu_torch.scripts import gen_sequences

    for var in ("BENCH_BATCH", "BENCH_REPS", "BENCH_DECODER", "BENCH_DEVICE"):
        os.environ.pop(var, None)
    table = {}
    zero_launches()
    line = _one_json_line(bench.main)
    counts = {k: v for k, v in all_launches().items() if v}
    k1_rate = BATCH / k1_ms * 1e3
    ratio = line["value"] / k1_rate
    print(f"entry: polar_tpu_torch.bench {json.dumps(line)} launches={counts}; "
          f"K1 alone (phase 6) {k1_rate} cw_per_s, ratio {ratio}; before the "
          f"second Arikan redesign {FLAGSHIP_PARENT} cw_per_s, "
          f"x{line['value'] / FLAGSHIP_PARENT:.3f} [{card}]")
    if (set(line) != {"metric", "value", "unit"}
            or line["metric"] != "decoded_codewords_per_s_per_chip_n1024_scl8"
            or counts != {"scl_decode": ENTRY_REPS + 1}):
        raise SystemExit(f"the flagship bench's line or launches are wrong: "
                         f"{line} {counts}")
    if ratio > FLAGSHIP_MAX:
        raise SystemExit(f"the flagship bench reads {ratio} x K1's own rate")
    if ratio < FLAGSHIP_LOW:
        print(f"finding: the flagship bench runs at {ratio} of K1's own rate, "
              f"below {FLAGSHIP_LOW} [{card}]")
    table["scl_decode"] = [{"row": "polar_tpu_torch.bench",
                            "launches": counts["scl_decode"],
                            "codewords_per_s": line["value"],
                            "of_k1_alone": ratio}]
    for argv, per_decode, kernels in ENTRY_ROWS:
        label = " ".join(argv)
        rec = _one_json_line(lambda: decode_bench.main(list(argv)))
        want = {k: n * ENTRY_REPS for k, n in per_decode.items()}
        print(f"entry: decode_bench {label}: {json.dumps(rec)}; {kernels} alone "
              f"{alone[kernels]} ms, the row's ms over it "
              f"{rec['ms_per_decode'] / alone[kernels]} [{card}]")
        if (set(rec) != ENTRY_FIELDS or rec["launches"] != want
                or rec["card"] != card or rec["device"] != kind
                or not math.isfinite(rec["codewords_per_s"])):
            raise SystemExit(f"decode_bench {label}: wrong fields or launches "
                             f"(want {want}): {rec}")
        for k, n in rec["launches"].items():
            table.setdefault(k, []).append(
                {"row": f"decode_bench {label}", "launches": n,
                 "ms_per_decode": rec["ms_per_decode"],
                 "codewords_per_s": rec["codewords_per_s"],
                 "alone_ms": alone[kernels]})
    print(f"entry: gen_sequences SPECS (phase 26(c) builds the Monte-Carlo "
          f"rows): {gen_sequences.SPECS}")
    return table


def _records(stdout: str) -> list[dict]:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith('{"preset"')]


def _seconds(stdout: str) -> float:
    """The sweep's wall seconds, as sweep_cli prints them."""
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith('{"seconds"')][-1]["seconds"]


def multi_card(dev, card) -> None:
    """Phase 25: the `sweep` preset's fused sweep over n ranks, against
    each rank's counts recomputed here, and against one card."""
    from polar_tpu_torch import entry
    from polar_tpu_torch.models.presets import get_preset
    from polar_tpu_torch.ops import cuda_build
    from polar_tpu_torch.parallel.mesh import launch
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    from polar_tpu_torch.sim.harness import SweepState, make_mc_step

    cards = min(torch.cuda.device_count(), 4)
    if cards >= 2:
        n, world_args = cards, []
        world = f"{n} ranks over NCCL, one card each"
    else:
        n, world_args = 2, ["--dist-backend", "gloo", "--device", "cuda:0"]
        world = ("2 ranks on the one card over gloo (NCCL refuses two ranks "
                 "on one card)")
    built = [cuda_build.library_path(src).exists() for src in cuda_build.SOURCES]
    print(f"multi-card: world {world}; kernels already built for the ranks "
          f"(phase 2): {dict(zip(cuda_build.SOURCES, built))}")
    if not all(built):
        raise SystemExit("the ranks would build the kernels again")
    work = ROOT / "build" / "multi"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    state = work / "state.json"
    sweep_args = ["-m", "polar_tpu_torch.sim.sweep_cli", "--preset", "sweep",
                  "--backend", "fused", "--snr", *MULTI_SNR,
                  "--per-device-batch", str(BATCH), "--seed", str(SWEEP_SEED)]
    ranks = sweep_args + world_args + ["--state", str(state)]
    gb = BATCH * n

    # the first steps of each point, each rank's counts recomputed here
    out = launch(n, ranks + ["--frames", str(MULTI_STEPS * gb),
                             "--jsonl", str(work / "out.jsonl")], MULTI_TIMEOUT)
    recs = _records(out)
    if ([(r["n_devices"], r["global_batch"], r["frames"]) for r in recs]
            != [(n, gb, MULTI_STEPS * gb)] * len(MULTI_SNR)):
        raise SystemExit(f"multi-card records: {recs}")
    if _records((work / "out.jsonl").read_text()) != recs:
        raise SystemExit("the multi-card JSONL is not rank 0's records")
    spec = get_preset("sweep").spec
    step = make_mc_step(spec, get_preset("sweep").list_size, backend="fused",
                        device=dev)
    for si, (snr, rec) in enumerate(zip(MULTI_SNR, recs)):
        sigma = float(ebn0_to_sigma(float(snr), spec.rate))
        per_rank = []
        for r in range(n):
            outs = [step(SWEEP_SEED, si, k, sigma, BATCH, rank=r)
                    for k in range(MULTI_STEPS)]
            per_rank.append([sum(int(o[f]) for o in outs)
                             for f in ("frame_errors", "bit_errors")])
        total = [sum(c[0] for c in per_rank), sum(c[1] for c in per_rank)]
        print(f"multi-card {snr} dB, the first {MULTI_STEPS} steps: each rank's "
              f"(frame_errors, bit_errors) recomputed on one card {per_rank}, "
              f"sum {total}; the sweep counted "
              f"{[rec['frame_errors'], rec['bit_errors']]}")
        if total != [rec["frame_errors"], rec["bit_errors"]]:
            raise SystemExit("the multi-card sweep != the ranks' sum")

    # resumed to SWEEP_FRAMES a point: the n-card rate
    t = time.perf_counter()
    out = launch(n, ranks + ["--frames", str(SWEEP_FRAMES)], MULTI_TIMEOUT)
    held = time.perf_counter() - t
    recs = _records(out)
    want = -(-SWEEP_FRAMES // gb) * gb
    if [r["frames"] for r in recs] != [want] * len(MULTI_SNR):
        raise SystemExit(f"multi-card frames {[r['frames'] for r in recs]}, "
                         f"not {want}")
    added = sum(r["frames"] for r in recs) - len(MULTI_SNR) * MULTI_STEPS * gb
    rate_n = added / _seconds(out)
    saved = SweepState.load(state)
    launch(n, ranks + ["--frames", str(SWEEP_FRAMES)], MULTI_TIMEOUT)
    if SweepState.load(state) != saved:
        raise SystemExit("resuming the finished multi-card sweep changed it")
    print(f"multi-card sweep resumed: {SweepState.load(state).frames} frames, "
          f"rng_step {saved.rng_step}; a further resume added no frame")

    # the same sweep on one card, one process
    one = subprocess.run([sys.executable, *sweep_args, "--frames",
                          str(SWEEP_FRAMES)], cwd=ROOT, capture_output=True,
                         text=True, timeout=MULTI_TIMEOUT)
    if one.returncode:
        raise SystemExit(f"one-card sweep failed:\n{one.stderr[-4000:]}")
    recs1 = _records(one.stdout)
    rate_1 = sum(r["frames"] for r in recs1) / _seconds(one.stdout)
    print(f"multi-card rates ({world}): all frames over the sweep's wall time "
          f"{rate_n} cw_per_s ({added} frames; {held} s with the ranks' start); "
          f"one card {rate_1} cw_per_s; ratio {rate_n / rate_1}; steady per "
          f"point {[r['codewords_per_s'] for r in recs]} against one card "
          f"{[r['codewords_per_s'] for r in recs1]} [{card}]")
    entry.dryrun_multichip(cards)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2,
                    help="main-path seeds, each 32 batches of 8192 frames")
    ap.add_argument("--multi", action="store_true",
                    help="phases 1, 2 and 25 alone: the multi-card sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from polar_tpu_torch.construction.ga import construct_ga
    from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
    from polar_tpu_torch.models.presets import ca_scl, get_preset
    from polar_tpu_torch.ops import cuda_build, cuda_scl, cuda_stage
    from polar_tpu_torch.ops.crc import crc_append
    from polar_tpu_torch.ops.encode import encode
    from polar_tpu_torch.ops.scl import build_scl_decoder
    from polar_tpu_torch.sim.channel import channel_llrs
    from polar_tpu_torch.sim.golden import jittered_spec, load_golden
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

    # ---- 2. build: one nvcc a source and the clock build, all started together ----
    cuda_build.build_all(clock=True)
    lib = cuda_scl.load_library()
    cuda_stage.load_library()
    for src, info in cuda_build.build_info.items():
        print(f"build: {src} {info['seconds']:.2f} s -> {info['library']}")
        if cuda_build.CLOCK_FLAG in src:
            continue
        entry = "?"
        for line in info["ptxas"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else "?"
            if "registers" in line or "spill" in line:
                print(f"ptxas: {entry}: {line.strip()}")
            # every instance: the general body's and the Arikan body's
            if any(int(v) for v in re.findall(r"(\d+) bytes spill", line)):
                raise SystemExit(f"ptxas: the instance {entry} spills: "
                                 f"{line.strip()}")
    # the launch plans (ops/cuda_scl.py `launch_plan`): the Arikan body at
    # ca_scl L=8 and arikan_sc L=1, capacity 32 at (2,)*7 L=32, the general
    # body at bch_sc
    c32 = jittered_spec((2,) * 7, 56, CrcSpec(8, 0x07, 0))
    for name, spec, L in ([("ca_scl", ca_scl().spec, 8), ("arikan_sc", get_preset("arikan_sc").spec, 1),
                           ("(2,)*7", c32, 32)]
                          + [("bch_sc", get_preset("bch_sc").spec, L) for L in range(1, 9)]):
        kern = cuda_scl.SclKernels(spec, L)
        print(f"launch plans at {name} L={L} (instance, threads and codewords a block, "
              "blocks an SM by the layout and by the occupancy API, dynamic and static "
              "shared memory a block): "
              + ", ".join(f"{p.instance} {p.threads} {p.codewords} {p.blocks_per_sm} "
                          f"{kern.blocks_per_sm(k, dev)} {p.smem} {p.static}"
                          for k in cuda_scl.KERNELS for p in [kern.plan(k, dev)]))

    if args.multi:
        # ---- 25. the multi-card sweep ----
        multi_card(dev, card)
        print(f"smoke seconds: {time.perf_counter() - t_start:.1f}")
        print("chip_smoke --multi: phases 1, 2 and 25 passed")
        return 0

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
    zero_launches()
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
    launches = all_launches()
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
    ms = time_ms(lambda: dec.kernel(v), iters=20, reps=3)
    plain_ms = time_ms(lambda: dec.plain(v), iters=2, warmup=1)
    # one block per codeword: time against batch shows the waves of blocks
    for b in (1024, 2048, 4096, 16384):
        vb = v2[:b].contiguous()
        print(f"kernel sweep: B={b} ms={time_ms(lambda: dec.kernel(vb), 10)} "
              f"[{card}]")
    k1_bound = bound(BATCH * (4 * spec.N + spec.N + 5), BATCH * element_ops(spec, L))
    print(f"kernel: scl_decode ca_scl B={BATCH} ms={ms} "
          f"cw_per_s={BATCH / ms * 1e3}{beside_parent('scl_decode', 'ca_scl', ms)} "
          f"[{card}]")
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

    def main_path(kernel: str, what: str, fn, into=None):
        into = main_launches if into is None else into
        zero_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = all_launches()
        print(f"launches: {counts} in the {what} run")
        if counts[kernel] < 1:
            raise SystemExit(f"the {what} run launched no {kernel}")
        into[kernel] = counts[kernel]
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
        ms=time_ms(lambda: sc.trajectory(va), iters=20, reps=3),
        plain_ms=time_ms(lambda: sc.plain_trajectory(va), iters=2, warmup=1))
    ca_traj_ms = time_ms(lambda: ca_traj.trajectory(v), iters=10)
    nq = len(ca_traj.spans)
    ca_traj_bound = bound(table_bytes(spec, L)
                          + BATCH * (4 * spec.N + spec.N * L + nq * L + 4 * L),
                          BATCH * element_ops(spec, L, epilogue=False))
    print(f"kernel: scl_decode_traj ca_scl L={L} B={BATCH} ms={ca_traj_ms}"
          f"{beside_parent('scl_decode_traj', 'ca_scl', ca_traj_ms)} "
          f"bound_ms={ca_traj_bound['bound_ms']} ({ca_traj_bound['bound_by']}: "
          f"bytes={ca_traj_bound['bytes']} {ca_traj_bound['t_bytes']} ms, "
          f"element_ops={ca_traj_bound['ops']} {ca_traj_bound['t_ops']} ms) [{card}]")
    key = step_seed(SWEEP_SEED, 99, 0, 0)
    nq = len(full.decoder.spans)
    rows["scl_mc_traj"] = dict(
        bound(table_bytes(spec, L)
              + BATCH * (spec.N * L + nq * L + 4 * L + spec.N),
              BATCH * (element_ops(spec, L, epilogue=False) + prologue_ops(spec))),
        ms=time_ms(lambda: full.trajectory(key, sigma2, BATCH), iters=20,
                   reps=3),
        plain_ms=time_ms(lambda: full.plain_trajectory(key, sigma2, BATCH),
                         iters=2, warmup=1))
    rows["scl_mc_counters"] = dict(
        bound(table_bytes(spec, L) + BATCH * 8,
              BATCH * (element_ops(spec, L) + prologue_ops(spec) + 2 * spec.K)),
        ms=time_ms(lambda: counters.counts(key, sigma2, BATCH), iters=20,
                   reps=3),
        plain_ms=time_ms(lambda: counters.plain_counts(key, sigma2, BATCH),
                         iters=2, warmup=1))
    bch_rows, bch_launches = bch_phases(dev, card, rng, check, err, main_path,
                                        rows, main_launches)
    mixed_rows = mixed_phases(dev, card, rng, check, err, main_path, rows,
                              main_launches)

    # ---- 23. the op-kind split: K5, K1 at ca_scl and bch_sc, K1 at L=32, K3 ----
    from polar_tpu_torch.sim.kernel_times import split
    split(BATCH, dev, card)

    for name in KERNELS:
        r = rows[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err[name])
        shape = {"scl_decode_traj": "arikan_sc L=1",
                 "stage_down": "bch_sc L=1, the 105 launches of a decode",
                 "scl_subtree": "mixed_scl32 L=32, the 13 launches of a decode"
                 }.get(name, f"ca_scl L={L}")
        b = MIXED_BATCH if name == "scl_subtree" else BATCH
        parent = beside_parent(name, shape.split()[0], r["ms"])
        print(f"time: {name} {shape} B={b} ms={r['ms']}{parent} "
              f"cw_per_s={b / r['ms'] * 1e3} plain_ms={r['plain_ms']} "
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
    # ---- 24. the fetch and the trace ----
    fetch_and_trace(dev, card, fused_frames / wall_f,
                    BATCH / rows["scl_mc_counters"]["ms"] * 1e3)
    # ---- 25. the multi-card sweep ----
    multi_card(dev, card)
    # ---- 26. the decoder knobs, the bfloat16 A/B and construct_mc ----
    knob_rows = knob_phases(dev, card, main_path)
    # ---- 27. the independent golden records ----
    golden_phase(dev, card)
    # ---- 28. the entry points ----
    entry_rows = entry_phase(card, kind, rows["scl_decode"]["ms"], {
        "K5 ca_scl": rows["scl_mc_counters"]["ms"],
        "K2 arikan_sc": rows["scl_decode_traj"]["ms"],
        "K2 bch_sc": bch_rows["scl_decode_traj"]["ms"],
        "K1 bch_sc L=8": bch_rows["scl_decode"]["ms"],
        "K6 x105 bch_sc": rows["stage_down"]["ms"],
        "K3 x13 + K6 x15 mixed_scl32": (rows["scl_subtree"]["ms"]
                                        + mixed_rows["stage_down"]["ms"])})
    print("library: no single PyTorch call computes an SCL decode, the "
          "Monte-Carlo step, a depth-1 child's list decode or a "
          "trellis/tail-table marginal (library_ms null)")
    print(f"smoke seconds: {time.perf_counter() - t_start:.1f}")

    print(json.dumps({"kernels": [dict({
        "name": name,
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "launches": main_launches[name],
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": None,
    }, **({"bch_sc": dict(bch_rows[name], launches=bch_launches[name])}
          if name in bch_rows else {}),
        **({"mixed_scl32": mixed_rows[name]} if name in mixed_rows else {}),
        **({"construct_mc": knob_rows} if name == "stage_down" else {}),
        **({"entry_points": entry_rows[name]} if name in entry_rows else {}),
        **({"b2048": {k: rows[name][k] for k in ("ms_b2048", "bound_ms_b2048")}}
           if name == "scl_subtree" else {})) for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
