"""The CA-SCL decode kernels (csrc/scl_decode.cu): host tables, build,
and the wrappers.

Counterpart of polar_tpu/ops/pallas_scl.py build_pallas_scl_kernel. One
source holds five kernels built from one decode body (one thread block
per codeword):

    scl_decode       K1, select mode: LLRs -> DecodeResult in-kernel;
    scl_decode_traj  K2, LLRs -> the genealogy (traj_bit, traj_perm, pm),
                     finished by ops/scl.py `scl_epilogue`;
    scl_mc_traj      K4, the fused Monte-Carlo step's full mode (ops/mc.py);
    scl_mc_counters  K5, its counters mode (ops/mc.py);
    scl_subtree      K3, one depth-1 child of a code on its own
                     (`SubtreeKernel`, the subtree route of ops/scl.py).

Each has instances for specs with l > 2 kernels (eBCH, mixed) and for list
capacities 8 and 32. `launch_plan` chooses the instance, its threads and
codewords a block and its shared memory, once a (spec, list size, kernel,
SM limits), by a rule of the spec's shape; the library only launches what
the plan names (`SclKernels.launch`). Arikan specs (2x2 kernels only) at P <= 8 go to the Arikan capacity-8 body
(`arikan8`: 64 or 128 threads a codeword by `fast_threads`, decisions and
trajectory bits packed in words, stage 1 read through the channel row,
`fast_smem_bytes`), every other spec and the subtree kernel to
the general body: at P <= 8 one warp a codeword, two where shared memory
would hold too few one-warp blocks (`general_threads`; the stage tables
copied to shared memory), and for K2, K4 and K5 at list size 1 two
codewords a warp, a half-warp each, where an SM then holds more codewords
(`general_codewords`); at capacity 32 256 threads (`general_smem_bytes`).
This module builds the op table from the fast-SSCL program
(ops/program.py) and the per-stage tables,
compiles the source with nvcc at first use into a shared library with a
plain C interface under build/ at the repository root (git-ignored;
ops/cuda_build.py), and loads it with ctypes.

`SclDecoder.kernel(llrs)` is the decode wrapper: a CUDA tensor goes to the
kernel (or the call raises), a CPU tensor to the plain PyTorch version
(ops/scl.py). `LAUNCHES[name]` counts each kernel's launches (calls of
`SclKernels.launch`), `CHUNKS[name]` the device launches they made: K5
at two codewords a block runs a long batch as a run of chunks of whole
rounds (`launch_chunks`). `INSTANCES[instance]` counts the device
launches by the instance the plan named.

`clock_build()` sends the launches inside it to the op-kind clock build
of the same source (`-DSCL_CLOCK`: cycles by op kind, and by stage in
the general body, of the first blocks, `read_clock`). Only
sim/kernel_times.py --split and chip_smoke.py's split phase load it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops import cuda_build
from polar_tpu_torch.ops.cuda_stage import MAX_L, BigKernel, big_kernel
from polar_tpu_torch.ops.program import build_program, staged_inverse_kernels
from polar_tpu_torch.ops.schedule import build_schedule
from polar_tpu_torch.ops.scl import (DecodeResult, build_plain_scl_decoder,
                                     build_plain_subtree, check_supported,
                                     scl_epilogue, trajectory_spans)
from polar_tpu_torch.utils.spans import span

SOURCE = cuda_build.CSRC / "scl_decode.cu"

# kernel name -> its index in scl_launch
KERNELS = {"scl_decode": 0, "scl_decode_traj": 1, "scl_mc_traj": 2,
           "scl_mc_counters": 3, "scl_subtree": 4}
LAUNCHES = {name: 0 for name in KERNELS}
CHUNKS = {name: 0 for name in KERNELS}
INSTANCES: dict[str, int] = {}

_KIND = {"DOWN_FRESH": 0, "DOWN_DYN": 1, "UP": 2, "R0": 3, "REP": 4,
         "R1": 5, "SPC": 6, "LEAF": 7}
_LEAF_FROZEN = 8
C32_THREADS = 256         # the general body's threads a codeword at capacity 32
_MAX_STAGES = 17
# static shared memory of the Arikan capacity-8 body (`Fast` in the source)
FAST_STATIC_BYTES = 944
# its registers a thread at the launch bounds, and its threads a codeword
FAST_REGISTERS = 64
FAST_THREADS = (64, 128)
# static shared memory of the general body's list capacities 8 (a
# codeword's) and 32 (`Small<8>`, `Small<32>` with their fork tables
# `ForkTable<CAP>`)
SMALL8_STATIC_BYTES = 1296
SMALL32_STATIC_BYTES = 10944
# registers a thread of the general body's instances at their launch
# bounds: capacity 8 (kBig8Registers), capacity 32 (2 blocks of 256)
BIG8_REGISTERS = 128
C32_REGISTERS = 128
SMEM_UNIT = 128               # a block's shared memory is given in these units


class SmLimits(NamedTuple):
    """An SM's limits, which the launch plan reads: its shared memory and
    what the runtime keeps of it a block, its registers and resident
    blocks, the most shared memory a block may use (bytes), and the
    device's SMs."""
    shared: int
    reserved: int
    registers: int
    blocks: int
    block_optin: int
    sms: int


# an H100 SXM's; on the card `device_limits` reads the device's own
H100 = SmLimits(shared=228 * 1024, reserved=1024, registers=65536, blocks=32,
                block_optin=232448, sms=132)

# Rounds a device launch of K5 (`scl_mc_counters`) takes at most where a
# block decodes two codewords; a round is the codewords every SM holds at
# once. A long launch lets its blocks drift apart; chunks of whole rounds,
# back to back, start each round's blocks together again. bch_sc's
# `_big_t32_cw2` at B = 32768 (H100 80GB HBM3, 700 W; kernel_times
# --chunks): one launch 7.192 ms, chunks of 1 round (4,224) 6.012, of 2
# 6.326, of 4 6.665. The one-codeword Arikan `_t128` (ca_scl, B = 8192)
# lost 0.8-1.0% in chunks (4.055 ms against 4.086-4.095), so it keeps one
# launch.
K5_CHUNK_ROUNDS = 1


class LaunchPlan(NamedTuple):
    """How a decode kernel launches for one (spec, list size, kernel): the
    instance (its `__global__` name in the source), threads and codewords a
    block, dynamic (`smem`) and static shared memory a block, the blocks
    an SM holds by the layout, and the codewords a device launch takes at
    most (`chunk`; 0: the whole batch in one)."""
    instance: str
    threads: int
    codewords: int
    smem: int
    static: int
    blocks_per_sm: int
    chunk: int


@functools.lru_cache(maxsize=1024)
def launch_plan(spec: CodeSpec, list_size: int, kernel: str,
                limits: SmLimits = H100) -> LaunchPlan:
    """The one choice of instance, threads, codewords and shared memory
    for `kernel` on (spec, list_size) at an SM's `limits`: the Arikan
    capacity-8 body where `arikan8` (`_t64` / `_t128` by `fast_threads`),
    else the general body (`_big` for l > 2 kernels; `_c32` at capacity
    32, `_t32_cw2` at two codewords a warp by `general_codewords`, else
    `_t32` / `_t64` by `general_threads`). Raises ValueError where the
    block's shared memory exceeds what a block may use. K5 at two
    codewords a block launches in chunks of K5_CHUNK_ROUNDS rounds
    (`launch_chunks`); every other plan a batch at once."""
    P = int(list_size)
    if arikan8(spec, P, kernel):
        T, cw = fast_threads(spec, P, kernel, limits), 1
        instance, smem, static = (f"{kernel}_t{T}", fast_smem_bytes(spec, P, kernel),
                                  FAST_STATIC_BYTES)
        blocks = fast_blocks_per_sm(spec, P, kernel, limits)
    else:
        big = kernel != "scl_subtree" and any(f > 2 for f in spec.factors)
        cw = general_codewords(spec, P, kernel, limits)
        T = cw * general_threads(spec, P, kernel, limits)
        width = "_c32" if P > 8 else "_t32_cw2" if cw == 2 else f"_t{T}"
        instance = kernel + ("_big" if big else "") + width
        smem = general_smem_bytes(spec, P, kernel, limits)
        static = general_static_bytes(spec, P, kernel, limits)
        blocks = general_blocks_per_sm(spec, P, kernel, limits)
    chunk = (K5_CHUNK_ROUNDS * blocks * limits.sms * cw
             if kernel == "scl_mc_counters" and cw == 2 else 0)
    plan = LaunchPlan(instance, T, cw, smem, static, blocks, chunk)
    if plan.smem + plan.static > limits.block_optin:
        raise ValueError(
            f"decode state of N={spec.N}, L={P}: {plan.smem} B exceeds the "
            f"{limits.block_optin} B of shared memory a block may use; decode "
            "it with build_scl_decoder(..., subtree_backend='pallas', "
            "big_stage_backend='pallas'), one subtree-kernel launch a depth-1 "
            "child")
    return plan


def launch_chunks(batch: int, chunk: int) -> list[tuple[int, int]]:
    """The device launches of a batch of `batch` codewords at a plan's
    `chunk`: (first codeword b0, codewords) in order, `chunk` each but the
    last; one launch where `chunk` is 0 or holds the batch."""
    batch = int(batch)
    if chunk <= 0 or batch <= chunk:
        return [(0, batch)]
    return [(b0, min(chunk, batch - b0)) for b0 in range(0, batch, chunk)]


def arikan8(spec: CodeSpec, list_size: int, kernel: str = "scl_decode") -> bool:
    """Whether `kernel` decodes (spec, list_size) with the Arikan
    capacity-8 body: every kernel but scl_subtree, for specs of 2x2
    kernels only at list sizes <= 8."""
    return (kernel != "scl_subtree" and all(f == 2 for f in spec.factors)
            and int(list_size) <= 8)


# States a lane of the decode body's syndrome trellis at most (the
# source's kTrellisMaxR): `big_down` takes cuda_stage.trellis_lanes(S,
# P * n, threads, BODY_TRELLIS_MAX_R) lanes a position.
BODY_TRELLIS_MAX_R = 8


def body_table_lanes(bk: BigKernel, i: int, elements: int, threads: int) -> int:
    """Lanes G that share a position's tail table of input i in the
    decode body's `big_down`, at `elements` = P * n positions and `threads`
    a codeword (16 at two codewords a warp): 16 where the walk takes the
    quad tables (bit i of `bk.quads`), else 1, doubled while under the
    threads and the walk and while twice as many still fit the threads."""
    walk = int(bk.walk[i])
    G = 16 if (int(bk.quads) >> i) & 1 else 1
    while G < threads and G < walk and elements * G * 2 <= threads:
        G *= 2
    return G


def general_threads(spec: CodeSpec, list_size: int, kernel: str,
                    limits: SmLimits = H100) -> int:
    """Threads a codeword of the general body: 16 where it decodes two
    codewords a warp (`general_codewords`), else at capacity 32 256; at
    capacity 8 one warp, or two where the one-warp blocks an SM's shared
    memory holds bring fewer warps than its registers allow at
    BIG8_REGISTERS a thread (decode kernels) or fewer than 3/4 of them
    (the Monte-Carlo kernels, which gained from the second warp only
    there)."""
    if general_codewords(spec, list_size, kernel, limits) == 2:
        return 16
    return _one_codeword_threads(spec, list_size, kernel, limits)


def _one_codeword_threads(spec: CodeSpec, list_size: int, kernel: str,
                          limits: SmLimits = H100) -> int:
    if int(list_size) > 8:
        return C32_THREADS
    blocks = limits.shared // (_copy_bytes(spec) + _state_bytes(spec, list_size, kernel)
                               + SMALL8_STATIC_BYTES + limits.reserved)
    quarters = 3 if kernel in ("scl_mc_traj", "scl_mc_counters") else 4
    return 64 if 4 * blocks * 32 * BIG8_REGISTERS < quarters * limits.registers else 32


# the kernels the general body runs two codewords a warp at list size 1
CW2_KERNELS = ("scl_decode_traj", "scl_mc_traj", "scl_mc_counters")


def general_codewords(spec: CodeSpec, list_size: int, kernel: str,
                      limits: SmLimits = H100) -> int:
    """Codewords a block of the general body: two, a half-warp each, for
    K2, K4 and K5 at list size 1 where an SM then holds more codewords
    (blocks by its registers, shared memory and count) than at one
    codeword a block; else one (at L >= 2 the forks need the whole
    warp)."""
    if (int(list_size) != 1 or kernel not in CW2_KERNELS
            or arikan8(spec, list_size, kernel)):
        return 1
    T = _one_codeword_threads(spec, 1, kernel, limits)
    copy, state = _copy_bytes(spec), _state_bytes(spec, 1, kernel)

    def per_sm(threads, block):
        return min(limits.blocks, limits.registers // (threads * BIG8_REGISTERS),
                   limits.shared // (block + limits.reserved))

    one = per_sm(T, copy + state + SMALL8_STATIC_BYTES)
    two = 2 * per_sm(32, copy + 2 * -(-state // 16) * 16 + 2 * SMALL8_STATIC_BYTES)
    return 2 if two > one else 1


@functools.lru_cache(maxsize=1024)
def stage1_view(spec: CodeSpec, list_size: int) -> bool:
    """Whether the Arikan capacity-8 body reads stage 1 through the channel
    row instead of storing it (SclArgs.view1): at least two stages, and no
    node op (R0, REP, R1, SPC, LEAF) at depth 1 of the op program, so only
    the stage-2 DOWN ops read stage 1."""
    program = build_program(spec, scl=(int(list_size) > 1))
    return len(spec.factors) >= 2 and all(
        op.level != 1 for op in program.ops
        if op.kind not in ("DOWN_FRESH", "DOWN_DYN", "UP"))


@functools.lru_cache(maxsize=1024)
def fast_smem_bytes(spec: CodeSpec, list_size: int, kernel: str) -> int:
    """Dynamic shared memory of the Arikan capacity-8 body (the source's
    `fast_layout`): LLR buffers P*(N-1) f32, or P*(N/2 - 1) under
    `stage1_view` (at least 2N bytes in the Monte-Carlo kernels: the
    prologue's scratch), the channel LLRs N f32 (Monte-Carlo kernels),
    decision words (two children of ceil(P*n_s/32) words a stage),
    trajectory rows (P rows of ceil(N/32) words), 8-byte path maps (3 a
    stage, 8-aligned), span perms and suffix indices (Q*P bytes each, then
    4-aligned), u_true as ceil(N/32) words (Monte-Carlo kernels)."""
    N, P, m = spec.N, int(list_size), len(spec.factors)
    mc = kernel in ("scl_mc_traj", "scl_mc_counters")
    Q = len(trajectory_spans(spec, P))
    off = 4 * P * ((N >> 1 if stage1_view(spec, P) else N) - 1)
    if mc:
        off = max(off, 2 * N) + 4 * N
    off += sum(8 * -(-P * (N >> s) // 32) for s in range(1, m + 1))
    off += 4 * P * -(-N // 32)
    off = -(-off // 8) * 8
    off = -(-(off + 24 * m + 2 * Q * P) // 4) * 4
    return off + (4 * -(-N // 32) if mc else 0)


def fast_threads(spec: CodeSpec, list_size: int, kernel: str,
                 limits: SmLimits = H100) -> int:
    """Threads a codeword of the Arikan capacity-8 body: 128 while the
    registers (FAST_REGISTERS a thread) cap the 128-thread blocks an SM,
    64 where its shared memory would hold more of them than the registers
    allow."""
    block = fast_smem_bytes(spec, list_size, kernel) + FAST_STATIC_BYTES + limits.reserved
    blocks = limits.shared // block
    return 64 if blocks * 128 * FAST_REGISTERS > limits.registers else 128


def fast_blocks_per_sm(spec: CodeSpec, list_size: int, kernel: str,
                       limits: SmLimits = H100) -> int:
    """Blocks of the Arikan capacity-8 instance for (spec, list_size,
    kernel) an SM holds, by its layout: the least of the SM's blocks, its
    registers at the launch bounds and its shared memory, which a block is
    given in units of SMEM_UNIT bytes."""
    T = fast_threads(spec, list_size, kernel, limits)
    smem = fast_smem_bytes(spec, list_size, kernel) + FAST_STATIC_BYTES
    block = -(-smem // SMEM_UNIT) * SMEM_UNIT + limits.reserved
    return min(limits.blocks, limits.registers // FAST_REGISTERS // T,
               limits.shared // block)


def leader_warp(slots, warps: int) -> int:
    """The warp of an Arikan capacity-8 block that runs its leader's part
    (the source's `leader_warp`), from the warp slots its `warps` warps got
    (`slots[w]`; slot s issues from sub-partition s % 4): the one on
    sub-partition (s0 + ((s0 >> 2) & (warps - 1))) % 4, s0 the least slot,
    else warp 0."""
    s0 = min(slots[:warps])
    want = (s0 + ((s0 >> 2) & (warps - 1))) & 3
    return next((w for w in range(warps) if slots[w] & 3 == want), 0)


def _copy_bytes(spec: CodeSpec) -> int:
    """The m + 1 stage tables a capacity-8 block copies (16-aligned, the
    source's `stage_copy_bytes`)."""
    return -(-(len(spec.factors) + 1) * ctypes.sizeof(StageTab) // 16) * 16


def _state_bytes(spec: CodeSpec, list_size: int, kernel: str) -> int:
    """One codeword's decode state (the source's `codeword_state_bytes`):
    the LLR buffers, decision bytes, trajectory bits N*P, span perms and
    suffix indices (Q*P bytes each), the path maps, the channel LLRs and
    u_true (5N, Monte-Carlo kernels) and the net map (P, scl_subtree)."""
    P = int(list_size)
    _, n_lam, n_dec, n_maps = stage_tables(spec, P)
    Q = len(trajectory_spans(spec, P))
    return (4 * n_lam + n_dec + spec.N * P + 2 * Q * P + n_maps
            + (5 * spec.N if kernel in ("scl_mc_traj", "scl_mc_counters") else 0)
            + (P if kernel == "scl_subtree" else 0))


def general_smem_bytes(spec: CodeSpec, list_size: int, kernel: str,
                       limits: SmLimits = H100) -> int:
    """Dynamic shared memory a block of the general body (the source's
    `layout_smem`): at capacity 8 the stage tables, then each codeword's
    state (`_state_bytes`; at two codewords a block each 16-aligned); at
    capacity 32 the state alone."""
    state = _state_bytes(spec, list_size, kernel)
    if int(list_size) > 8:
        return state
    if general_codewords(spec, list_size, kernel, limits) == 2:
        return _copy_bytes(spec) + 2 * -(-state // 16) * 16
    return _copy_bytes(spec) + state


def general_static_bytes(spec: CodeSpec, list_size: int, kernel: str,
                         limits: SmLimits = H100) -> int:
    """Static shared memory a block of the general body: a `Small<8>` a
    codeword at capacity 8, `Small<32>` at capacity 32."""
    if int(list_size) > 8:
        return SMALL32_STATIC_BYTES
    return general_codewords(spec, list_size, kernel, limits) * SMALL8_STATIC_BYTES


def general_blocks_per_sm(spec: CodeSpec, list_size: int, kernel: str,
                          limits: SmLimits = H100) -> int:
    """Blocks of the general body's instance for (spec, list_size, kernel)
    an SM holds, by its layout: the least of the SM's blocks, its registers
    at the launch bounds (BIG8_REGISTERS or C32_REGISTERS a thread; a block
    is at least a warp) and its shared memory (dynamic, static and what the
    runtime keeps a block)."""
    T = max(32, general_threads(spec, list_size, kernel, limits))
    regs = C32_REGISTERS if int(list_size) > 8 else BIG8_REGISTERS
    block = (general_smem_bytes(spec, list_size, kernel, limits)
             + general_static_bytes(spec, list_size, kernel, limits) + limits.reserved)
    return min(limits.blocks, limits.registers // regs // T, limits.shared // block)


def max_maps(list_size: int) -> int | None:
    """Bytes of path maps the kernels hold (the source's
    `kMapsPerThread32`): 8 a thread of 256 at capacity 32 (list sizes
    9..32); None at capacity 8, where a thread permutes whole maps."""
    return 8 * C32_THREADS if int(list_size) > 8 else None


# the op-kind clock build's slots, in the source's `ClockSlot` order; the
# last is a count, not cycles: the R1/SPC fork rounds the blocks ran
ROUNDS_SLOT = "R1/SPC rounds"
CLOCK_SLOTS = ("setup", "prologue", "DOWN", "UP", "R0", "REP sums",
               "REP fork", "R1/SPC select", "R1/SPC chain", "R1/SPC decide",
               "apply_perm", "inverse", "l>2 last", "l>2 trellis",
               "l>2 table", "epilogue", ROUNDS_SLOT)
# the stage keys of each slot (the source's kClkStages): the general body's
# op level, the last key holding the deeper stages; key 0 the set-up,
# prologue and epilogue
CLOCK_STAGES = 4

_libs: dict = {}          # clock build? -> loaded library
_instances: dict = {}     # clock build? -> {instance name: index}
# (clock build?, device index, instance index) -> the dynamic shared
# memory the instance may take there (cudaFuncSetAttribute)
_smem_set: dict = {}
_clock = False            # whether launches go to the clock build


class StageTab(ctypes.Structure):
    """One stage's table; mirrors `StageTab` in the source."""
    _fields_ = [("n", ctypes.c_int), ("loff", ctypes.c_int),
                ("doff", ctypes.c_int), ("mbase", ctypes.c_int),
                ("arikan_below", ctypes.c_int),
                ("icol", ctypes.c_ushort * MAX_L), ("k", BigKernel)]


class SclArgs(ctypes.Structure):
    """The kernels' argument block; mirrors `SclArgs` in the source."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "llr", "noise", "ops", "qrow", "pidx", "gmask", "st", "u", "pm", "ok",
        "traj_bit", "traj_perm", "u_true", "counters", "pm_in", "netp",
        "xblk")]
        + [(name, ctypes.c_uint) for name in ("offmask", "seed0", "seed1")]
        + [("sigma", ctypes.c_float)]
        + [(name, ctypes.c_int) for name in (
            "n_ops", "N", "m", "P", "Q", "K", "W", "B", "n_lam", "n_dec",
            "n_maps", "big", "view1", "b0")])


_POINTERS = {name for name, kind in SclArgs._fields_ if kind is ctypes.c_void_p}


def load_library(clock: bool | None = None) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library
    (the op-kind clock build if `clock`; None: the one launches go to);
    cuda_build.build_info["scl_decode.cu"] holds the build seconds and
    nvcc's ptxas report."""
    clock = _clock if clock is None else bool(clock)
    if clock in _libs:
        return _libs[clock]
    lib = ctypes.CDLL(str(cuda_build.build("scl_decode.cu", clock)))
    ci, args = ctypes.c_int, ctypes.POINTER(SclArgs)
    for name, argtypes, restype in (
            ("scl_launch", [ci, ci, ci, ci, args, ci, ctypes.c_void_p], ci),
            ("scl_instance_count", [], ci),
            ("scl_instance_name", [ci], ctypes.c_char_p),
            ("scl_smem_bytes", [ci, args], ctypes.c_size_t),
            ("scl_static_smem_bytes", [ci], ci),
            ("scl_set_smem", [ci, ci], ci),
            ("scl_device_limits", [ctypes.POINTER(ci)], ci),
            ("scl_blocks_per_sm", [ci, args], ci),
            ("scl_args_bytes", [], ci),
            ("scl_stage_tab_bytes", [], ci)):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    for name, struct in (("scl_args_bytes", SclArgs),
                         ("scl_stage_tab_bytes", StageTab)):
        if getattr(lib, name)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {getattr(lib, name)()} B"
                               f" in the library, {ctypes.sizeof(struct)} B here")
    if clock:
        lib.scl_clock_slots.restype = ci
        lib.scl_clock_stages.restype = ci
        lib.scl_clock_reset.restype = ci
        lib.scl_clock_read.argtypes = [ctypes.c_void_p]
        lib.scl_clock_read.restype = ci
        if (lib.scl_clock_slots(), lib.scl_clock_stages()) != (
                len(CLOCK_SLOTS), CLOCK_STAGES):
            raise RuntimeError(f"{lib.scl_clock_slots()} clock slots and "
                               f"{lib.scl_clock_stages()} stage keys in the "
                               f"library, {len(CLOCK_SLOTS)} and "
                               f"{CLOCK_STAGES} here")
    _libs[clock] = lib
    _instances[clock] = {lib.scl_instance_name(i).decode(): i
                         for i in range(lib.scl_instance_count())}
    return lib


def instance_index(instance: str) -> int:
    """The index of a named instance in the table of the library that
    launches go to."""
    load_library()
    return _instances[_clock][instance]


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> SmLimits:
    """The SM limits of CUDA device `index`, read from it once."""
    out = (ctypes.c_int * len(SmLimits._fields))()
    with torch.cuda.device(index):
        err = load_library().scl_device_limits(out)
    if err != 0:
        raise RuntimeError(f"scl_device_limits failed: CUDA error {err}")
    return SmLimits(*out)


@contextlib.contextmanager
def clock_build():
    """Launches inside go to the op-kind clock build, its clock set to 0
    on entry; yields the library."""
    global _clock
    lib = load_library(True)
    if lib.scl_clock_reset() != 0:
        raise RuntimeError("scl_clock_reset failed")
    saved, _clock = _clock, True
    try:
        yield lib
    finally:
        _clock = saved


def read_clock(lib: ctypes.CDLL) -> dict:
    """{slot: cycles summed over the measured blocks and every stage,
    "blocks": count, "stages": {stage key: {slot: cycles}} for the keys and
    slots that counted anything} of an instrumented library since its last
    reset (synchronises)."""
    slots = len(CLOCK_SLOTS)
    out = (ctypes.c_ulonglong * (CLOCK_STAGES * slots + 1))()
    torch.cuda.synchronize()
    if lib.scl_clock_read(ctypes.addressof(out)) != 0:
        raise RuntimeError("scl_clock_read failed")
    cells = np.array(out[:-1], np.int64).reshape(CLOCK_STAGES, slots)
    clk = dict(zip(CLOCK_SLOTS, (int(v) for v in cells.sum(0))))
    clk["blocks"] = int(out[-1])
    clk["stages"] = {k: {s: int(c) for s, c in zip(CLOCK_SLOTS, row) if c}
                     for k, row in enumerate(cells) if row.any()}
    return clk


def stage_tables(spec: CodeSpec, P: int):
    """(StageTab array [m + 1], n_lam, n_dec, n_maps): per stage s its
    block n_s, the offsets of its LLR buffer (P*n_s floats), its l_s
    decision children (P*n_s bytes each) and its 1 + l_s path maps (P
    bytes each), whether the kernels below it are all 2x2, the columns of
    its kernel's inverse and its kernel's tables (ops/cuda_stage.py). At
    capacity 32 the maps, with the subtree kernel's net map (P bytes
    more), must fit `max_maps(P)`."""
    m = len(spec.factors)
    if m + 1 > _MAX_STAGES:
        raise ValueError(f"{m} stages exceed the kernel's {_MAX_STAGES - 1}")
    ns = spec.block_sizes
    inv = staged_inverse_kernels(spec)
    tabs = (StageTab * (m + 1))()
    lam = dec = maps = 0
    for s in range(m + 1):
        t = tabs[s]
        t.n = ns[s]
        t.arikan_below = int(all(f == 2 for f in spec.factors[s:]))
        if s == 0:
            continue
        l = spec.factors[s - 1]
        t.loff, t.doff, t.mbase = lam, dec, maps
        lam += P * ns[s]
        dec += l * P * ns[s]
        maps += (1 + l) * P
        ki = inv[s - 1].astype(np.int64)
        for k in range(l):
            t.icol[k] = int((ki[:, k] << np.arange(l)).sum())
        t.k = big_kernel(spec.kernels[s - 1])
    limit = max_maps(P)
    if limit is not None and maps + P > limit:
        raise ValueError(f"{maps} + {P} bytes of path maps exceed the "
                         f"kernel's {limit}")
    return tabs, lam, dec, maps


def build_tables(spec: CodeSpec, list_size: int) -> dict:
    """Host tables of the kernels, numpy:

    ops  [n_ops, 4] int32: kind, level, t0, child (the digit of t0 that
         names the buffer an op writes, or reads for DOWN_DYN: for a DOWN
         op, the kernel input i it computes);
    qrow [N] int16: trajectory span of each u row;
    pidx [N] int16: payload index of each row (-1 frozen; < K data, >= K
         CRC);
    gmask [K] int32: CRC generator row k as a bit mask over CRC bits;
    st   [m + 1] StageTab bytes (`stage_tables`), uint8;
    offmask, Q, K, W, n_lam, n_dec, n_maps, big, view1: CRC offset mask,
    span count, info bits, CRC width, buffer sizes, whether a kernel is
    l > 2, and whether the Arikan capacity-8 body reads stage 1 through
    the channel row (`stage1_view`).
    """
    check_supported(spec, list_size)
    P = int(list_size)
    digits = build_schedule(spec).digits
    frozen = spec.frozen.astype(bool)
    program = build_program(spec, scl=(P > 1))
    ops = np.zeros((len(program.ops), 4), np.int32)
    qrow = np.zeros(spec.N, np.int16)
    q = 0
    for i, op in enumerate(program.ops):
        kind = _KIND[op.kind]
        if op.kind == "UP":
            child = digits[op.t0, op.level - 2]
        else:
            child = digits[op.t0, op.level - 1]
        if op.kind == "LEAF" and frozen[op.t0]:
            kind = _LEAF_FROZEN
        ops[i] = (kind, op.level, op.t0, child)
        if kind >= _KIND["R0"]:
            n = spec.block_sizes[op.level]
            qrow[op.t0:op.t0 + n] = q
            q += 1
    pidx = np.full(spec.N, -1, np.int16)
    pidx[spec.info_positions] = np.arange(spec.n_payload_slots)
    W = spec.n_crc
    gmask = np.zeros(max(spec.K, 1), np.int64)
    offmask = 0
    if W:
        if W > 32:
            raise ValueError(f"CRC width {W} > 32")
        weights = 1 << np.arange(W, dtype=np.int64)
        gmask[:spec.K] = spec.crc.generator_matrix(spec.K).astype(np.int64) @ weights
        offmask = int(spec.crc.offset_bits(spec.K).astype(np.int64) @ weights)
    tabs, n_lam, n_dec, n_maps = stage_tables(spec, P)
    return {"ops": ops, "qrow": qrow, "pidx": pidx,
            "gmask": gmask.astype(np.uint32).view(np.int32),
            "st": np.frombuffer(bytes(tabs), np.uint8).copy(),
            "offmask": offmask, "Q": q, "K": spec.K, "W": W,
            "n_lam": n_lam, "n_dec": n_dec, "n_maps": n_maps,
            "big": int(any(f > 2 for f in spec.factors)),
            "view1": int(stage1_view(spec, P))}


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


class SclKernels:
    """The four kernels for one (spec, list size): device tables (built at
    the first launch) and `launch`, which checks nothing about the caller's
    tensors (the wrappers do) and counts the launch."""

    def __init__(self, spec: CodeSpec, list_size: int):
        check_supported(spec, list_size)
        self.spec = spec
        self.P = int(list_size)
        self.tables: dict | None = None
        self._dev_tables: dict = {}
        self._plans: dict = {}

    def device_tables(self, device: torch.device) -> dict:
        key = str(device)
        if key not in self._dev_tables:
            # the host build (once an instance) and the upload (once a
            # device); a cached call opens no span
            with span("scl.tables"):
                if self.tables is None:
                    self.tables = build_tables(self.spec, self.P)
                t = dict(self.tables, positions=self.spec.info_positions)
                self._dev_tables[key] = {
                    name: torch.as_tensor(t[name], device=device).contiguous()
                    for name in ("ops", "qrow", "pidx", "gmask", "st",
                                 "positions")}
        return self._dev_tables[key]

    def _args(self, batch: int, device: torch.device, **fields) -> SclArgs:
        dt = self.device_tables(device)
        t = self.tables
        fields = {k: _ptr(v) if k in _POINTERS else v
                  for k, v in fields.items()}
        return SclArgs(ops=_ptr(dt["ops"]), qrow=_ptr(dt["qrow"]),
                       pidx=_ptr(dt["pidx"]), gmask=_ptr(dt["gmask"]),
                       st=_ptr(dt["st"]), offmask=t["offmask"],
                       n_ops=int(t["ops"].shape[0]), N=self.spec.N,
                       m=len(self.spec.factors), P=self.P, Q=t["Q"], K=t["K"],
                       W=t["W"], B=int(batch), n_lam=t["n_lam"],
                       n_dec=t["n_dec"], n_maps=t["n_maps"], big=t["big"],
                       view1=t["view1"], **fields)

    def plan(self, name: str, device: torch.device) -> LaunchPlan:
        """The launch plan of kernel `name` on `device` (its own SM limits)."""
        return launch_plan(self.spec, self.P, name, device_limits(_device_index(device)))

    def smem_bytes(self, name: str, device: torch.device) -> tuple[int, int]:
        """(dynamic, static) shared memory a block of kernel `name` takes."""
        plan = self.plan(name, device)
        return plan.smem, plan.static

    def block_threads(self, name: str, device: torch.device) -> int:
        """Threads a block of kernel `name`."""
        return self.plan(name, device).threads

    def block_codewords(self, name: str, device: torch.device) -> int:
        """Codewords a block of kernel `name` decodes."""
        return self.plan(name, device).codewords

    def blocks_per_sm(self, name: str, device: torch.device) -> int:
        """Blocks of kernel `name` an SM holds at once (the occupancy API)."""
        _, index = self._ready(name, device)
        with torch.cuda.device(device):
            return load_library().scl_blocks_per_sm(
                index, ctypes.byref(self._args(1, device)))

    def _ready(self, name: str, device: torch.device) -> tuple[LaunchPlan, int]:
        """(plan, instance index) of kernel `name` on `device`, its instance
        let take the plan's shared memory there (once a device, and again
        only for a plan that needs more)."""
        dev = _device_index(device)
        key = (name, dev, _clock)
        if key not in self._plans:
            plan = launch_plan(self.spec, self.P, name, device_limits(dev))
            index = instance_index(plan.instance)
            where = (_clock, dev, index)
            if _smem_set.get(where, -1) < plan.smem:
                with torch.cuda.device(dev):
                    err = load_library().scl_set_smem(index, plan.smem)
                if err != 0:
                    raise RuntimeError(f"{plan.instance}: cudaFuncSetAttribute "
                                       f"failed: CUDA error {err}")
                _smem_set[where] = plan.smem
            self._plans[key] = plan, index
        return self._plans[key]

    def launch(self, name: str, batch: int, device: torch.device,
               chunk: int | None = None, **fields) -> None:
        """Launch kernel `name` over `batch` codewords on the device's
        current stream, as its launch plan says: one device launch a chunk
        of `launch_chunks`, back to back (`chunk` in place of the plan's,
        for measurement). `fields` are the SclArgs entries of this kernel:
        tensors for the pointers, numbers for the scalars."""
        plan, index = self._ready(name, device)
        args = self._args(batch, device, **fields)
        parts = launch_chunks(batch, plan.chunk if chunk is None else chunk)
        lib = load_library()
        # the launch acts on the current device: make it the tensors' device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for b0, count in parts:
                args.b0 = b0
                err = lib.scl_launch(index, KERNELS[name], plan.threads, plan.codewords,
                                     ctypes.byref(args), count, stream)
                if err != 0:
                    raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
        CHUNKS[name] += len(parts)
        INSTANCES[plan.instance] = INSTANCES.get(plan.instance, 0) + len(parts)


def check_llrs(llrs: torch.Tensor, N: int) -> None:
    """What the decode kernels take: contiguous float32 [B >= 1, N]."""
    if llrs.dtype != torch.float32:
        raise TypeError(f"llrs must be float32, got {llrs.dtype}")
    if llrs.ndim != 2 or llrs.shape[1] != N or llrs.shape[0] < 1:
        raise ValueError(f"llrs must be [B, {N}], got {tuple(llrs.shape)}")
    if not llrs.is_contiguous():
        raise ValueError("llrs must be contiguous")


def trajectory_outputs(spec: CodeSpec, P: int, n_spans: int, batch: int,
                       device, mc: bool = False) -> dict:
    """Output tensors of the trajectory kernels, [B, ...]-major as they
    write them; n_spans = len(trajectory_spans(spec, P)), which the
    callers keep (rebuilding the program on every launch costs ms of host
    time, more than a short kernel)."""
    out = {"traj_bit": torch.empty((batch, spec.N, P), dtype=torch.int8,
                                   device=device),
           "traj_perm": torch.empty((batch, n_spans, P),
                                    dtype=torch.uint8, device=device),
           "pm": torch.empty((batch, P), dtype=torch.float32, device=device)}
    if mc:
        out["u_true"] = torch.empty((batch, spec.N), dtype=torch.int8,
                                    device=device)
    return out


def trajectory_layout(out: dict):
    """The kernels' [B, ...] outputs in the plain version's layout:
    (traj_bit [N, P, B] int8, traj_perm [Q, P, B] int64, pm [P, B])."""
    return (out["traj_bit"].permute(1, 2, 0).contiguous(),
            out["traj_perm"].permute(1, 2, 0).to(torch.int64),
            out["pm"].T.contiguous())


class SclDecoder:
    """decode(llrs [B, N]) -> DecodeResult on `device`; see `kernel`.

    select (default: list_size > 1, as build_pallas_scl_decoder): the
    decode finishes in-kernel (scl_decode); otherwise scl_decode_traj
    emits the genealogy and `scl_epilogue` finishes it."""

    route = "decode kernels"

    def __init__(self, spec: CodeSpec, list_size: int,
                 device: torch.device = torch.device("cuda"),
                 select: bool | None = None):
        self.spec = spec
        self.P = int(list_size)
        self.device = torch.device(device)
        self.select = self.P > 1 if select is None else bool(select)
        self.plain = build_plain_scl_decoder(spec, self.P)
        self.kernels = SclKernels(spec, self.P)

    @functools.cached_property
    def plain_trajectory(self):
        """The plain version of scl_decode_traj (built at first use)."""
        return build_plain_scl_decoder(self.spec, self.P, trajectory=True)

    @functools.cached_property
    def spans(self) -> list[tuple[int, int]]:
        return trajectory_spans(self.spec, self.P)

    def __call__(self, llrs) -> DecodeResult:
        with span("scl.decode"):
            llrs = torch.as_tensor(llrs, dtype=torch.float32,
                                   device=self.device)
            return self.kernel(llrs)

    def kernel(self, llrs: torch.Tensor) -> DecodeResult:
        """The wrapper: a CUDA tensor is decoded by the kernels, a CPU
        tensor by the plain PyTorch version."""
        if _on_cpu(llrs):
            return self.plain(llrs)
        if self.select:
            return self._select(llrs)
        return self.epilogue(*self._trajectory(llrs))

    def trajectory(self, llrs: torch.Tensor):
        """(traj_bit [N, P, B] int8, traj_perm [Q, P, B] int64, pm [P, B]):
        scl_decode_traj for a CUDA tensor, the plain version for a CPU one."""
        if _on_cpu(llrs):
            return self.plain_trajectory(llrs)
        return self._trajectory(llrs)

    def epilogue(self, traj_bit, traj_perm, pm) -> DecodeResult:
        entries = [(t0, n, traj_perm[q]) for q, (t0, n) in enumerate(self.spans)]
        return scl_epilogue(self.spec, self.P, entries, traj_bit, pm)

    def _select(self, llrs: torch.Tensor) -> DecodeResult:
        spec = self.spec
        check_llrs(llrs, spec.N)
        B = llrs.shape[0]
        u = torch.empty((B, spec.N), dtype=torch.int8, device=llrs.device)
        pm = torch.empty(B, dtype=torch.float32, device=llrs.device)
        ok = torch.empty(B, dtype=torch.bool, device=llrs.device)
        self.kernels.launch("scl_decode", B, llrs.device, llr=llrs, u=u,
                            pm=pm, ok=ok)
        positions = self.kernels.device_tables(llrs.device)["positions"]
        return DecodeResult(u=u, payload=u[:, positions], crc_ok=ok, pm=pm)

    def _trajectory(self, llrs: torch.Tensor):
        check_llrs(llrs, self.spec.N)
        B = llrs.shape[0]
        out = trajectory_outputs(self.spec, self.P, len(self.spans), B,
                                 llrs.device)
        self.kernels.launch("scl_decode_traj", B, llrs.device, llr=llrs, **out)
        return trajectory_layout(out)


class SubtreeKernel:
    """core_sub(lam1 [P, N1, B] float32, pm [P, B] float32) -> (bits
    [N1, P, B] int8, perms [Q, P, B] int64, netp [P, B] int64, x [P, N1, B]
    int8, pm' [P, B] float32) for one depth-1 child `sub_spec`
    (ops/program.subtree_spec): `build_plain_subtree`'s contract, run by the
    subtree kernel scl_subtree (K3) for a CUDA tensor (or the call raises)
    and by the plain version for a CPU one. `spans` are the children's
    trajectory spans (t0 relative to the child)."""

    def __init__(self, sub_spec: CodeSpec, list_size: int):
        self.spec = sub_spec
        self.P = int(list_size)
        self.kernels = SclKernels(sub_spec, self.P)
        self.spans = trajectory_spans(sub_spec, self.P)

    @functools.cached_property
    def plain(self):
        return build_plain_subtree(self.spec, self.P)

    def __call__(self, lam1: torch.Tensor, pm: torch.Tensor):
        if _on_cpu(lam1):
            return self.plain(lam1, pm)
        return self.kernel(lam1, pm)

    def kernel(self, lam1: torch.Tensor, pm: torch.Tensor):
        P, N = self.P, self.spec.N
        if lam1.dtype != torch.float32 or pm.dtype != torch.float32:
            raise TypeError(f"lam1 and pm must be float32, got {lam1.dtype}, "
                            f"{pm.dtype}")
        if lam1.ndim != 3 or tuple(lam1.shape[:2]) != (P, N) or lam1.shape[2] < 1:
            raise ValueError(f"lam1 must be [{P}, {N}, B], got {tuple(lam1.shape)}")
        B = lam1.shape[2]
        if tuple(pm.shape) != (P, B) or pm.device != lam1.device:
            raise ValueError(f"pm must be [{P}, {B}] on {lam1.device}, got "
                             f"{tuple(pm.shape)} on {pm.device}")
        dev = lam1.device
        out = trajectory_outputs(self.spec, P, len(self.spans), B, dev)
        netp = torch.empty((B, P), dtype=torch.uint8, device=dev)
        xblk = torch.empty((B, P, N), dtype=torch.int8, device=dev)
        self.kernels.launch("scl_subtree", B, dev,
                            llr=lam1.permute(2, 0, 1).contiguous(),
                            pm_in=pm.T.contiguous(), netp=netp, xblk=xblk, **out)
        bits, perms, pm_out = trajectory_layout(out)
        return (bits, perms, netp.T.to(torch.int64),
                xblk.permute(1, 2, 0).contiguous(), pm_out)


def _device_index(device) -> int:
    """The index of a CUDA device (the current one for a bare "cuda")."""
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False
