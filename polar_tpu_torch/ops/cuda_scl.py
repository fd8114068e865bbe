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
capacities 8 and 32, chosen at launch by a rule of the spec's shape:
Arikan specs (2x2 kernels only) at P <= 8 go to the Arikan capacity-8 body
(`arikan8`: 128 threads a codeword, decisions and trajectory bits packed
in words, `fast_smem_bytes`), every other spec and the subtree kernel to
the general body (256 threads). This module builds the op table
from the fast-SSCL program (ops/program.py) and the per-stage tables,
compiles the source with nvcc at first use into a shared library with a
plain C interface under build/ at the repository root (git-ignored;
ops/cuda_build.py), and loads it with ctypes.

`SclDecoder.kernel(llrs)` is the decode wrapper: a CUDA tensor goes to the
kernel (or the call raises), a CPU tensor to the plain PyTorch version
(ops/scl.py). `LAUNCHES[name]` counts each kernel's launches.

`clock_build()` sends the launches inside it to the op-kind clock build
of the same source (`-DSCL_CLOCK`: cycles by op kind of the first blocks,
`read_clock`). Only sim/kernel_times.py --split and chip_smoke.py's split
phase load it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

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

SOURCE = cuda_build.CSRC / "scl_decode.cu"

# kernel name -> its index in scl_launch
KERNELS = {"scl_decode": 0, "scl_decode_traj": 1, "scl_mc_traj": 2,
           "scl_mc_counters": 3, "scl_subtree": 4}
LAUNCHES = {name: 0 for name in KERNELS}

_KIND = {"DOWN_FRESH": 0, "DOWN_DYN": 1, "UP": 2, "R0": 3, "REP": 4,
         "R1": 5, "SPC": 6, "LEAF": 7}
_LEAF_FROZEN = 8
_THREADS = 256            # the general body's threads a codeword
_MAX_STAGES = 17
# static shared memory of the Arikan capacity-8 body (`Fast` in the source)
FAST_STATIC_BYTES = 1232

# `arikan8`, `fast_smem_bytes` and FAST_STATIC_BYTES model the source's
# rule and layout on the host (the launches take the library's own
# figures); tests/test_torch_cuda.py holds them to the library.


def arikan8(spec: CodeSpec, list_size: int, kernel: str = "scl_decode") -> bool:
    """Whether `kernel` decodes (spec, list_size) with the Arikan
    capacity-8 body: every kernel but scl_subtree, for specs of 2x2
    kernels only at list sizes <= 8 (the source's `arikan8`)."""
    return (kernel != "scl_subtree" and all(f == 2 for f in spec.factors)
            and int(list_size) <= 8)


def fast_smem_bytes(spec: CodeSpec, list_size: int, kernel: str) -> int:
    """Dynamic shared memory of the Arikan capacity-8 body (the source's
    `fast_layout`): LLR buffers P*(N-1) f32, the channel LLRs N f32
    (Monte-Carlo kernels), decision words (two children of ceil(P*n_s/32)
    words a stage), trajectory rows (P rows of ceil(N/32) words), 8-byte
    path maps (3 a stage, 8-aligned), span perms and suffix indices (Q*P
    bytes each), u_true N bytes (Monte-Carlo kernels)."""
    N, P, m = spec.N, int(list_size), len(spec.factors)
    mc = kernel in ("scl_mc_traj", "scl_mc_counters")
    Q = len(trajectory_spans(spec, P))
    off = 4 * P * (N - 1) + (4 * N if mc else 0)
    off += sum(8 * -(-P * (N >> s) // 32) for s in range(1, m + 1))
    off += 4 * P * -(-N // 32)
    off = -(-off // 8) * 8
    return off + 24 * m + 2 * Q * P + (N if mc else 0)


def max_maps(list_size: int) -> int:
    """Bytes of path maps the kernels hold (the source's `maps_per_thread`):
    the instances of list capacity 8 take 2 a thread, those of capacity 32
    (list sizes 9..32) 8 a thread."""
    return (2 if int(list_size) <= 8 else 8) * _THREADS


# the op-kind clock build's slots, in the source's `ClockSlot` order
CLOCK_SLOTS = ("setup", "prologue", "DOWN", "UP", "R0", "REP sums",
               "REP fork", "R1/SPC select", "R1/SPC chain", "R1/SPC decide",
               "apply_perm", "inverse", "l>2 last", "l>2 trellis",
               "l>2 table", "epilogue")

_libs: dict = {}          # clock build? -> loaded library
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
            "n_maps", "big")])


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
    ci = ctypes.c_int
    lib.scl_launch.argtypes = [ci, ctypes.POINTER(SclArgs), ctypes.c_void_p]
    lib.scl_launch.restype = ci
    lib.scl_smem_bytes.argtypes = [ci, ctypes.POINTER(SclArgs)]
    lib.scl_smem_bytes.restype = ctypes.c_size_t
    lib.scl_args_bytes.argtypes = []
    lib.scl_args_bytes.restype = ci
    lib.scl_decode_max_smem_bytes.argtypes = []
    lib.scl_decode_max_smem_bytes.restype = ci
    lib.scl_static_smem_bytes.argtypes = [ci, ci, ci]
    lib.scl_static_smem_bytes.restype = ci
    lib.scl_block_threads.argtypes = [ci, ci, ci]
    lib.scl_block_threads.restype = ci
    lib.scl_blocks_per_sm.argtypes = [ci, ctypes.POINTER(SclArgs)]
    lib.scl_blocks_per_sm.restype = ci
    lib.scl_stage_tab_bytes.argtypes = []
    lib.scl_stage_tab_bytes.restype = ci
    for name, struct in (("scl_args_bytes", SclArgs),
                         ("scl_stage_tab_bytes", StageTab)):
        if getattr(lib, name)() != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {getattr(lib, name)()} B"
                               f" in the library, {ctypes.sizeof(struct)} B here")
    if clock:
        lib.scl_clock_slots.restype = ci
        lib.scl_clock_reset.restype = ci
        lib.scl_clock_read.argtypes = [ctypes.c_void_p]
        lib.scl_clock_read.restype = ci
        if lib.scl_clock_slots() != len(CLOCK_SLOTS):
            raise RuntimeError(f"{lib.scl_clock_slots()} clock slots in the "
                               f"library, {len(CLOCK_SLOTS)} here")
    _libs[clock] = lib
    return lib


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
    """{slot: cycles summed over the measured blocks, "blocks": count} of
    an instrumented library since its last reset (synchronises)."""
    out = (ctypes.c_ulonglong * (len(CLOCK_SLOTS) + 1))()
    torch.cuda.synchronize()
    if lib.scl_clock_read(ctypes.addressof(out)) != 0:
        raise RuntimeError("scl_clock_read failed")
    return dict(zip(CLOCK_SLOTS + ("blocks",), (int(v) for v in out)))


def stage_tables(spec: CodeSpec, P: int):
    """(StageTab array [m + 1], n_lam, n_dec, n_maps): per stage s its
    block n_s, the offsets of its LLR buffer (P*n_s floats), its l_s
    decision children (P*n_s bytes each) and its 1 + l_s path maps (P
    bytes each), whether the kernels below it are all 2x2, the columns of
    its kernel's inverse and its kernel's tables (ops/cuda_stage.py). The
    maps, with the subtree kernel's net map (P bytes more), must fit
    `max_maps(P)`."""
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
    if maps + P > max_maps(P):
        raise ValueError(f"{maps} + {P} bytes of path maps exceed the "
                         f"kernel's {max_maps(P)}")
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
    offmask, Q, K, W, n_lam, n_dec, n_maps, big: CRC offset mask, span
    count, info bits, CRC width, buffer sizes, whether a kernel is l > 2.
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
            "big": int(any(f > 2 for f in spec.factors))}


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

    def device_tables(self, device: torch.device) -> dict:
        if self.tables is None:
            self.tables = build_tables(self.spec, self.P)
        key = str(device)
        if key not in self._dev_tables:
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
                       **fields)

    def smem_bytes(self, name: str, device: torch.device,
                   args: SclArgs | None = None) -> tuple[int, int]:
        """(dynamic, static) shared memory a block of kernel `name` takes,
        from the library."""
        lib = load_library()
        args = self._args(1, device) if args is None else args
        return (lib.scl_smem_bytes(KERNELS[name], ctypes.byref(args)),
                lib.scl_static_smem_bytes(KERNELS[name], self.P, args.big))

    def blocks_per_sm(self, name: str, device: torch.device) -> int:
        """Blocks of kernel `name` an SM holds at once (the occupancy API)."""
        with torch.cuda.device(device):
            return load_library().scl_blocks_per_sm(
                KERNELS[name], ctypes.byref(self._args(1, device)))

    def launch(self, name: str, batch: int, device: torch.device,
               **fields) -> None:
        """Launch kernel `name` over `batch` codewords on the device's
        current stream. `fields` are the SclArgs entries of this kernel:
        tensors for the pointers, numbers for the scalars."""
        lib = load_library()
        args = self._args(batch, device, **fields)
        smem, static = self.smem_bytes(name, device, args)
        # the launch (and its cudaFuncSetAttribute) acts on the current
        # device: make it the tensors' device
        with torch.cuda.device(device):
            limit = lib.scl_decode_max_smem_bytes()
            if smem + static > limit:
                raise ValueError(
                    f"decode state of N={self.spec.N}, L={self.P}: {smem} B "
                    f"exceeds the {limit} B of shared memory a block may "
                    "use; decode it "
                    "with build_scl_decoder(..., subtree_backend='pallas', "
                    "big_stage_backend='pallas'), one subtree-kernel launch "
                    "a depth-1 child")
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.scl_launch(KERNELS[name], ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1


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
        llrs = torch.as_tensor(llrs, dtype=torch.float32, device=self.device)
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


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False
