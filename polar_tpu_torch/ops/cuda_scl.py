"""The CA-SCL decode kernels (csrc/scl_decode.cu): host tables, build,
and the wrappers.

Counterpart of polar_tpu/ops/pallas_scl.py build_pallas_scl_kernel. One
source holds four kernels built from one decode body (one thread block
per codeword):

    scl_decode       K1, select mode: LLRs -> DecodeResult in-kernel;
    scl_decode_traj  K2, LLRs -> the genealogy (traj_bit, traj_perm, pm),
                     finished by ops/scl.py `scl_epilogue`;
    scl_mc_traj      K4, the fused Monte-Carlo step's full mode (ops/mc.py);
    scl_mc_counters  K5, its counters mode (ops/mc.py).

This module builds the op table from the fast-SSCL program
(ops/program.py), compiles the source with nvcc at first use into a shared
library with a plain C interface under build/ at the repository root
(git-ignored, keyed by a hash of the source), and loads it with ctypes.

`SclDecoder.kernel(llrs)` is the decode wrapper: a CUDA tensor goes to the
kernel (or the call raises), a CPU tensor to the plain PyTorch version
(ops/scl.py). `LAUNCHES[name]` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops.program import build_program
from polar_tpu_torch.ops.schedule import build_schedule
from polar_tpu_torch.ops.scl import (DecodeResult, build_plain_scl_decoder,
                                     check_supported, scl_epilogue,
                                     trajectory_spans)

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "scl_decode.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

# kernel name -> its index in scl_launch
KERNELS = {"scl_decode": 0, "scl_decode_traj": 1, "scl_mc_traj": 2,
           "scl_mc_counters": 3}
LAUNCHES = {name: 0 for name in KERNELS}

_KIND = {"DOWN_FRESH": 0, "DOWN_DYN": 1, "UP": 2, "R0": 3, "REP": 4,
         "R1": 5, "SPC": 6, "LEAF": 7}
_LEAF_FROZEN = 8
_THREADS = 256

_lib = None
build_info: dict = {}


class SclArgs(ctypes.Structure):
    """The kernels' argument block; mirrors `SclArgs` in the source."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "llr", "noise", "ops", "qrow", "pidx", "gmask", "u", "pm", "ok",
        "traj_bit", "traj_perm", "u_true", "counters")]
        + [(name, ctypes.c_uint) for name in ("offmask", "seed0", "seed1")]
        + [("sigma", ctypes.c_float)]
        + [(name, ctypes.c_int) for name in (
            "n_ops", "N", "m", "P", "Q", "K", "W", "B")])


_POINTERS = {name for name, kind in SclArgs._fields_ if kind is ctypes.c_void_p}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA decode kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library.
    Fills `build_info` with the build seconds and nvcc's ptxas report."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libscl_decode_{key}.so"
    log = out.with_suffix(".log")
    t = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    build_info["seconds"] = time.perf_counter() - t
    build_info["ptxas"] = log.read_text() if log.exists() else ""
    build_info["library"] = str(out)
    lib = ctypes.CDLL(str(out))
    ci = ctypes.c_int
    lib.scl_launch.argtypes = [ci, ctypes.POINTER(SclArgs), ctypes.c_void_p]
    lib.scl_launch.restype = ci
    lib.scl_smem_bytes.argtypes = [ci, ci, ci, ci, ci]
    lib.scl_smem_bytes.restype = ctypes.c_size_t
    lib.scl_args_bytes.argtypes = []
    lib.scl_args_bytes.restype = ci
    lib.scl_decode_max_smem_bytes.argtypes = []
    lib.scl_decode_max_smem_bytes.restype = ci
    if lib.scl_args_bytes() != ctypes.sizeof(SclArgs):
        raise RuntimeError(f"SclArgs is {lib.scl_args_bytes()} B in the "
                           f"library, {ctypes.sizeof(SclArgs)} B here")
    _lib = lib
    return lib


def build_tables(spec: CodeSpec, list_size: int) -> dict:
    """Host tables of the kernels, numpy:

    ops  [n_ops, 4] int32: kind, level, t0, child (the digit of t0 that
         names the buffer an op writes, or reads for DOWN_DYN);
    qrow [N] int16: trajectory span of each u row;
    pidx [N] int16: payload index of each row (-1 frozen; < K data, >= K
         CRC);
    gmask [K] int32: CRC generator row k as a bit mask over CRC bits;
    offmask, Q, K, W: CRC offset mask, span count, info bits, CRC width.
    """
    check_supported(spec, list_size)
    P = int(list_size)
    m = len(spec.factors)
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
    if 3 * m * P > 2 * _THREADS:
        raise ValueError(f"3*m*P = {3 * m * P} path maps exceed the kernel's "
                         f"{2 * _THREADS}")
    return {"ops": ops, "qrow": qrow, "pidx": pidx,
            "gmask": gmask.astype(np.uint32).view(np.int32),
            "offmask": offmask, "Q": q, "K": spec.K, "W": W}


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
                for name in ("ops", "qrow", "pidx", "gmask", "positions")}
        return self._dev_tables[key]

    def launch(self, name: str, batch: int, device: torch.device,
               **fields) -> None:
        """Launch kernel `name` over `batch` codewords on the device's
        current stream. `fields` are the SclArgs entries of this kernel:
        tensors for the pointers, numbers for the scalars."""
        lib = load_library()
        dt = self.device_tables(device)
        t = self.tables
        spec, P = self.spec, self.P
        m = len(spec.factors)
        smem = lib.scl_smem_bytes(KERNELS[name], spec.N, m, P, t["Q"])
        fields = {k: _ptr(v) if k in _POINTERS else v
                  for k, v in fields.items()}
        args = SclArgs(ops=_ptr(dt["ops"]), qrow=_ptr(dt["qrow"]),
                       pidx=_ptr(dt["pidx"]), gmask=_ptr(dt["gmask"]),
                       offmask=t["offmask"], n_ops=int(t["ops"].shape[0]),
                       N=spec.N, m=m, P=P, Q=t["Q"], K=t["K"], W=t["W"],
                       B=int(batch), **fields)
        # the launch (and its cudaFuncSetAttribute) acts on the current
        # device: make it the tensors' device
        with torch.cuda.device(device):
            limit = lib.scl_decode_max_smem_bytes()
            if smem + 1024 > limit:
                raise ValueError(f"decode state {smem} B exceeds the {limit} "
                                 "B of shared memory a block may use")
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


def trajectory_outputs(spec: CodeSpec, P: int, batch: int, device,
                       mc: bool = False) -> dict:
    """Output tensors of the trajectory kernels, [B, ...]-major as they
    write them."""
    out = {"traj_bit": torch.empty((batch, spec.N, P), dtype=torch.int8,
                                   device=device),
           "traj_perm": torch.empty((batch, len(trajectory_spans(spec, P)), P),
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
        out = trajectory_outputs(self.spec, self.P, B, llrs.device)
        self.kernels.launch("scl_decode_traj", B, llrs.device, llr=llrs, **out)
        return trajectory_layout(out)


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False
