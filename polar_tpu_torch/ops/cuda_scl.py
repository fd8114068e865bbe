"""The CA-SCL decode kernel (csrc/scl_decode.cu): host tables, build,
and the wrapper.

Counterpart of polar_tpu/ops/pallas_scl.py build_pallas_scl_decoder in
select mode. The kernel decodes one codeword per thread block; this
module builds its op table from the fast-SSCL program (ops/program.py),
compiles the source with nvcc at first use into a shared library with a
plain C interface under build/ at the repository root (git-ignored,
keyed by a hash of the source), and loads it with ctypes.

`SclDecoder.kernel(llrs)` is the wrapper: a CUDA tensor goes to the
kernel (or the call raises), a CPU tensor to the plain PyTorch version
(ops/scl.py). `LAUNCHES["scl_decode"]` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
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
                                     check_supported)

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "scl_decode.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

LAUNCHES = {"scl_decode": 0}

_KIND = {"DOWN_FRESH": 0, "DOWN_DYN": 1, "UP": 2, "R0": 3, "REP": 4,
         "R1": 5, "SPC": 6, "LEAF": 7}
_LEAF_FROZEN = 8
_THREADS = 256

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA decode kernel is built "
                           "on a machine with the CUDA toolkit")
    return path


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library.
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.scl_decode_launch.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, vp,
                                      ctypes.c_uint, ci, ci, ci, ci, ci, ci, ci,
                                      vp]
    lib.scl_decode_launch.restype = ci
    lib.scl_decode_smem_bytes.argtypes = [ci, ci, ci, ci]
    lib.scl_decode_smem_bytes.restype = ctypes.c_size_t
    lib.scl_decode_max_smem_bytes.argtypes = []
    lib.scl_decode_max_smem_bytes.restype = ci
    _lib = lib
    return lib


def build_tables(spec: CodeSpec, list_size: int) -> dict:
    """Host tables of the kernel, numpy:

    ops  [n_ops, 4] int32: kind, level, t0, child (the digit of t0 that
         names the buffer an op writes, or reads for DOWN_DYN);
    qrow [N] int16: trajectory span of each u row;
    pidx [N] int16: payload index of each row (-1 frozen);
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


class SclDecoder:
    """decode(llrs [B, N]) -> DecodeResult on `device`; see `kernel`."""

    def __init__(self, spec: CodeSpec, list_size: int,
                 device: torch.device = torch.device("cuda")):
        self.spec = spec
        self.P = int(list_size)
        self.device = torch.device(device)
        self.plain = build_plain_scl_decoder(spec, self.P)
        self.tables: dict | None = None     # built at the first launch
        self._dev_tables: dict = {}

    def __call__(self, llrs) -> DecodeResult:
        llrs = torch.as_tensor(llrs, dtype=torch.float32, device=self.device)
        return self.kernel(llrs)

    def kernel(self, llrs: torch.Tensor) -> DecodeResult:
        """The wrapper: a CUDA tensor is decoded by the kernel, a CPU tensor
        by the plain PyTorch version."""
        if llrs.device.type == "cpu":
            return self.plain(llrs)
        if llrs.device.type != "cuda":
            raise ValueError(f"unsupported device {llrs.device}")
        return self._launch(llrs)

    def _device_tables(self, device: torch.device) -> dict:
        if self.tables is None:
            self.tables = build_tables(self.spec, self.P)
        key = str(device)
        if key not in self._dev_tables:
            t = dict(self.tables, positions=self.spec.info_positions)
            self._dev_tables[key] = {
                name: torch.as_tensor(t[name], device=device).contiguous()
                for name in ("ops", "qrow", "pidx", "gmask", "positions")}
        return self._dev_tables[key]

    def _launch(self, llrs: torch.Tensor) -> DecodeResult:
        spec, P = self.spec, self.P
        if llrs.dtype != torch.float32:
            raise TypeError(f"llrs must be float32, got {llrs.dtype}")
        if llrs.ndim != 2 or llrs.shape[1] != spec.N or llrs.shape[0] < 1:
            raise ValueError(f"llrs must be [B, {spec.N}], got "
                             f"{tuple(llrs.shape)}")
        if not llrs.is_contiguous():
            raise ValueError("llrs must be contiguous")
        lib = load_library()
        dt = self._device_tables(llrs.device)   # fills self.tables
        t = self.tables
        m = len(spec.factors)
        smem = lib.scl_decode_smem_bytes(spec.N, m, P, t["Q"])
        with torch.cuda.device(llrs.device):
            limit = lib.scl_decode_max_smem_bytes()
            if smem + 1024 > limit:
                raise ValueError(f"decode state {smem} B exceeds the "
                                 f"{limit} B of shared memory a block may use")
            B = llrs.shape[0]
            u = torch.empty((B, spec.N), dtype=torch.int8, device=llrs.device)
            pm = torch.empty(B, dtype=torch.float32, device=llrs.device)
            ok = torch.empty(B, dtype=torch.bool, device=llrs.device)
            stream = torch.cuda.current_stream(llrs.device).cuda_stream
            err = lib.scl_decode_launch(
                llrs.data_ptr(), u.data_ptr(), pm.data_ptr(), ok.data_ptr(),
                dt["ops"].data_ptr(), int(t["ops"].shape[0]),
                dt["qrow"].data_ptr(), dt["pidx"].data_ptr(),
                dt["gmask"].data_ptr(), t["offmask"], spec.N, m, P, t["Q"],
                t["K"], t["W"], B, stream)
        if err != 0:
            raise RuntimeError(f"scl_decode launch failed: CUDA error {err}")
        LAUNCHES["scl_decode"] += 1
        payload = u[:, dt["positions"]]
        return DecodeResult(u=u, payload=payload, crc_ok=ok, pm=pm)
