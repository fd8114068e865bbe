"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Each source under csrc/ compiles with its own nvcc at first use into
build/ at the repository root (git-ignored), keyed by a hash of the
source, the headers of csrc/ and the flags. `build_all` starts one nvcc
for every source at once, so a fresh checkout builds in the time of the
slowest one. The op-kind clock build of scl_decode.cu (`clock=True`,
`-DSCL_CLOCK`) is a library of its own, built only where it is asked for.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]
CLOCK_FLAG = "-DSCL_CLOCK"
SOURCES = ("scl_decode.cu", "stage_down.cu")

# build label (source name, + CLOCK_FLAG for the clock build) ->
# {"seconds", "ptxas", "library"} of its last build or load
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _flags(clock: bool) -> list[str]:
    return NVCC_FLAGS + ([CLOCK_FLAG] if clock else [])


def _label(name: str, clock: bool) -> str:
    return f"{name} {CLOCK_FLAG}" if clock else name


def library_path(name: str, clock: bool = False) -> pathlib.Path:
    src = (CSRC / name).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(_flags(clock)).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{pathlib.Path(name).stem}_{key}.so"


def _start(name: str, clock: bool):
    """Start nvcc for `name` unless its library exists; returns the
    process or None."""
    out = library_path(name, clock)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    return subprocess.Popen([_nvcc(), *_flags(clock), "-o", str(tmp),
                             str(CSRC / name)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(name: str, proc, t0: float, clock: bool) -> pathlib.Path:
    out = library_path(name, clock)
    log = out.with_suffix(".log")
    label = _label(name, clock)
    if proc is None and build_info.get(label, {}).get("library") == str(out):
        return out          # built or loaded before: keep that record
    if proc is not None:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {label} failed ({proc.returncode}):\n"
                               f"{stderr}")
        log.write_text(stdout + stderr)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        os.replace(tmp, out)
    build_info[label] = {"seconds": time.perf_counter() - t0,
                         "ptxas": log.read_text() if log.exists() else "",
                         "library": str(out)}
    return out


def build(name: str, clock: bool = False) -> pathlib.Path:
    """The library of source `name` (its op-kind clock build if `clock`),
    built if missing."""
    t0 = time.perf_counter()
    return _finish(name, _start(name, clock), t0, clock)


def build_all(clock: bool = False) -> dict:
    """Build every source (and, if `clock`, the clock build of
    scl_decode.cu), one nvcc each, all started together."""
    t0 = time.perf_counter()
    jobs = [(name, False) for name in SOURCES] + ([("scl_decode.cu", True)]
                                                 if clock else [])
    procs = [(name, c, _start(name, c)) for name, c in jobs]
    return {_label(name, c): _finish(name, proc, t0, c)
            for name, c, proc in procs}
