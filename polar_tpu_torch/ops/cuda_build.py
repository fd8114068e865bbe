"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Each source under csrc/ compiles with its own nvcc at first use into
build/ at the repository root (git-ignored), keyed by a hash of the
source, the headers of csrc/ and the flags. `build_all` starts one nvcc
for every source at once, so a fresh checkout builds in the time of the
slowest one.
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
SOURCES = ("scl_decode.cu", "stage_down.cu")

# source name -> {"seconds", "ptxas", "library"} of its last build or load
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / name).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{pathlib.Path(name).stem}_{key}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns the
    process or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / name)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(name: str, proc, t0: float) -> pathlib.Path:
    out = library_path(name)
    log = out.with_suffix(".log")
    if proc is None and build_info.get(name, {}).get("library") == str(out):
        return out          # built or loaded before: keep that record
    if proc is not None:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed ({proc.returncode}):\n"
                               f"{stderr}")
        log.write_text(stdout + stderr)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        os.replace(tmp, out)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": log.read_text() if log.exists() else "",
                        "library": str(out)}
    return out


def build(name: str) -> pathlib.Path:
    """The library of source `name`, built if missing."""
    t0 = time.perf_counter()
    return _finish(name, _start(name), t0)


def build_all() -> dict:
    """Build every source, one nvcc each, all started together."""
    t0 = time.perf_counter()
    procs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, proc, t0) for name, proc in procs.items()}
