"""The standalone l > 2 DOWN kernel (K6, csrc/stage_down.cu): host tables,
build and the wrapper.

Counterpart of polar_tpu/ops/pallas_stage.py `build_down_kernel`. In the
port the hybrid decoder (ops/scl.py `big_stage_backend="pallas"`) runs one
launch of it for every l > 2 trellis/table DOWN op. `fn(lam_adj)` takes a
CUDA tensor to the kernel (or raises) and a CPU tensor to the plain
version, ops/kernel_proc.py StageProcessor.plain_llr.
`LAUNCHES["stage_down"]` counts the launches.

`big_kernel` builds the kernel's tables (also used by the decode kernels'
l > 2 stages, ops/cuda_scl.py): the columns and rows of K as bit masks,
and per input i the syndrome-trellis state count (0 where the tail table
is the cheaper backend, as StageProcessor chooses), syndrome columns and
the end state of hypothesis u_i = 1 (`s1`: the kernels' one pass is read
at states 0 and s1).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from polar_tpu_torch.ops import cuda_build
from polar_tpu_torch.ops.kernel_proc import StageProcessor

MAX_L = 16
MAX_STATES = 32
_THREADS = 256
_FILL_THREADS = 132 * 2048   # resident threads of an H100: 132 SMs x 2048
# a warp for each of an H100's 528 warp schedulers (132 SMs x 4): the
# trellis's one thread an element fills the card from here (`lanes_for`)
_TRELLIS_THREADS = 132 * 4 * 32

LAUNCHES = {"stage_down": 0}
SOURCE = cuda_build.CSRC / "stage_down.cu"

_lib = None


# A tail table whose walk is shorter than this many columns folds each
# column directly; from here on it looks the column up in quad tables
# (csrc/big_stage.cuh `table_max`), whose 16-lane group repeats the
# element's loads and table build in every lane. Measured on an H100
# (PERF.md §6, `kernel_times`): K6 at mixed_scl32's outer shape takes 0.79
# ms with quads against 0.91 direct at a walk of 64, 0.68 against 0.47 at
# 32; K3's 13 launches take 33.0 ms at a cut-over of 16, 31.9 at 64, 31.7
# at 128, 32.2 at 256.
QUAD_MIN_COLS = 64


class BigKernel(ctypes.Structure):
    """Mirrors `bigstage::BigKernel` (csrc/big_stage.cuh)."""
    _fields_ = [("l", ctypes.c_int),
                ("kcol", ctypes.c_ushort * MAX_L),
                ("krow", ctypes.c_ushort * MAX_L),
                ("states", ctypes.c_ubyte * MAX_L),
                ("cols", (ctypes.c_ubyte * MAX_L) * MAX_L),
                ("walk", ctypes.c_ushort * MAX_L),
                ("quads", ctypes.c_ushort),
                ("s1", ctypes.c_ubyte * MAX_L)]


class StageDownArgs(ctypes.Structure):
    """Mirrors `StageDownArgs` (csrc/stage_down.cu)."""
    _fields_ = [("lam", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("P", ctypes.c_int), ("nB", ctypes.c_int), ("i", ctypes.c_int),
                ("lanes", ctypes.c_int), ("k", BigKernel)]


@functools.lru_cache(maxsize=None)
def _processor(kernel_bytes: bytes, l: int) -> StageProcessor:
    return StageProcessor(np.frombuffer(kernel_bytes, np.uint8).reshape(l, l))


def processor(kernel: np.ndarray) -> StageProcessor:
    kernel = np.asarray(kernel, np.uint8)
    return _processor(kernel.tobytes(), int(kernel.shape[0]))


def big_kernel(kernel: np.ndarray) -> BigKernel:
    """The kernel tables of an l x l kernel, 2 <= l <= 16 (for l = 2 only
    the columns are used). Raises where an input's syndrome trellis would
    need more states than a warp has lanes.

    The tail-table rules are decided here, once, and the kernels read them
    (for the inputs whose backend is the table): `walk[i]`, the columns a
    lane group walks, is 2^(l-1-i), halved where
    row l-1 is all ones (each column's complement is then walked with it,
    as |corr|); bit i of `quads` is set where l is 8 or 16 and the walk is
    at least QUAD_MIN_COLS columns (the quad tables pay there).

    For a trellis input, `s1[i]` is the syndrome H row_i of row i (the XOR
    of its syndrome columns where row i has a 1): the trellis state in
    which the paths of hypothesis u_i = 1 end."""
    kernel = np.asarray(kernel, np.uint8)
    l = int(kernel.shape[0])
    if not 2 <= l <= MAX_L:
        raise ValueError(f"kernel size {l} outside 2..{MAX_L}")
    bk = BigKernel(l=l)
    for k in range(l):
        bk.kcol[k] = int((kernel[:, k].astype(np.int64) << np.arange(l)).sum())
        bk.krow[k] = int((kernel[k].astype(np.int64) << np.arange(l)).sum())
    if l == 2:
        return bk
    pairs = bk.krow[l - 1] == (1 << l) - 1
    for i in range(l - 1):
        bk.walk[i] = 1 << (l - 1 - i - int(pairs))
        if l in (8, 16) and bk.walk[i] >= QUAD_MIN_COLS:
            bk.quads |= 1 << i
    proc = processor(kernel)
    for i in range(l - 1):
        if proc.backend[i] != "trellis":
            continue
        S, cols = proc.syn[i]
        if S > MAX_STATES:
            raise ValueError(f"input {i} of the {l}x{l} kernel needs {S} "
                             f"trellis states; the kernels take <= {MAX_STATES}")
        bk.states[i] = S
        s1 = 0
        for t, c in enumerate(cols):
            bk.cols[i][t] = c
            if kernel[i, t]:
                s1 ^= c
        bk.s1[i] = s1
    return bk


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the stage kernel's library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build("stage_down.cu")))
        lib.stage_down_launch.argtypes = [ctypes.POINTER(StageDownArgs),
                                          ctypes.c_void_p]
        lib.stage_down_launch.restype = ctypes.c_int
        lib.stage_down_args_bytes.argtypes = []
        lib.stage_down_args_bytes.restype = ctypes.c_int
        if lib.stage_down_args_bytes() != ctypes.sizeof(StageDownArgs):
            raise RuntimeError(f"StageDownArgs is {lib.stage_down_args_bytes()}"
                               f" B in the library, "
                               f"{ctypes.sizeof(StageDownArgs)} B here")
        _lib = lib
    return _lib


def trellis_lanes(S: int, elements: int, threads: int, rmax: int = MAX_STATES
                  ) -> int:
    """Lanes a syndrome-trellis element takes (csrc/big_stage.cuh
    `trellis_lanes`): at least S / rmax, doubled while `elements` at twice
    the count still fit in `threads`; each lane holds S / lanes states."""
    lanes = S // rmax if S > rmax else 1
    while lanes < S and elements * lanes * 2 <= threads:
        lanes *= 2
    return lanes


def lanes_for(bk: BigKernel, i: int, elements: int) -> int:
    """Threads per output element: for the trellis `trellis_lanes` over
    a warp a scheduler (one thread an element, all S states in its
    registers, wherever that keeps every scheduler busy; `kernel_times
    --k6-lanes` times every count, PERF.md §6); for the table 16 where the
    walk takes the quad tables (bit i of `bk.quads`), else 1, doubled up
    to 32 (and up to the walk) while there are too few elements to fill
    the card."""
    if bk.states[i]:
        return trellis_lanes(int(bk.states[i]), elements, _TRELLIS_THREADS)
    walk = int(bk.walk[i])
    lanes = 16 if (bk.quads >> i) & 1 else 1
    while lanes < 32 and lanes < walk and elements * lanes < _FILL_THREADS:
        lanes *= 2
    return lanes


class DownKernel:
    """fn(lam_adj [P, l, n, B] float32) -> [P, n, B]: input i of `kernel`
    (0 <= i < l-1) from coset-adjusted output LLRs."""

    def __init__(self, kernel: np.ndarray, i: int, P: int, n: int):
        self.kernel = np.asarray(kernel, np.uint8)
        self.l = int(self.kernel.shape[0])
        if not (self.l > 2 and 0 <= i < self.l - 1):
            raise ValueError("the stage kernel covers l > 2 and 0 <= i < l-1 "
                             "(i = l-1 is a single correlation)")
        self.i, self.P, self.n = int(i), int(P), int(n)
        self.bk = big_kernel(self.kernel)
        self.proc = processor(self.kernel)

    def __call__(self, lam_adj: torch.Tensor) -> torch.Tensor:
        shape = (self.P, self.l, self.n)
        if lam_adj.ndim != 4 or tuple(lam_adj.shape[:3]) != shape:
            raise ValueError(f"lam_adj must be [{self.P}, {self.l}, {self.n}, "
                             f"B], got {tuple(lam_adj.shape)}")
        if lam_adj.dtype != torch.float32:
            raise TypeError(f"lam_adj must be float32, got {lam_adj.dtype}")
        if lam_adj.device.type == "cpu":
            return self.plain(lam_adj)
        if lam_adj.device.type != "cuda":
            raise ValueError(f"unsupported device {lam_adj.device}")
        return self.kernel_call(lam_adj)

    def plain(self, lam_adj: torch.Tensor) -> torch.Tensor:
        return self.proc.plain_llr(self.i, lam_adj)

    def kernel_call(self, lam_adj: torch.Tensor, lanes: int | None = None
                    ) -> torch.Tensor:
        """The kernel at `lanes` threads an element (default: `lanes_for`;
        another power of two <= 32 and <= the states or the walk gives the
        same floats)."""
        lam_adj = lam_adj.contiguous()
        B = lam_adj.shape[3]
        nB = self.n * B
        out = torch.empty((self.P, self.n, B), dtype=torch.float32,
                          device=lam_adj.device)
        if lanes is None:
            lanes = lanes_for(self.bk, self.i, self.P * nB)
        args = StageDownArgs(lam=lam_adj.data_ptr(), out=out.data_ptr(),
                             P=self.P, nB=nB, i=self.i, lanes=lanes, k=self.bk)
        lib = load_library()
        with torch.cuda.device(lam_adj.device):
            stream = torch.cuda.current_stream(lam_adj.device).cuda_stream
            err = lib.stage_down_launch(ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"stage_down launch failed: CUDA error {err}")
        LAUNCHES["stage_down"] += 1
        return out


@functools.lru_cache(maxsize=None)
def _build(kernel_bytes: bytes, l: int, i: int, P: int, n: int) -> DownKernel:
    return DownKernel(np.frombuffer(kernel_bytes, np.uint8).reshape(l, l),
                      i, P, n)


def build_down_kernel(kernel: np.ndarray, i: int, P: int, n: int) -> DownKernel:
    """fn(lam_adj [P, l, n, B] float32) -> [P, n, B] float32, the input-i
    LLR of an l x l kernel, float-identical to StageProcessor._llr_static
    for 0 <= i < l-1. A CUDA tensor runs K6, a CPU tensor the plain
    version."""
    kernel = np.asarray(kernel, np.uint8)
    return _build(kernel.tobytes(), int(kernel.shape[0]), int(i), int(P), int(n))
