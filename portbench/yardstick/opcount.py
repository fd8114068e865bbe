"""The least work of one codeword, counted from the code's shapes, and the
published peaks of the card it is held to.

A frozen copy of chip_smoke.py's `element_ops`, `prologue_ops`,
`node_ops`, `stage_down_ops`, `inverse_xors` and `half_tables`, built on
the reference's copies of the program, schedule and kernel tables
(portbench/ref), so that the count stays what it was when the benchmark
was written, whatever kernels later implement the work. The tail-table
walk of an l > 2 input (`walk`) is the rule the program's kernel tables
state: 2^(l-1-i) columns, halved where row l-1 of the kernel is all ones.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from portbench.ref.kernel_proc import StageProcessor
from portbench.ref.program import build_program, staged_inverse_kernels
from portbench.ref.schedule import build_schedule

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: HBM3 bandwidth,
# and float32 outside the tensor cores (67 TFLOP/s with an FMA counted as
# two: the decode's compares, min, abs, selects and XORs issue one a lane a
# cycle, half that rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_ELEM_OPS_PER_S = 67e12 / 2


@functools.lru_cache(maxsize=None)
def _processor(kernel_bytes: bytes, l: int) -> StageProcessor:
    return StageProcessor(np.frombuffer(kernel_bytes, np.uint8).reshape(l, l))


def processor(kernel) -> StageProcessor:
    kernel = np.asarray(kernel, np.uint8)
    return _processor(kernel.tobytes(), int(kernel.shape[0]))


def walk(kernel, i: int) -> int:
    """Columns of input i's tail table that must be walked (l > 2)."""
    kernel = np.asarray(kernel, np.uint8)
    l = int(kernel.shape[0])
    pairs = int(bool(kernel[l - 1].all()))
    return 1 << (l - 1 - i - pairs)


def _xors(t) -> int:
    """XORs of x' = x T over GF(2) for one vector: weight - 1 a column."""
    return int(sum(max(int(c.sum()) - 1, 0) for c in np.asarray(t).T))


def half_tables(l: int) -> int:
    """Adds that build the fixed tree's two half-subtree tables of an l x l
    kernel level by level, one add an entry."""
    tables, w = 0, 2
    while w <= l // 2:
        tables += (l // w) * (1 << w)
        w *= 2
    return tables


def stage_down_ops(kernel, i: int, shared: bool = False) -> int:
    """Least element operations of input i of an l x l kernel (l > 2) for
    one (path, position): the last input a weighted correlation; a trellis
    input one min-plus pass for both hypotheses; a table input the cheaper
    of the half tables plus 5 a walked column, or 1 + 2l a column; then a
    subtraction and a halving. `shared`: the half tables are counted
    elsewhere (once for every input of a node)."""
    l = kernel.shape[0]
    if i == l - 1:
        return 2 * l - 1
    proc = processor(kernel)
    if proc.backend[i] == "trellis":
        return l * (2 + 3 * proc.syn[i][0])
    cols = walk(kernel, i)
    if shared:
        return cols * 5 + 2
    return min(half_tables(l) + cols * 5, cols * (1 + 2 * l)) + 2


def node_ops(kernel, inputs, P: int, rows: int) -> int:
    """Least element operations, per position, of the DOWN ops of one node
    of an l > 2 stage at P paths, its parent block holding `rows` distinct
    rows: the half tables once a row, each table input its walk and a
    coset XOR, or where cheaper its `stage_down_ops` alone; the trellis
    and the last input take the coset as l sign selects."""
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
    ns = spec.block_sizes
    if all(f == 2 for f in spec.factors[d:]):
        return (ns[d] // 2) * int(math.log2(ns[d]))
    inv = staged_inverse_kernels(spec)
    return sum(ns[d] // spec.factors[s] * _xors(inv[s])
               for s in range(d, len(spec.factors)))


def element_ops(spec, P: int, epilogue: bool = True, root_rows: int = 1) -> int:
    """Least element operations of one codeword's decode, counted from the
    shapes of the fast-SSCL program: per path and output element f 4, g 2,
    UP 1 (an l > 2 stage: its nodes' DOWN ops together, `node_ops`, and
    UP's GF(2) products); per path and input R0 2, REP 4; R1/SPC a hard
    decision and an abs an input, the least reliable inputs selected at
    ceil(log2(n_min + 1)) compares an input, a flip a selected position,
    the inverse transform's XORs and, for SPC, n parity XORs; a 2P -> P
    fork 2P adds and 2P log2(2P) compares; the epilogue (`epilogue`) a
    CRC mask XOR an unfrozen bit and an argmin compare a path.
    `root_rows`: rows of the block stage 1 reads (1: the channel LLRs)."""
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
    """Least element operations of one codeword's Monte-Carlo draw: 2N
    Philox words at 10 rounds of 8 operations a call of 4 words; K data bit
    masks, K CRC mask XORs, the encode's XORs; Box-Muller 15 a pair of
    rows (transcendentals one each); the channel 5 a row."""
    N, K = spec.N, spec.K
    philox = (2 * N // 4) * 10 * 8
    if all(f == 2 for f in spec.factors):
        enc = (N // 2) * int(math.log2(N))
    else:
        enc = sum(N // f * _xors(k) for f, k in zip(spec.factors, spec.kernels))
    return philox + 2 * K + enc + 15 * (N // 2) + 5 * N


def bound_s(ops: float, bytes_moved: float) -> float:
    """The least time the card could take for this work: the larger of its
    operations at the element-op peak and its bytes at the HBM peak."""
    return max(ops / PEAK_ELEM_OPS_PER_S, bytes_moved / PEAK_BYTES_PER_S)
