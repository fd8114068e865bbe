"""Pruned-tree op program: fast-SSC(L) node schedule (host-precomputed).

The reference decodes leaf-by-leaf over the full kernel tree (SURVEY.md
§3.3). This module replaces that schedule with the pruned constituent-node
program of Fast-SSC (Sarkis et al.) / Fast-SSCL (Hashemi et al.),
generalized to mixed Arikan/eBCH kernels — the sequential step count drops
from O(N) leaves + O(N) stage ops to the pruned node count, which is the
main lever on the SC throughput target (SURVEY.md §6, §7.2 item 1).

Node classes (exactness notes; all PM updates use the telescoping identity
PM' = PM + relu(-+llr) == min cost over codewords consistent with the
path, which holds for *any* kernel whose input LLRs are exact max-log
marginals — ours are):

- R0  (all-frozen subtree, any kernel mix): the only consistent codeword
  is all-zero => PM += sum_j relu(-lam_j) at the node inputs. Exact.
- REP (all frozen but the last leaf, any kernel mix: the last row of any
  Kronecker product of our kernels is all-ones): one 2-way fork with
  PM0 += sum relu(-lam), PM1 += sum relu(+lam), candidate order bit-major
  — identical to what plain SCL does at the node's single info leaf. Exact.
- R1  (all-info subtree): rate-1 code is the full space, so the min-cost
  codeword is the positionwise hard decision. SC: u = hd(lam) @ Kinv,
  zero penalty. Exact. SCL: Fast-SSCL — min(L-1, n) sequential 2-way
  keep/flip forks on the least-reliable positions reproduces full SCL's
  surviving paths and metrics (Hashemi et al. 2017); tie ORDER may differ
  from leaf-sequential SCL, so it is gated by `fast_r1_scl`.
- SPC (single parity check: first leaf frozen, rest info; only valid when
  every kernel below has exactly one odd-weight row, i.e. pure-Arikan
  subtrees): SC: hd + flip least-reliable position if parity fails,
  PM += min|lam| on failure. Exact. SCL: Fast-SSCL-SPC — mandatory parity
  fix then min(L, n-1) keep/flip pair-forks with per-path parity state
  (ops/scl.py `_spc`); classified under the same `fast_r1_scl` gate as R1
  (identical survivors/metrics; tie order may differ from leaf-sequential
  SCL), verified frame-for-frame in tests/test_fast_nodes.py.
- LEAF: single-leaf fallback — the original frozen/fork step (bit-major
  candidates), preserving the oracle's tie behavior exactly.
- DOWN/UP: the original stage ops (kernel-input LLR / re-encode).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.utils.gf2 import gf2_inverse

R0, REP, R1, SPC, LEAF, DOWN_FRESH, DOWN_DYN, UP = (
    "R0", "REP", "R1", "SPC", "LEAF", "DOWN_FRESH", "DOWN_DYN", "UP")


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str
    level: int     # node depth d for node ops; stage s for DOWN/UP
    t0: int        # first leaf covered (leaf index for LEAF)


@dataclasses.dataclass(frozen=True)
class Program:
    ops: tuple[Op, ...]
    branch_keys: tuple[tuple[str, int], ...]   # distinct (kind, level)
    op_code: np.ndarray                        # [n_ops] branch index
    op_t0: np.ndarray                          # [n_ops]


def _spc_valid_below(spec: CodeSpec, depth: int) -> bool:
    """True iff span(rows != 0) of the sub-Kronecker is the even-weight
    code: every factor below must have exactly one odd-weight row."""
    for s in range(depth, len(spec.factors)):
        rows = spec.kernels[s]
        odd = (rows.sum(axis=1) % 2 == 1).sum()
        if odd != 1:
            return False
    return True


def build_program(spec: CodeSpec, scl: bool, classify: bool = True,
                  fast_r1_scl: bool = True, genie: bool = False) -> Program:
    m = len(spec.factors)
    n_sizes = spec.block_sizes
    frozen = spec.frozen
    ops: list[Op] = []

    def emit(t0: int, d: int) -> None:
        n = n_sizes[d]
        fr = frozen[t0:t0 + n]
        if classify and not genie and d >= 1:
            if fr.all():
                ops.append(Op(R0, d, t0))
                return
            if n >= 2 and fr[:-1].all() and fr[-1] == 0:
                ops.append(Op(REP, d, t0))
                return
            if n >= 2 and not fr.any() and (not scl or fast_r1_scl):
                ops.append(Op(R1, d, t0))
                return
            if (n >= 4 and (not scl or fast_r1_scl) and fr[0] == 1
                    and not fr[1:].any() and _spc_valid_below(spec, d)):
                ops.append(Op(SPC, d, t0))
                return
        if d == m:
            ops.append(Op(LEAF, m, t0))
            return
        l = spec.factors[d]
        child_n = n_sizes[d + 1]
        for i in range(l):
            ct0 = t0 + i * child_n
            ops.append(Op(DOWN_FRESH if i == 0 else DOWN_DYN, d + 1, ct0))
            emit(ct0, d + 1)
        if d >= 1:
            ops.append(Op(UP, d + 1, t0))

    emit(0, 0)
    keys = []
    seen = {}
    codes = np.zeros(len(ops), np.int32)
    t0s = np.zeros(len(ops), np.int32)
    for j, op in enumerate(ops):
        k = (op.kind, op.level)
        if k not in seen:
            seen[k] = len(keys)
            keys.append(k)
        codes[j] = seen[k]
        t0s[j] = op.t0
    return Program(ops=tuple(ops), branch_keys=tuple(keys),
                   op_code=codes, op_t0=t0s)


def staged_inverse_kernels(spec: CodeSpec) -> tuple[np.ndarray, ...]:
    """GF(2) inverses of each kernel factor (for R1/SPC u recovery)."""
    return tuple(gf2_inverse(k).astype(np.float32) for k in spec.kernels)
