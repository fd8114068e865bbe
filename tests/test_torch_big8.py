"""The general body's list capacity 8 (csrc/scl_decode.cu `scl_body` at
P <= 8: the l > 2 instances of K1, K2, K4, K5 and the subtree kernel K3):
its rule of threads a codeword and its layout, parts of the launch plan
(ops/cuda_scl.py), and the op-kind split's `--only bch_sc`.

The instances run at 128 registers a thread, so an SM holds 16 of their
warps. One warp a codeword is the rule (`general_threads`); the block
takes two only where the blocks an SM's shared memory holds (the stage
tables copied there, the decode state, `Small<8>`) bring fewer than those
16 warps. At list size 1, K2, K4 and K5 decode two codewords a warp, a
half-warp each, where an SM then holds more codewords
(`general_codewords`). A thread permutes whole path maps, so capacity
8 has no bound on the maps. The card holds the plans to the library
(tests/test_torch_cuda.py `test_big8_shared_memory_mirror`).
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.sim import kernel_times

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = tuple(cuda_scl.KERNELS)
H100 = cuda_scl.H100
# warps an H100 SM's registers allow at the capacity-8 instances' launch bounds
BIG8_WARPS = H100.registers // cuda_scl.BIG8_REGISTERS // 32
CRC8 = CrcSpec(8, 0x07, 0)
# tests/test_torch_cuda.py `_MIXED`
MIXED = [((16,), 6, None), ((4, 4), 6, None), ((8, 2, 4), 30, CRC8),
         ((16, 2), 12, None), ((2, 16), 10, CRC8), ((16, 2, 2), 20, CRC8)]


def _mixed(factors, K, crc, seed=1):
    N = int(np.prod(factors))
    r = np.random.default_rng(seed)
    nk = K + (crc.width if crc else 0)
    mask = np.ones(N, np.uint8)
    mask[np.argsort(r.random(N) + np.linspace(0, 1, N))[-nk:]] = 0
    return CodeSpec(N=N, K=K, factors=tuple(factors),
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)


def _specs():
    """bch_sc, the golden mixed spec (N=512, (16,2,2,2,2,2)) and `MIXED`."""
    from polar_tpu_torch.sim.golden import load_golden
    gold = load_golden(ROOT / "results" / "golden_mixed_scl_b128.npz")[0]
    return [get_preset("bch_sc").spec, gold] + [_mixed(*m) for m in MIXED]


@pytest.mark.parametrize("L", range(1, 33))
def test_general_threads_rule(L):
    """One warp a codeword at capacity 8 wherever the SM's shared memory
    holds 16 one-warp blocks (bch_sc at every L), a half-warp at L = 1 for
    K2, K4 and K5 (two codewords a warp); the golden mixed spec's decode
    kernels take 64 threads from L=6 (14 blocks), its Monte-Carlo kernels
    from L=7 (11 blocks: below 3/4 of 16); 256 at capacity 32."""
    bch, gold = _specs()[:2]
    for kernel in KERNELS:
        half = L == 1 and kernel in cuda_scl.CW2_KERNELS
        assert not cuda_scl.arikan8(bch, L, kernel)
        assert cuda_scl.general_threads(bch, L, kernel) == (
            256 if L > 8 else 16 if half else 32)
        mc = kernel in ("scl_mc_traj", "scl_mc_counters")
        want = 256 if L > 8 else 64 if L >= (7 if mc else 6) else 16 if half else 32
        assert cuda_scl.general_threads(gold, L, kernel) == want


@pytest.mark.parametrize("L", range(1, 9))
def test_general_threads_is_the_least_that_fills_the_sm(L):
    """At one codeword a block, T is 32 where the one-warp blocks that
    shared memory allows bring BIG8_WARPS warps (3/4 of them for the
    Monte-Carlo kernels), else 64, the widest instance; at two, 16."""
    for spec in _specs():
        for kernel in KERNELS:
            T = cuda_scl.general_threads(spec, L, kernel)
            if cuda_scl.general_codewords(spec, L, kernel) == 2:
                assert T == 16
                continue
            block = (cuda_scl.general_smem_bytes(spec, L, kernel)
                     + cuda_scl.SMALL8_STATIC_BYTES + H100.reserved)
            blocks = H100.shared // block
            least = BIG8_WARPS * (
                3 if kernel in ("scl_mc_traj", "scl_mc_counters") else 4) / 4
            assert T in (32, 64)
            assert T == 64 or blocks >= least
            assert T == 32 or blocks < least


def test_max_maps_by_capacity():
    """Capacity 8 permutes a map a thread (no bound); capacity 32 holds 8
    bytes a thread of 256."""
    for L in range(1, 9):
        assert cuda_scl.max_maps(L) is None
    for L in (9, 16, 32):
        assert cuda_scl.max_maps(L) == 2048
    # four 16x16 stages, 4 x 17 maps: more than the 2 bytes a thread of
    # 256 the capacity-8 instances held (512 at P=8), fine now; at P=32
    # more than capacity 32's 2048
    spec = CodeSpec(N=2 ** 16, K=8, factors=(16,) * 4,
                    frozen_mask=tuple([1] * (2 ** 16 - 8) + [0] * 8))
    _, _, _, maps = cuda_scl.stage_tables(spec, 8)
    assert maps + 8 > 512
    with pytest.raises(ValueError, match="path maps"):
        cuda_scl.stage_tables(spec, 32)


@pytest.mark.parametrize("L", range(1, 9))
def test_general_smem_bytes_at_bch_sc(L):
    """bch_sc's layout at capacity 8: the three stage tables (444 B each
    with BigKernel's s1, 16-aligned),
    LLR buffers 17P floats, decisions 272P, trajectory 256P, span perms
    and suffix indices 2 * 106P, maps 34P; + 5N for the Monte-Carlo
    kernels, + P for the subtree kernel's net map."""
    spec = get_preset("bch_sc").spec
    tabs = -(-3 * ctypes.sizeof(cuda_scl.StageTab) // 16) * 16
    assert ctypes.sizeof(cuda_scl.StageTab) == 444 and tabs == 1344
    state = 4 * 17 * L + 272 * L + 256 * L + 2 * 106 * L + 34 * L
    want = {"scl_decode": state, "scl_decode_traj": state,
            "scl_mc_traj": state + 5 * 256, "scl_mc_counters": state + 5 * 256,
            "scl_subtree": state + L}
    for kernel in KERNELS:
        # at L = 1, K2, K4 and K5 hold two codewords' states, 16-aligned
        two = L == 1 and kernel in cuda_scl.CW2_KERNELS
        assert cuda_scl.general_smem_bytes(spec, L, kernel) == tabs + (
            2 * -(-want[kernel] // 16) * 16 if two else want[kernel])
    # capacity 32 keeps its layout (no copied tables)
    assert cuda_scl.general_smem_bytes(spec, 9, "scl_decode") == (
        4 * 17 * 9 + 272 * 9 + 256 * 9 + 2 * 106 * 9 + 34 * 9)


@pytest.mark.parametrize("spec_args", [None] + MIXED,
                         ids=["bch_sc"] + [str(m[0]) for m in MIXED])
def test_layout_fills_the_warps_an_sm(spec_args):
    """At every L <= 8 each kernel's blocks fill the 16 warps an SM's
    registers allow (BIG8_REGISTERS a thread): 16 one-warp blocks, of two
    codewords each (a half-warp a codeword) for K2, K4 and K5 at L = 1."""
    spec = get_preset("bch_sc").spec if spec_args is None else _mixed(*spec_args)
    assert BIG8_WARPS == 16
    for L in range(1, 9):
        for kernel in KERNELS:
            T = cuda_scl.general_threads(spec, L, kernel)
            cw = cuda_scl.general_codewords(spec, L, kernel)
            assert (T, cw) == ((16, 2) if L == 1 and kernel in cuda_scl.CW2_KERNELS
                               else (32, 1))
            assert cuda_scl.general_blocks_per_sm(spec, L, kernel) == 16


def test_split_takes_bch_sc():
    """`kernel_times --split --only bch_sc`: K5 at L=1 and K1 at L=8; the
    default split takes it too; an unknown name is refused."""
    assert kernel_times.parse_args(["--split", "--only", "bch_sc"]).only == "bch_sc"
    assert "bch_sc" in kernel_times.parse_args(["--split"]).only.split(",")
    assert kernel_times.parse_args([]).only.split(",") == list(kernel_times.ROWS)
    with pytest.raises(SystemExit):
        kernel_times.parse_args(["--split", "--only", "arikan_sc"])
    with pytest.raises(SystemExit):
        kernel_times.parse_args(["--only", "bch"])
    assert kernel_times.fork_rounds(get_preset("bch_sc").spec, 8) == 37


def test_rule_reaches_the_built_instances_only():
    """The source builds capacity-8 instances at 32 and 64 threads a
    codeword, and two-codeword instances (16 threads a codeword) of K2, K4
    and K5; the rule sends every spec of these tests, at every kernel and
    L <= 8, to one of them, the golden mixed spec reaches both one-codeword
    widths, and every spec the two-codeword ones at L = 1 alone."""
    src = (ROOT / "polar_tpu_torch" / "csrc" / "scl_decode.cu").read_text()
    assert re.findall(r"^BIG8_KERNELS\((\d+)\)$", src, re.M) == ["32", "64"]
    assert tuple(re.findall(r"^BIG8_CW2_KERNEL\((\w+),", src, re.M)) == cuda_scl.CW2_KERNELS
    seen = {}
    for i, spec in enumerate(_specs()):
        for L in range(1, 9):
            for kernel in KERNELS:
                T = cuda_scl.general_threads(spec, L, kernel)
                seen.setdefault(T, set()).add(i)
                assert (T == 16) == (L == 1 and kernel in cuda_scl.CW2_KERNELS)
    assert set(seen) == {16, 32, 64}
    assert seen[64] == {1}
    assert seen[16] == set(range(len(_specs())))


@pytest.mark.parametrize("L", range(1, 9))
def test_general_codewords_rule(L):
    """Two codewords a block only for K2, K4 and K5 at L = 1, and there
    exactly where an SM holds more codewords so (its blocks by registers,
    shared memory and count, times two) than at one codeword a block of
    the one-codeword rule's threads; bch_sc and the golden mixed spec go to
    two (32 codewords an SM against 16; the golden mixed spec's
    Monte-Carlo kernels 30)."""
    specs = _specs()
    for spec in specs:
        for kernel in KERNELS:
            cw = cuda_scl.general_codewords(spec, L, kernel)
            if L > 1 or kernel not in cuda_scl.CW2_KERNELS:
                assert cw == 1
                continue
            T = cuda_scl._one_codeword_threads(spec, L, kernel)
            copy = cuda_scl._copy_bytes(spec)
            state = cuda_scl._state_bytes(spec, L, kernel)
            one = min(H100.blocks, BIG8_WARPS * 32 // T,
                      H100.shared // (copy + state + cuda_scl.SMALL8_STATIC_BYTES
                                      + H100.reserved))
            two = 2 * min(H100.blocks, BIG8_WARPS,
                          H100.shared // (copy + 2 * -(-state // 16) * 16
                                          + 2 * cuda_scl.SMALL8_STATIC_BYTES
                                          + H100.reserved))
            assert cw == (2 if two > one else 1)
    bch, gold = specs[:2]
    if L == 1:
        for kernel in cuda_scl.CW2_KERNELS:
            assert cuda_scl.general_codewords(bch, 1, kernel) == 2
            assert cuda_scl.general_codewords(gold, 1, kernel) == 2
            assert 2 * cuda_scl.general_blocks_per_sm(bch, 1, kernel) == 32
        assert cuda_scl.general_blocks_per_sm(gold, 1, "scl_mc_counters") == 15


def test_two_codeword_layout_at_bch_sc():
    """The shared-memory mirror at two codewords a block: the stage tables
    once, then each codeword's state at a 16-byte boundary (the second
    half's LLR rows stay 16-byte aligned for `select_rank`'s float4
    reads), and a `Small<8>` a codeword; one codeword a block at L = 2."""
    spec = get_preset("bch_sc").spec
    copy = cuda_scl._copy_bytes(spec)
    for kernel in cuda_scl.CW2_KERNELS:
        state = cuda_scl._state_bytes(spec, 1, kernel)
        region = -(-state // 16) * 16
        assert copy % 16 == 0 and region % 16 == 0 and region - state < 16
        assert cuda_scl.general_smem_bytes(spec, 1, kernel) == copy + 2 * region
        assert cuda_scl.general_static_bytes(spec, 1, kernel) == 2 * cuda_scl.SMALL8_STATIC_BYTES
        block = (cuda_scl.general_smem_bytes(spec, 1, kernel)
                 + cuda_scl.general_static_bytes(spec, 1, kernel) + H100.reserved)
        assert H100.shared // block >= 16
        assert cuda_scl.general_smem_bytes(spec, 2, kernel) == copy + cuda_scl._state_bytes(
            spec, 2, kernel)
        assert cuda_scl.general_static_bytes(spec, 2, kernel) == cuda_scl.SMALL8_STATIC_BYTES
    # K5 at bch_sc: 1,344 B of tables and two states of 2,122 B (2,128
    # aligned); 9,216 B a block with the static and reserved shares
    assert cuda_scl.general_smem_bytes(spec, 1, "scl_mc_counters") == 1344 + 2 * 2128
