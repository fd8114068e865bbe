"""The l > 2 syndrome-trellis marginal as the CUDA kernels compute it
(polar_tpu_torch/csrc/big_stage.cuh `trellis_llr`, shared by K1-K6),
modelled step for step in numpy float32 and held bit for bit against the
JAX package's two-pass reference (CPU).

What the model repeats of the kernel: one min-plus pass, read at state 0
(hypothesis u_i = 0) and at state s1 = H row_i (u_i = 1, `BigKernel.s1`
as cuda_stage.big_kernel fills it); R = S / lanes states a lane, the
relabelling alpha[st ^ c_t] split into a lane XOR by c_t // R (the
shuffle) and a register XOR by c_t % R (the compile-time permutation);
the readout of register s1 % R from lane s1 // R; the prior decisions'
coset as a sign flip of section t's input by the parity of u & kcol[t]
(the decode body's `big_down`); and the host rule that picks the lanes
(`trellis_lanes`). Inputs: Gaussian, integer-valued (ties and exact
zeros), and +-0.0, +-1e30 and +-inf mixed in. Where JAX gives NaN
(inf - inf) the model must give NaN too; everywhere else torch.equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.kernels.bch import build_bch_kernel
from polar_tpu.kernels.trellis import syndrome_min_cost, tail_syndrome_cols
from polar_tpu.ops import kernel_proc as j_kp
from polar_tpu_torch.kernels.trellis import INF
from polar_tpu_torch.ops import cuda_build, cuda_scl, cuda_stage

P, N_POS, B = 2, 2, 8
F32 = np.float32


def model_alpha(kernel, i: int, w, lanes: int):
    """The one pass of input i on coset-adjusted LLRs w [E, l] with `lanes`
    lanes an element: alpha [E, lanes, R], lane g register j = state
    g * R + j."""
    bk = cuda_stage.big_kernel(kernel)
    S, l = int(bk.states[i]), kernel.shape[0]
    R = S // lanes
    a = np.full((w.shape[0], lanes, R), INF, F32)
    a[:, 0, 0] = 0.0
    g, j = np.arange(lanes), np.arange(R)
    for t in range(l):
        x = w[:, t][:, None, None]
        p0, p1 = np.maximum(-x, F32(0)), np.maximum(x, F32(0))
        c = int(bk.cols[i][t])
        o = a[:, g ^ (c // R), :]            # shuffle by c // R lanes
        a = np.minimum(a + p0, o[:, :, j ^ (c % R)] + p1)   # registers
    return a


def model_llr(kernel, i: int, w, lanes: int):
    """alpha[s1] - alpha[0] [E], and the two ends."""
    a = model_alpha(kernel, i, w, lanes)
    s1 = int(cuda_stage.big_kernel(kernel).s1[i])
    R = a.shape[2]
    z, z0 = a[:, s1 // R, s1 % R], a[:, 0, 0]
    with np.errstate(invalid="ignore"):        # inf - inf: NaN, as in JAX
        return (z - z0).astype(F32), z0, z


def _inputs(kind, l, seed):
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal((P, l, N_POS, B))
    if kind == "int":
        x = np.round(x)
    elif kind == "special":
        x = np.round(x)
        x[0, :, 0, :] = 0.0
        x[0, ::3, 1, :] *= -0.0
        x[0, 1, 1, ::2] = -0.0
        x[1, 0, 0, :] = 1e30
        x[1, 3 % l, 0, ::3] = -1e30
        e = rng.integers(0, l, B)              # one +-inf an element
        x[1, e, 1, np.arange(B)] = np.where(np.arange(B) % 2, np.inf, -np.inf)
    return x.astype(F32)


def _flat(lam):
    """[P, l, n, B] -> [E, l], elements in (p, position, b) order."""
    return np.moveaxis(lam, 1, -1).reshape(-1, lam.shape[1])


def _same(got, ref):
    got, ref = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(ref))
    nan = torch.isnan(ref)
    return torch.equal(nan, torch.isnan(got)) and torch.equal(got[~nan], ref[~nan])


def _trellis_cases():
    cases = []
    for l in (4, 8, 16):
        proc = j_kp.StageProcessor(build_bch_kernel(l))
        cases += [(l, i) for i in range(l - 1) if proc.backend[i] == "trellis"]
    return cases


def test_trellis_cases_cover_the_kernels():
    """The eBCH 4, 8 and 16 kernels have 1, 2 and 5 trellis inputs (i = 0,
    0..1, 0..4), with S = 2^(i+1) states."""
    cases = _trellis_cases()
    assert cases == [(4, 0), (8, 0), (8, 1)] + [(16, i) for i in range(5)]
    for l, i in cases:
        assert cuda_stage.big_kernel(build_bch_kernel(l)).states[i] == 2 << i


@pytest.mark.parametrize("kind", ["normal", "int", "special"])
@pytest.mark.parametrize("l,i", _trellis_cases())
def test_one_pass_matches_jax_two_passes(l, i, kind):
    """At every lane count 1..S, the one pass's alpha[0] is JAX's first
    pass's cost, its alpha[s1] the second (sign-flipped) pass's, and
    alpha[s1] - alpha[0] is JAX's _llr_static, bit for bit."""
    kernel = build_bch_kernel(l)
    jp = j_kp.StageProcessor(kernel)
    lam = _inputs(kind, l, 300 * l + i)
    S, cols = jp.syn[i]
    both = np.stack([lam, lam * jp.row_signs[i][None, :, None, None]])
    cost = np.asarray(syndrome_min_cost(S, cols, jnp.asarray(both)))   # [2, P, n, B]
    ref = np.asarray(jp._llr_static(i, jnp.asarray(lam)))
    w = _flat(lam)
    lanes = 1
    while lanes <= S:
        llr, z0, z1 = model_llr(kernel, i, w, lanes)
        shape = (P, N_POS, B)
        assert _same(z0.reshape(shape), cost[0]), (lanes, "alpha[0]")
        assert _same(z1.reshape(shape), cost[1]), (lanes, "alpha[s1]")
        assert _same(llr.reshape(shape), ref), (lanes, "llr")
        lanes *= 2


def _half_warp_lanes(S: int) -> list[int]:
    """The lanes the decode body gives a trellis element of S states at 16
    threads a codeword (two codewords a warp), at bch_sc's stage-1 and
    stage-2 positions (E = 16 and E = 1)."""
    return sorted({cuda_stage.trellis_lanes(S, E, 16, cuda_scl.BODY_TRELLIS_MAX_R)
                   for E in (1, 16)})


def test_half_warp_lanes_of_the_16x16_kernel():
    """At 16 threads a codeword the 16x16 kernel's trellis inputs i = 0..4
    take 2, 4, 8, 16 and 16 lanes at one position (a warp a codeword: 2,
    4, 8, 16, 32) and S / 8 (at least one) at 16 positions."""
    body = cuda_scl.BODY_TRELLIS_MAX_R
    assert [cuda_stage.trellis_lanes(2 << i, 1, 16, body) for i in range(5)] == [2, 4, 8, 16, 16]
    assert [cuda_stage.trellis_lanes(2 << i, 1, 32, body) for i in range(5)] == [2, 4, 8, 16, 32]
    assert [cuda_stage.trellis_lanes(2 << i, 16, 16, body) for i in range(5)] == [1, 1, 1, 2, 4]
    assert [_half_warp_lanes(2 << i) for i in range(5)] == [[1, 2], [1, 4], [1, 8],
                                                            [2, 16], [4, 16]]


@pytest.mark.parametrize("kind", ["normal", "int", "special"])
@pytest.mark.parametrize("l,i", _trellis_cases())
def test_one_pass_matches_jax_at_half_warp_lanes(l, i, kind):
    """At the lane counts a 16-lane codeword gives (`_half_warp_lanes`),
    the one pass's alpha[s1] - alpha[0] is JAX's _llr_static, bit for bit,
    on raw inputs and on the coset-adjusted inputs of prior decisions."""
    kernel = build_bch_kernel(l)
    jp = j_kp.StageProcessor(kernel)
    bk = cuda_stage.big_kernel(kernel)
    lam = _inputs(kind, l, 900 * l + i)
    ref = np.asarray(jp._llr_static(i, jnp.asarray(lam)))
    rng = np.random.default_rng(11 * l + i)
    dec = rng.integers(0, 2, (l, P, N_POS, B)).astype(np.int8)
    ref_c = np.asarray(jp.static_llr(i, jnp.asarray(lam), jnp.asarray(dec)))
    u = np.zeros(dec.shape[1:], np.int64)
    for c in range(i):
        u |= dec[c].astype(np.int64) << c
    flip = np.stack([np.bitwise_count(u & int(bk.kcol[t])) & 1 for t in range(l)], axis=1)
    adj = np.where(flip == 1, -lam, lam).astype(F32)
    for lanes in _half_warp_lanes(int(bk.states[i])):
        llr, _, _ = model_llr(kernel, i, _flat(lam), lanes)
        assert _same(llr.reshape(P, N_POS, B), ref), lanes
        llr, _, _ = model_llr(kernel, i, _flat(adj), lanes)
        assert _same(llr.reshape(P, N_POS, B), ref_c), lanes


@pytest.mark.parametrize("i", range(5))
def test_coset_as_section_sign_flips(i):
    """The decode body's input: raw parent LLRs and prior decisions u_c (c
    < i), section t's LLR negated where the parity of u & kcol[t] is 1,
    equals JAX's static_llr."""
    kernel = build_bch_kernel(16)
    jp = j_kp.StageProcessor(kernel)
    rng = np.random.default_rng(40 + i)
    view = _inputs("int", 16, 60 + i)
    dec = rng.integers(0, 2, (16, P, N_POS, B)).astype(np.int8)
    ref = np.asarray(jp.static_llr(i, jnp.asarray(view), jnp.asarray(dec)))
    bk = cuda_stage.big_kernel(kernel)
    u = np.zeros(dec.shape[1:], np.int64)                             # [P, n, B]
    for c in range(i):
        u |= dec[c].astype(np.int64) << c
    flip = np.stack([np.bitwise_count(u & int(bk.kcol[t])) & 1
                     for t in range(16)], axis=1)                      # [P, l, n, B]
    adj = np.where(flip == 1, -view, view).astype(F32)
    for lanes in (1, 2, int(bk.states[i])):
        llr, _, _ = model_llr(kernel, i, _flat(adj), lanes)
        assert _same(llr.reshape(P, N_POS, B), ref), lanes


@pytest.mark.parametrize("l", [4, 8, 16])
def test_s1_is_the_syndrome_of_row_i(l):
    """big_kernel's s1[i] = H row_i for the JAX package's parity checks H
    of the tail code span(rows i+1..l-1): nonzero (row i is not in the tail
    code), and H annihilates every tail row."""
    kernel = build_bch_kernel(l)
    bk = cuda_stage.big_kernel(kernel)
    for i in range(l - 1):
        if not bk.states[i]:
            assert bk.s1[i] == 0
            continue
        S, cols = tail_syndrome_cols(kernel.tobytes(), l, i)
        r = S.bit_length() - 1
        H = np.array([[(c >> b) & 1 for c in cols] for b in range(r)], np.int64)
        want = int(((H @ kernel[i].astype(np.int64)) % 2) @ (1 << np.arange(r)))
        assert int(bk.s1[i]) == want != 0
        assert not ((H @ kernel[i + 1:].T.astype(np.int64)) % 2).any()
        assert list(bk.cols[i])[:l] == list(cols) and bk.states[i] == S


def test_host_rule_picks_the_lanes():
    """trellis_lanes: at least S / rmax lanes, more only while twice the
    lanes still fit in `threads`, never past S. K6 (`lanes_for`) asks with
    a warp for each of an H100's schedulers and rmax 32 (one thread an
    element wherever the elements keep every scheduler busy); the decode
    body with its block and rmax BODY_TRELLIS_MAX_R (8)."""
    rule = cuda_stage.trellis_lanes
    k6 = 132 * 4 * 32
    # K6 at mixed_scl32's outer shapes (n = 256, B = 256) and bch_sc's
    # hybrid shapes (n = 16 and 1, B = 8192)
    assert rule(32, 32 * 256 * 256, k6) == 1
    assert rule(32, 256 * 256, k6) == 1
    assert rule(32, 16 * 8192, k6) == 1
    assert rule(32, 8192, k6) == 2
    assert rule(2, 8192, k6) == 2
    assert rule(32, 1, k6) == 32
    # the decode body: bch_sc at one warp (stage 1: 16 positions a path;
    # stage 2: one), K3's 16x16 stage (32 paths x 16 positions, 256 threads)
    body = cuda_scl.BODY_TRELLIS_MAX_R
    assert body == 8
    assert rule(32, 16, 32, body) == 4
    assert rule(32, 8 * 16, 32, body) == 4
    assert rule(32, 8, 32, body) == 4
    assert rule(16, 8, 32, body) == 4
    assert rule(32, 1, 32, body) == 32
    assert rule(16, 1, 32, body) == 16
    assert rule(32, 32 * 16, 256, body) == 4
    assert rule(8, 32 * 16, 256, body) == 1
    assert rule(2, 16, 32, body) == 2
    for S in (2, 4, 8, 16, 32):
        for E in (1, 3, 16, 100, 4096, 10 ** 6):
            for threads in (32, 64, 256, k6):
                for rmax in (4, 8, 32):
                    lanes = rule(S, E, threads, rmax)
                    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= S
                    assert S // lanes <= rmax
                    assert lanes == S or E * lanes * 2 > threads
                    assert lanes == max(1, S // rmax) or E * lanes <= threads


def test_rule_constants_match_the_sources():
    """The Python mirrors name the sources' constants: BODY_TRELLIS_MAX_R
    is scl_decode.cu's kTrellisMaxR, and big_stage.cuh's trellis_lanes
    starts from S / rmax and doubles while E * lanes * 2 <= threads."""
    csrc = cuda_build.CSRC
    body = (csrc / "scl_decode.cu").read_text()
    assert f"constexpr int kTrellisMaxR = {cuda_scl.BODY_TRELLIS_MAX_R};" in body
    assert "trellis_lanes(S, E, T, kTrellisMaxR)" in body
    # the table's lanes (`body_table_lanes`)
    assert "int G = bigstage::table_quads(K, i, 16) ? 16 : 1;" in body
    assert "while (G < T && G < walk && E * G * 2 <= T) G *= 2;" in body
    head = (csrc / "big_stage.cuh").read_text()
    assert "int lanes = S > rmax ? S / rmax : 1;" in head
    assert "while (lanes < S && E * lanes * 2 <= threads) lanes *= 2;" in head


def test_lanes_for_uses_the_rule():
    """K6's lanes at every trellis input of the 16x16 kernel follow
    trellis_lanes over a warp a scheduler; the table inputs keep their
    rule."""
    bk = cuda_stage.big_kernel(build_bch_kernel(16))
    for E in (1, 8192, 16 * 8192, 256 * 256, 32 * 256 * 256):
        for i in range(5):
            assert cuda_stage.lanes_for(bk, i, E) == cuda_stage.trellis_lanes(
                2 << i, E, 132 * 4 * 32)
        assert cuda_stage.lanes_for(bk, 5, E) >= 16
