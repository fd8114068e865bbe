"""The port's primitives and copied host modules against the JAX package,
on the same numpy inputs (CPU).

f/g, CRC, encode and the channel with injected noise are bit-exact.
f_exact is held to a tolerance: its log1p/exp come from different
libraries in the two frameworks and may differ in the last ulp.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.construction import ga as j_ga
from polar_tpu.kernels import arikan as j_arikan
from polar_tpu.kernels import bch as j_bch
from polar_tpu.kernels import trellis as j_trellis
from polar_tpu.models import polar as j_polar
from polar_tpu.models import presets as j_presets
from polar_tpu.ops import crc as j_crc
from polar_tpu.ops import encode as j_encode
from polar_tpu.ops import program as j_program
from polar_tpu.ops import schedule as j_schedule
from polar_tpu.sim import channel as j_channel
from polar_tpu.sim import golden as j_golden
from polar_tpu.utils import gf2 as j_gf2
from polar_tpu.utils import gf2m as j_gf2m
from polar_tpu_torch.construction import ga as t_ga
from polar_tpu_torch.kernels import arikan as t_arikan
from polar_tpu_torch.kernels import bch as t_bch
from polar_tpu_torch.kernels import trellis as t_trellis
from polar_tpu_torch.models import polar as t_polar
from polar_tpu_torch.models import presets as t_presets
from polar_tpu_torch.ops import crc as t_crc
from polar_tpu_torch.ops import encode as t_encode
from polar_tpu_torch.ops import program as t_program
from polar_tpu_torch.ops import schedule as t_schedule
from polar_tpu_torch.sim import channel as t_channel
from polar_tpu_torch.sim import golden as t_golden
from polar_tpu_torch.utils import gf2 as t_gf2
from polar_tpu_torch.utils import gf2m as t_gf2m

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _llr_pairs(seed):
    rng = np.random.default_rng(seed)
    a = (2.0 * rng.standard_normal(256)).astype(np.float32)
    b = (2.0 * rng.standard_normal(256)).astype(np.float32)
    a[:16] = 0.0            # exact zeros: sign(0) = +1
    b[8:24] = 0.0
    a[24:32] = -0.0
    b[32:40] = np.round(a[32:40])
    return a, b


def test_f_minsum_and_g_bit_exact():
    a, b = _llr_pairs(0)
    u0 = (np.arange(256) % 3 == 0).astype(np.int8)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    f_j = np.asarray(j_arikan.f_minsum(jnp.asarray(a), jnp.asarray(b)))
    f_t = t_arikan.f_minsum(ta, tb).numpy()
    assert np.array_equal(f_j.view(np.uint32), f_t.view(np.uint32))
    g_j = np.asarray(j_arikan.g_update(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(u0)))
    g_t = t_arikan.g_update(ta, tb, torch.as_tensor(u0)).numpy()
    assert np.array_equal(g_j, g_t)


def test_f_exact_close():
    a, b = _llr_pairs(1)
    f_j = np.asarray(j_arikan.f_exact(jnp.asarray(a), jnp.asarray(b)))
    f_t = t_arikan.f_exact(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(f_t, f_j, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.sign(f_t[:16]), np.sign(f_j[:16]))


@pytest.mark.parametrize("width,poly,init,k", [
    (8, 0x07, 0x00, 20), (16, 0x1021, 0x0000, 512), (16, 0x1021, 0xFFFF, 40)])
def test_crc_append_check_bit_exact(width, poly, init, k):
    rng = np.random.default_rng(width + k)
    info = rng.integers(0, 2, (16, k)).astype(np.int8)
    jcrc = j_polar.CrcSpec(width, poly, init)
    tcrc = t_polar.CrcSpec(width, poly, init)
    pj = np.asarray(j_crc.crc_append(jcrc, jnp.asarray(info)))
    pt = t_crc.crc_append(tcrc, torch.as_tensor(info)).numpy()
    assert np.array_equal(pj, pt)
    bad = pt.copy()
    bad[::2, 3] ^= 1
    for payload in (pt, bad):
        assert np.array_equal(
            np.asarray(j_crc.crc_check(jcrc, jnp.asarray(payload))),
            t_crc.crc_check(tcrc, torch.as_tensor(payload)).numpy())


@pytest.mark.parametrize("factors", [(2,) * 6, (2, 2, 2, 2, 2, 2, 2, 2, 2, 2),
                                     (16,), (16, 2), (2, 16)])
def test_encode_assemble_extract_bit_exact(factors):
    rng = np.random.default_rng(len(factors))
    N = int(np.prod(factors))
    K = N // 2
    frozen = np.ones(N, np.uint8)
    frozen[rng.choice(N, K, replace=False)] = 0
    jspec = j_polar.CodeSpec(N=N, K=K, factors=factors,
                             frozen_mask=tuple(int(v) for v in frozen))
    tspec = t_polar.spec_from_reference(jspec)
    payload = rng.integers(0, 2, (8, K)).astype(np.int8)
    u_j = np.asarray(j_encode.assemble_u(jspec, jnp.asarray(payload)))
    u_t = t_encode.assemble_u(tspec, torch.as_tensor(payload)).numpy()
    assert np.array_equal(u_j, u_t)
    assert np.array_equal(np.asarray(j_encode.encode(jspec, jnp.asarray(payload))),
                          t_encode.encode(tspec, torch.as_tensor(payload)).numpy())
    u = rng.integers(0, 2, (8, N)).astype(np.int8)
    assert np.array_equal(np.asarray(j_encode.encode_u(jspec, jnp.asarray(u))),
                          t_encode.encode_u(tspec, torch.as_tensor(u)).numpy())
    assert np.array_equal(
        np.asarray(j_encode.extract_payload(jspec, jnp.asarray(u))),
        t_encode.extract_payload(tspec, torch.as_tensor(u)).numpy())


@pytest.mark.parametrize("ebn0", [-1.0, 0.0, 1.25, 2.0, 3.5])
@pytest.mark.parametrize("rate", [0.5, 528 / 1024, 28 / 64])
def test_channel_injected_noise_bit_exact(ebn0, rate):
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (4, 128)).astype(np.int8)
    noise = rng.standard_normal((4, 128)).astype(np.float32)
    sj = j_channel.ebn0_to_sigma(ebn0, rate)
    st = t_channel.ebn0_to_sigma(ebn0, rate)
    assert np.asarray(sj) == st.numpy()
    y_j = j_channel.modulate(jnp.asarray(bits)) + sj * jnp.asarray(noise)
    llr_j = np.asarray(j_channel.llr_demod(y_j, sj))
    llr_t = t_channel.channel_llrs(torch.as_tensor(bits), ebn0, rate,
                                   noise=torch.as_tensor(noise)).numpy()
    assert np.array_equal(llr_j, llr_t)
    y_t = t_channel.awgn(t_channel.modulate(torch.as_tensor(bits)), st,
                         noise=torch.as_tensor(noise))
    assert np.array_equal(np.asarray(y_j), y_t.numpy())


def test_channel_generator_draws():
    gen = torch.Generator().manual_seed(3)
    sym = t_channel.modulate(torch.zeros(64, 256, dtype=torch.int8))
    y = t_channel.awgn(sym, 0.5, generator=gen)
    assert abs(float((y - sym).std()) - 0.5) < 0.02
    with pytest.raises(ValueError):
        t_channel.awgn(sym, 0.5)


def test_copied_gf2_gf2m_bch_ga_equal():
    rng = np.random.default_rng(0)
    for _ in range(10):
        n = int(rng.integers(2, 9))
        a = rng.integers(0, 2, (n, n)).astype(np.uint8)
        b = rng.integers(0, 2, (n, n + 1)).astype(np.uint8)
        assert np.array_equal(j_gf2.gf2_matmul(a, b), t_gf2.gf2_matmul(a, b))
        assert np.array_equal(j_gf2.gf2_kron(a, b), t_gf2.gf2_kron(a, b))
        assert j_gf2.gf2_rank(b) == t_gf2.gf2_rank(b)
        rj, pj = j_gf2.gf2_rref(b)
        rt, pt = t_gf2.gf2_rref(b)
        assert np.array_equal(rj, rt) and pj == pt
        assert np.array_equal(j_gf2.gf2_null_space(b), t_gf2.gf2_null_space(b))
        if j_gf2.gf2_rank(a) == n:
            assert np.array_equal(j_gf2.gf2_inverse(a), t_gf2.gf2_inverse(a))
    for m in range(2, 9):
        fj, ft = j_gf2m.GF2m(m), t_gf2m.GF2m(m)
        assert np.array_equal(fj.exp, ft.exp) and np.array_equal(fj.log, ft.log)
        assert [fj.minimal_polynomial(e) for e in range(1, 8)] == \
            [ft.minimal_polynomial(e) for e in range(1, 8)]
    for l in (2, 4, 8, 16):
        assert np.array_equal(j_bch.build_bch_kernel(l), t_bch.build_bch_kernel(l))
    assert np.array_equal(j_bch.ARIKAN_KERNEL, t_bch.ARIKAN_KERNEL)
    for N, k, snr in [(64, 32, 2.0), (1024, 528, 2.0), (256, 100, 0.5)]:
        assert np.array_equal(j_ga.construct_ga(N, k, snr),
                              t_ga.construct_ga(N, k, snr))


def test_copied_trellis_builders_equal():
    """The numpy trellis builders (kernels/trellis.py) on random codes."""
    rng = np.random.default_rng(4)
    for _ in range(12):
        n = int(rng.integers(3, 9))
        basis = rng.integers(0, 2, (int(rng.integers(1, n)), n)).astype(np.uint8)
        lo, hi = sorted(int(v) for v in rng.integers(0, n + 1, 2))
        assert np.array_equal(j_trellis._subcode_basis(basis, lo, hi),
                              t_trellis._subcode_basis(basis, lo, hi))
        tj, tt = j_trellis.build_trellis(basis, n), t_trellis.build_trellis(basis, n)
        assert np.array_equal(tj.trans, tt.trans)
        assert (tj.s_max, tj.state_profile) == (tt.s_max, tt.state_profile)
    for l in (4, 8, 16):
        kb = t_bch.build_bch_kernel(l).tobytes()
        for i in range(l):
            assert j_trellis.tail_syndrome_cols(kb, l, i) == \
                t_trellis.tail_syndrome_cols(kb, l, i)


@pytest.mark.parametrize("name", sorted(j_presets.PRESETS))
def test_presets_schedule_program_equal(name):
    jp, tp = j_presets.get_preset(name), t_presets.get_preset(name)
    assert (jp.name, jp.list_size, jp.ebn0_grid, jp.frames, jp.batch) == \
        (tp.name, tp.list_size, tp.ebn0_grid, tp.frames, tp.batch)
    assert tp.spec == t_polar.spec_from_reference(jp.spec)
    assert (tp.spec.N, tp.spec.K, tp.spec.factors, tp.spec.frozen_mask) == \
        (jp.spec.N, jp.spec.K, jp.spec.factors, jp.spec.frozen_mask)
    sj, st = j_schedule.build_schedule(jp.spec), t_schedule.build_schedule(tp.spec)
    for f in ("digits", "s_star", "r_up", "frozen"):
        assert np.array_equal(getattr(sj, f), getattr(st, f))
    for scl in (False, True):
        pj = j_program.build_program(jp.spec, scl=scl)
        pt = t_program.build_program(tp.spec, scl=scl)
        assert [(o.kind, o.level, o.t0) for o in pj.ops] == \
            [(o.kind, o.level, o.t0) for o in pt.ops]
    for kj, kt in zip(jp.spec.kernels, tp.spec.kernels):
        assert np.array_equal(kj, kt)


def test_sequences_copied_byte_for_byte():
    """Every mask of the JAX package is in the port byte for byte; the one
    mask the port has beyond them is its own mixed_n1024_k528 (preset
    mixed_n1024_scl32, built by the port's construct_mc)."""
    src = ROOT / "polar_tpu" / "models" / "sequences"
    dst = ROOT / "polar_tpu_torch" / "models" / "sequences"
    names = sorted(p.name for p in src.glob("*.npy"))
    ported = {p.name for p in dst.glob("*.npy")}
    assert set(names) <= ported and len(names) == 4
    assert ported - set(names) == {"mixed_n1024_k528.npy"}
    for n in names:
        assert (src / n).read_bytes() == (dst / n).read_bytes()


def test_crc_generator_and_golden_loader_equal():
    jcrc, tcrc = j_polar.CrcSpec(16, 0x1021, 0xFFFF), t_polar.CrcSpec(16, 0x1021, 0xFFFF)
    assert np.array_equal(jcrc.generator_matrix(33), tcrc.generator_matrix(33))
    assert np.array_equal(jcrc.offset_bits(33), tcrc.offset_bits(33))
    rec = ROOT / "results" / "golden_ca_scl_b256.npz"
    js, jl, jx, ju = j_golden.load_golden(rec)
    ts, tl, tx, tu = t_golden.load_golden(rec)
    assert ts == t_polar.spec_from_reference(js) == \
        t_polar.spec_from_reference(np.load(rec))
    assert jl == tl and np.array_equal(jx, tx) and np.array_equal(ju, tu)
