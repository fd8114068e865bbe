"""The port's decoder knobs (genie, fast, fast_r1_scl, llr_dtype, unroll,
f_mode, pm_mode) against the JAX package's XLA `build_scl_decoder` with
the same knobs, on the same numpy frames (the cases of tests/test_knobs.py
and more; the reference is the JAX decoder, not oracle.py, which the JAX
suite holds to it).

u, payload and crc_ok must be equal to JAX's. pm: allclose(rtol=1e-6,
atol=1e-5) for min-sum f and the |llr| metric (the rule of
tests/test_torch_scl.py); rtol=1e-5 for f_mode="exact" and
pm_mode="smooth", whose exp / log1p come from XLA's CPU code in JAX and
from libm in PyTorch (up to 3 ulp apart, `test_smooth_penalty_*`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.ops.scl import build_scl_decoder as j_build_scl_decoder
from polar_tpu_torch.models.polar import spec_from_reference
from polar_tpu_torch.ops import scl as t_scl
from tests.test_decoders import _noisy_frames, _spec
from tests.test_knobs import KNOB_CONFIGS

B = 32


@functools.lru_cache(maxsize=None)
def _jax_decoder(spec, L, **kw):
    return jax.jit(j_build_scl_decoder(spec, L, **kw))


def _port(spec, L, **kw):
    return t_scl.build_scl_decoder(spec_from_reference(spec), L, device="cpu", **kw)


def _assert_matches(out, ref, rtol=1e-6):
    for f in ("u", "payload", "crc_ok"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    np.testing.assert_allclose(out.pm.numpy(), np.asarray(ref.pm), rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("factors,K,L,f_mode,pm_mode", KNOB_CONFIGS)
def test_knob_configs_match_jax(factors, K, L, f_mode, pm_mode):
    spec = _spec(factors, K, seed=5)
    _, llr = _noisy_frames(spec, B, seed=21)
    dec = _port(spec, L, f_mode=f_mode, pm_mode=pm_mode)
    assert isinstance(dec, t_scl.ProgramDecoder)
    assert dec.route.startswith("op program, knobs")
    ref = _jax_decoder(spec, L, f_mode=f_mode, pm_mode=pm_mode)(jnp.asarray(llr))
    _assert_matches(dec(llr), ref, rtol=1e-5)


@pytest.mark.parametrize("knob", [{"fast": False}, {"fast_r1_scl": False},
                                  {"unroll": False}], ids=str)
@pytest.mark.parametrize("factors,K,L", [((2,) * 5, 12, 4), ((16, 2), 16, 2)])
def test_program_knobs_match_jax(factors, K, L, knob):
    """The unclassified program, the leaf-sequential R1 forks and the JAX
    package's fori_loop program (whose results its docstring calls
    bit-identical to the unrolled one; the port has only that form)."""
    spec = _spec(factors, K, seed=5)
    _, llr = _noisy_frames(spec, B, seed=21)
    ref = _jax_decoder(spec, L, **knob)(jnp.asarray(llr))
    _assert_matches(_port(spec, L, **knob)(llr), ref)


@pytest.mark.parametrize("factors,K", [((2,) * 6, 20), ((16,), 8), ((16, 2), 16)])
def test_genie_matches_jax(factors, K):
    spec = _spec(factors, K, seed=5)
    _, llr = _noisy_frames(spec, B, noise=2.5, seed=21)
    ref = _jax_decoder(spec, 1, genie=True)(jnp.asarray(llr))
    out = _port(spec, 1, genie=True)(llr)
    _assert_matches(out, ref)
    assert out.u.sum() > 0                  # the leaves' errors, not zeros


def test_knobs_change_decisions():
    """The knobs flip decisions on noisy frames, as JAX's do (they are
    wired through, not ignored)."""
    spec = _spec((2, 2, 2, 2, 2), 16, seed=2)
    _, llr = _noisy_frames(spec, 64, noise=2.5, seed=3)
    outs = {}
    for name, kw in (("base", {}), ("exact", {"f_mode": "exact"}),
                     ("smooth", {"pm_mode": "smooth"})):
        outs[name] = _port(spec, 4, **kw)(llr)
        _assert_matches(outs[name], _jax_decoder(spec, 4, **kw)(jnp.asarray(llr)),
                        rtol=1e-5)
    assert (outs["base"].u != outs["exact"].u).any()
    assert (outs["base"].u != outs["smooth"].u).any()


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_smooth_penalty_matches_jax_softplus():
    """pm_mode="smooth"'s penalty is jax.nn.softplus(-lam) =
    logaddexp(-lam, 0), written in that form (torch's softplus is
    another). Exact at 0, +-20, +-30 and +-inf; elsewhere within 3 ulp of
    JAX (XLA's CPU exp/log1p against libm) and within 1 ulp of the
    float64 value, which JAX's misses by up to 3."""
    rng = np.random.default_rng(0)
    points = np.array([0.0, -0.0, 20.0, -20.0, 30.0, -30.0, np.inf, -np.inf],
                      np.float32)
    lam = np.concatenate([points, rng.normal(0, 8, 20000),
                          rng.uniform(-40, 40, 20000)]).astype(np.float32)
    got = t_scl.pen_smooth(torch.as_tensor(lam)).numpy()
    want = np.asarray(jax.nn.softplus(-jnp.asarray(lam)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:len(points)], want[:len(points)])
    truth = np.logaddexp(-lam[len(points):].astype(np.float64), 0.0)
    normal = truth > np.finfo(np.float32).tiny   # XLA flushes subnormals to 0
    g, w = got[len(points):][normal], want[len(points):][normal]
    assert _ulps(g, w).max() <= 3
    assert _ulps(g, truth[normal].astype(np.float32)).max() <= 1
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("factors,K,L", [((2,) * 7, 56, 4), ((16, 2), 16, 2)])
def test_llr_dtype_bfloat16_matches_jax(factors, K, L):
    """tests/test_knobs.py::test_llr_dtype_bfloat16 against JAX's bfloat16
    decoder: noiseless frames decode exactly; on noisy frames the
    decisions equal JAX's on every frame (measured on these 64 frames;
    XLA may keep excess float32 precision between bfloat16 ops where
    PyTorch rounds each) and the FER keeps that test's bound against
    float32."""
    spec = _spec(factors, K, seed=5)
    dec16 = _port(spec, L, llr_dtype=torch.bfloat16)
    u0, llr0 = _noisy_frames(spec, 64, noise=0.0, seed=3)
    assert np.array_equal(dec16(llr0).u.numpy(), u0)
    u, llr = _noisy_frames(spec, 64, noise=1.0, seed=11)
    o16 = dec16(llr)
    ref16 = _jax_decoder(spec, L, llr_dtype=jnp.bfloat16)(jnp.asarray(llr))
    o32 = _port(spec, L)(llr)
    assert o16.u.dtype == o32.u.dtype and o16.u.shape == o32.u.shape
    assert (o16.u.numpy() == np.asarray(ref16.u)).all(axis=1).mean() == 1.0
    _assert_matches(o16, ref16)
    fer32 = float((o32.u.numpy() != u).any(axis=1).mean())
    fer16 = float((o16.u.numpy() != u).any(axis=1).mean())
    assert abs(fer16 - fer32) <= 0.05 + 0.5 * fer32, (fer16, fer32)
    assert (o16.u == o32.u).all(dim=1).float().mean() >= 0.9


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("L,kw", [
    (2, {"genie": True}), (1, {"pm_mode": "hard"}), (1, {"f_mode": "tanh"}),
    (1, {"genie": True, "subtree_backend": "pallas"}),
    (2, {"f_mode": "exact", "subtree_backend": "pallas"}),
    (2, {"pm_mode": "smooth", "subtree_backend": "pallas"}),
    (2, {"unroll": False, "subtree_backend": "pallas"}),
    (2, {"llr_dtype": "bfloat16", "subtree_backend": "pallas"})], ids=str)
def test_refusals_match_jax(L, kw):
    """The JAX package's refusals, with its messages."""
    spec = _spec((2,) * 4, 6, seed=5)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("llr_dtype"):
        jkw["llr_dtype"], tkw["llr_dtype"] = jnp.bfloat16, torch.bfloat16
    want = _message(lambda: j_build_scl_decoder(spec, L, **jkw))
    assert _message(lambda: _port(spec, L, **tkw)) == want


def test_subtree_refuses_every_knob():
    """The subtree kernel takes defaults only; fast and fast_r1_scl are
    refused too (JAX builds the outer program unclassified and the
    children classified)."""
    spec = spec_from_reference(_spec((2,) * 4, 6, seed=5))
    for kw in ({"fast": False}, {"fast_r1_scl": False}):
        with pytest.raises(ValueError, match="default-mode program"):
            t_scl.build_scl_decoder(spec, 2, device="cpu",
                                    subtree_backend="pallas", **kw)
