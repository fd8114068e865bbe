"""eBCH and mixed-kernel polar codes in the port (CPU): the plain decoder
against the JAX XLA decoder, the hybrid route (`big_stage_backend=
"pallas"`) against the default one, the Monte-Carlo harness's three routes
against each other, and the decode kernels' host tables for bch_sc.

u, payload and crc_ok must be equal to JAX's; pm is held to
allclose(rtol=1e-6, atol=1e-5), the rule of tests/test_torch_scl.py (the
JAX decoder's R0/REP sums reduce in a backend-defined order). The hybrid
route runs the same floats on the CPU, so it is held bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.models import presets as j_presets
from polar_tpu.models.polar import CrcSpec as JCrcSpec
from polar_tpu.ops.scl import build_scl_decoder as j_build_scl_decoder
from polar_tpu_torch.models.polar import spec_from_reference
from polar_tpu_torch.models.presets import Preset, bch_sc
from polar_tpu_torch.ops import cuda_stage
from polar_tpu_torch.ops import scl as t_scl
from polar_tpu_torch.ops.cuda_scl import build_tables
from polar_tpu_torch.ops.program import staged_inverse_kernels
from polar_tpu_torch.sim import harness
from polar_tpu_torch.utils.gf2 import gf2_inverse, gf2_kron
from tests.test_pallas_scl import _mixed_spec

CRC8 = JCrcSpec(8, 0x07, 0)
BATCH = 64

# (factors, K, L, crc): pure eBCH, BCH-major and Arikan-major mixed, and
# the mixed_scl32 kernel mix at L = 8 and 32 with a CRC
SPECS = [((16,), 6, 1, None), ((16,), 6, 4, None), ((16, 2), 12, 2, None),
         ((2, 16), 10, 4, CRC8), ((16, 2, 2), 20, 8, CRC8),
         ((16, 2, 2), 20, 32, CRC8)]


@functools.lru_cache(maxsize=None)
def _jax(factors, K, L, crc):
    jspec = _mixed_spec(factors, K, crc)
    return jspec, jax.jit(j_build_scl_decoder(jspec, L))


def _llrs(N, L, kind):
    rng = np.random.default_rng(N * 10 + L)
    x = 2.0 * rng.standard_normal((BATCH, N)) + 0.3
    if kind == "int":
        x = np.round(x)          # integer LLRs: metric and position ties
    return x.astype(np.float32)


def _assert_matches(out, ref):
    for f in ("u", "payload", "crc_ok"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    np.testing.assert_allclose(out.pm.numpy(), np.asarray(ref.pm),
                               rtol=1e-6, atol=1e-5)


def _equal(a, b):
    for f in ("u", "payload", "crc_ok", "pm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("kind", ["gauss", "int"])
@pytest.mark.parametrize("factors,K,L,crc", SPECS)
def test_plain_matches_jax(factors, K, L, crc, kind):
    jspec, jdec = _jax(factors, K, L, crc)
    x = _llrs(jspec.N, L, kind)
    ref = jdec(jnp.asarray(x))
    spec = spec_from_reference(jspec)
    _assert_matches(t_scl.build_plain_scl_decoder(spec, L)(torch.as_tensor(x)), ref)


@pytest.mark.parametrize("factors,K,L,crc", SPECS)
def test_hybrid_route_equals_default(factors, K, L, crc):
    """build_scl_decoder(big_stage_backend="pallas") on the CPU: the stage
    kernel's wrapper takes the plain version, so the hybrid equals the
    default decoder bit for bit, pm included, and launches nothing."""
    spec = spec_from_reference(_mixed_spec(factors, K, crc))
    x = _llrs(spec.N, L, "gauss")
    before = cuda_stage.LAUNCHES["stage_down"]
    hybrid = t_scl.build_scl_decoder(spec, L, device="cpu",
                                     big_stage_backend="pallas")
    _equal(hybrid(x), t_scl.build_scl_decoder(spec, L, device="cpu")(x))
    assert cuda_stage.LAUNCHES["stage_down"] == before


def test_apply_inverse_general():
    """u = x (K_{d+1} (x) ... (x) K_m)^-1, stage by stage, equals the
    product with the inverse of the whole Kronecker factor."""
    spec = spec_from_reference(_mixed_spec((2, 16, 2), 8, None))
    rng = np.random.default_rng(1)
    inv = staged_inverse_kernels(spec)
    for d in (1, 2):
        g = np.array([[1]], np.uint8)
        for k in spec.kernels[d:]:
            g = gf2_kron(g, k)
        n = g.shape[0]
        x = rng.integers(0, 2, (3, n, 5)).astype(np.int8)
        got = t_scl.apply_inverse(torch.as_tensor(x),
                                  [k.astype(np.uint8) for k in inv[d:]])
        ref = np.einsum("pnb,nk->pkb", x.astype(np.int64),
                        gf2_inverse(g).astype(np.int64)) % 2
        assert np.array_equal(got.numpy(), ref), d


def test_kernel_tables_for_bch_sc():
    """The decode kernels' host tables for bch_sc (N = 256 = 16 x 16, L = 1):
    224 ops, the per-stage buffers of the l > 2 layout, and the trellis
    tables of the 16x16 kernel (the kernels run on the card:
    tests/test_torch_cuda.py)."""
    spec = bch_sc().spec
    t = build_tables(spec, 1)
    kinds = np.bincount(t["ops"][:, 0], minlength=9)
    # DOWN_FRESH, DOWN_DYN, UP, R0, REP, R1, SPC, LEAF, frozen LEAF
    assert list(kinds) == [7, 105, 6, 51, 1, 3, 2, 49, 0]
    assert t["ops"].shape == (224, 4) and t["Q"] == 106
    assert t["big"] == 1
    assert (t["n_lam"], t["n_dec"], t["n_maps"]) == (17, 272, 34)
    assert build_tables(spec, 8)["n_maps"] == 34 * 8
    # DOWN ops carry their kernel input i: 35 trellis, 70 table, 7 i = 15
    down = t["ops"][t["ops"][:, 0] <= 1]
    i = down[:, 3]
    assert (int((i < 5).sum()), int(((i >= 5) & (i < 15)).sum()),
            int((i == 15).sum())) == (35, 70, 7)
    arikan = spec_from_reference(_mixed_spec((2, 2, 2, 2), 6, None))
    assert build_tables(arikan, 2)["big"] == 0


def test_full_size_bch_sc_decodes_on_cpu():
    """bch_sc decodes at full size in the port (the JAX comparison at this
    size is the slow test below): N = 256 frames come back decided."""
    spec = bch_sc().spec
    x = _llrs(spec.N, 1, "gauss")[:8] + 2.0
    out = t_scl.build_scl_decoder(spec, 1, device="cpu")(x)
    assert out.u.shape == (8, 256) and out.payload.shape == (8, 128)
    assert torch.isfinite(out.pm).all()


@pytest.mark.slow
@pytest.mark.parametrize("L", [1, 8])
def test_full_size_bch_sc_matches_jax(L):
    jspec = j_presets.bch_sc().spec
    x = _llrs(jspec.N, L, "gauss")
    ref = jax.jit(j_build_scl_decoder(jspec, L))(jnp.asarray(x))
    out = t_scl.build_plain_scl_decoder(spec_from_reference(jspec), L)(
        torch.as_tensor(x))
    _assert_matches(out, ref)


def test_sweep_routes_count_the_same():
    """run_sweep of bch_sc on the CPU, on the same keys: the torch backend,
    the fused step and the hybrid (torch + big_stage_backend="pallas")
    count the same frame and bit errors."""
    preset = Preset("bch_sc", bch_sc().spec, 1, (1.0, 2.0), 128, 64)
    kw = dict(device="cpu", progress=False, seed=3)
    runs = [harness.run_sweep(preset, backend="torch", **kw),
            harness.run_sweep(preset, backend="fused", **kw),
            harness.run_sweep(preset, backend="torch",
                              big_stage_backend="pallas", **kw)]
    for recs in runs[1:]:
        for a, b in zip(runs[0], recs):
            assert (a["frames"], a["frame_errors"], a["bit_errors"]) == \
                (b["frames"], b["frame_errors"], b["bit_errors"])
    assert runs[0][0]["frames"] == 128 and runs[0][0]["frame_errors"] > 0


def test_sweep_cli_big_stage_on_cpu(capsys):
    """`sweep_cli --preset bch_sc --big-stage pallas` reaches the hybrid
    decoder and counts what `--backend fused` counts."""
    import json

    from polar_tpu_torch.sim import sweep_cli

    args = ["--preset", "bch_sc", "--snr", "1.5", "--frames", "64",
            "--per-device-batch", "64", "--device", "cpu", "--seed", "9"]
    sweep_cli.main(args + ["--big-stage", "pallas"])
    hybrid = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sweep_cli.main(args + ["--backend", "fused"])
    fused = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert hybrid == fused and hybrid["summary"][0]["frames"] == 64
