"""The depth-1 subtree route of the port (CPU): `build_scl_decoder(
subtree_backend="pallas")` against the JAX XLA decoder and against the
port's own default walk, the subtree contract `build_plain_subtree` against
the JAX package's subtree kernel `core_sub` (Pallas interpret mode), the
merge scan `subtree_items`, and the replay of the mixed-kernel golden file.

Mirrors tests/test_subtree.py at N <= 128. u, payload and crc_ok must equal
JAX's; pm is held to allclose(rtol=1e-6, atol=1e-5), the rule of
tests/test_torch_scl.py. The route runs the default walk's ops in the
same order on the CPU, so against it every field, pm included, is equal."""
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.models.polar import CodeSpec as JCodeSpec
from polar_tpu.models.polar import CrcSpec as JCrcSpec
from polar_tpu.ops.pallas_scl import build_pallas_scl_kernel
from polar_tpu.ops.scl import build_scl_decoder as j_build_scl_decoder
from polar_tpu_torch.models.polar import spec_from_reference
from polar_tpu_torch.models.presets import mixed_scl32
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops import scl as t_scl
from polar_tpu_torch.ops.program import (build_program, subtree_items,
                                         subtree_spec)
from polar_tpu_torch.sim.golden import load_golden
from tests.test_pallas_scl import _mixed_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
CRC8 = JCrcSpec(8, 0x07, 0)
BATCH = 64

# (factors, K, L, crc): tests/test_subtree.py's specs at N <= 128
SPECS = [((2, 2, 2, 2, 2), 12, 2, None), ((2, 2, 2, 2, 2), 12, 4, CRC8),
         ((16, 2, 2), 20, 8, CRC8), ((2, 16, 2), 14, 4, CRC8),
         ((2, 16, 2), 14, 32, CRC8), ((16, 2, 2), 24, 1, None)]


@functools.lru_cache(maxsize=None)
def _jax(factors, K, L, crc):
    jspec = _mixed_spec(factors, K, crc)
    return jspec, jax.jit(j_build_scl_decoder(jspec, L))


def _llrs(N, L):
    return (3.0 * np.random.default_rng(N + L + 31).standard_normal(
        (BATCH, N))).astype(np.float32)


def _equal(a, b):
    for f in ("u", "payload", "crc_ok", "pm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("big_stage", ["xla", "pallas"])
@pytest.mark.parametrize("factors,K,L,crc", SPECS)
def test_subtree_route_matches_jax(factors, K, L, crc, big_stage):
    """With either stage route; on the CPU the decoder walks eagerly (no
    CUDA graph) with its host tables uploaded once."""
    jspec, jdec = _jax(factors, K, L, crc)
    spec = spec_from_reference(jspec)
    x = _llrs(spec.N, L)
    ref = jdec(jnp.asarray(x))
    before = dict(cuda_scl.LAUNCHES)
    graphs = dict(t_scl.GRAPHS)
    out = t_scl.build_scl_decoder(spec, L, device="cpu",
                                  subtree_backend="pallas",
                                  big_stage_backend=big_stage)(x)
    assert t_scl.GRAPHS == graphs == {"captures": 0, "replays": 0}
    for f in ("u", "payload", "crc_ok"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    np.testing.assert_allclose(out.pm.numpy(), np.asarray(ref.pm),
                               rtol=1e-6, atol=1e-5)
    # bit for bit against the port's default walk; nothing launched
    _equal(out, t_scl.build_scl_decoder(spec, L, device="cpu")(x))
    assert cuda_scl.LAUNCHES == before
    items = subtree_items(build_program(spec, scl=L > 1), spec)
    assert any(item[0] == "sub" for item in items)


def test_subtree_route_with_stage_kernel_equals_default():
    """Both knobs at "pallas" (mixed_scl32's route) on the CPU: the stage
    and subtree wrappers take their plain versions."""
    spec = spec_from_reference(_mixed_spec((2, 16, 2), 14, CRC8))
    x = _llrs(spec.N, 4)
    both = t_scl.build_scl_decoder(spec, 4, device="cpu", subtree_backend="pallas",
                                   big_stage_backend="pallas")
    _equal(both(x), t_scl.build_scl_decoder(spec, 4, device="cpu")(x))
    traj = t_scl.build_plain_scl_decoder(spec, 4, trajectory=True, subtree=True)
    ref = t_scl.build_plain_scl_decoder(spec, 4, trajectory=True)
    for a, b in zip(traj(torch.as_tensor(x)), ref(torch.as_tensor(x))):
        assert torch.equal(a, b)


def _contract_inputs(P, N, B, seed):
    """Diverged paths: a different LLR row and metric for every path, on a
    1/8 grid so that every metric sum is exact in float32 whatever its
    order."""
    rng = np.random.default_rng(seed)
    lam = np.round(8 * 2.5 * rng.standard_normal((P, N, B))) / 8
    pm = np.round(8 * 3.0 * rng.random((P, B))) / 8
    return lam.astype(np.float32), pm.astype(np.float32)


@pytest.mark.parametrize("factors,K,L,child", [
    ((2, 2, 2, 2, 2), 12, 2, 1),
    ((2, 16, 2), 14, 2, 0),          # an l > 2 child
])
def test_plain_subtree_matches_jax_core_sub(factors, K, L, child):
    """build_plain_subtree against the JAX package's core_sub on one child:
    bits, perms, netp, the root re-encode x and pm' all exact."""
    jspec = _mixed_spec(factors, K, None)
    spec = spec_from_reference(jspec)
    n1 = spec.block_sizes[1]
    fr = tuple(int(v) for v in spec.frozen[child * n1:(child + 1) * n1])
    sub = subtree_spec(spec, fr)
    assert len(t_scl.trajectory_spans(sub, L)) > 2
    jsub = JCodeSpec(N=sub.N, K=sub.K, factors=sub.factors,
                     frozen_mask=sub.frozen_mask, crc=None)
    core_j, spans_j = build_pallas_scl_kernel(jsub, L, subtree=True,
                                              interpret=True)
    lam, pm = _contract_inputs(L, sub.N, 128, seed=child)
    bits, perms, netp, x, pmo = (np.asarray(v) for v in core_j(
        jnp.asarray(lam), jnp.asarray(pm)))
    got = t_scl.build_plain_subtree(sub, L)(torch.as_tensor(lam), torch.as_tensor(pm))
    assert [(int(t), int(n)) for t, n, *_ in spans_j] == t_scl.trajectory_spans(sub, L)
    assert np.array_equal(got[0].numpy(), bits)
    assert np.array_equal(got[1].numpy(), perms)
    assert np.array_equal(got[2].numpy(), netp)
    assert np.array_equal(got[3].numpy(), np.moveaxis(x, 0, 1))
    assert np.array_equal(got[4].numpy(), pmo)
    assert (got[2].numpy() != np.arange(L)[:, None]).any()   # paths moved


def test_subtree_kernel_wrapper_on_cpu():
    """SubtreeKernel takes a CPU tensor to build_plain_subtree, launches
    nothing, and checks its inputs."""
    spec = spec_from_reference(_mixed_spec((2, 16, 2), 14, CRC8))
    fr = tuple(int(v) for v in spec.frozen[:32])
    core = cuda_scl.SubtreeKernel(subtree_spec(spec, fr), 4)
    lam, pm = _contract_inputs(4, 32, 16, seed=3)
    lam, pm = torch.as_tensor(lam), torch.as_tensor(pm)
    before = cuda_scl.LAUNCHES["scl_subtree"]
    for a, b in zip(core(lam, pm), t_scl.build_plain_subtree(core.spec, 4)(lam, pm)):
        assert torch.equal(a, b)
    assert cuda_scl.LAUNCHES["scl_subtree"] == before
    assert core.spans == t_scl.trajectory_spans(core.spec, 4)
    with pytest.raises(ValueError):
        core(lam[:, :16], pm)
    with pytest.raises(ValueError):
        core(lam, pm[:2])


def test_subtree_items_mixed_scl32():
    """mixed_scl32 (16x16 eBCH then four 2x2 stages, L=32): 912 ops walk as
    32 items, 13 depth-1 children through the subtree kernel (each with
    its own frozen slice) and 3 that collapse to a single node."""
    spec = mixed_scl32().spec
    program = build_program(spec, scl=True)
    items = subtree_items(program, spec)
    assert len(program.ops) == 912 and len(items) == 32
    subs = [item for item in items if item[0] == "sub"]
    assert len(subs) == 13 and len({item[2] for item in subs}) == 13
    kinds = [program.ops[item[1]].kind for item in items if item[0] == "op"]
    downs = [k for k in kinds if k in ("DOWN_FRESH", "DOWN_DYN")]
    assert len(downs) == 16
    assert sorted(k for k in kinds if k not in downs) == ["R0", "R1", "REP"]
    # every op is walked once: the subs cover their children's ops
    covered = sum(1 for item in items if item[0] == "op")
    for _, t0, fr in subs:
        covered += len(build_program(subtree_spec(spec, fr), scl=True).ops) + 1
    assert covered == len(program.ops)


@pytest.mark.parametrize("subtree", ["none", "pallas"])
def test_golden_mixed_replay(subtree):
    """results/golden_mixed_scl_b128.npz: 128 frames of N=512, factors
    (16,2,2,2,2,2), K=256 + CRC-16, L=8, from the independent C++ decoder,
    through the plain decoder and the subtree route (Arikan children)."""
    spec, L, llrs, u_ref = load_golden(ROOT / "results" / "golden_mixed_scl_b128.npz")
    assert spec.factors == (16, 2, 2, 2, 2, 2) and L == 8
    out = t_scl.build_scl_decoder(spec, L, device="cpu", subtree_backend=subtree)(llrs)
    assert out.u.shape == (128, 512)
    assert int((out.u.numpy() != u_ref).any(axis=1).sum()) == 0


def test_sweep_routes_with_subtree_count_the_same(capsys):
    """run_sweep's torch backend through the subtree route (with and
    without the stage kernel) counts what the default route counts on the
    same keys, and `sweep_cli --subtree pallas` reaches it."""
    import json

    from polar_tpu_torch.models.presets import Preset
    from polar_tpu_torch.sim import harness, sweep_cli

    spec = spec_from_reference(_mixed_spec((2, 16, 2), 14, CRC8))
    preset = Preset("mixed_small", spec, 4, (1.0, 2.5), 96, 48)
    kw = dict(device="cpu", progress=False, seed=5, backend="torch")
    runs = [harness.run_sweep(preset, **kw),
            harness.run_sweep(preset, subtree_backend="pallas", **kw),
            harness.run_sweep(preset, subtree_backend="pallas",
                              big_stage_backend="pallas", **kw)]
    for recs in runs[1:]:
        for a, b in zip(runs[0], recs):
            assert (a["frames"], a["frame_errors"], a["bit_errors"]) == \
                (b["frames"], b["frame_errors"], b["bit_errors"])
    assert runs[0][0]["frame_errors"] > 0
    with pytest.raises(ValueError):
        harness.make_mc_step(spec, 4, device="cpu", subtree_backend="xla")
    args = ["--preset", "bch_sc", "--snr", "2.0", "--frames", "32",
            "--per-device-batch", "32", "--device", "cpu", "--seed", "4"]
    sweep_cli.main(args + ["--subtree", "pallas"])
    sub = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sweep_cli.main(args)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sub == ref and sub["summary"][0]["frames"] == 32


@pytest.mark.slow
def test_mixed_scl32_top_stages_match_jax():
    """mixed_scl32's two 16x16 eBCH stages at L=32 with CRC-16, over one
    2x2 stage (N=512): the port's decoder against the JAX XLA decoder on
    64 frames (~100 s: JAX compiles the unrolled L=32 program)."""
    jspec = _mixed_spec((16, 16, 2), 200, JCrcSpec(16, 0x1021, 0))
    x = (2.0 * np.random.default_rng(5).standard_normal((64, jspec.N))
         + 0.8).astype(np.float32)
    ref = jax.jit(j_build_scl_decoder(jspec, 32))(jnp.asarray(x))
    spec = spec_from_reference(jspec)
    for route in ("none", "pallas"):
        out = t_scl.build_scl_decoder(spec, 32, device="cpu",
                                      subtree_backend=route)(x)
        for f in ("u", "payload", "crc_ok"):
            assert np.array_equal(getattr(out, f).numpy(),
                                  np.asarray(getattr(ref, f))), f
        np.testing.assert_allclose(out.pm.numpy(), np.asarray(ref.pm),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.slow
def test_mixed_scl32_frames_match_jax_at_1p25db():
    """mixed_scl32 (N=4096, K=2048 + CRC-16, L=32) at 1.25 dB: 256 of the
    port's Monte-Carlo frames (`mc_draw`, 16 steps of 16) through the
    port's plain subtree route and through the JAX XLA decoder of the
    JAX package's own preset, frame by frame (u, crc_ok); pm to the
    suite's tolerance. JAX compiles the unrolled L=32 program once (~6 min,
    ~11 GB), then ~0.6 s a frame; the port's route ~2 s a frame."""
    from polar_tpu.models.presets import mixed_scl32 as j_mixed_scl32
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.sim.channel import ebn0_to_sigma

    jpreset, preset = j_mixed_scl32(), mixed_scl32()
    spec = preset.spec
    assert spec == spec_from_reference(jpreset.spec)
    sigma = float(ebn0_to_sigma(1.25, spec.rate))
    ref_dec = jax.jit(j_build_scl_decoder(jpreset.spec, 32))
    route = t_scl.build_scl_decoder(spec, 32, device="cpu", subtree_backend="pallas")
    errors = [0, 0]
    for k in range(16):
        u_true, llr = mc_draw(spec, step_seed(2026, 0, k, 0), sigma, 16, "cpu")
        ref = ref_dec(jnp.asarray(llr.numpy()))
        out = route(llr)
        assert np.array_equal(out.u.numpy(), np.asarray(ref.u)), k
        assert np.array_equal(out.crc_ok.numpy(), np.asarray(ref.crc_ok)), k
        np.testing.assert_allclose(out.pm.numpy(), np.asarray(ref.pm),
                                   rtol=1e-6, atol=1e-5)
        errors[0] += int((out.u != u_true).any(dim=1).sum())
        errors[1] += int((np.asarray(ref.u) != u_true.numpy()).any(axis=1).sum())
    assert errors[0] == errors[1]
    print(f"mixed_scl32 at 1.25 dB: 256 frames, {errors[0]} frame errors on "
          f"both sides")
