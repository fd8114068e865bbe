"""Genie Monte-Carlo construction in the port (CPU): the genie decoder and
the per-leaf counts against the JAX package's genie decoder on the same
LLRs, the masks against GA and against the JAX package's construct_mc
(tests/test_construction.py's bounds), and the presets' fall-back to it.

The two packages draw different noise (the port's Philox stream, JAX's
jax.random), so their masks agree on the ranking, not frame for frame;
on the same LLRs their counts are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.construction.montecarlo import construct_mc as j_construct_mc
from polar_tpu.models.polar import CodeSpec as JCodeSpec
from polar_tpu.ops.scl import build_scl_decoder as j_build_scl_decoder
from polar_tpu_torch.construction import montecarlo as t_mc
from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.models import presets as t_presets
from polar_tpu_torch.ops import scl as t_scl
from polar_tpu_torch.sim.channel import ebn0_to_sigma


def _jax_genie(factors):
    N = int(np.prod(factors))
    spec = JCodeSpec(N=N, K=0, factors=tuple(factors), frozen_mask=(1,) * N,
                     crc=None)
    return jax.jit(j_build_scl_decoder(spec, 1, genie=True))


@pytest.mark.parametrize("factors", [(2,) * 6, (16,), (16, 2)])
def test_genie_decoder_matches_jax(factors):
    N = int(np.prod(factors))
    rng = np.random.default_rng(N)
    sigma = 0.9
    llr = (2.0 * (1.0 + sigma * rng.standard_normal((64, N))) / sigma ** 2
           ).astype(np.float32)
    out = t_mc.genie_decoder(factors, torch.device("cpu"))(llr)
    ref = _jax_genie(factors)(jnp.asarray(llr))
    assert np.array_equal(out.u.numpy(), np.asarray(ref.u))
    assert np.array_equal(out.payload.numpy(), np.asarray(ref.payload))
    assert out.u.sum() > 0


@pytest.mark.parametrize("factors", [(2,) * 6, (16, 2)])
def test_leaf_error_rates_equal_jax_counts_on_the_same_llrs(factors):
    """mc_leaf_error_rates over three batches equals the counts of the
    JAX genie decoder on the batches' LLRs (`genie_llrs`, which the port's
    loop draws), both counted by `leaf_error_counts`."""
    N = int(np.prod(factors))
    batch, batches, seed = 256, 3, 5
    sigma = float(ebn0_to_sigma(2.0, 0.5))
    jdec = _jax_genie(factors)

    def jax_decode(llr):
        return t_scl.DecodeResult(*(torch.as_tensor(np.array(t)) for t in
                                    jdec(jnp.asarray(llr.numpy()))))

    want = sum(t_mc.leaf_error_counts(
        jax_decode, t_mc.genie_llrs(N, sigma, seed, k, batch, "cpu")).numpy()
        for k in range(batches))
    got = t_mc.mc_leaf_error_rates(factors, 2.0, 0.5, frames=batches * batch - 1,
                                   batch=batch, seed=seed, device="cpu")
    np.testing.assert_array_equal(got * (batches * batch), want)
    assert want.sum() > 0


def test_ga_matches_mc_arikan():
    fg = construct_ga(64, 32, 2.0)
    fm = t_mc.construct_mc((2,) * 6, 32, 2.0, frames=1 << 13, seed=0,
                           device="cpu")
    assert fm.sum() == 32
    # the two methods may disagree on a few borderline subchannels
    assert (fg == fm).mean() >= 0.9


def test_mc_bch_kernel_runs():
    mask = t_mc.construct_mc((16,), 8, 2.0, frames=1 << 10, seed=1,
                             device="cpu")
    assert mask.sum() == 8
    # input 15 of the eBCH kernel (partial distance 16) must be unfrozen
    assert mask[15] == 0
    # input 0 (partial distance 1) must be frozen at rate 1/2
    assert mask[0] == 1


def test_mc_matches_jax_construct_mc():
    fj = j_construct_mc((2,) * 6, 32, 2.0, frames=1 << 13, seed=0)
    ft = t_mc.construct_mc((2,) * 6, 32, 2.0, frames=1 << 13, seed=0,
                           device="cpu")
    assert (fj == ft).mean() >= 0.9


def test_presets_fall_back_to_construct_mc(tmp_path, monkeypatch):
    """Without its artifact a non-Arikan mask is built by construct_mc on
    the device asked for (the card by default); the committed artifacts
    still load first."""
    committed = t_presets._load_mask("bch_n256_k128", (16, 16), 128)
    assert committed == tuple(int(v) for v in
                              np.load(t_presets._SEQ_DIR / "bch_n256_k128.npy"))
    monkeypatch.setattr(t_presets, "_SEQ_DIR", tmp_path)
    mask = t_presets._load_mask("bch_n16_k8", (16,), 8, device="cpu")
    assert mask == tuple(int(v) for v in
                         t_mc.construct_mc((16,), 8, 2.0, device="cpu"))
    assert len(mask) - sum(mask) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_presets._load_mask("bch_n16_k8", (16,), 8)
