"""The port's numpy oracle (polar_tpu_torch/oracle.py), the port's ground
truth: equal to the JAX package's oracle, survivor paths and float64 path
metrics included, on the configurations of tests/test_decoders.py and
tests/test_knobs.py; and the port's plain decoder on the CPU equal to the
port's oracle (u), the counterpart of `test_device_matches_oracle` and
`test_knobs_match_oracle`. The frames are made by the port alone (numpy
draws, the port's generator matrix) and fed to both oracles."""
import functools

import numpy as np
import pytest
import torch

from polar_tpu import oracle as j_oracle
from polar_tpu_torch import oracle as t_oracle
from polar_tpu_torch.models.polar import CodeSpec, CrcSpec, spec_from_reference
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.utils.gf2 import gf2_matmul
from tests.test_decoders import CONFIGS, _spec
from tests.test_knobs import KNOB_CONFIGS

# factors, K, L, crc, f_mode, pm_mode, spec seed: test_decoders' CONFIGS
# (spec seed 0) and test_knobs' KNOB_CONFIGS (spec seed 5, no CRC)
CASES = ([(f, K, L, crc, "minsum", "abs", 0) for f, K, L, crc in CONFIGS]
         + [(f, K, L, None, fm, pm, 5) for f, K, L, fm, pm in KNOB_CONFIGS])
IDS = [f"{c[0]}-K{c[1]}-L{c[2]}-{'crc' if c[3] else 'nocrc'}-{c[4]}-{c[5]}"
       for c in CASES]
FRAMES = 4


def _decode(oracle, spec, llr, L, f_mode, pm_mode):
    """SC decisions at L=1, else every survivor (pm, path) and the CRC
    selection among them (what `scl_decode` returns without return_all)."""
    if L == 1:
        return oracle.sc_decode(spec, llr, f_mode=f_mode)
    paths = oracle.scl_decode(spec, llr, L, return_all=True, f_mode=f_mode,
                              pm_mode=pm_mode)
    return paths, np.array(oracle._select_path(spec, paths)[1], np.uint8)


def _port_spec(factors, K, crc, seed):
    """tests/test_decoders.py `_spec`'s recipe in numpy alone."""
    rng = np.random.default_rng(seed)
    N = int(np.prod(factors))
    frozen = np.ones(N, np.uint8)
    frozen[rng.choice(N, K + (crc.width if crc else 0), replace=False)] = 0
    return CodeSpec(N=N, K=K, factors=factors,
                    frozen_mask=tuple(int(v) for v in frozen), crc=crc)


def _port_frames(spec, B, seed, noise=1.5):
    """Noisy LLRs of random codewords (CRC-valid where the spec has a
    CRC), encoded with the port's generator matrix; numpy draws."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, spec.K), dtype=np.uint8)
    payload = info
    if spec.crc is not None:
        g = spec.crc.generator_matrix(spec.K)
        off = spec.crc.offset_bits(spec.K).astype(np.uint8)
        payload = np.concatenate([info, gf2_matmul(info, g) ^ off], axis=1)
    u = np.zeros((B, spec.N), np.uint8)
    u[:, spec.info_positions] = payload
    x = gf2_matmul(u, spec.generator)
    llr = (1 - 2 * x.astype(np.float64)) * 2.0 + rng.normal(0, noise, x.shape)
    return llr.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _port_case(factors, K, L, crc, f_mode, pm_mode, seed):
    """The port's spec, FRAMES frames of it, and the port oracle's
    decode of each (shared by both tests of a case)."""
    if crc is not None:      # the JAX suite's CrcSpec -> the port's
        crc = CrcSpec(width=crc.width, poly=crc.poly, init=crc.init)
    spec = _port_spec(factors, K, crc, seed)
    llr = _port_frames(spec, FRAMES, seed=31)
    return spec, llr, [_decode(t_oracle, spec, x, L, f_mode, pm_mode)
                       for x in llr]


@pytest.mark.parametrize("factors,K,L,crc,f_mode,pm_mode,seed", CASES, ids=IDS)
def test_oracle_matches_jax(factors, K, L, crc, f_mode, pm_mode, seed):
    spec, llr, got_all = _port_case(factors, K, L, crc, f_mode, pm_mode, seed)
    jspec = _spec(factors, K, crc, seed=seed)
    assert spec_from_reference(jspec) == spec
    for i, got in enumerate(got_all):
        want = _decode(j_oracle, jspec, llr[i], L, f_mode, pm_mode)
        if L == 1:
            assert np.array_equal(got, want), i
            continue
        (gp, gu), (wp, wu) = got, want
        assert np.array_equal(gu, wu), i
        assert [p for _, p in gp] == [p for _, p in wp], i
        # float64 path metrics, summed in the same order: equal exactly
        assert [pm for pm, _ in gp] == [pm for pm, _ in wp], i


@pytest.mark.parametrize("factors,K,L,crc,f_mode,pm_mode,seed", CASES, ids=IDS)
def test_plain_decoder_matches_oracle(factors, K, L, crc, f_mode, pm_mode,
                                      seed):
    spec, llr, ref = _port_case(factors, K, L, crc, f_mode, pm_mode, seed)
    out = build_scl_decoder(spec, L, device="cpu", f_mode=f_mode,
                            pm_mode=pm_mode)(torch.as_tensor(llr)).u.numpy()
    for i in range(llr.shape[0]):
        want = ref[i] if L == 1 else ref[i][1]
        assert np.array_equal(out[i], want), f"frame {i} mismatch"


def test_port_frames_are_codewords_with_valid_crc():
    """The frames above come from valid codewords: without noise the
    oracle's SC and SCL decode them to payloads whose CRC checks."""
    spec = _port_spec((2, 2, 2, 2, 2), 10, CrcSpec(width=8, poly=0x07), 0)
    llr = _port_frames(spec, 4, seed=31, noise=0.0)
    for i in range(4):
        for u in (t_oracle.sc_decode(spec, llr[i]),
                  t_oracle.scl_decode(spec, llr[i], 4)):
            payload = u[spec.info_positions]
            assert np.array_equal(spec.crc.compute(payload[:spec.K]),
                                  payload[spec.K:])
