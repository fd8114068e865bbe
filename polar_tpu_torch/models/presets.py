"""Named code/benchmark presets — the five BASELINE configs and one more.

Mirrors BASELINE.json:6-12 / SURVEY.md §5 "Config / flag system": the
reference hardcodes its configs in main(); here they are named presets
with frozen sets loaded from committed artifacts
(polar_tpu/models/sequences/*.npy, regenerated by scripts/gen_sequences.py).

1. arikan_sc      — Arikan N=1024 K=512, plain SC, BPSK-AWGN [B:7]
2. ca_scl         — CRC-aided SCL L=8, N=1024 K=512 + CRC-16 [B:8]
3. bch_sc         — BCH-kernel (16x16 eBCH) N=256 K=128, trellis/maxcorr
                    kernel processing, SC [B:9]
4. mixed_scl32    — mixed-kernel N=4096 = 16*16*2^4, SCL L=32 + CRC-16 [B:10]
5. sweep          — multi-host Monte-Carlo FER sweep: 8-point Eb/N0 grid,
                    10^7 codewords, batch-sharded [B:11] (see sim.harness)
6. mixed_n1024_scl32 — config 4's kernels, CRC and list size at config 2's
                    length and rate: N=1024 = 16*16*2*2, K=512 + CRC-16,
                    SCL L=32; small enough for one thread block, so the
                    fused step (K5) decodes it (the port's own preset)
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec

_SEQ_DIR = pathlib.Path(__file__).resolve().parent / "sequences"


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    spec: CodeSpec
    list_size: int
    ebn0_grid: tuple[float, ...]
    frames: int
    batch: int


def _load_mask(name: str, factors, n_unfrozen: int,
               design_ebn0_db: float = 2.0, device="cuda") -> tuple[int, ...]:
    """The committed frozen mask `name`, or one built on the fly: GA for
    pure-Arikan kernels, else genie Monte-Carlo on `device` (the card
    unless the caller asks for the CPU)."""
    path = _SEQ_DIR / f"{name}.npy"
    if path.exists():
        mask = np.load(path)
        if int(mask.size - mask.sum()) != n_unfrozen:
            raise ValueError(f"stale sequence artifact {path}")
        return tuple(int(v) for v in mask)
    # fall back to on-the-fly construction (GA for pure-Arikan, else MC)
    N = int(np.prod(factors))
    if all(f == 2 for f in factors):
        from polar_tpu_torch.construction.ga import construct_ga
        mask = construct_ga(N, n_unfrozen, design_ebn0_db)
    else:
        from polar_tpu_torch.construction.montecarlo import construct_mc
        mask = construct_mc(tuple(factors), n_unfrozen, design_ebn0_db,
                            device=device)
    return tuple(int(v) for v in mask)


CRC16 = CrcSpec(width=16, poly=0x1021, init=0x0000)

_GRID8 = tuple(np.round(np.linspace(0.0, 3.5, 8), 4))  # 8-point Eb/N0 grid


def arikan_sc() -> Preset:
    factors = (2,) * 10
    mask = _load_mask("arikan_n1024_k512", factors, 512)
    spec = CodeSpec(N=1024, K=512, factors=factors, frozen_mask=mask)
    return Preset("arikan_sc", spec, 1, (2.0,), 1 << 20, 1 << 12)


def ca_scl() -> Preset:
    factors = (2,) * 10
    mask = _load_mask("arikan_n1024_k528", factors, 528)
    spec = CodeSpec(N=1024, K=512, factors=factors, frozen_mask=mask, crc=CRC16)
    return Preset("ca_scl", spec, 8, (2.0,), 1 << 20, 1 << 11)


def bch_sc() -> Preset:
    factors = (16, 16)
    mask = _load_mask("bch_n256_k128", factors, 128)
    spec = CodeSpec(N=256, K=128, factors=factors, frozen_mask=mask)
    return Preset("bch_sc", spec, 1, (2.0,), 1 << 18, 1 << 11)


def mixed_scl32() -> Preset:
    factors = (16, 16, 2, 2, 2, 2)
    mask = _load_mask("mixed_n4096_k2064", factors, 2064)
    spec = CodeSpec(N=4096, K=2048, factors=factors, frozen_mask=mask,
                    crc=CRC16)
    return Preset("mixed_scl32", spec, 32, (2.0,), 1 << 16, 1 << 8)


def mixed_n1024_scl32() -> Preset:
    factors = (16, 16, 2, 2)
    mask = _load_mask("mixed_n1024_k528", factors, 528)
    spec = CodeSpec(N=1024, K=512, factors=factors, frozen_mask=mask,
                    crc=CRC16)
    return Preset("mixed_n1024_scl32", spec, 32, (1.0, 1.5, 2.0, 2.5),
                  1 << 16, 1 << 13)


def sweep() -> Preset:
    p = ca_scl()
    return dataclasses.replace(p, name="sweep", ebn0_grid=_GRID8,
                               frames=10_000_000)


PRESETS = {f.__name__: f for f in (arikan_sc, ca_scl, bch_sc, mixed_scl32,
                                   sweep, mixed_n1024_scl32)}


def get_preset(name: str) -> Preset:
    return PRESETS[name]()
