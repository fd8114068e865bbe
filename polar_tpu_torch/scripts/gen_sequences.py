"""Build the frozen-set artifacts of the named constructions.

Counterpart of scripts/gen_sequences.py:

    python -m polar_tpu_torch.scripts.gen_sequences [name ...] [--out DIR]
        [--device cpu]

The GA constructions (construction/ga.py) run on the host; the Monte-Carlo
ones (construction/montecarlo.py `construct_mc`: the genie decoder, 2^15
frames, seed 0) on the card unless `--device cpu` is given, and raise
RuntimeError without one.

The artifacts land in build/sequences/ (git-ignored) by default, not in
polar_tpu_torch/models/sequences/: the masks committed there are byte for
byte the JAX package's (tests/test_torch_primitives.py), and the port's
Philox draws give other Monte-Carlo masks (leaves near the reliability
cut swap; chip_smoke.py holds them within 4 sd of it). Writing over them
would break that copy.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.construction.montecarlo import construct_mc
from polar_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "sequences"
MC_FRAMES = 1 << 15
MC_SEED = 0

SPECS = {
    # name: (factors, n_unfrozen, design_ebn0_db, method)
    "arikan_n1024_k512": ((2,) * 10, 512, 2.0, "ga"),
    "arikan_n1024_k528": ((2,) * 10, 528, 2.0, "ga"),       # 512 + CRC16
    "bch_n256_k128": ((16, 16), 128, 2.0, "mc"),
    "mixed_n4096_k2064": ((16, 16, 2, 2, 2, 2), 2064, 2.0, "mc"),  # 2048+CRC16
}


def build(name: str, out: pathlib.Path = OUT, device="cuda") -> pathlib.Path:
    """Construct `name`'s frozen mask (1 = frozen) and save it as
    out/name.npy; the Monte-Carlo specs on `device`."""
    dev = resolve_device(device)
    factors, n_unfrozen, snr, method = SPECS[name]
    N = int(np.prod(factors))
    if method == "ga":
        mask = construct_ga(N, n_unfrozen, snr)
    else:
        mask = construct_mc(factors, n_unfrozen, snr, frames=MC_FRAMES,
                            seed=MC_SEED, device=dev)
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.npy"
    np.save(path, mask)
    print(f"{name}: N={N} unfrozen={N - int(mask.sum())} -> {path}")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"any of {list(SPECS)} (default: all)")
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the Monte-Carlo decodes' device")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in SPECS]
    if unknown:
        ap.error(f"unknown names {unknown}: not in {list(SPECS)}")
    for name in args.names or list(SPECS):
        build(name, args.out, args.device)


if __name__ == "__main__":
    main()
