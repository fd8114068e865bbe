"""Golden-file records: hard decisions of the independent C++ decoder
(polar_tpu_torch/native.py) on fixed channel LLRs, replayed through this
package's decoders, which must reproduce them frame for frame.

Record format (.npz):
    factors[int m], frozen[uint8 N], K, crc_width, crc_poly, crc_init,
    list_size, llrs[float64 B, N], u_ref[uint8 B, N]

The records of `RECORDS` live in polar_tpu_torch/records/; record one (if
absent) and replay it through each of its routes on the card with

    python -m polar_tpu_torch.sim.golden --record golden_bch_sc_l1

and replay any record (results/golden_ca_scl_b256.npz, ...) with
`--replay PATH` (`--device cpu` for the plain version).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
from typing import Callable

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import bch_sc

RECORDS_DIR = pathlib.Path(__file__).resolve().parents[1] / "records"


def record_golden(spec: CodeSpec, list_size: int, llrs: np.ndarray,
                  path: str | pathlib.Path) -> np.ndarray:
    """Decode llrs with the native golden decoder and write a record.

    LLRs are rounded to float32 before the native decode (VERDICT r2
    weak 7): the replay runs in float32, so recording on exactly
    float32-representable values gives both decoders bit-identical
    inputs."""
    from polar_tpu_torch.native import NativeGolden

    llrs = np.asarray(llrs, np.float64).astype(np.float32).astype(np.float64)
    u_ref = NativeGolden(spec).decode(llrs, list_size)
    np.savez_compressed(
        path,
        factors=np.asarray(spec.factors, np.int64),
        frozen=spec.frozen.astype(np.uint8),
        K=np.int64(spec.K),
        crc_width=np.int64(spec.crc.width if spec.crc else 0),
        crc_poly=np.int64(spec.crc.poly if spec.crc else 0),
        crc_init=np.int64(spec.crc.init if spec.crc else 0),
        list_size=np.int64(list_size),
        llrs=llrs,
        u_ref=u_ref)
    return u_ref


def load_golden(path: str | pathlib.Path):
    """-> (spec, list_size, llrs, u_ref)"""
    z = np.load(path)
    crc = None
    if int(z["crc_width"]):
        crc = CrcSpec(width=int(z["crc_width"]), poly=int(z["crc_poly"]),
                      init=int(z["crc_init"]))
    spec = CodeSpec(
        N=int(z["frozen"].size), K=int(z["K"]),
        factors=tuple(int(f) for f in z["factors"]),
        frozen_mask=tuple(int(v) for v in z["frozen"]), crc=crc)
    return spec, int(z["list_size"]), z["llrs"], z["u_ref"]


def replay_check(path: str | pathlib.Path, device="cuda",
                 **decoder_kwargs) -> dict:
    """Replay a golden record through `ops/scl.py` `build_scl_decoder(spec,
    L, device=device, **decoder_kwargs)`: device "cuda" runs the kernels,
    "cpu" the plain version; `subtree_backend="pallas"` selects the K3
    route and `big_stage_backend="pallas"` the hybrid. Raises without a
    card for a CUDA device, and for unknown arguments.

    Returns {"frames", "mismatch_frames", "mismatch_bits"}; bit-match
    holds iff mismatch_frames == 0."""
    from polar_tpu_torch.ops.scl import build_scl_decoder

    spec, list_size, llrs, u_ref = load_golden(path)
    dec = build_scl_decoder(spec, list_size, device=device, **decoder_kwargs)
    out = dec(torch.as_tensor(np.asarray(llrs, np.float32))).u.cpu().numpy()
    mism = out != u_ref
    return {
        "frames": int(llrs.shape[0]),
        "mismatch_frames": int(mism.any(axis=1).sum()),
        "mismatch_bits": int(mism.sum()),
    }


def jittered_spec(factors, K: int, crc: CrcSpec | None,
                  seed: int = 1) -> CodeSpec:
    """A spec with a cheap deterministic frozen set: reliability by index
    plus jitter (the JAX suite's `_mixed_spec`); the decoding paths under
    test do not depend on the mask, and a mediocre code gives the wrong
    survivor paths a record needs at low SNR."""
    N = int(np.prod(factors))
    r = np.random.default_rng(seed)
    nk = K + (crc.width if crc else 0)
    mask = np.ones(N, np.uint8)
    mask[np.argsort(r.random(N) + np.linspace(0, 1, N))[-nk:]] = 0
    return CodeSpec(N=N, K=K, factors=tuple(factors),
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)


CRC8 = CrcSpec(8, 0x07, 0)


@dataclasses.dataclass(frozen=True)
class Record:
    """A committed golden record: its spec, list size, frames (the first
    half at `ebn0_db[0]`, the rest at `ebn0_db[1]`), numpy seed, and the
    routes it is replayed through on the card: (label, decoder keyword
    arguments, the kernel that route must launch)."""
    spec: Callable[[], CodeSpec]
    list_size: int
    frames: int
    ebn0_db: tuple[float, float]
    seed: int
    routes: tuple[tuple[str, dict, str], ...]


HYBRID = ("hybrid", {"big_stage_backend": "pallas"}, "stage_down")
RECORDS = {
    # BASELINE config 3: N=256, two 16x16 eBCH stages, SC
    "golden_bch_sc_l1": Record(
        lambda: bch_sc().spec, 1, 128, (1.0, 3.0), 20261017,
        (("default", {}, "scl_decode_traj"), HYBRID)),
    "golden_bch_sc_l8": Record(
        lambda: bch_sc().spec, 8, 64, (1.5, 3.0), 20261018,
        (("default", {}, "scl_decode"),)),
    # list capacity 32: the Arikan spec of chip_smoke.py phase 17
    "golden_c32_arikan": Record(
        lambda: jittered_spec((2,) * 7, 56, CRC8), 32, 256, (1.0, 3.0),
        20261019, (("default", {}, "scl_decode"),)),
    # tests/test_torch_subtree.py's (2, 16, 2) spec: K1's l > 2 capacity-32
    # instance, the subtree route (K3) and the hybrid (K6)
    "golden_c32_subtree": Record(
        lambda: jittered_spec((2, 16, 2), 14, CRC8), 32, 128, (1.0, 3.0),
        20261020, (("default", {}, "scl_decode"),
                   ("subtree", {"subtree_backend": "pallas"}, "scl_subtree"),
                   HYBRID)),
}


def record_path(name: str) -> pathlib.Path:
    """Where the record `name` of `RECORDS` is committed."""
    return RECORDS_DIR / f"{name}.npz"


def record_llrs(spec: CodeSpec, rec: Record) -> np.ndarray:
    """Channel LLRs of `rec`: CRC-appended random info bits, encoded by the
    C++ codec, BPSK over AWGN, numpy draws from `rec.seed`."""
    from polar_tpu_torch.native import NativeGolden
    from polar_tpu_torch.ops.crc import crc_append
    from polar_tpu_torch.sim.channel import ebn0_to_sigma

    rng = np.random.default_rng(rec.seed)
    B = rec.frames
    payload = rng.integers(0, 2, (B, spec.K), dtype=np.uint8)
    if spec.crc is not None:
        payload = crc_append(spec.crc, torch.as_tensor(payload)).numpy()
    u = np.zeros((B, spec.N), np.uint8)
    u[:, spec.info_positions] = payload
    x = NativeGolden(spec).encode(u)
    sig = np.array([float(ebn0_to_sigma(db, spec.rate)) for db in rec.ebn0_db])
    sigma = np.repeat(sig, [B // 2, B - B // 2])[:, None]
    y = (1.0 - 2.0 * x.astype(np.float64)) + sigma * rng.normal(size=x.shape)
    return 2.0 * y / (sigma * sigma)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Record (if absent) and replay a golden record.")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--record", choices=sorted(RECORDS),
                      help="record polar_tpu_torch/records/NAME.npz if "
                           "absent, then replay it through each of its routes")
    what.add_argument("--replay", metavar="PATH",
                      help="replay the record at PATH")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: the plain version")
    ap.add_argument("--subtree", default="none", choices=("none", "pallas"))
    ap.add_argument("--big-stage", default="xla", choices=("xla", "pallas"))
    args = ap.parse_args(argv)
    if args.record:
        rec = RECORDS[args.record]
        path = record_path(args.record)
        if not path.exists():
            spec = rec.spec()
            t0 = time.perf_counter()
            record_golden(spec, rec.list_size, record_llrs(spec, rec), path)
            print(f"recorded {rec.frames} frames -> {path} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        routes = [(label, kw) for label, kw, _ in rec.routes]
    else:
        path = pathlib.Path(args.replay)
        routes = [("args", {"subtree_backend": args.subtree,
                            "big_stage_backend": args.big_stage})]
    ok = True
    for label, kw in routes:
        t0 = time.perf_counter()
        res = replay_check(path, device=args.device, **kw)
        res.update(record=path.name, route=label, device=args.device,
                   wall_s=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
        ok &= res["mismatch_frames"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
