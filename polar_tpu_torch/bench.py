"""Benchmark: decoded codewords/s on one card, flagship configuration.

Counterpart of bench.py: `ca_scl` (N=1024, K=512 + CRC-16, CA-SCL L=8)
decoded at B=8192 on channel LLRs at 2.0 dB. Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ...}.

    python -m polar_tpu_torch.bench
    BENCH_DEVICE=cpu BENCH_BATCH=4 BENCH_REPS=1 python -m polar_tpu_torch.bench

Environment: BENCH_BATCH (8192), BENCH_REPS (8), BENCH_DECODER (`pallas`:
ops/cuda_scl.py `SclDecoder`, the decode kernel; `xla`: ops/scl.py
`build_scl_decoder`, the route it picks) and BENCH_DEVICE (`cuda`; `cpu`
runs the plain PyTorch version). Without a card and without
BENCH_DEVICE=cpu it raises RuntimeError.

The LLRs are made once, outside the timed window, and the decodes are
timed by benchmarks/decode_bench.py `timed` (one warm-up call, then a
window of chained decodes between two CUDA events). bench.py's
`vs_baseline` is left out: it is measured against the TPU v5e-8 target,
which is no target of this port.
"""
from __future__ import annotations

import json
import os

import torch

from polar_tpu_torch.benchmarks.decode_bench import timed
from polar_tpu_torch.models.presets import ca_scl
from polar_tpu_torch.ops.cuda_scl import SclDecoder
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.sim.channel import ebn0_to_sigma
from polar_tpu_torch.utils.device import resolve_device

METRIC = "decoded_codewords_per_s_per_chip_n1024_scl8"
EBN0_DB = 2.0
SEED = 0


def flagship_llrs(N: int, rate: float, batch: int, device) -> torch.Tensor:
    """[batch, N] float32 LLRs as bench.py makes them: random BPSK symbols
    +-1 plus sigma N(0, 1) noise at 2.0 dB, scaled by 2 / sigma^2."""
    sigma = float(ebn0_to_sigma(EBN0_DB, rate))
    gen = torch.Generator(device=device).manual_seed(SEED)
    bits = torch.randint(0, 2, (batch, N), generator=gen, device=device)
    y = 1.0 - 2.0 * bits.to(torch.float32)
    y = y + sigma * torch.randn((batch, N), generator=gen, device=device)
    return (2.0 / (sigma * sigma)) * y


def main() -> None:
    dev = resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))
    batch = int(os.environ.get("BENCH_BATCH", "8192"))
    reps = int(os.environ.get("BENCH_REPS", "8"))
    backend = os.environ.get("BENCH_DECODER", "pallas")
    if backend not in ("pallas", "xla"):
        raise ValueError(f"BENCH_DECODER must be pallas or xla, not {backend!r}")
    preset = ca_scl()
    spec = preset.spec
    if backend == "pallas":
        decode = SclDecoder(spec, preset.list_size, dev)
    else:
        decode = build_scl_decoder(spec, preset.list_size, device=dev)
    llr = flagship_llrs(spec.N, spec.rate, batch, dev)
    ms = timed(lambda i: decode(llr), reps, dev)["ms"]
    print(json.dumps({"metric": METRIC, "value": batch / ms * 1e3,
                      "unit": "codewords/s/chip"}), flush=True)


if __name__ == "__main__":
    main()
