"""Entry points: one Monte-Carlo step of the flagship, and a dry run of
the sharded step over several cards.

Counterpart of the repository's __graft_entry__.py. `dryrun_multichip(n)`
starts n ranks, one card each (torchrun, parallel/mesh.py `launch`); each
rank runs this module as a script:

    torchrun --nproc-per-node 2 -m polar_tpu_torch.entry cuda
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import ca_scl
from polar_tpu_torch.parallel.mesh import (init_multihost, launch,
                                           make_batch_mesh, sharded_mc_step)
from polar_tpu_torch.sim.channel import ebn0_to_sigma
from polar_tpu_torch.sim.harness import make_mc_step
from polar_tpu_torch.utils.device import resolve_device

ENTRY_BATCH = 64
PER_DEVICE = 8          # frames a rank in each dry-run case
DRYRUN_TIMEOUT = 900    # seconds; covers building the kernels on each rank


def entry(device="cuda"):
    """(fn, args): fn(seed) runs one fused Monte-Carlo step of the flagship
    (ca_scl: N=1024 CA-SCL, L=8) at batch 64 and 2.0 dB, returning its
    counters ({"frames", "frame_errors", "bit_errors"})."""
    dev = resolve_device(device)
    preset = ca_scl()
    step = make_mc_step(preset.spec, preset.list_size, backend="fused",
                        device=dev)
    sigma = float(ebn0_to_sigma(2.0, preset.spec.rate))

    def fn(seed: int) -> dict:
        return step(seed, 0, 0, sigma, ENTRY_BATCH)

    return fn, (0,)


def _cases():
    """The dry run's cases: a tiny mixed-kernel code (N=64 = 16*2*2,
    CRC-8, L=4, a fixed mask by index) and the flagship ca_scl (L=8)."""
    mask = np.ones(64, np.uint8)
    mask[-28:] = 0
    tiny = CodeSpec(N=64, K=20, factors=(16, 2, 2),
                    frozen_mask=tuple(int(v) for v in mask),
                    crc=CrcSpec(width=8, poly=0x07, init=0))
    flagship = ca_scl()
    return (("tiny-mixed", tiny, 4),
            ("flagship-ca_scl", flagship.spec, flagship.list_size))


def dryrun_rank(device="cuda") -> None:
    """One rank of `dryrun_multichip`: the sharded fused step of each case,
    PER_DEVICE frames a rank; rank 0 prints a line a case."""
    init_multihost(device)
    mesh = make_batch_mesh(device=device)
    for name, spec, L in _cases():
        raw = make_mc_step(spec, L, backend="fused", device=mesh.device)
        step = sharded_mc_step(raw, mesh)
        out = step(0, 0, 0, float(ebn0_to_sigma(2.0, spec.rate)), PER_DEVICE)
        fe, be = out["counts"].tolist()
        if out["frames"] != PER_DEVICE * mesh.size:
            raise RuntimeError(f"{name}: {out['frames']} frames, not "
                               f"{PER_DEVICE * mesh.size}")
        if mesh.rank == 0:
            print(f"dryrun_multichip ok [{name}]: {mesh.size} devices, "
                  f"{out['frames']} frames, frame_errors={fe} bit_errors={be} "
                  f"fer={fe / out['frames']:.3f}", flush=True)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> list[str]:
    """Run the sharded Monte-Carlo step over n_devices ranks, one card each
    (device="cpu": n ranks over gloo), on the reference's two cases;
    returns and prints rank 0's lines. Raises RuntimeError with fewer than
    n_devices cards, or if any rank fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have "
                           f"{torch.cuda.device_count()}")
    out = launch(n_devices, ["-m", "polar_tpu_torch.entry", dev.type],
                 timeout=DRYRUN_TIMEOUT)
    lines = [line for line in out.splitlines()
             if line.startswith("dryrun_multichip ok")]
    if len(lines) != len(_cases()):
        raise RuntimeError(f"dry run printed {lines}")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    dryrun_rank(sys.argv[1] if len(sys.argv) > 1 else "cuda")
