"""Data-parallel Monte-Carlo sweeps over several cards: one process a card,
the per-rank error counters summed with one all-reduce.

Counterpart of polar_tpu/parallel/mesh.py in PyTorch's idiom. The JAX
package runs one SPMD program over a mesh of devices and psums the
counters; here each card is driven by a process of its own, launched by
torchrun (`python -m torch.distributed.run --nproc-per-node N ...`), and
the ranks' counters meet in one `all_reduce` of an int64 tensor: over
NCCL on the card (enqueued on the stream, the host does not wait), over
gloo where the caller asks for it (the CPU, or several ranks on one card,
which NCCL refuses). Each rank draws its own frames: its rank is the last
word of the Philox counter of its keys (ops/philox.py `step_seed`), and
rank 0 draws the frames of a single-device sweep.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
import uuid

import torch
import torch.distributed as dist

from polar_tpu_torch.utils.device import resolve_device

# set by torchrun for every rank; LOCAL_RANK names the rank's card
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
RANK_THREADS = 1        # intra-op threads of each rank `launch` starts
ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh with one axis, "batch", over the first `size` ranks of
    the process group: this process's `rank` in it (-1 outside it) and its
    `device`. `group` None: one process alone, no collective."""
    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = ("batch",)


def _rank_device(device="cuda") -> torch.device:
    """The device of this rank: a card named without an index is the card
    LOCAL_RANK (torchrun's local rank) names. Raises RuntimeError without
    that card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} requested but {torch.cuda.device_count()} "
                           "CUDA device(s) are present")
    return dev


def init_multihost(device="cuda", backend: str | None = None) -> bool:
    """Join the process group of a torchrun launch, before first device use.

    Does nothing where the launcher's environment (RANK, WORLD_SIZE,
    MASTER_ADDR) is not set, as the JAX package's gate on
    JAX_COORDINATOR_ADDRESS. backend: "nccl" (the default on the card,
    bound to the rank's card) or "gloo" (the default for device="cpu"; on
    the card only where asked for). NCCL without a card raises; nothing
    falls back to gloo or to the CPU. Returns whether a process group is
    up."""
    if not all(os.environ.get(k) for k in LAUNCH_ENV):
        return False
    if dist.is_initialized():
        return True
    dev = _rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL reduces on the card, not on {dev}")
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group(backend)
    return True


def make_batch_mesh(n_devices: int | None = None, device="cuda") -> BatchMesh:
    """1-D mesh with a single "batch" axis over the first `n_devices` ranks
    of the process group (all of them by default), each on its own device
    (`_rank_device`). Without a process group: this process alone on
    `device`."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs one process "
                             "a card: launch with torchrun")
        return BatchMesh(None, 0, 1, resolve_device(device))
    dev = _rank_device(device)
    world = dist.get_world_size()
    size = world if n_devices is None else n_devices
    if not 1 <= size <= world:
        raise ValueError(f"n_devices {n_devices} outside 1..{world}")
    group = (dist.group.WORLD if size == world
             else dist.new_group(list(range(size))))
    rank = dist.get_rank()
    return BatchMesh(group, rank if rank < size else -1, size, dev)


def sharded_mc_step(step_fn, mesh: BatchMesh):
    """Wrap a per-rank Monte-Carlo step into a step over the mesh.

    step_fn(seed, snr_index, rng_step, sigma, batch, rank=...) is
    sim/harness.py `make_mc_step`'s step: it draws its rank's frames on
    its device from keys that fold in `rank`. The wrapper passes this
    process's rank and sums the counters over the mesh: step(seed,
    snr_index, rng_step, sigma, batch) -> {"frames": batch x steps x mesh
    size, "counts": int64 [2] (frame errors, bit errors), all ranks'
    sum}. Over NCCL the host does not wait for the sum: work that follows
    on the stream runs after it."""
    if mesh.rank < 0:
        raise ValueError("this process is not in the mesh")

    def step(seed: int, snr_index: int, rng_step: int, sigma: float,
             batch: int) -> dict:
        out = step_fn(seed, snr_index, rng_step, sigma, batch, rank=mesh.rank)
        counts = torch.stack([torch.as_tensor(out["frame_errors"]),
                              torch.as_tensor(out["bit_errors"])]
                             ).to(torch.int64)
        if mesh.group is not None:
            dist.all_reduce(counts, group=mesh.group, async_op=True).wait()
        return {"frames": out["frames"] * mesh.size, "counts": counts}

    return step


def launch(n: int, args: list[str], timeout: float) -> str:
    """Run `python -m torch.distributed.run --nproc-per-node n <args>` on
    this host and return its standard output. Raises RuntimeError if a
    rank exits non-zero (torchrun then stops the others) or the run
    outlasts `timeout` seconds (every process it started is killed).

    The rendezvous is c10d's on 127.0.0.1 port 0, as torchrun's
    --standalone: the agent's store binds a port the kernel picks and
    hands it to the ranks, so no port number is chosen here and bound
    later, when another process may have taken it. Each rank runs
    RANK_THREADS intra-op threads (OMP_NUM_THREADS), whatever the caller's
    environment: n ranks on one host share its cores."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = str(RANK_THREADS)
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc-per-node={n}", "--rdzv-backend=c10d",
           "--rdzv-endpoint=127.0.0.1:0", f"--rdzv-id={uuid.uuid4()}",
           "--local-addr=127.0.0.1", *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()            # torchrun stops its ranks (own sessions)
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        raise RuntimeError(f"{n} ranks of {args} outlasted {timeout} s:\n"
                           f"{out[-2000:]}\n{err[-6000:]}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"{n} ranks of {args} exited {proc.returncode}:\n"
                           f"{out[-2000:]}\n{err[-6000:]}")
    return out
