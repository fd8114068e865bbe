"""One rank of a several-card run of the benchmark, started by torchrun
(`portbench.run` starts it through `polar_tpu_torch.parallel.mesh.launch`):
joins the process group over NCCL, runs its part of the cell on the card
its local rank names and writes it to `<out>/rank<r>.json`.

    python -m torch.distributed.run --nproc-per-node 4 -m portbench.worker \\
        --workload <cell> --seed <n> --seconds <s> --trace <0|1> --out DIR
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from portbench import core
from portbench.run import run_here


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--control", action="store_true",
                   help="the lower-precision control takes the program's "
                        "place in the comparison (its test, never a run)")
    args = p.parse_args(argv)
    import torch.distributed as dist

    from polar_tpu_torch.parallel.mesh import init_multihost, make_batch_mesh

    if not init_multihost("cuda"):
        raise SystemExit("portbench.worker runs under torchrun")
    mesh = make_batch_mesh(device="cuda")
    out = pathlib.Path(args.out)
    work = out / f"work{mesh.rank}"
    work.mkdir()
    part = run_here(core.load_cell(args.workload), args.seed, args.seconds,
                    bool(args.trace), work, mesh=mesh,
                    control=args.control)
    part["forbidden"] = core.forbidden_modules()
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(part))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
