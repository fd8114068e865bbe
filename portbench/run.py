"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell by name from BENCHMARK.json, sets up the program under test
(polar_tpu_torch) on the card, warms up every shape the cell uses, measures
for `--seconds` seconds (closing at the end of the pass or batch in which
they run out), then compares a sample of what the window produced with the
plain reference (portbench/ref). A four-card cell starts one process a
card through torchrun (`polar_tpu_torch.parallel.mesh.launch`), each
running `portbench.worker`, and gathers their parts.

Standard output's last line is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (`--trace 0`: the cell's end-to-end metrics; `--trace
1`: its per-layer metrics, with `breakdown`), `device`, `card` (power limit
and the peaks that shares are taken against) and, last, `compared`: each
number the comparison read beside its limit. Standard error ends with the
same numbers, one a line. Without as many cards as the cell asks for, or
where a forbidden module (the JAX stack, the JAX package) is loaded, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.time()                 # set-up runs from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import pathlib  # noqa: E402

from portbench import core  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_here(cell, seed: int, seconds: float, trace: bool, tmp, mesh=None,
             device="cuda", control: bool = False) -> dict:
    """This process's part of a run (one rank's on several cards)."""
    return core.load_kind(cell.kind).run(cell, seed, seconds, trace, tmp,
                                         mesh=mesh, device=device,
                                         control=control)


def merged_calls(parts: list[dict]) -> dict:
    """Every rank's comparison of each sampled call, merged: frames off
    summed, the widest path-metric gap, the reference's counters summed
    over the ranks beside the counters the harness got (under the control,
    the ranks' own sums, summed)."""
    calls: dict = {}
    for part in parts:
        control = part["check"]["control"]
        for i, c in part["check"]["calls"].items():
            m = calls.setdefault(str(i), {"off": 0, "gap": None,
                                          "ref_sum": None, "logged": None})
            m["off"] += c["off"]
            if c.get("gap") is not None:
                m["gap"] = max(m["gap"] or 0.0, c["gap"])
            if "ref_sum" in c:
                m["ref_sum"] = [a + b for a, b in
                                zip(m["ref_sum"] or [0, 0], c["ref_sum"])]
                if control:
                    m["logged"] = [a + b for a, b in
                                   zip(m["logged"] or [0, 0], c["logged"])]
                elif m["logged"] is None:
                    m["logged"] = c["logged"]
    return calls


def compared_numbers(cell, parts: list[dict], calls: dict) -> list[dict]:
    """The numbers compared, each with its limit (the cell's `limits`):
    `frames_off`, frames whose outputs differ from the reference's;
    `pm_gap`, the widest path-metric gap; `calls_off`, sampled calls whose
    counters differ from the reference's summed over the ranks;
    `passes_off`, passes whose records differ from their calls' counters.
    A run that compared nothing reads None, which no limit passes."""
    limits = cell.traffic["limits"]
    seen = bool(calls)
    gaps = [c["gap"] for c in calls.values() if c["gap"] is not None]
    values = {
        "frames_off": sum(c["off"] for c in calls.values()) if seen else None,
        "pm_gap": max(gaps) if gaps else None,
        "calls_off": (sum(c["ref_sum"] != c["logged"] for c in calls.values())
                      if seen else None),
        "passes_off": max(p["check"].get("passes_off", 0) for p in parts)}
    return [{"name": n, "value": values[n], "limit": limits[n]} for n in limits]


def rejected(cell, calls: dict) -> int:
    """Sampled calls the comparison rejects."""
    limit = cell.traffic["limits"].get("pm_gap", 0.0)
    return sum(bool(c["off"]) or c["ref_sum"] != c["logged"]
               or (c["gap"] is not None and not c["gap"] <= limit)
               for c in calls.values())


def result(cell, parts: list[dict], trace: bool,
           card: dict) -> tuple[dict, list[dict]]:
    """The result line and the numbers compared, from every rank's part
    (rank 0's first)."""
    from portbench.yardstick import opcount
    from portbench.yardstick import trace as tr

    lead = parts[0]
    calls = merged_calls(parts)
    checks = compared_numbers(cell, parts, calls)
    raised = max(p["raised"] for p in parts)
    failed = raised + rejected(cell, calls)
    correct = not raised and all(core.passes(c) for c in checks)
    device = {"platform": "gpu", "kind": card["name"], "count": len(parts),
              "memory_peak_bytes": max(p["memory_peak_bytes"] for p in parts)}
    if trace:
        ctx = {"cell": cell.name, "kind": cell.kind, "trace": lead["trace"],
               "work": lead["work"], "submit_ms": lead.get("submit_ms"),
               "ranks": [p["trace"] for p in parts]}
        metrics = core.per_layer(cell, ctx)
        device["busy_s"] = sum(p["trace"]["busy_us"] for p in parts) * 1e-6 / len(parts)
        device["window_s"] = lead["trace"]["window_us"] * 1e-6
    else:
        values = dict(lead["values"], setup_s=lead["wall_start"] - T0)
        metrics = core.end_to_end(cell, values)
    line = {"correct": correct, "attempted": lead["attempted"] + raised,
            "failed": failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = tr.breakdown(lead["trace"])
    line["card"] = {"power_limit_w": card["power_limit_w"],
                    "peak_elem_ops_per_s": opcount.PEAK_ELEM_OPS_PER_S,
                    "peak_bytes_per_s": opcount.PEAK_BYTES_PER_S,
                    "frames_compared": sum(p["check"]["frames"] for p in parts),
                    "compare_s": max(p["check_s"] for p in parts)}
    line["compared"] = core.compared(checks)
    return line, checks


def multi_card(cell, args, tmp: pathlib.Path, control: bool = False) -> list[dict]:
    """Start one process a card through the program's launcher and return
    their parts, rank 0's first."""
    from polar_tpu_torch.parallel.mesh import launch

    launch(cell.chips, ["-m", "portbench.worker", "--workload", cell.name,
                        "--seed", str(args.seed), "--seconds", str(args.seconds),
                        "--trace", str(args.trace), "--out", str(tmp)]
           + (["--control"] if control else []), timeout=300)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(cell.chips)]


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = core.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one intra-op thread, as every rank of a several-card run has: the
    # host's other cores stay free, so host-paced cells spread less
    torch.set_num_threads(1)
    card = core.card()
    from polar_tpu_torch.ops import cuda_build

    cuda_build.build_all()          # every source at once; a no-op once built
    with tempfile.TemporaryDirectory(prefix="portbench_") as d:
        tmp = pathlib.Path(d)
        if cell.chips > 1:
            parts = multi_card(cell, args, tmp)
        else:
            parts = [run_here(cell, args.seed, args.seconds, bool(args.trace), tmp)]
            parts[0]["forbidden"] = core.forbidden_modules()
    forbidden = sorted({m for p in parts for m in p["forbidden"]}
                       | set(core.forbidden_modules()))
    if forbidden:
        print(f"forbidden modules loaded: {forbidden}", file=sys.stderr)
        return 3
    for p in parts:
        if p["error"]:
            print(p["error"], file=sys.stderr)
    line, checks = result(cell, parts, bool(args.trace), card)
    for c in checks:
        print(f"compared {c['name']} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
