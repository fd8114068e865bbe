"""What every run of the benchmark shares: the cells, configurations and
metrics named in BENCHMARK.json, found by name in files of their own; the
card; the result line; the check for modules that must not be loaded.

A cell `<config>.<traffic>` is the workload entry of that name. Its
configuration is `portbench/configs/<config>.json`, its traffic
`portbench/cells/<cell>.json`, whose `kind` names the module under
`portbench/kinds/` that runs it. A per-layer metric `<name>` is read by
`read(ctx)` in `portbench/metrics/<name>.py`, which returns None where the
run holds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# top-level module names that no process of a run may hold: the JAX stack
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "polar_tpu")


@dataclasses.dataclass
class Cell:
    """One workload entry with its configuration and traffic files, and the
    metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list where it has
    one, else every cell that reports the end-to-end metric it moves (for
    an end-to-end metric: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "cells" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, int(entry["chips"]), config, traffic, e2e, layer)


def load_kind(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def load_reader(metric: str):
    """`read` of portbench/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card() -> dict:
    """The first card's name and power limit as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit_w": float(limit)}


def forbidden_modules() -> list[str]:
    """Forbidden top-level modules this process holds, names compared whole
    (polar_tpu_torch is not polar_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def end_to_end(cell: Cell, values: dict) -> dict:
    """The cell's end-to-end metrics from the kind's values; raises where
    one is missing."""
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
    if missing:
        raise RuntimeError(f"{cell.name}: no value for {missing}")
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell: Cell, ctx: dict) -> dict:
    """The cell's per-layer metrics that have something to read."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compared(checks: list[dict]) -> dict:
    """The numbers compared, each beside its limit: {name: {value, limit}}."""
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in checks}


def passes(check: dict) -> bool:
    return check["value"] is not None and check["value"] <= check["limit"]
