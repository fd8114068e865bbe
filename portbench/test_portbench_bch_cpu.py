"""The bch_sc configuration and its cell's readers on the CPU: the
configuration is the program's preset uncut (the first without a CRC,
compared whole: None only equals None), and each of the five readers
reads its own numbers, and nothing, without raising, where its run holds
nothing to read. The cell's work a codeword is held to chip_smoke.py's by
tests/test_torch_bch_sc_cell.py.

    python -m pytest portbench/test_portbench_bch_cpu.py -q -p no:cacheprovider
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import core
from portbench.ref import model
from portbench.yardstick import opcount

BENCH = core.load_benchmark()
CELL = "bch_sc.fused_sweep"
# metric -> the spans it reads: {name: (count, total us)}, its value in ms
SPANS = {
    "dispatch_ms.bch": ({"run_sweep.dispatch": (8, 400.0)}, 0.05),
    "pass_setup_ms.bch": ({"run_sweep.setup": (4, 100.0)}, 0.025),
    "tables_ms.bch": ({"scl.tables": (4, 2000.0)}, 0.5),
}
# metric -> its value on the summary below, in %
TRACE = {"idle_pct.bch": 50.0, "roofline_pct.bch": 20.0}
NEW = sorted([*SPANS, *TRACE])
# the spans a program without `scl.tables` has
PARENT_SPANS = {"run_sweep.dispatch": (6, 600.0), "run_sweep.fetch": (6, 60.0),
                "run_sweep.setup": (1, 7.0)}


def ctx(kind: str, cards: int, spans: dict) -> dict:
    """A traced run's context: a 10-ms window, the card busy 5 ms of it,
    and work whose least time is 1 ms."""
    s = {"window_us": 1e4, "busy_us": 5e3, "idle_share": 0.5,
         "kernel_busy_us": 5e3, "nccl_us": 0.0, "device_ops": [], "gaps": [],
         "spans": {n: {"count": c, "us": us} for n, (c, us) in spans.items()}}
    work = {"frames": 1, "ops": opcount.PEAK_ELEM_OPS_PER_S * 1e-3, "bytes": 0}
    return {"cell": CELL, "kind": kind, "trace": s, "work": work,
            "submit_ms": None, "ranks": [s] * cards}


def test_configuration_is_the_program_preset_uncut():
    from polar_tpu_torch.models.presets import get_preset

    conf = next(c for c in BENCH["configs"] if c["name"] == "bch_sc")
    config = json.loads((core.ROOT / conf["file"]).read_text())
    assert conf["reduced"] == [] and config["name"] == "bch_sc"
    spec, prog = model.code_spec(config), get_preset("bch_sc")
    assert (spec.N, spec.K, spec.factors) == (prog.spec.N, prog.spec.K,
                                              prog.spec.factors)
    assert np.array_equal(spec.frozen, prog.spec.frozen)
    whole = (lambda c: None if c is None else (c.width, c.poly, c.init))
    assert whole(spec.crc) == whole(prog.spec.crc) is None
    assert config["list_size"] == prog.list_size == 1
    data = core.ROOT / config["code"]["frozen_set"]
    seq = core.ROOT / "polar_tpu_torch" / "models" / "sequences" / data.name
    assert data.read_bytes() == seq.read_bytes()


def test_each_metric_is_declared_for_the_cell_alone():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    cell = core.load_cell(CELL)
    assert sorted(m["name"] for m in cell.per_layer) == NEW
    assert [m["name"] for m in cell.end_to_end] == ["sim_cw_per_s", "setup_s"]
    for name in NEW:
        m = declared[name]
        assert m["workloads"] == [CELL] and m["moves"] == "sim_cw_per_s"
        assert m["source"] == ("program_span" if name in SPANS else "device_trace")


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_reads_its_span(name):
    spans, value = SPANS[name]
    read = core.load_reader(name)
    assert read(ctx("sweep", 1, dict(PARENT_SPANS, **spans))) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", sorted(TRACE))
def test_trace_reader_reads_the_window(name):
    assert core.load_reader(name)(ctx("sweep", 1, PARENT_SPANS)) == \
        pytest.approx(TRACE[name])


def test_tables_reader_reads_nothing_on_a_program_without_the_span():
    read = core.load_reader("tables_ms.bch")
    assert read(ctx("sweep", 1, PARENT_SPANS)) is None
    assert read(ctx("sweep", 1, {"scl.tables": (0, 0.0)})) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_where_the_run_holds_nothing(name):
    read = core.load_reader(name)
    spans = dict(PARENT_SPANS, **SPANS.get(name, ({}, None))[0])
    assert read(dict(ctx("sweep", 1, spans), trace=None)) is None
    if name in SPANS:
        assert read(ctx("sweep", 1, {})) is None
        no_spans = ctx("sweep", 1, spans)
        del no_spans["trace"]["spans"]
        assert read(no_spans) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_in_another_cell(name):
    read = core.load_reader(name)
    spans = dict(PARENT_SPANS, **SPANS.get(name, ({}, None))[0])
    assert read(ctx("decode", 1, spans)) is None
    if name in ("pass_setup_ms.bch", "tables_ms.bch"):
        assert read(ctx("sweep", 4, spans)) is None
