"""The mixed_n1024_scl32 cell's readers on the CPU: each of the five
reads its own numbers, and nothing, without raising, where its run holds
nothing to read; `launch_ms.m1024` reads nothing on a program without the
`mc_step.launch` span. The configuration against the program's preset and
the cell's work a codeword are held by tests/test_torch_mixed1024_cell.py.

    python -m pytest portbench/test_portbench_mixed1024_cpu.py -q -p no:cacheprovider
"""
from __future__ import annotations

import pytest

from portbench import core
from portbench.yardstick import opcount

BENCH = core.load_benchmark()
CELL = "mixed_n1024_scl32.fused_sweep"
# metric -> the spans it reads: {name: (count, total us)}, its value in ms
SPANS = {
    "pass_setup_ms.m1024": ({"run_sweep.setup": (4, 100.0)}, 0.025),
    "tables_ms.m1024": ({"scl.tables": (4, 2000.0)}, 0.5),
    "launch_ms.m1024": ({"mc_step.launch": (32, 1600.0)}, 0.05),
}
# metric -> its value on the summary below, in %
TRACE = {"idle_pct.m1024": 50.0, "roofline_pct.m1024": 20.0}
NEW = sorted([*SPANS, *TRACE])
# the spans a program without `mc_step.launch` has
PARENT_SPANS = {"run_sweep.dispatch": (6, 600.0), "run_sweep.fetch": (6, 60.0),
                "run_sweep.setup": (1, 7.0), "scl.tables": (1, 3.0)}
ONE_CARD = ("pass_setup_ms.m1024", "tables_ms.m1024")


def ctx(kind: str, cards: int, spans: dict) -> dict:
    """A traced run's context: a 10-ms window, the card busy 5 ms of it,
    and work whose least time is 1 ms."""
    s = {"window_us": 1e4, "busy_us": 5e3, "idle_share": 0.5,
         "kernel_busy_us": 5e3, "nccl_us": 0.0, "device_ops": [], "gaps": [],
         "spans": {n: {"count": c, "us": us} for n, (c, us) in spans.items()}}
    work = {"frames": 1, "ops": opcount.PEAK_ELEM_OPS_PER_S * 1e-3, "bytes": 0}
    return {"cell": CELL, "kind": kind, "trace": s, "work": work,
            "submit_ms": None, "ranks": [s] * cards}


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


def test_launch_reader_reads_nothing_on_a_program_without_the_span():
    read = core.load_reader("launch_ms.m1024")
    assert read(ctx("sweep", 1, PARENT_SPANS)) is None
    assert read(ctx("sweep", 1, {"mc_step.launch": (0, 0.0)})) is None


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
    if name in ONE_CARD:
        assert read(ctx("sweep", 4, spans)) is None


def test_b2048_cell_reports_the_eager_metrics():
    cell = core.load_cell("mixed_scl32.subtree_sweep_b2048")
    base = core.load_cell("mixed_scl32.subtree_sweep")
    assert [m["name"] for m in cell.end_to_end] == ["sim_cw_per_s.eager", "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == ["idle_pct.eager",
                                                         "roofline_pct.eager"]
    same = {k: v for k, v in base.traffic.items()
            if k not in ("frames_per_pass", "batch_per_card", "check_calls")}
    assert {k: cell.traffic[k] for k in same} == same
    assert (cell.traffic["frames_per_pass"] // cell.traffic["batch_per_card"]
            == base.traffic["frames_per_pass"] // base.traffic["batch_per_card"] == 16)
