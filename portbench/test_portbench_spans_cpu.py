"""The readers of the per-layer metrics that read the program's own spans
(portbench/metrics): each reads its spans from rank 0's trace summary of
its own cell, and nothing, without raising, where the program has no such
span, as a program older than these spans has none.

    python -m pytest portbench/test_portbench_spans_cpu.py -q -p no:cacheprovider
"""
from __future__ import annotations

import pytest

from portbench import core

BENCH = core.load_benchmark()
# metric -> (kind, cards, the spans it reads: {name: (count, total us)},
# its value in ms)
READS = {
    "pass_setup_ms.sim": ("sweep", 1, {"run_sweep.setup": (4, 100.0)}, 0.025),
    "pass_setup_ms.mesh": ("sweep", 4, {"run_sweep.setup": (4, 100.0)}, 0.025),
    "pass_setup_ms.eager": ("sweep", 1, {"run_sweep.setup": (4, 100.0)}, 0.025),
    "save_ms.sim": ("sweep", 1, {"run_sweep.save": (10, 50.0)}, 0.005),
    "entry_ms.decode": ("decode", 1, {"scl.decode": (8, 40.0)}, 0.005),
    "child_ms.eager": ("sweep", 1, {"walk.child": (26, 300.0),
                                    "scl.decode": (2, 900.0)}, 0.15),
    "outer_ms.eager": ("sweep", 1, {"walk.outer": (28, 500.0),
                                    "scl.decode": (2, 900.0)}, 0.25),
    "epilogue_ms.eager": ("sweep", 1, {"walk.epilogue": (2, 60.0),
                                       "scl.decode": (2, 900.0)}, 0.03),
    "draw_ms.eager": ("sweep", 1, {"mc_step.draw": (2, 20.0),
                                   "run_sweep.dispatch": (2, 1000.0)}, 0.01),
}
# the spans a program without the new ones has: the harness's and the
# decode kind's own
PARENT_SPANS = {"run_sweep.dispatch": (6, 600.0), "run_sweep.fetch": (6, 60.0),
                "portbench.decode_call": (6, 30.0)}


def summary(spans: dict) -> dict:
    """A trace summary (yardstick/trace.py) holding `spans` alone."""
    return {"window_us": 1e4, "busy_us": 5e3, "idle_share": 0.5,
            "kernel_busy_us": 5e3, "nccl_us": 0.0, "device_ops": [],
            "gaps": [],
            "spans": {n: {"count": c, "us": us} for n, (c, us) in spans.items()}}


def ctx(kind: str, cards: int, spans: dict) -> dict:
    s = summary(spans)
    return {"cell": "x", "kind": kind, "trace": s,
            "work": {"frames": 1, "ops": 1, "bytes": 0}, "submit_ms": None,
            "ranks": [s] * cards}


def test_each_new_metric_is_declared_for_its_one_cell():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name, (kind, cards, _, _) in READS.items():
        m = declared[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert len(m["workloads"]) == 1
        cell = core.load_cell(m["workloads"][0])
        assert (cell.kind, cell.chips) == (kind, cards)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_its_spans(name):
    kind, cards, spans, value = READS[name]
    read = core.load_reader(name)
    assert read(ctx(kind, cards, dict(PARENT_SPANS, **spans))) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_where_its_spans_are_absent(name):
    kind, cards, spans, _ = READS[name]
    read = core.load_reader(name)
    assert read(ctx(kind, cards, PARENT_SPANS)) is None
    assert read(ctx(kind, cards, {})) is None
    no_spans = ctx(kind, cards, spans)
    del no_spans["trace"]["spans"]
    assert read(no_spans) is None
    assert read(dict(ctx(kind, cards, spans), trace=None)) is None
    # every span it divides by has to be there with a count above 0
    for span in spans:
        zero = dict(spans, **{span: (0, 0.0)})
        assert read(ctx(kind, cards, zero)) is None, span
        assert read(ctx(kind, cards, {n: v for n, v in spans.items()
                                      if n != span})) is None, span


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_in_another_cell(name):
    kind, cards, spans, _ = READS[name]
    read = core.load_reader(name)
    other = "decode" if kind == "sweep" else "sweep"
    assert read(ctx(other, cards, spans)) is None
    # a one-card metric on four ranks, the four-card one on one
    assert read(ctx(kind, 1 if cards == 4 else 4, spans)) is None
