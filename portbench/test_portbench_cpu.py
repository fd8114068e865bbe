"""The benchmark's CPU tests: its files, its yardstick and its reference
against the program's plain versions, and a whole run of each kind at a
tiny size with the program's plain versions, sound and with faults
planted underneath.

    python -m pytest portbench/test_portbench_cpu.py -q -p no:cacheprovider
"""
from __future__ import annotations

import ast
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from portbench import core, run, window
from portbench.ref import model
from portbench.yardstick import opcount
from portbench.yardstick import trace as tr

BENCH = core.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 4_294_967_311
CARD = {"name": "cpu", "power_limit_w": 0.0}
TINY = {"sweep": {"frames_per_pass": 128, "batch_per_card": 64,
                  "check_calls": 2},
        "decode": {"batch": 32, "pool": 3, "check_batches": 2}}


def tiny_cell(name: str, **over):
    cell = core.load_cell(name)
    cell.traffic.update(TINY[cell.kind], **over)
    return cell


def cpu_line(cell, tmp, seconds=0.01):
    part = run.run_here(cell, SEED, seconds, False, tmp, device="cpu")
    part["forbidden"] = core.forbidden_modules()
    return run.result(cell, [part], False, CARD)[0]


# ---- the files: BENCHMARK.json, cells, configurations, metrics ----

def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = core.load_cell(name)
    assert core.load_kind(cell.kind).run
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.traffic["limits"]) <= {"frames_off", "pm_gap",
                                           "calls_off", "passes_off"}
    for m in cell.per_layer:
        assert callable(core.load_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_is_the_program_preset_uncut(name):
    from polar_tpu_torch.models.presets import get_preset

    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    config = json.loads((core.ROOT / conf["file"]).read_text())
    assert conf["reduced"] == [] and config["name"] == name
    spec = model.code_spec(config)
    prog = get_preset(name).spec
    assert (spec.N, spec.K, spec.factors) == (prog.N, prog.K, prog.factors)
    assert np.array_equal(spec.frozen, prog.frozen)
    assert (spec.crc.width, spec.crc.poly, spec.crc.init) == (
        prog.crc.width, prog.crc.poly, prog.crc.init)
    assert config["list_size"] == get_preset(name).list_size
    data = core.ROOT / config["code"]["frozen_set"]
    seq = (core.ROOT / "polar_tpu_torch" / "models" / "sequences" / data.name)
    assert data.read_bytes() == seq.read_bytes()


def _imports(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(core.HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(core.HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = _imports(path)
    assert not tops & set(core.FORBIDDEN), tops
    if path.is_relative_to(core.HERE / "ref"):
        assert "polar_tpu_torch" not in tops
    if path.is_relative_to(core.HERE / "yardstick"):
        assert "polar_tpu_torch" not in tops


def test_forbidden_modules_compare_whole_names():
    assert "polar_tpu_torch" not in core.FORBIDDEN
    assert core.forbidden_modules() == []


# ---- the yardstick ----

@pytest.mark.parametrize("name,P,ops,pro", [
    ("ca_scl", 8, 224_048, 59_904), ("mixed_scl32", 32, 131_160_096, 262_656)])
def test_op_counts_equal_chip_smokes(name, P, ops, pro):
    import chip_smoke
    from polar_tpu_torch.models.presets import get_preset

    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    spec = model.code_spec(json.loads((core.ROOT / conf["file"]).read_text()))
    assert opcount.element_ops(spec, P) == ops
    assert opcount.prologue_ops(spec) == pro
    prog = get_preset(name).spec
    assert chip_smoke.element_ops(prog, P) == ops
    assert chip_smoke.prologue_ops(prog) == pro
    assert opcount.PEAK_ELEM_OPS_PER_S == chip_smoke.PEAK_ELEM_OPS_PER_S
    assert opcount.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S


def test_stage_counts_equal_chip_smokes_on_the_16x16_kernel():
    import chip_smoke
    from polar_tpu_torch.kernels.bch import build_bch_kernel

    k = build_bch_kernel(16)
    for i in range(16):
        for shared in (False, True):
            assert (opcount.stage_down_ops(k, i, shared)
                    == chip_smoke.stage_down_ops(k, i, shared))
    assert (opcount.node_ops(k, list(range(16)), 32, 1)
            == chip_smoke.node_ops(k, list(range(16)), 32, 1))


def _trace(tmp) -> pathlib.Path:
    """A small recorded trace: two kernels (one NCCL), a copy, two
    dispatch spans and a host op over the idle gap."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "scl_mc_counters", "ts": 0, "dur": 400},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce", "ts": 800, "dur": 200},
        {"ph": "X", "cat": "user_annotation", "name": "run_sweep.dispatch", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "run_sweep.dispatch", "ts": 700, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 550, "dur": 200},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5}]
    path = tmp / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_summary_of_a_recorded_trace(tmp_path):
    s = tr.summary(tr.load_events(_trace(tmp_path)))
    assert s["window_us"] == 1000 and s["busy_us"] == 700
    assert s["kernel_busy_us"] == 600 and s["nccl_us"] == 200
    assert s["spans"]["run_sweep.dispatch"] == {"count": 2, "us": 80}
    assert s["gaps"][0]["us"] == 300 and list(s["gaps"][0]["host_ops"]) == [
        "aten::to", "run_sweep.dispatch"]
    b = tr.breakdown(s)
    assert b["device_ops"][0] == ["scl_mc_counters", pytest.approx(400e-6)]
    assert b["idle_gaps"] == [["aten::to + run_sweep.dispatch",
                               pytest.approx(300e-6)]]


def test_each_metric_reader_on_a_recorded_trace(tmp_path):
    s = tr.summary(tr.load_events(_trace(tmp_path)))
    work = {"frames": 10, "ops": 33.5e12 * 300e-6, "bytes": 0}
    sim = {"cell": "x", "kind": "sweep", "trace": s, "work": work,
           "ranks": [s, s]}
    dec = dict(sim, kind="decode", submit_ms=0.25, ranks=[s])
    read = {m["name"]: core.load_reader(m["name"]) for m in BENCH["per_layer"]}
    for layer in ("idle_pct", "roofline_pct", "dispatch_ms"):
        for suffix in ("eager", "mesh"):
            assert read[f"{layer}.{suffix}"](sim) == read[f"{layer}.sim"](sim)
    assert read["idle_pct.sim"](sim) == pytest.approx(30.0)
    assert read["idle_pct.decode"](dec) == pytest.approx(30.0)
    assert read["roofline_pct.sim"](sim) == pytest.approx(50.0)
    assert read["roofline_pct.decode"](dec) == pytest.approx(50.0)
    assert read["dispatch_ms.sim"](sim) == pytest.approx(0.04)
    assert read["submit_ms.decode"](dec) == 0.25
    assert read["allreduce_pct.sim"](sim) == pytest.approx(20.0)
    # each reads nothing where its run holds nothing to read
    assert read["idle_pct.sim"](dec) is None
    assert read["submit_ms.decode"](sim) is None
    assert read["allreduce_pct.sim"](dict(sim, ranks=[s])) is None
    assert read["roofline_pct.sim"](dict(sim, work=dict(work, frames=0))) is None


# ---- the reference against the program's plain versions ----

@pytest.mark.parametrize("factors,K,L", [((2,) * 5, 16, 4), ((2,) * 6, 24, 8),
                                         ((4, 2, 2), 6, 2), ((16, 2), 12, 4)])
def test_reference_decoder_equals_the_programs_plain(factors, K, L):
    from polar_tpu_torch.models.polar import CodeSpec as PSpec
    from polar_tpu_torch.ops.scl import build_plain_scl_decoder as plain
    from portbench.ref.polar import CodeSpec
    from portbench.ref.scl import build_plain_scl_decoder

    N = int(np.prod(factors))
    rng = np.random.default_rng(N + K)
    mask = np.ones(N, int)
    mask[rng.choice(N, K, replace=False)] = 0
    mask = tuple(int(v) for v in mask)
    ref = CodeSpec(N=N, K=K, factors=factors, frozen_mask=mask)
    prog = PSpec(N=N, K=K, factors=factors, frozen_mask=mask)
    llr = torch.from_numpy(rng.normal(1.0, 2.0, (32, N)).astype(np.float32))
    a = build_plain_scl_decoder(ref, L)(llr)
    b = plain(prog, L)(llr)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_reference_draw_and_decode_equal_the_programs_on_full_ca_scl_frames():
    from polar_tpu_torch.models.presets import get_preset
    from polar_tpu_torch.ops.mc import count_errors, mc_draw
    from polar_tpu_torch.ops.philox import step_seed
    from polar_tpu_torch.ops.scl import build_plain_scl_decoder as plain
    from portbench.ref.channel import ebn0_to_sigma
    from polar_tpu_torch.sim.channel import ebn0_to_sigma as prog_sigma

    conf = json.loads((core.ROOT / "portbench/configs/ca_scl.json").read_text())
    ref = model.Reference(conf, "cpu")
    prog = get_preset("ca_scl").spec
    key = model.Reference.key(SEED << 20 | 3, 0, 5, 2)
    assert key == step_seed(SEED << 20 | 3, 0, 5, 0, 2)
    sigma = ebn0_to_sigma(0.5, ref.spec.rate)
    assert sigma == float(prog_sigma(0.5, prog.rate))
    u_true, llr = ref.draw(key, sigma, 6)
    pu, pllr = mc_draw(prog, key, sigma, 6)
    assert torch.equal(u_true, pu) and torch.equal(llr, pllr)
    a, b = ref.decode(llr), plain(prog, 8)(llr)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ref.count(a.u, u_true), count_errors(prog, b.u, pu))


# ---- the window, `failed`, and the result line ----

def test_window_counts_units_and_a_raise_as_one_failed_call():
    seen = []
    w = window.run_units(seen.append, 0.0)
    assert (w["units"], w["failed"], seen) == (1, 0, [0])

    def unit(i):
        if i == 3:
            raise RuntimeError("boom")

    w = window.run_units(unit, 60.0)
    assert (w["units"], w["failed"]) == (3, 1) and "boom" in w["error"]
    votes = iter([False, False, True])
    w = window.run_units(lambda i: None, 60.0, stop=lambda done: next(votes))
    assert w["units"] == 3


def test_reservoir_is_the_seeds_and_builds_only_what_it_keeps():
    a, b = window.Reservoir(7, 3), window.Reservoir(7, 3)
    made = []
    for i in range(100):
        a.offer(lambda j: made.append(j) or j)
        b.offer(lambda j: j)
    assert a.items == b.items and len(made) < 100 and a.offered == 100


def _part(calls, control=False, raised=0):
    return {"check": {"calls": calls, "passes_off": 0, "frames": 64,
                      "control": control},
            "raised": raised, "error": None, "attempted": len(calls),
            "memory_peak_bytes": 1, "check_s": 0.1, "forbidden": [],
            "wall_start": run.T0 + 1.0,
            "values": {"sim_cw_per_s": 1.0, "sim_cw_per_s.mesh": 1.0}}


def test_failed_counts_calls_not_frame_errors():
    cell = core.load_cell("ca_scl.fused_sweep")
    # every frame in error at a low SNR, the reference agreeing: no failure
    calls = {i: {"off": 0, "gap": None, "ref_sum": [64, 9000],
                 "logged": [64, 9000]} for i in range(4)}
    line, _ = run.result(cell, [_part(calls)], False, CARD)
    assert (line["correct"], line["failed"], line["attempted"]) == (True, 0, 4)
    calls[1]["off"] = 5
    calls[2]["logged"] = [63, 9000]
    line, _ = run.result(cell, [_part(calls)], False, CARD)
    assert (line["correct"], line["failed"]) == (False, 2)
    line, _ = run.result(cell, [_part({}, raised=1)], False, CARD)
    assert not line["correct"] and line["failed"] == 1
    assert line["compared"]["frames_off"]["value"] is None


def test_result_line_keys_and_compared_last():
    cell = core.load_cell("ca_scl.fused_sweep")
    calls = {0: {"off": 0, "gap": None, "ref_sum": [1, 2], "logged": [1, 2]}}
    line, checks = run.result(cell, [_part(calls)], False, CARD)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"sim_cw_per_s", "setup_s"}
    assert line["metrics"]["setup_s"]["value"] == pytest.approx(1.0)
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert {c["name"] for c in checks} == set(line["compared"])


def test_the_exchange_between_cards_left_out_is_not_correct():
    cell = core.load_cell("sweep.fused_4chip")
    ranks = [{0: {"off": 0, "gap": None, "ref_sum": [3, 40], "logged": [5, 70]}},
             {0: {"off": 0, "gap": None, "ref_sum": [2, 30], "logged": [5, 70]}}]
    line, _ = run.result(cell, [_part(c) for c in ranks], False, CARD)
    assert line["correct"]
    # each rank's counters alone, as where the all-reduce is left out
    ranks[0][0]["logged"], ranks[1][0]["logged"] = [3, 40], [2, 30]
    line, _ = run.result(cell, [_part(c) for c in ranks], False, CARD)
    assert not line["correct"] and line["compared"]["calls_off"]["value"] == 1


# ---- whole runs at a tiny size on the CPU, sound and with faults ----

@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_sweep_run_on_the_cpu_is_correct(backend, tmp_path):
    line = cpu_line(tiny_cell("ca_scl.fused_sweep", backend=backend), tmp_path)
    assert line["correct"], line
    assert line["card"]["frames_compared"] == 128
    assert line["attempted"] == 2 and line["failed"] == 0


def test_decode_run_on_the_cpu_is_correct(tmp_path):
    line = cpu_line(tiny_cell("ca_scl.decode"), tmp_path)
    assert line["correct"], line
    assert line["metrics"]["decode_p95_ms"]["value"] > 0


def _break_counts(monkeypatch, how):
    from polar_tpu_torch.ops.mc import McStep

    inner = McStep.plain_counts

    def broken(self, seed, sigma, batch, noise=None):
        cnt = inner(self, seed, sigma, batch, noise).clone()
        if how == "half":        # half of the batch left out
            cnt[:, batch // 2:] = 0
        else:                    # one answer altered where it is produced
            cnt[1, 0] += 1
            cnt[0, 0] = 1
        return cnt

    monkeypatch.setattr(McStep, "plain_counts", broken)


@pytest.mark.parametrize("how", ["half", "altered"])
def test_fused_sweep_with_a_fault_is_not_correct(how, monkeypatch, tmp_path):
    _break_counts(monkeypatch, how)
    cell = tiny_cell("ca_scl.fused_sweep", ebn0_db=[0.0])
    line = cpu_line(cell, tmp_path)
    assert not line["correct"], line
    assert line["compared"]["frames_off"]["value"] > 0
    assert line["failed"] > 0


def test_torch_sweep_with_an_altered_decision_is_not_correct(monkeypatch,
                                                             tmp_path):
    from polar_tpu_torch.ops import scl

    inner = scl.build_scl_decoder

    def broken(*args, **kwargs):
        decode = inner(*args, **kwargs)

        def flip(llrs):
            res = decode(llrs)
            return res._replace(u=res.u ^ 1)
        return flip

    monkeypatch.setattr(scl, "build_scl_decoder", broken)
    from polar_tpu_torch.sim import harness
    monkeypatch.setattr(harness, "build_scl_decoder", broken)
    line = cpu_line(tiny_cell("ca_scl.fused_sweep", backend="torch"), tmp_path)
    assert not line["correct"]
    assert line["compared"]["frames_off"]["value"] == 128


def test_decode_with_an_altered_metric_is_not_correct(monkeypatch, tmp_path):
    from polar_tpu_torch.ops import scl

    inner = scl.build_scl_decoder

    def broken(*args, **kwargs):
        decode = inner(*args, **kwargs)
        return lambda llrs: decode(llrs)._replace(pm=decode(llrs).pm + 0.5)

    monkeypatch.setattr(scl, "build_scl_decoder", broken)
    line = cpu_line(tiny_cell("ca_scl.decode"), tmp_path)
    assert not line["correct"]
    assert line["compared"]["pm_gap"]["value"] > 1e-3
    assert line["compared"]["frames_off"]["value"] == 0


def test_sweep_drawing_other_frames_is_not_correct(monkeypatch, tmp_path):
    from polar_tpu_torch.sim import harness

    inner = harness.step_seed
    monkeypatch.setattr(harness, "step_seed",
                        lambda seed, *a, **k: inner(seed + 1, *a, **k))
    line = cpu_line(tiny_cell("ca_scl.fused_sweep"), tmp_path)
    assert not line["correct"]
    assert line["compared"]["frames_off"]["value"] == 128


def test_sweep_whose_harness_drops_a_calls_counters_is_not_correct(monkeypatch,
                                                                   tmp_path):
    from polar_tpu_torch.sim import harness

    inner = harness.InFlight.counts
    seen = []

    def dropped(self):
        fe, be = inner(self)
        seen.append(fe)
        # the warm-up fetches two calls; drop the window's first
        return (0, 0) if len(seen) == 3 else (fe, be)

    monkeypatch.setattr(harness.InFlight, "counts", dropped)
    line = cpu_line(tiny_cell("ca_scl.fused_sweep", ebn0_db=[0.0]), tmp_path)
    assert not line["correct"]
    assert line["compared"]["passes_off"]["value"] == 1
    assert line["compared"]["frames_off"]["value"] == 0
