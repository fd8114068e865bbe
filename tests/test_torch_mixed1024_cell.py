"""The mixed_n1024_scl32 benchmark cell on the CPU
(portbench/cells/mixed_n1024_scl32.fused_sweep.json): config 4's kernels
(16x16 eBCH, 16x16 eBCH, Arikan, Arikan), CRC-16 and L=32 at N=1024,
K=512, through the fused step.

- The configuration is the program's preset, uncut.
- A whole run of the cell at a tiny size reads correct, and not correct
  with one decision flipped in the program's counts.
- The work a codeword that the cell's roofline share counts.
- The launch plan: K5 at its capacity-32 l > 2 instance, one launch a
  call; the `mc_step.launch` span once a call traced, never untraced, and
  `INSTANCES` counting the instance's launches.

An N=1024 decode at L=32 takes about a second a frame on one CPU
thread, so each decode is of one frame. The port's fused step against
the reference at each of the cell's points is
tests/test_torch_mixed1024_points.py.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops.mc import McStep, count_errors
from portbench import core, run
from portbench.ref.model import code_spec
from portbench.yardstick import opcount
from tests.test_torch_bch_sc_cell import _entered
from tests.test_torch_launch_plan import _fake_card

CELL = "mixed_n1024_scl32.fused_sweep"
SEED = 4_294_967_311
POINTS = json.loads((core.HERE / "cells" / f"{CELL}.json").read_text())["ebn0_db"]
CARD = {"name": "cpu", "power_limit_w": 0.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark runs (portbench/run.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cell():
    return core.load_cell(CELL)


@pytest.fixture(scope="module")
def preset():
    return get_preset("mixed_n1024_scl32")


def test_cell_is_the_preset_uncut(cell, preset):
    spec, prog = code_spec(cell.config), preset.spec
    assert (spec.N, spec.K, spec.factors) == (prog.N, prog.K, prog.factors) == \
        (1024, 512, (16, 16, 2, 2))
    assert np.array_equal(spec.frozen, prog.frozen)
    assert int((~prog.frozen.astype(bool)).sum()) == cell.config["code"]["unfrozen"] == 528
    assert (spec.crc.width, spec.crc.poly, spec.crc.init) == \
        (prog.crc.width, prog.crc.poly, prog.crc.init) == (16, 0x1021, 0)
    assert cell.config["list_size"] == preset.list_size == 32
    assert tuple(POINTS) == preset.ebn0_grid
    assert cell.traffic["batch_per_card"] == preset.batch
    assert cell.traffic["backend"] == "fused" and cell.chips == 1
    conf = next(c for c in core.load_benchmark()["configs"]
                if c["name"] == "mixed_n1024_scl32")
    assert conf["reduced"] == [] and cell.config["assumed"]
    data = core.ROOT / cell.config["code"]["frozen_set"]
    seq = core.ROOT / "polar_tpu_torch" / "models" / "sequences" / data.name
    assert data.read_bytes() == seq.read_bytes()


def tiny(cell):
    """The cell at a tiny size: its first point, one call of one frame a
    pass, that call compared."""
    cell = core.load_cell(cell.name)
    cell.traffic.update(ebn0_db=POINTS[:1], frames_per_pass=1, batch_per_card=1,
                        check_calls=1)
    return cell


def cpu_line(cell, tmp) -> dict:
    part = run.run_here(cell, SEED, 0.01, False, tmp, device="cpu")
    return run.result(cell, [part], False, CARD)[0]


def test_tiny_run_of_the_cell_is_correct(cell, tmp_path):
    line = cpu_line(tiny(cell), tmp_path)
    assert line["correct"], line
    assert line["failed"] == 0 and line["attempted"] == 1
    assert line["card"]["frames_compared"] == 1
    assert set(line["metrics"]) == {"sim_cw_per_s", "setup_s"}


def test_tiny_run_with_one_decision_flipped_is_not_correct(cell, monkeypatch,
                                                          tmp_path):
    def flipped(self, seed, sigma, batch, noise=None):
        u_true, llr = self._draw(seed, sigma, batch, noise)
        u = self.decoder.plain(llr).u.clone()
        u[0, self.spec.info_positions[0]] ^= 1
        return count_errors(self.spec, u, u_true)

    monkeypatch.setattr(McStep, "plain_counts", flipped)
    line = cpu_line(tiny(cell), tmp_path)
    assert not line["correct"], line
    assert line["compared"]["frames_off"]["value"] == 1
    assert line["compared"]["calls_off"]["value"] == 1
    assert line["failed"] == 1


def test_work_a_codeword_is_chip_smokes_count(cell, preset):
    import chip_smoke

    spec = code_spec(cell.config)
    assert opcount.element_ops(spec, 32) == chip_smoke.element_ops(preset.spec, 32) \
        == 29_257_728
    assert opcount.prologue_ops(spec) == chip_smoke.prologue_ops(preset.spec) == 64_640


def test_k5_plan_is_the_capacity32_big_instance(preset):
    plan = cuda_scl.launch_plan(preset.spec, 32, "scl_mc_counters")
    assert (plan.instance, plan.threads, plan.codewords, plan.blocks_per_sm,
            plan.chunk) == ("scl_mc_counters_big_c32", 256, 1, 2, 0)
    assert cuda_scl.launch_plan(preset.spec, 32, "scl_decode").instance == \
        "scl_decode_big_c32"


def test_launch_span_once_a_call_traced_never_untraced(monkeypatch, preset):
    """On an H100's plan with the library faked: each call of the fused
    step's launch is one `mc_step.launch` span while a profile is active,
    none otherwise; each is one library call of `_big_c32`, which
    `INSTANCES` counts."""
    lib, index = _fake_card(monkeypatch)
    entered = _entered(monkeypatch)
    step = McStep(preset.spec, 32, "cpu", counters=True)
    step.device = torch.device("cuda:0")
    B = preset.batch

    def call():
        step._launch("scl_mc_counters", (1, 2), 0.5, B, None,
                     counters=torch.empty((2, B), dtype=torch.int32))

    before = dict(cuda_scl.INSTANCES)
    call()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        call()
    assert entered.count("mc_step.launch") == 2
    assert next(e for e in prof.key_averages() if e.key == "mc_step.launch").count == 2
    call()
    assert entered.count("mc_step.launch") == 2
    i = index["scl_mc_counters_big_c32"]
    assert [c for c in lib.calls if c[0] == "scl_launch"] == [
        ("scl_launch", i, cuda_scl.KERNELS["scl_mc_counters"], 256, 1, B, 0, B)] * 4
    assert cuda_scl.INSTANCES["scl_mc_counters_big_c32"] == \
        before.get("scl_mc_counters_big_c32", 0) + 4
