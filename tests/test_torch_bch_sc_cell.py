"""The bch_sc benchmark cell on the CPU (portbench/cells/bch_sc.fused_sweep.json):
the 16x16 eBCH code N=256, K=128, SC, no CRC, through the fused step.

- The port's fused step (its plain version, `McStep.counts` on the CPU)
  gives, on the key `run_sweep` draws call 0 of each of the cell's points
  with, the frame and bit errors of each frame that the benchmark's plain
  reference (portbench/ref) gives: draw, decode, count.
- A whole run of the cell at a tiny size reads correct, and not correct
  with one decision flipped in the program's counts.
- The work a codeword that the cell's roofline share counts.
- The `scl.tables` span: once for a fresh kernel set's tables, never on a
  cached call, never untraced.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops.cuda_scl import SclKernels
from polar_tpu_torch.ops.mc import McStep, count_errors
from polar_tpu_torch.ops.philox import step_seed
from portbench import core, run
from portbench.kinds.sweep import pass_seed
from portbench.ref.channel import ebn0_to_sigma
from portbench.ref.model import Reference, code_spec
from portbench.yardstick import opcount

CELL = "bch_sc.fused_sweep"
SEED = 4_294_967_311
BATCH = 64
POINTS = json.loads((core.HERE / "cells" / f"{CELL}.json").read_text())["ebn0_db"]
CARD = {"name": "cpu", "power_limit_w": 0.0}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark runs (portbench/run.py): the
    plain l > 2 stages' many small ops slow down, and vary tenfold, when
    their threads share the host's cores with other processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cell():
    return core.load_cell(CELL)


@pytest.fixture(scope="module")
def step():
    return McStep(get_preset("bch_sc").spec, 1, "cpu", counters=True)


@pytest.fixture(scope="module")
def ref(cell):
    return Reference(cell.config, "cpu")


def test_cell_is_the_bch_sc_preset(cell):
    spec, prog = code_spec(cell.config), get_preset("bch_sc")
    assert (spec.N, spec.K, spec.factors, spec.crc) == (256, 128, (16, 16), None)
    assert np.array_equal(spec.frozen, prog.spec.frozen) and prog.spec.crc is None
    assert cell.config["list_size"] == prog.list_size == 1
    assert cell.traffic["backend"] == "fused" and cell.chips == 1


@pytest.mark.parametrize("point", range(len(POINTS)))
def test_fused_step_equals_the_reference_at_each_point(point, step, ref):
    seed = pass_seed(SEED, 0)
    key = Reference.key(seed, point, 0)
    assert key == step_seed(seed, point, 0, 0, 0)
    sigma = ebn0_to_sigma(POINTS[point], ref.spec.rate)
    u_true, llr = ref.draw(key, sigma, BATCH)
    want = ref.count(ref.decode(llr).u, u_true)
    got = step.counts(key, sigma, BATCH)
    assert got.dtype == want.dtype and torch.equal(got, want)


def tiny(cell):
    """The cell at a tiny size: its points, two calls of 64 frames a
    point a pass, two calls compared."""
    cell = core.load_cell(cell.name)
    cell.traffic.update(frames_per_pass=2 * BATCH, batch_per_card=BATCH,
                        check_calls=2)
    return cell


def cpu_line(cell, tmp) -> dict:
    part = run.run_here(cell, SEED, 0.01, False, tmp, device="cpu")
    return run.result(cell, [part], False, CARD)[0]


def test_tiny_run_of_the_cell_is_correct(cell, tmp_path):
    line = cpu_line(tiny(cell), tmp_path)
    assert line["correct"], line
    assert line["failed"] == 0
    assert line["attempted"] == 2 * len(POINTS)
    assert line["card"]["frames_compared"] == 2 * BATCH
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
    assert line["compared"]["frames_off"]["value"] == 2
    assert line["compared"]["calls_off"]["value"] == 2
    assert line["failed"] == 2


def test_work_a_codeword_is_chip_smokes_count(cell):
    import chip_smoke

    spec, prog = code_spec(cell.config), get_preset("bch_sc").spec
    assert opcount.element_ops(spec, 1) == chip_smoke.element_ops(prog, 1) == 199_528
    assert opcount.prologue_ops(spec) == chip_smoke.prologue_ops(prog) == 15_904


def _entered(monkeypatch) -> list:
    """Names of the RecordFunctions made from here on."""
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        entered.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    return entered


def test_tables_span_once_for_a_fresh_kernel_set(monkeypatch):
    entered = _entered(monkeypatch)
    kernels = SclKernels(get_preset("bch_sc").spec, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = kernels.device_tables(torch.device("cpu"))
        again = kernels.device_tables(torch.device("cpu"))
    assert again is first and kernels.tables is not None
    assert entered.count("scl.tables") == 1
    names = [e.key for e in prof.key_averages()]
    assert "scl.tables" in names
    assert next(e for e in prof.key_averages() if e.key == "scl.tables").count == 1


def test_tables_span_absent_untraced(monkeypatch):
    entered = _entered(monkeypatch)
    kernels = SclKernels(get_preset("bch_sc").spec, 1)
    kernels.device_tables(torch.device("cpu"))
    kernels.device_tables(torch.device("cpu"))
    assert kernels.tables is not None and entered == []
