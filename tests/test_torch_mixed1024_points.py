"""The mixed_n1024_scl32 benchmark cell's fused step against the
benchmark's plain reference on the CPU: at each of the cell's points, the
port's fused step (its plain version, `McStep.counts` on the CPU) gives,
on the key `run_sweep` draws call 0 of the point with, the frame and bit
errors that portbench/ref gives for the same frame: draw, decode, count.

An N=1024 decode at L=32 takes about a second a frame on one CPU
thread: one frame a point. The rest of the cell's CPU tests:
tests/test_torch_mixed1024_cell.py.
"""
import json

import pytest
import torch

from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops.mc import McStep
from polar_tpu_torch.ops.philox import step_seed
from portbench import core
from portbench.kinds.sweep import pass_seed
from portbench.ref.channel import ebn0_to_sigma
from portbench.ref.model import Reference

CELL = "mixed_n1024_scl32.fused_sweep"
SEED = 4_294_967_311
POINTS = json.loads((core.HERE / "cells" / f"{CELL}.json").read_text())["ebn0_db"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark runs (portbench/run.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def step():
    return McStep(get_preset("mixed_n1024_scl32").spec, 32, "cpu", counters=True)


@pytest.fixture(scope="module")
def ref():
    return Reference(core.load_cell(CELL).config, "cpu")


@pytest.mark.parametrize("point", range(len(POINTS)))
def test_fused_step_equals_the_reference_at_each_point(point, step, ref):
    seed = pass_seed(SEED, 0)
    key = Reference.key(seed, point, 0)
    assert key == step_seed(seed, point, 0, 0, 0)
    sigma = ebn0_to_sigma(POINTS[point], ref.spec.rate)
    u_true, llr = ref.draw(key, sigma, 1)
    want = ref.count(ref.decode(llr).u, u_true)
    got = step.counts(key, sigma, 1)
    assert got.dtype == want.dtype and torch.equal(got, want)
