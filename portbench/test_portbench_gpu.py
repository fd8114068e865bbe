"""The benchmark on the card (marker `gpu`; each skips without the cards
its cell asks for):

    python -m pytest -m gpu portbench/test_portbench_gpu.py -s

- every cell runs a short window and comes out correct;
- the lower-precision control of every cell, at the cell's own size on
  three seeds, comes out not correct; `-s` prints each reading.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import pytest
import torch

from portbench import core, run

pytestmark = pytest.mark.gpu

CELLS = [w["name"] for w in core.load_benchmark()["workloads"]]
CONTROL_SEEDS = (2_147_483_659, 3_000_000_019, 4_294_967_311)


@pytest.fixture
def card(name) -> dict:
    """The first card's name and power limit; skips the test where the
    machine has fewer cards than the cell `name` asks for."""
    need = core.load_cell(name).chips
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        pytest.skip(f"{name} needs {need} CUDA card(s), {have} present")
    return core.card()


def one_card_line(name: str, seed: int, seconds: float, tmp, card: dict,
                  control=False):
    cell = core.load_cell(name)
    part = run.run_here(cell, seed, seconds, False, tmp, control=control)
    return run.result(cell, [part], False, card)[0]


@pytest.mark.parametrize("name", CELLS)
def test_short_window_is_correct(name, card, tmp_path):
    if core.load_cell(name).chips == 1:
        line = one_card_line(name, 5_000_000_029, 1.0, tmp_path, card)
    else:
        out = subprocess.run([sys.executable, "-m", "portbench.run",
                              "--workload", name, "--seed", "5000000029",
                              "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=600,
                             cwd=core.ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps({"cell": name, "compared": line["compared"]}))
    assert line["correct"], line


@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_control_is_not_correct(name, seed, card, tmp_path):
    cell = core.load_cell(name)
    if cell.chips == 1:
        line = one_card_line(name, seed, 1.0, tmp_path, card, control=True)
    else:
        args = argparse.Namespace(seed=seed, seconds=1.0, trace=0)
        parts = run.multi_card(cell, args, tmp_path, control=True)
        line = run.result(cell, parts, False, card)[0]
    print(json.dumps({"control": name, "seed": seed,
                      "compared": line["compared"]}))
    assert not line["correct"], line
