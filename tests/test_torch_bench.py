"""The port's entry points on the CPU: the decode bench
(polar_tpu_torch/benchmarks/decode_bench.py), the flagship bench
(polar_tpu_torch/bench.py) and gen_sequences
(polar_tpu_torch/scripts/gen_sequences.py), held to the JAX package's
benchmarks/decode_bench.py options and scripts/gen_sequences.py table."""
import importlib.util
import json
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from polar_tpu_torch import bench
from polar_tpu_torch.benchmarks import decode_bench
from polar_tpu_torch.models.presets import get_preset
from polar_tpu_torch.ops.mc import build_mc_step
from polar_tpu_torch.scripts import gen_sequences
from polar_tpu_torch.sim.channel import ebn0_to_sigma

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = {"preset", "backend", "batch", "big_stage", "subtree", "measures",
          "route", "list_size", "ms_per_decode", "codewords_per_s", "build_s",
          "frame_errors", "launches", "device", "card"}


def _line(capsys) -> dict:
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("argv,measures,route", [
    (["--preset", "arikan_sc", "--backend", "pallas"], "decode", "decode kernels"),
    (["--preset", "arikan_sc", "--backend", "xla"], "decode", "decode kernels"),
    (["--preset", "ca_scl", "--backend", "xla"], "decode", "decode kernels"),
    (["--preset", "ca_scl", "--backend", "fused"], "mc_step", "fused step"),
    (["--preset", "bch_sc", "--backend", "xla", "--big-stage", "pallas"],
     "decode", "op program, stage kernel"),
], ids=["arikan_sc-pallas", "arikan_sc-xla", "ca_scl-xla", "ca_scl-fused",
        "bch_sc-hybrid"])
def test_decode_bench_row_on_cpu(capsys, argv, measures, route):
    decode_bench.main(argv + ["--device", "cpu", "--batch", "4", "--reps", "1"])
    rec = _line(capsys)
    assert set(rec) == FIELDS
    preset = get_preset(argv[1])
    assert (rec["preset"], rec["backend"], rec["batch"]) == (argv[1], argv[3], 4)
    assert rec["list_size"] == preset.list_size
    assert rec["measures"] == measures and rec["route"] == route
    assert rec["codewords_per_s"] == 4 / rec["ms_per_decode"] * 1e3 > 0
    assert rec["build_s"] > 0
    assert rec["launches"] == {}
    assert rec["device"] == "cpu" and rec["card"] is None
    xla = argv[3] == "xla"
    assert rec["big_stage"] == ((argv[5] if len(argv) > 4 else "xla")
                                if xla else None)
    assert rec["subtree"] == ("none" if xla else None)
    if argv[3] != "fused":
        assert rec["frame_errors"] is None
        return
    # the fused row's frame errors: the step's own counts at keys (1 + i, 17),
    # i = 0 (the warm-up) and 1
    step = build_mc_step(preset.spec, preset.list_size, device="cpu",
                         counters=True)
    sigma = float(ebn0_to_sigma(2.0, preset.spec.rate))
    assert rec["frame_errors"] == sum(int(step((1 + i, 17), sigma, 4)[0])
                                      for i in range(2))


@pytest.mark.parametrize("decoder", ["pallas", "xla"])
def test_flagship_bench_on_cpu(capsys, monkeypatch, decoder):
    for var, value in (("BENCH_DEVICE", "cpu"), ("BENCH_BATCH", "4"),
                       ("BENCH_REPS", "1"), ("BENCH_DECODER", decoder)):
        monkeypatch.setenv(var, value)
    bench.main()
    line = _line(capsys)
    assert set(line) == {"metric", "value", "unit"}
    assert line["metric"] == "decoded_codewords_per_s_per_chip_n1024_scl8"
    assert line["unit"] == "codewords/s/chip" and line["value"] > 0


def test_flagship_llrs_follow_the_channel():
    """BPSK +-1 (equiprobable) plus sigma N(0, 1) at 2.0 dB, scaled by
    2 / sigma^2, as bench.py makes them: y = llr sigma^2 / 2 has mean 0 and
    E|y| = E|1 + sigma n|; the same seed gives the same LLRs."""
    spec = get_preset("ca_scl").spec
    llr = bench.flagship_llrs(spec.N, spec.rate, 64, "cpu")
    sigma = float(ebn0_to_sigma(2.0, spec.rate))
    y = llr.double() * sigma * sigma / 2.0
    assert llr.shape == (64, spec.N) and llr.dtype == torch.float32
    e_abs = (sigma * math.sqrt(2 / math.pi) * math.exp(-0.5 / sigma ** 2)
             + math.erf(1 / (sigma * math.sqrt(2))))
    # 65,536 samples: sd of each mean below 0.004
    assert abs(float(y.abs().mean()) - e_abs) < 0.02
    assert abs(float(y.mean())) < 0.02
    assert torch.equal(bench.flagship_llrs(spec.N, spec.rate, 64, "cpu"), llr)


def test_entry_points_raise_without_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("BENCH_DEVICE", "BENCH_BATCH", "BENCH_REPS", "BENCH_DECODER"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()
    for backend in ("xla", "pallas", "fused"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            decode_bench.main(["--backend", backend, "--batch", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_sequences.main(["--out", str(tmp_path), "arikan_n1024_k512"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_sequences.build("bch_n256_k128", tmp_path)
    assert list(tmp_path.iterdir()) == []


def _usage_options(help_text: str) -> set:
    usage = help_text.split("\n\n")[0]
    return set(re.findall(r"\[(--?[\w-]+)", usage))


def test_decode_bench_options_match_jax(capsys):
    """The JAX script's options (its --help exits before any JAX import),
    less --batch-tile, are the port's; the port adds only --device."""
    res = subprocess.run([sys.executable, "benchmarks/decode_bench.py", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    theirs = _usage_options(res.stdout)
    with pytest.raises(SystemExit):
        decode_bench.main(["--help"])
    ours = _usage_options(capsys.readouterr().out)
    assert "--batch-tile" in theirs and "--big-stage" in theirs
    assert theirs - {"--batch-tile"} <= ours
    assert ours - theirs == {"--device"}


def test_gen_sequences_specs_match_jax():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_sequences", ROOT / "scripts" / "gen_sequences.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    # the JAX script's specs, each as it states it, and the port's one own
    # (the mixed_n1024_scl32 preset's mask)
    own = {"mixed_n1024_k528": ((16, 16, 2, 2), 528, 2.0, "mc")}
    assert gen_sequences.SPECS == {**jax_script.SPECS, **own}
    assert not set(own) & set(jax_script.SPECS)
    assert "frames = 1 << 15" in (ROOT / "scripts" / "gen_sequences.py").read_text()
    assert gen_sequences.MC_FRAMES == 1 << 15 and gen_sequences.MC_SEED == 0


@pytest.mark.parametrize("name", ["arikan_n1024_k512", "arikan_n1024_k528"])
def test_gen_sequences_rebuilds_committed_ga_masks(tmp_path, capsys, name):
    path = gen_sequences.build(name, tmp_path, device="cpu")
    committed = ROOT / "polar_tpu_torch" / "models" / "sequences" / f"{name}.npy"
    assert path == tmp_path / f"{name}.npy"
    assert path.read_bytes() == committed.read_bytes()
    assert name in capsys.readouterr().out
    assert gen_sequences.OUT == ROOT / "build" / "sequences"
    assert np.load(path).sum() == 1024 - gen_sequences.SPECS[name][1]
