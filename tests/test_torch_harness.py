"""The port's Monte-Carlo harness and CLI (polar_tpu_torch/sim) on the CPU,
held against the JAX package's harness where they share semantics
(wilson_ci, SweepState and its JSON, resume, record keys)."""
import dataclasses
import json

import numpy as np
import pytest

from polar_tpu.sim import harness as j_harness
from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import Preset
from polar_tpu_torch.sim import harness, sweep_cli


def _tiny_preset():
    """The tiny preset of tests/test_harness_parallel.py."""
    mask = tuple(int(v) for v in construct_ga(64, 24, 2.0))
    spec = CodeSpec(N=64, K=16, factors=(2,) * 6, frozen_mask=mask,
                    crc=CrcSpec(width=8, poly=0x07))
    return Preset("tiny", spec, 4, (1.0, 4.0), 1 << 11, 1 << 9)


def _sweep(**kw):
    return harness.run_sweep(_tiny_preset(), frames=1024, per_device_batch=128,
                             device="cpu", progress=False, **kw)


def test_wilson_ci_matches_jax():
    for errors, n in [(0, 0), (0, 10), (10, 1000), (999, 1000), (5, 5),
                      (28258, 10027008), (1, 3)]:
        assert harness.wilson_ci(errors, n) == j_harness.wilson_ci(errors, n)


def test_sweep_state_matches_jax(tmp_path):
    fields = [(f.name, f.type) for f in dataclasses.fields(harness.SweepState)]
    assert fields == [(f.name, f.type) for f in
                      dataclasses.fields(j_harness.SweepState)]
    st = j_harness.SweepState.fresh("tiny", (1.0, 4.0), 7)
    st.frames[0], st.frame_errors[0], st.rng_step[0] = 512, 33, 4
    st.save(tmp_path / "s.json")
    mine = harness.SweepState.load(tmp_path / "s.json")
    assert dataclasses.asdict(mine) == dataclasses.asdict(st)
    mine.save(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "s.json").read_text())


def test_sweep_runs_and_resumes(tmp_path):
    spath, jpath = tmp_path / "state.json", tmp_path / "out.jsonl"
    recs = _sweep(state_path=str(spath), jsonl_path=str(jpath))
    assert len(recs) == 2
    assert recs[0]["fer"] > recs[1]["fer"]          # 1 dB vs 4 dB
    assert recs[0]["frames"] == 1024 and recs[0]["frame_errors"] > 0
    lines = [json.loads(line) for line in jpath.read_text().splitlines()]
    assert lines == recs
    jax_keys = {"preset", "ebn0_db", "frames", "frame_errors", "bit_errors",
                "fer", "ber", "fer_ci95", "codewords_per_s", "n_devices",
                "global_batch"}
    assert set(recs[0]) == jax_keys
    st = harness.SweepState.load(spath)
    assert st.rng_step == [8, 8]
    # resume: the state file says done; a rerun adds no frames
    recs2 = _sweep(state_path=str(spath))
    st2 = harness.SweepState.load(spath)
    assert st2.frames == st.frames and st2.rng_step == st.rng_step
    assert [r["frame_errors"] for r in recs2] == [r["frame_errors"] for r in recs]


def test_resume_draws_the_same_frames(tmp_path):
    """A sweep cut after half its frames and resumed counts what an uncut
    sweep counts (frames are keyed by their place in the sweep)."""
    spath = tmp_path / "state.json"
    harness.run_sweep(_tiny_preset(), frames=512, per_device_batch=128,
                      device="cpu", progress=False, state_path=str(spath))
    resumed = _sweep(state_path=str(spath))
    whole = _sweep()
    for a, b in zip(resumed, whole):
        assert (a["frames"], a["frame_errors"], a["bit_errors"]) == \
            (b["frames"], b["frame_errors"], b["bit_errors"])


def test_backends_give_identical_records():
    recs = {b: _sweep(backend=b, seed=5) for b in harness.BACKENDS}
    for a, b in zip(recs["torch"], recs["fused"]):
        a, b = dict(a), dict(b)
        a.pop("codewords_per_s"), b.pop("codewords_per_s")
        assert a == b


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_superbatch_counts_frames(backend):
    """steps_per_call=2 counts 2 batches: sub-step s is the batch keyed
    step_seed(seed, snr_index, step, s)."""
    from polar_tpu_torch.ops.mc import build_mc_step
    from polar_tpu_torch.ops.philox import step_seed

    spec = _tiny_preset().spec
    step2 = harness.make_mc_step(spec, 4, steps_per_call=2, backend=backend,
                                 device="cpu")
    out = step2(3, 0, 5, 0.9, 128)
    assert out["frames"] == 256
    one = build_mc_step(spec, 4, device="cpu", counters=True)
    parts = [one(step_seed(3, 0, 5, sub), 0.9, 128) for sub in (0, 1)]
    assert int(out["frame_errors"]) == sum(int(p[0]) for p in parts) > 0
    assert int(out["bit_errors"]) == sum(int(p[1]) for p in parts)
    recs = _sweep(backend=backend, steps_per_call=2, pipeline_depth=1)
    assert [r["frames"] for r in recs] == [1024, 1024]


def test_min_frame_errors_stops_early():
    recs = _sweep(min_frame_errors=20)
    assert recs[0]["frames"] < 1024 and recs[0]["frame_errors"] >= 20
    assert recs[1]["frames"] == 1024


def test_unported_knobs_raise():
    with pytest.raises(ValueError):
        _sweep(big_stage_backend="mosaic")
    with pytest.raises(ValueError):
        _sweep(backend="xla")


def test_sweep_cli_on_cpu(tmp_path, capsys):
    jpath = tmp_path / "out.jsonl"
    sweep_cli.main(["--preset", "arikan_sc", "--snr", "1.0", "3.0",
                    "--frames", "128", "--per-device-batch", "64",
                    "--backend", "fused", "--device", "cpu",
                    "--jsonl", str(jpath)])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])["summary"]
    assert [s["ebn0_db"] for s in summary] == [1.0, 3.0]
    assert all(s["frames"] == 128 for s in summary)
    assert summary[0]["fer"] >= summary[1]["fer"]
    assert len(jpath.read_text().splitlines()) == 2
    assert np.isfinite([s["ber"] for s in summary]).all()
