"""The port's multi-device sweep on the CPU: polar_tpu_torch/parallel/mesh.py
(init_multihost, make_batch_mesh, sharded_mc_step) in two gloo ranks
launched by torchrun, run_sweep over that mesh against the JAX package's
run_sweep on a 2-device mesh of the virtual CPU devices (tests/conftest.py),
two launches at once, the counter copies of run_sweep's fetch, `sweep_cli
--profile`, the trace reader, and the entry points of
polar_tpu_torch/entry.py."""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from polar_tpu.models.polar import CodeSpec as JCodeSpec, CrcSpec as JCrcSpec
from polar_tpu.models.presets import Preset as JPreset
from polar_tpu.parallel.mesh import make_batch_mesh as j_make_batch_mesh
from polar_tpu.sim import harness as j_harness
from polar_tpu_torch import entry
from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import Preset
from polar_tpu_torch.ops.philox import MASK32, philox4x32_10_int, step_seed
from polar_tpu_torch.parallel.mesh import (RANK_THREADS, launch,
                                           make_batch_mesh)
from polar_tpu_torch.sim import harness, sweep_cli
from polar_tpu_torch.sim.kernel_times import trace_summary

# a guard against a hung 2-rank run, not a check of its speed: on an 8-core
# host the fixture's run took 4.9-6.7 s beside 0 to 56 busy processes, and
# its first test 7.6-8.5 s in three runs of the whole suite (-n 6); 300 s is
# ~35x that, and the limit tests/test_multiprocess.py gives its two processes
LAUNCH_TIMEOUT = 300
SIGMA = 0.9

# one rank of the 2-rank gloo run: the sharded step, then a sweep over the
# mesh and its resume; each rank writes its result to result_rank<r>.json
# (not to the stdout both ranks share: two ranks' writes to one pipe can
# interleave, and rank 0's stdout carries the sweep's printed records)
_WORKER = r"""
import json, pathlib, sys
import torch.distributed as dist
from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import Preset
from polar_tpu_torch.parallel.mesh import (init_multihost, make_batch_mesh,
                                           sharded_mc_step)
from polar_tpu_torch.sim.harness import SweepState, make_mc_step, run_sweep

out = pathlib.Path(sys.argv[1])
mask = tuple(int(v) for v in construct_ga(64, 24, 2.0))
spec = CodeSpec(N=64, K=16, factors=(2,) * 6, frozen_mask=mask,
                crc=CrcSpec(width=8, poly=0x07))
preset = Preset("tiny", spec, 4, (1.0, 4.0), 1 << 11, 1 << 9)
assert init_multihost("cpu")
mesh = make_batch_mesh(device="cpu")
raw = make_mc_step(spec, 4, backend="fused", device="cpu")
res = sharded_mc_step(raw, mesh)(3, 0, 5, 0.9, 64)
own = raw(3, 0, 5, 0.9, 64, rank=mesh.rank)
state = out / "state.json"
recs = run_sweep(preset, frames=1024, mesh=mesh, state_path=str(state),
                 jsonl_path=str(out / "out.jsonl"))
saved = SweepState.load(state).__dict__ if mesh.rank == 0 else None
again = run_sweep(preset, frames=1024, mesh=mesh, state_path=str(state),
                  progress=False)
(out / f"result_rank{mesh.rank}.json").write_text(json.dumps({
    "rank": mesh.rank, "size": mesh.size, "axis": mesh.axis_names,
    "frames": res["frames"], "counts": res["counts"].tolist(),
    "own": [int(own["frame_errors"]), int(own["bit_errors"])],
    "recs": recs, "again": again, "saved": saved,
    "resaved": SweepState.load(state).__dict__ if mesh.rank == 0 else None,
}))
dist.destroy_process_group()
"""


# one rank of a 2-rank gloo run that only meets its peer: the sum of its
# run's values (argv[2] + rank) over the group, the store's port and the
# rank's threads, written to argv[1]/peer<rank>.json
_PEER_WORKER = r"""
import json, os, pathlib, sys
import torch
import torch.distributed as dist
dist.init_process_group("gloo")
rank = dist.get_rank()
total = torch.tensor([int(sys.argv[2]) + rank])
dist.all_reduce(total)
(pathlib.Path(sys.argv[1]) / f"peer{rank}.json").write_text(json.dumps([
    rank, dist.get_world_size(), int(total), os.environ["MASTER_PORT"],
    torch.get_num_threads()]))
dist.destroy_process_group()
"""


def _spec():
    """The tiny code of tests/test_harness_parallel.py."""
    mask = tuple(int(v) for v in construct_ga(64, 24, 2.0))
    return CodeSpec(N=64, K=16, factors=(2,) * 6, frozen_mask=mask,
                    crc=CrcSpec(width=8, poly=0x07))


def _counted(rec: dict) -> dict:
    """A record without its rate (each rank's own clock)."""
    return {k: v for k, v in rec.items() if k != "codewords_per_s"}


def _preset():
    return Preset("tiny", _spec(), 4, (1.0, 4.0), 1 << 11, 1 << 9)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Rank 0's and rank 1's results of the 2-rank gloo run, its stdout and
    its output directory."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "worker.py"
    script.write_text(_WORKER)
    stdout = launch(2, [str(script), str(out)], timeout=LAUNCH_TIMEOUT)
    res = sorted((json.loads(p.read_text()) for p in
                  out.glob("result_rank*.json")), key=lambda r: r["rank"])
    assert [r["rank"] for r in res] == [0, 1]
    return res, stdout, out


def test_step_seed_rank():
    assert step_seed(7, 2, 5, 1) == step_seed(7, 2, 5, 1, rank=0)
    keys = {step_seed(7, 2, 5, 1, rank=r) for r in range(8)}
    assert len(keys) == 8
    # the rank is the last word of the Philox counter
    assert step_seed(7, 2, 5, 1, rank=3) == philox4x32_10_int((5, 1, 2, 3),
                                                              (7, 0))[:2]
    with pytest.raises(ValueError):
        step_seed(7, 2, 5, 1, rank=-1)
    with pytest.raises(ValueError):
        step_seed(7, 2, 5, 1, rank=MASK32 + 1)


def test_sharded_step_sums_the_ranks(two_ranks):
    """The all-reduced counters are the sum of each rank's own step on
    step_seed(..., rank=r), and rank 0 draws the single-device step's
    frames."""
    res, _, _ = two_ranks
    step = harness.make_mc_step(_spec(), 4, backend="fused", device="cpu")
    mine = [step(3, 0, 5, SIGMA, 64, rank=r) for r in (0, 1)]
    mine = [[int(o["frame_errors"]), int(o["bit_errors"])] for o in mine]
    single = step(3, 0, 5, SIGMA, 64)
    assert [r["own"] for r in res] == mine
    assert mine[0] == [int(single["frame_errors"]), int(single["bit_errors"])]
    assert mine[0] != mine[1]
    for r in res:
        assert (r["size"], r["axis"], r["frames"]) == (2, ["batch"], 128)
        assert r["counts"] == [mine[0][0] + mine[1][0], mine[0][1] + mine[1][1]]


def test_mesh_sweep_runs_and_resumes(two_ranks):
    """Both ranks count the same; rank 0 alone prints and writes the state
    and JSONL; a rerun adds no frame."""
    res, stdout, out = two_ranks
    recs = res[0]["recs"]
    assert [_counted(r) for r in res[1]["recs"]] == [_counted(r) for r in recs]
    assert [r["frames"] for r in recs] == [1024, 1024]
    assert all((r["n_devices"], r["global_batch"]) == (2, 512) for r in recs)
    printed = [json.loads(line) for line in stdout.splitlines()
               if line.startswith('{"preset"')]
    assert printed == recs
    assert [json.loads(line) for line in
            (out / "out.jsonl").read_text().splitlines()] == recs
    assert res[1]["saved"] is None
    saved = res[0]["saved"]
    assert saved["frames"] == [1024, 1024] and saved["rng_step"] == [2, 2]
    assert res[0]["resaved"] == saved
    for r in res:
        assert [_counted(a) for a in r["again"]] == [_counted(a) for a in recs]


def test_mesh_sweep_records_match_jax(two_ranks, tmp_path):
    """Records of the JAX package's run_sweep on a 2-device mesh of the
    same preset: the same keys, frames, n_devices, global_batch and
    rng_step; both FERs fall from 1 dB to 4 dB. The counts differ by
    design (the RNG streams differ)."""
    res, _, _ = two_ranks
    spec = _spec()
    jspec = JCodeSpec(N=64, K=16, factors=(2,) * 6, frozen_mask=spec.frozen_mask,
                      crc=JCrcSpec(width=8, poly=0x07))
    jpath = tmp_path / "jax_state.json"
    jrecs = j_harness.run_sweep(JPreset("tiny", jspec, 4, (1.0, 4.0), 1 << 11, 1 << 9),
                                frames=1024, mesh=j_make_batch_mesh(2),
                                state_path=str(jpath), progress=False)
    recs = res[0]["recs"]
    for mine, theirs in zip(recs, jrecs):
        assert set(mine) == set(theirs)
        for k in ("preset", "ebn0_db", "frames", "n_devices", "global_batch"):
            assert mine[k] == theirs[k], k
    assert j_harness.SweepState.load(jpath).rng_step == res[0]["saved"]["rng_step"]
    assert recs[0]["fer"] > recs[1]["fer"]
    assert jrecs[0]["fer"] > jrecs[1]["fer"]


def test_concurrent_launches_meet_their_own_peers(tmp_path, monkeypatch):
    """Two 2-rank launches at once, from two threads, both return: each
    run's ranks meet only each other (the sum of their own run's values)
    on a store port of their own, at RANK_THREADS threads whatever the
    caller's OMP_NUM_THREADS. A port picked, released and handed to
    torchrun would fail here whenever the two runs drew the same one."""
    monkeypatch.setenv("OMP_NUM_THREADS", "4")
    script = tmp_path / "peer.py"
    script.write_text(_PEER_WORKER)
    bases = (10, 20)
    for base in bases:
        (tmp_path / str(base)).mkdir()
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(launch, 2, [str(script), str(tmp_path / str(base)),
                                        str(base)], LAUNCH_TIMEOUT)
                for base in bases]
        for run in runs:
            run.result()
    ports = []
    for base in bases:
        peers = [json.loads((tmp_path / str(base) / f"peer{r}.json").read_text())
                 for r in (0, 1)]
        assert [p[:3] for p in peers] == [[0, 2, 2 * base + 1],
                                          [1, 2, 2 * base + 1]]
        assert [p[4] for p in peers] == [RANK_THREADS] * 2
        assert peers[0][3] == peers[1][3]
        ports.append(peers[0][3])
    assert ports[0] != ports[1]


def test_single_device_mesh():
    mesh = make_batch_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.axis_names) == \
        (None, 0, 1, ("batch",))
    with pytest.raises(ValueError):
        make_batch_mesh(2, device="cpu")
    # a mesh passed in gives what the default gives
    a = harness.run_sweep(_preset(), frames=512, device="cpu", progress=False)
    b = harness.run_sweep(_preset(), frames=512, mesh=mesh, progress=False)
    assert [r["frame_errors"] for r in a] == [r["frame_errors"] for r in b]
    assert all((r["n_devices"], r["global_batch"]) == (1, 512) for r in a)


def test_pipeline_depth_gives_the_same_sweep(tmp_path):
    out = {}
    for depth in (1, 2, 3):
        spath = tmp_path / f"state{depth}.json"
        recs = harness.run_sweep(_preset(), frames=512, per_device_batch=128,
                                 device="cpu", progress=False,
                                 state_path=str(spath), pipeline_depth=depth)
        out[depth] = ([_counted(r) for r in recs], json.loads(spath.read_text()))
    assert out[1] == out[2] == out[3]


def test_counter_copies_ring():
    """Each call's counters land in a buffer of their own while depth + 1
    calls are in flight; on the CPU the copy is done at once."""
    import torch

    copies = harness.CounterCopies(2, torch.device("cpu"))
    calls = [copies.start(64, torch.tensor([i, 10 * i], dtype=torch.int64))
             for i in range(3)]
    assert len({c.host.data_ptr() for c in calls}) == 3
    assert all(c.event is None for c in calls)
    assert [c.counts() for c in calls] == [(0, 0), (1, 10), (2, 20)]
    assert copies.start(64, torch.tensor([5, 6])).host is calls[0].host


def test_sweep_cli_profile_on_cpu(tmp_path, capsys):
    args = ["--preset", "arikan_sc", "--snr", "1.0", "3.0", "--frames", "128",
            "--per-device-batch", "64", "--backend", "fused", "--device", "cpu"]
    sweep_cli.main(args)
    plain = capsys.readouterr().out.strip().splitlines()
    sweep_cli.main(args + ["--profile", str(tmp_path / "trace")])
    traced = capsys.readouterr().out.strip().splitlines()
    assert traced[-1] == plain[-1] and json.loads(plain[-1])["summary"]
    assert json.loads(traced[-2])["seconds"] > 0
    trace = tmp_path / "trace" / "trace_rank0.json"
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"run_sweep.dispatch", "run_sweep.fetch"} <= names
    with pytest.raises(ValueError, match="no device activity"):
        trace_summary(trace)


def test_trace_summary(tmp_path):
    """Busy is the union of device intervals over streams; gaps carry the
    host ops that overlap them."""
    def ev(cat, name, ts, dur, tid=7):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": tid}

    events = [ev("kernel", "k5", 0, 10), ev("kernel", "k5", 5, 15, tid=8),
              ev("gpu_memcpy", "Memcpy DtoH", 30, 5), ev("kernel", "k1", 50, 10),
              ev("cuda_runtime", "cudaEventSynchronize", 20, 30),
              ev("user_annotation", "run_sweep.fetch", 22, 18),
              ev("cpu_op", "aten::stack", 100, 5), {"ph": "i", "name": "mark"}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_summary(path, top=5, gaps=3)
    assert (s["window_us"], s["busy_us"]) == (60.0, 35.0)
    assert s["idle_share"] == pytest.approx(25 / 60)
    assert s["kernels"] == [{"name": "k5", "launches": 2, "us": 25.0},
                            {"name": "k1", "launches": 1, "us": 10.0}]
    assert [(g["us"], g["at_us"]) for g in s["gaps"]] == [(15.0, 35.0), (10.0, 20.0)]
    assert s["gaps"][0]["host_ops"] == {"cudaEventSynchronize": 15.0,
                                        "run_sweep.fetch": 5.0}


def test_entry_on_cpu():
    fn, args = entry.entry(device="cpu")
    out = fn(*args)
    assert out["frames"] == entry.ENTRY_BATCH
    assert 0 <= int(out["frame_errors"]) <= int(out["bit_errors"])


def test_dryrun_multichip_on_cpu(capsys):
    lines = entry.dryrun_multichip(2, device="cpu")
    assert [line.split("[")[1].split("]")[0] for line in lines] == \
        ["tiny-mixed", "flagship-ca_scl"]
    assert all(f"2 devices, {2 * entry.PER_DEVICE} frames" in line
               for line in lines)
    assert capsys.readouterr().out.splitlines() == lines
    assert np.isfinite([float(line.rsplit("=", 1)[1]) for line in lines]).all()
