"""The port's host spans (polar_tpu_torch/utils/spans.py) on the CPU: with
no profiler active a span is one shared null context and makes no
RecordFunction; under torch.profiler a sweep's trace holds every span,
each inside the span that holds it in the program; and the spans leave
what the program computes as it was."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import Preset
from polar_tpu_torch.ops.program import build_program, subtree_items
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.sim import harness
from polar_tpu_torch.utils import spans

# span -> the span that holds it; the others sit at the top of the call
PARENT = {"run_sweep.save": "run_sweep.fetch",
          "mc_step.draw": "run_sweep.dispatch",
          "scl.decode": "run_sweep.dispatch",
          "walk.child": "scl.decode", "walk.outer": "scl.decode",
          "walk.epilogue": "scl.decode"}
TOP = ("run_sweep.setup", "run_sweep.dispatch", "run_sweep.fetch")
SWEEP = {"run_sweep.setup", "run_sweep.dispatch", "run_sweep.fetch",
         "run_sweep.save"}
# backend -> the spans a two-call sweep through it holds on the CPU, where
# the fused step runs the plain walk (ops/mc.py McStep.plain) under the
# dispatch, with no decoder entry; on the card it is one kernel launch
HELD = {"torch": SWEEP | {"mc_step.draw", "scl.decode", "walk.child",
                          "walk.outer", "walk.epilogue"},
        "fused": SWEEP | {"walk.outer", "walk.epilogue"}}
CALLS = 2
BATCH = 16


def _spec() -> CodeSpec:
    """A small mixed (2, 16, 2) code whose subtree route runs on the CPU
    (a cheap mask: the spans do not depend on it)."""
    factors, K, crc = (2, 16, 2), 14, CrcSpec(8, 0x07, 0)
    N = int(np.prod(factors))
    r = np.random.default_rng(1)
    mask = np.ones(N, np.uint8)
    mask[np.argsort(r.random(N) + np.linspace(0, 1, N))[-(K + 8):]] = 0
    return CodeSpec(N=N, K=K, factors=factors,
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)


def _sweep(backend: str, state_path) -> list[dict]:
    """A two-call sweep of one point through `backend` (the torch backend
    on the subtree route, mixed_scl32's)."""
    preset = Preset("mixed_small", _spec(), 4, (1.0,), CALLS * BATCH, BATCH)
    return harness.run_sweep(preset, per_device_batch=BATCH, device="cpu",
                             seed=5, state_path=str(state_path),
                             progress=False, backend=backend,
                             subtree_backend="pallas")


def _traced(fn, path):
    """fn() under torch.profiler on the CPU, and the user spans of the
    Chrome trace it exports to `path`."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]


def _inside(e, outer) -> bool:
    return (e["tid"] == outer["tid"] and outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def test_untraced_span_is_one_null_context_and_makes_no_record_function(
        monkeypatch, tmp_path):
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        entered.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    assert spans.span("run_sweep.setup") is spans.span("walk.child")
    with spans.span("walk.child") as held:
        assert held is None
    _sweep("torch", tmp_path / "state.json")
    assert entered == []
    # the count sees the spans where a profile is active
    _traced(lambda: _sweep("torch", tmp_path / "traced.json"),
            tmp_path / "trace.json")
    assert HELD["torch"] <= set(entered)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_traced_sweep_holds_every_span_nested(backend, tmp_path):
    _, events = _traced(lambda: _sweep(backend, tmp_path / "state.json"),
                        tmp_path / "trace.json")
    ours = [e for e in events if e["name"] in HELD["torch"]]
    names = [e["name"] for e in ours]
    assert set(names) == HELD[backend]
    assert names.count("run_sweep.setup") == 1
    for name in ("run_sweep.dispatch", "run_sweep.fetch", "run_sweep.save"):
        assert names.count(name) == CALLS, name
    parent = dict(PARENT)
    if backend == "fused":
        parent.update({"walk.outer": "run_sweep.dispatch",
                       "walk.epilogue": "run_sweep.dispatch"})
    for e in ours:
        if e["name"] in parent:
            assert any(_inside(e, o) for o in ours
                       if o["name"] == parent[e["name"]]), e["name"]
        else:
            assert e["name"] in TOP
            assert not any(_inside(e, o) for o in ours if o is not e), e["name"]
    if backend == "torch":
        spec = _spec()
        items = subtree_items(build_program(spec, 4), spec)
        kinds = [kind for kind, *_ in items]
        children = kinds.count("sub")
        runs = sum(k == "op" and (j == 0 or kinds[j - 1] == "sub")
                   for j, k in enumerate(kinds))
        assert children > 1
        assert names.count("scl.decode") == CALLS
        assert names.count("mc_step.draw") == CALLS
        assert names.count("walk.child") == CALLS * children
        assert names.count("walk.outer") == CALLS * runs
        assert names.count("walk.epilogue") == CALLS


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_spans_leave_the_sweeps_counters_as_they_are(backend, tmp_path):
    plain = _sweep(backend, tmp_path / "plain.json")
    traced, _ = _traced(lambda: _sweep(backend, tmp_path / "traced.json"),
                        tmp_path / "trace.json")
    for a, b in zip(plain, traced):
        a.pop("codewords_per_s"), b.pop("codewords_per_s")
    assert traced == plain and plain[0]["frames"] == CALLS * BATCH
    assert (json.loads((tmp_path / "traced.json").read_text())
            == json.loads((tmp_path / "plain.json").read_text()))


@pytest.mark.parametrize("subtree", ["none", "pallas"])
def test_spans_leave_the_decoders_outputs_as_they_are(subtree, tmp_path):
    """The decoder entry on the default walk (one `walk.outer` a decode)
    and on the subtree route, with and without the profiler."""
    spec = _spec()
    decode = build_scl_decoder(spec, 4, device="cpu", subtree_backend=subtree)
    llrs = torch.from_numpy((3.0 * np.random.default_rng(7).standard_normal(
        (BATCH, spec.N))).astype(np.float32))
    plain = decode(llrs)
    traced, events = _traced(lambda: decode(llrs), tmp_path / "trace.json")
    for field in ("u", "payload", "crc_ok", "pm"):
        assert torch.equal(getattr(traced, field), getattr(plain, field)), field
    names = [e["name"] for e in events]
    assert names.count("scl.decode") == 1 and names.count("walk.epilogue") == 1
    if subtree == "none":
        assert names.count("walk.outer") == 1 and "walk.child" not in names
    else:
        assert names.count("walk.child") > 1
