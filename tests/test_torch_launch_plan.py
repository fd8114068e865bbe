"""The decode kernels' launch plan (ops/cuda_scl.py `launch_plan`), on the
CPU: the one place that chooses a launch's instance of
csrc/scl_decode.cu, its threads and codewords a block and its shared
memory. The library only launches what the plan names and checks it
against its own table of instances (`kInstances`, parsed here from the
source); tests/test_torch_cuda.py (marker `gpu`) holds the plan to the
library and the occupancy API on the card.
"""
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from polar_tpu_torch.models import presets
from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
from polar_tpu_torch.sim.golden import CRC8, jittered_spec
from tests.test_torch_arikan8 import SIZES, _spec
from tests.test_torch_big8 import _specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = tuple(cuda_scl.KERNELS)


def instance_table() -> dict:
    """{instance: (kernel index, capacity, threads, codewords, fast, big)}
    of the source's `kInstances`."""
    src = (ROOT / "polar_tpu_torch" / "csrc" / "scl_decode.cu").read_text()
    rows = re.findall(r"^\s*INSTANCE\((\w+), (\d), (\d+), (\w+), (\d), (true|false), "
                      r"(true|false)\),$", src, re.M)
    return {name: (int(k), int(cap), cuda_scl.C32_THREADS if t == "kThreads" else int(t),
                   int(cw), fast == "true", big == "true")
            for name, k, cap, t, cw, fast, big in rows}


def _mixed_children():
    spec = presets.get_preset("mixed_scl32").spec
    return [subtree_spec(spec, it[2]) for it in subtree_items(build_program(spec, scl=True), spec)
            if it[0] == "sub"]


def test_instance_table_holds_every_built_instance():
    """The table lists the 30 instances the macros build, each once, with
    the threads of its launch bounds and its codewords a block."""
    src = (ROOT / "polar_tpu_torch" / "csrc" / "scl_decode.cu").read_text()
    table = instance_table()
    built = {f"{k}_t{T}" for T in re.findall(r"^FAST_KERNELS\((\d+)\)$", src, re.M)
             for k in KERNELS[:4]}
    built |= {f"{k}{'' if k == 'scl_subtree' else '_big'}_t{T}"
              for T in re.findall(r"^BIG8_KERNELS\((\d+)\)$", src, re.M) for k in KERNELS}
    built |= {f"{k}_big_t32_cw2" for k in re.findall(r"^BIG8_CW2_KERNEL\((\w+),", src, re.M)}
    built |= set(re.findall(r"^SCL_KERNEL\((\w+_c32), kThreads,", src, re.M))
    assert len(table) == 30 and set(table) == built
    for name, (kernel, cap, threads, cw, fast, big) in table.items():
        assert name.startswith(KERNELS[kernel])
        assert cap == (32 if name.endswith("_c32") else 8)
        assert cw == (2 if name.endswith("_cw2") else 1)
        assert threads == (256 if cap == 32 else 32 if cw == 2 else int(name.rsplit("_t", 1)[1]))
        assert fast == (cap == 8 and "_big" not in name and kernel < 4)


def test_plans_of_the_cells():
    """The instances the benchmark's cells run (the ledger's device ops):
    ca_scl K5 and K1 on the Arikan body, bch_sc K5 two codewords a warp,
    mixed_scl32's K3 at capacity 32 on each of its 13 children; the default
    route of mixed_scl32 at L=32 is refused at the plan."""
    ca, bch = presets.ca_scl().spec, presets.bch_sc().spec
    assert cuda_scl.launch_plan(ca, 8, "scl_mc_counters") == cuda_scl.LaunchPlan(
        "scl_mc_counters_t128", 128, 1, 25176, 944, 8)
    assert cuda_scl.launch_plan(ca, 8, "scl_decode") == cuda_scl.LaunchPlan(
        "scl_decode_t64", 64, 1, 20952, 944, 10)
    assert cuda_scl.launch_plan(bch, 1, "scl_mc_counters") == cuda_scl.LaunchPlan(
        "scl_mc_counters_big_t32_cw2", 32, 2, 1344 + 2 * 2128, 2 * 1296, 16)
    children = _mixed_children()
    assert len(children) == 13
    for child in children:
        plan = cuda_scl.launch_plan(child, 32, "scl_subtree")
        assert (plan.instance, plan.threads, plan.codewords, plan.static) == (
            "scl_subtree_c32", 256, 1, cuda_scl.SMALL32_STATIC_BYTES)
        assert plan.blocks_per_sm == 2
    mixed = presets.get_preset("mixed_scl32").spec
    with pytest.raises(ValueError, match="subtree_backend='pallas'"):
        cuda_scl.launch_plan(mixed, 32, "scl_decode")


def _test_shapes():
    """(spec, list size, kernels) of tests/test_torch_big8.py,
    tests/test_torch_arikan8.py and tests/test_torch_select.py."""
    specs = _specs()
    shapes = [(spec, L, KERNELS) for spec in specs for L in range(1, 9)]
    shapes += [(spec, L, KERNELS) for spec in specs[:2] for L in range(9, 33)]
    shapes += [(_spec(N), L, KERNELS) for N in SIZES for L in range(1, 9)]
    for N in (16, 32, 64, 1024):
        spec = CodeSpec(N=N, K=N // 2, factors=(2,) * int(np.log2(N)),
                        frozen_mask=tuple([1] * (N // 2) + [0] * (N // 2)))
        shapes += [(spec, L, KERNELS) for L in (1, 2, 3, 4, 8, 32)]
    shapes += [(child, 32, ("scl_subtree",)) for child in _mixed_children()]
    shapes += [(jittered_spec(f, K, CRC8), 32, KERNELS)
               for f, K in (((2,) * 7, 56), ((16, 2, 2), 20), ((2, 16, 2), 14))]
    return shapes


def test_every_plan_names_an_instance_of_the_table():
    """Every plan of the CPU tests' shapes names an instance of the
    source's table that runs its kernel at its capacity, with the plan's
    threads and codewords, on the Arikan body exactly where `arikan8`, and
    l > 2 kernels only where the instance takes them; where the plan is
    refused, the state exceeds what a block may use. Every instance is
    reached."""
    table = instance_table()
    seen, refused = set(), set()
    for spec, L, kernels in _test_shapes():
        big = any(f > 2 for f in spec.factors)
        for kernel in kernels:
            try:
                plan = cuda_scl.launch_plan(spec, L, kernel)
            except ValueError as e:
                assert "exceeds the 232448 B" in str(e), (spec.factors, L, kernel)
                refused.add((spec.N, L > 8, kernel))
                continue
            k, cap, threads, cw, fast, takes_big = table[plan.instance]
            assert (k, cap, threads, cw) == (
                cuda_scl.KERNELS[kernel], 32 if L > 8 else 8, plan.threads, plan.codewords)
            assert fast == cuda_scl.arikan8(spec, L, kernel)
            assert takes_big or not big
            assert plan.smem + plan.static <= cuda_scl.H100.block_optin
            seen.add(plan.instance)
    assert seen == set(table)
    # the Arikan body holds N = 4096 at L = 8; the general body does not
    assert {r for r in refused if not r[1]} == {(4096, False, "scl_subtree")}


# an SM of 100 KB of shared memory and 16 blocks (an sm_86 part)
SMALL_SM = cuda_scl.SmLimits(shared=100 * 1024, reserved=1024, registers=65536, blocks=16,
                             block_optin=101376)


def test_other_limits_lead_to_the_other_widths():
    """On an SM with less shared memory, the blocks it holds of the one-warp
    layout bring too few warps: bch_sc at L=8 takes the 64-thread
    instances, one codeword a block, and ca_scl's K1 128 threads; at L=1
    bch_sc's K5 keeps two codewords a warp. The H100's plans stay."""
    bch, ca = presets.bch_sc().spec, presets.ca_scl().spec
    for kernel in KERNELS:
        plan = cuda_scl.launch_plan(bch, 8, kernel, SMALL_SM)
        assert (plan.threads, plan.codewords) == (64, 1)
        base = kernel if kernel == "scl_subtree" else kernel + "_big"
        assert plan.instance == base + "_t64"
        assert cuda_scl.launch_plan(bch, 8, kernel).instance == base + "_t32"
    assert cuda_scl.launch_plan(ca, 8, "scl_decode", SMALL_SM).instance == "scl_decode_t128"
    assert cuda_scl.launch_plan(bch, 1, "scl_mc_counters", SMALL_SM)[:3] == (
        "scl_mc_counters_big_t32_cw2", 32, 2)
    # the state a block may hold follows the limits too
    with pytest.raises(ValueError, match="exceeds the 101376 B"):
        cuda_scl.launch_plan(jittered_spec((2,) * 9, 200, CRC8), 32, "scl_decode", SMALL_SM)


def test_plan_is_made_once():
    """A second ask for the same (spec, list size, kernel, limits) is a
    cache hit that returns the same plan."""
    spec = jittered_spec((16, 2), 12, CRC8)
    first = cuda_scl.launch_plan(spec, 3, "scl_mc_traj")
    before = cuda_scl.launch_plan.cache_info()
    again = cuda_scl.launch_plan(spec, 3, "scl_mc_traj")
    after = cuda_scl.launch_plan.cache_info()
    assert again is first
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)


class _NullDevice:
    """torch.cuda.device without a card."""

    def __init__(self, dev):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeLibrary:
    """The library calls a launch may make, recorded."""

    def __init__(self):
        self.calls = []

    def scl_set_smem(self, index, smem):
        self.calls.append(("scl_set_smem", index, smem))
        return 0

    def scl_launch(self, index, kernel, threads, codewords, args, stream):
        self.calls.append(("scl_launch", index, kernel, threads, codewords,
                           args._obj.B))
        return 0


def test_launch_calls_the_library_once(monkeypatch):
    """`SclKernels.launch` takes its plan at the first launch on a device
    and then calls the library once a launch (`scl_launch`, with the
    plan's instance, threads and codewords); the instance's shared memory
    is set once a device, also for the kernels of a later pass; the
    wrappers' answers are the plan's."""
    lib = _FakeLibrary()
    index = {name: i for i, name in enumerate(instance_table())}
    monkeypatch.setattr(cuda_scl, "load_library", lambda clock=None: lib)
    monkeypatch.setattr(cuda_scl, "instance_index", index.__getitem__)
    monkeypatch.setattr(cuda_scl, "device_limits", lambda dev: cuda_scl.H100)
    monkeypatch.setattr(cuda_scl, "_smem_set", {})
    monkeypatch.setattr(torch.cuda, "device", _NullDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    tables = cuda_scl.SclKernels.device_tables
    monkeypatch.setattr(cuda_scl.SclKernels, "device_tables",
                        lambda self, device: tables(self, torch.device("cpu")))
    spec, dev = presets.bch_sc().spec, torch.device("cuda:0")
    plan = cuda_scl.launch_plan(spec, 1, "scl_mc_counters")
    for kernels in (cuda_scl.SclKernels(spec, 1), cuda_scl.SclKernels(spec, 1)):
        for B in (8192, 77):
            kernels.launch("scl_mc_counters", B, dev, noise=None, seed0=1, seed1=2,
                           sigma=0.5, counters=torch.empty((2, B), dtype=torch.int32))
        assert kernels.block_threads("scl_mc_counters", dev) == plan.threads == 32
        assert kernels.block_codewords("scl_mc_counters", dev) == plan.codewords == 2
        assert kernels.smem_bytes("scl_mc_counters", dev) == (plan.smem, plan.static)
    i = index["scl_mc_counters_big_t32_cw2"]
    launch = ("scl_launch", i, cuda_scl.KERNELS["scl_mc_counters"], 32, 2)
    assert lib.calls == [("scl_set_smem", i, plan.smem), launch + (8192,), launch + (77,),
                         launch + (8192,), launch + (77,)]
