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
        "scl_mc_counters_t128", 128, 1, 25176, 944, 8, 0)
    assert cuda_scl.launch_plan(ca, 8, "scl_decode") == cuda_scl.LaunchPlan(
        "scl_decode_t64", 64, 1, 20952, 944, 10, 0)
    assert cuda_scl.launch_plan(bch, 1, "scl_mc_counters") == cuda_scl.LaunchPlan(
        "scl_mc_counters_big_t32_cw2", 32, 2, 1344 + 2 * 2128, 2 * 1296, 16, 16 * 132 * 2)
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


# an SM of 100 KB of shared memory and 16 blocks (an sm_86 part of 84 SMs)
SMALL_SM = cuda_scl.SmLimits(shared=100 * 1024, reserved=1024, registers=65536, blocks=16,
                             block_optin=101376, sms=84)


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

    def scl_launch(self, index, kernel, threads, codewords, args, count, stream):
        self.calls.append(("scl_launch", index, kernel, threads, codewords,
                           args._obj.B, args._obj.b0, count))
        return 0


def _fake_card(monkeypatch) -> tuple[_FakeLibrary, dict]:
    """The library calls of launches recorded, on an H100's limits, with
    no card: (library, {instance: index})."""
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
    return lib, index


def test_launch_calls_the_library_once(monkeypatch):
    """`SclKernels.launch` takes its plan at the first launch on a device
    and then calls the library once a launch of at most the plan's chunk
    (`scl_launch`, with the plan's instance, threads and codewords); the
    instance's shared memory is set once a device, also for the kernels of
    a later pass; the wrappers' answers are the plan's."""
    lib, index = _fake_card(monkeypatch)
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
    pass_calls = [launch + (8192, 0, 4224), launch + (8192, 4224, 3968), launch + (77, 0, 77)]
    assert lib.calls == [("scl_set_smem", i, plan.smem)] + pass_calls + pass_calls


@pytest.mark.parametrize("batch,chunk", [(1, 8448), (8447, 8448), (8448, 8448), (8449, 8448),
                                         (2 * 8448 + 1, 8448), (32768, 8448), (8192, 2112),
                                         (2113, 2112), (32768, 4224), (5, 0), (32768, 0)])
def test_launch_chunks_cover_the_batch_in_order(batch, chunk):
    """`launch_chunks` covers [0, batch) in order and without overlap, in
    chunks of `chunk` codewords but the last, which holds the rest; a batch
    of at most one chunk, or a chunk of 0, is one launch."""
    parts = cuda_scl.launch_chunks(batch, chunk)
    assert [b0 for b0, _ in parts] == list(np.cumsum([0] + [n for _, n in parts[:-1]]))
    assert sum(n for _, n in parts) == batch
    if chunk == 0 or batch <= chunk:
        assert parts == [(0, batch)]
    else:
        assert len(parts) == -(-batch // chunk)
        assert all(n == chunk for _, n in parts[:-1]) and 0 < parts[-1][1] <= chunk


def test_k5_chunk_is_whole_rounds_of_its_plan():
    """K5's plan at two codewords a block launches K5_CHUNK_ROUNDS rounds
    at most, a round being the codewords every SM holds at once by the
    plan (blocks an SM x SMs x codewords a block): bch_sc's `_big_t32_cw2`
    4,224 on an H100, so the cell's 32,768 launch as 8 chunks; K5 at one
    codeword a block (ca_scl's `_t128`) and the other kernels launch a
    batch at once."""
    bch, ca = presets.bch_sc().spec, presets.ca_scl().spec
    for spec, L, limits in ((bch, 1, cuda_scl.H100), (ca, 8, cuda_scl.H100),
                            (bch, 1, SMALL_SM), (bch, 8, cuda_scl.H100)):
        for kernel in KERNELS:
            try:
                plan = cuda_scl.launch_plan(spec, L, kernel, limits)
            except ValueError:
                continue
            two = kernel == "scl_mc_counters" and plan.codewords == 2
            rounds = cuda_scl.K5_CHUNK_ROUNDS if two else 0
            assert plan.chunk == rounds * plan.blocks_per_sm * limits.sms * plan.codewords
    assert cuda_scl.K5_CHUNK_ROUNDS == 1
    assert cuda_scl.launch_plan(bch, 1, "scl_mc_counters").chunk == 4224
    assert cuda_scl.launch_plan(bch, 1, "scl_mc_counters", SMALL_SM).chunk == 11 * 84 * 2
    assert cuda_scl.launch_plan(ca, 8, "scl_mc_counters").chunk == 0
    assert len(cuda_scl.launch_chunks(32768, 4224)) == 8


def test_k5_launches_a_long_batch_in_chunks(monkeypatch):
    """A K5 launch of bch_sc's 32,768 codewords calls the library once a
    chunk of a round (4,224), back to back, each with its first codeword
    in `b0` and the whole batch in `B`; `LAUNCHES` counts the call,
    `CHUNKS` the device launches. A `chunk` given to `launch` takes the
    plan's place; K1 at the same batch is one launch."""
    lib, index = _fake_card(monkeypatch)
    spec, dev = presets.bch_sc().spec, torch.device("cuda:0")
    kernels = cuda_scl.SclKernels(spec, 1)
    before = {d: dict(getattr(cuda_scl, d)) for d in ("LAUNCHES", "CHUNKS")}
    B = 32768

    def k5(chunk=None):
        kernels.launch("scl_mc_counters", B, dev, chunk=chunk, noise=None, seed0=1,
                       seed1=2, sigma=0.5, counters=torch.empty((2, B), dtype=torch.int32))
    k5()
    launch = ("scl_launch", index["scl_mc_counters_big_t32_cw2"],
              cuda_scl.KERNELS["scl_mc_counters"], 32, 2, B)
    assert lib.calls[1:] == [launch + (b0, 4224) for b0 in range(0, 7 * 4224, 4224)] + [
        launch + (7 * 4224, 3200)]
    assert cuda_scl.LAUNCHES["scl_mc_counters"] == before["LAUNCHES"]["scl_mc_counters"] + 1
    assert cuda_scl.CHUNKS["scl_mc_counters"] == before["CHUNKS"]["scl_mc_counters"] + 8
    del lib.calls[:]
    k5(chunk=B)
    assert lib.calls == [launch + (0, B)]
    del lib.calls[:]
    k5(chunk=2 * 4224)
    assert [c[-2:] for c in lib.calls] == [(0, 8448), (8448, 8448), (16896, 8448), (25344, 7424)]
    assert cuda_scl.LAUNCHES["scl_mc_counters"] == before["LAUNCHES"]["scl_mc_counters"] + 3
    assert cuda_scl.CHUNKS["scl_mc_counters"] == before["CHUNKS"]["scl_mc_counters"] + 8 + 1 + 4
    del lib.calls[:]
    dec = cuda_scl.SclKernels(spec, 8)
    llr = torch.empty((B, spec.N))
    dec.launch("scl_decode", B, dev, llr=llr, u=llr, pm=llr, ok=llr)
    assert [c[-2:] for c in lib.calls if c[0] == "scl_launch"] == [(0, B)]
    assert cuda_scl.CHUNKS["scl_decode"] == before["CHUNKS"]["scl_decode"] + 1


def _struct_fields(src: str, name: str) -> list:
    """The member names of `struct name { ... };` in C++ source, in order."""
    body = re.search(r"^struct " + name + r" \{(.*?)^\};", src, re.M | re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        parts = [p.strip() for p in decl.split(",") if p.strip()]
        if parts:
            names += [parts[0].split()[-1].lstrip("*")] + [p.lstrip("*") for p in parts[1:]]
    return names


def test_sclargs_mirror_holds_the_source_order():
    """ops/cuda_scl.py `SclArgs` names the source's `SclArgs` members in the
    source's order, `b0` (a chunk's first codeword) last, so the library
    reads each field where the host writes it."""
    src = (ROOT / "polar_tpu_torch" / "csrc" / "scl_decode.cu").read_text()
    names = _struct_fields(src, "SclArgs")
    assert names == [f for f, _ in cuda_scl.SclArgs._fields_]
    assert names[-1] == "b0" and names.count("b0") == 1
