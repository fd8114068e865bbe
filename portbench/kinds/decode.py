"""Kind `decode`: batches of the benchmark's own channel LLRs through the
decoder `polar_tpu_torch.ops.scl.build_scl_decoder` returns, closed loop.

Set-up makes a pool of `pool` batches of `batch` codewords on the card
from the seed (a torch.Generator on the card): random data bits, the
code's CRC, encode, BPSK over AWGN at the traffic's Eb/N0, LLR = 2y /
sigma^2 in float32. The window takes the batches in turn, `in_flight` at
a time: each call's `payload` and `crc_ok` are copied to pinned host
memory behind an event, and a batch is done when its event has passed on
the host. A batch's latency runs from handing its LLRs to the decoder to
that moment.

A sample of the window's batches, drawn from the seed, keeps the
decoder's outputs (u, payload, crc_ok, pm) for the comparison with the
reference decoder on the same LLRs, by reference: nothing is copied in
the window for it.
"""
from __future__ import annotations

import collections
import math
import time

import torch
from torch.profiler import record_function

from portbench import window as win
from portbench.kinds.sweep import program_preset
from portbench.ref.channel import ebn0_to_sigma
from portbench.ref.crc import crc_append
from portbench.ref.encode import assemble_u, encode_u
from portbench.ref.model import Reference, code_spec
from portbench.yardstick import opcount
from portbench.yardstick import trace as tr

SPAN = "portbench.decode_call"


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """The cell's LLR batches, made on `device` from `seed`."""
    spec = code_spec(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sigma = ebn0_to_sigma(traffic["ebn0_db"], spec.rate)
    B = int(traffic["batch"])
    pool = []
    for _ in range(int(traffic["pool"])):
        info = torch.randint(0, 2, (B, spec.K), generator=gen, device=device,
                             dtype=torch.int8)
        payload = crc_append(spec.crc, info) if spec.crc is not None else info
        x = encode_u(spec, assemble_u(spec, payload))
        noise = torch.randn((B, spec.N), generator=gen, device=device)
        y = (1.0 - 2.0 * x.to(torch.float32)) + sigma * noise
        pool.append((2.0 / (sigma * sigma)) * y)
    return pool


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank: the least value that at least
    95% of the values do not exceed."""
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]


def bytes_a_frame(spec) -> int:
    """A frame's input and output bytes, each once: its float32 LLRs in;
    u (int8), payload (int8), crc_ok (bool) and pm (float32) out."""
    return 4 * spec.N + spec.N + spec.n_payload_slots + 1 + 4


def run(cell, seed: int, seconds: float, trace: bool, tmp, mesh=None,
        device="cuda", control: bool = False) -> dict:
    from polar_tpu_torch.ops.scl import build_scl_decoder

    t = cell.traffic
    spec = program_preset(cell.config, {"ebn0_db": [t["ebn0_db"]],
                                        "frames_per_pass": t["batch"],
                                        "batch_per_card": t["batch"]}).spec
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L = int(cell.config["list_size"])
    decoder = build_scl_decoder(spec, L, device=dev)
    pool = make_pool(cell.config, t, seed, dev)
    depth = int(t["in_flight"])
    host = [(torch.empty(tuple(pool[0].shape[:1]) + (spec.n_payload_slots,),
                         dtype=torch.int8, pin_memory=cuda),
             torch.empty(pool[0].shape[:1], dtype=torch.bool, pin_memory=cuda))
            for _ in range(depth + 1)]
    for llr in pool[:2]:                        # warm-up: build, load, first call
        decoder(llr)
    if cuda:
        torch.cuda.synchronize(dev)

    sample = win.Reservoir(seed, t["check_batches"])
    lat: list[float] = []
    submit: list[float] = []
    flight: collections.deque = collections.deque()

    def retire() -> None:
        i, j, start, event, res, slot = flight.popleft()
        if event is not None:
            event.synchronize()
        lat.append(time.perf_counter() - start)
        sample.offer(lambda _: {"index": i, "pool": j, "res": res})

    def one_batch(i: int) -> None:
        j = i % len(pool)
        start = time.perf_counter()
        with record_function(SPAN):
            res = decoder(pool[j])
        submit.append(time.perf_counter() - start)
        slot = i % (depth + 1)
        host[slot][0].copy_(res.payload, non_blocking=cuda)
        host[slot][1].copy_(res.crc_ok, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        flight.append((i, j, start, event, res, slot))
        if len(flight) >= depth:
            retire()

    length = min(seconds, t["trace_seconds"]) if trace else seconds
    with win.traced(trace, tmp / "trace.json"):
        w = win.run_units(one_batch, length)
        close = time.perf_counter()
        while flight:
            retire()
        w["seconds"] += time.perf_counter() - close
    done = len(lat)
    B = int(t["batch"])
    out = {"values": {"decode_cw_per_s": done * B / w["seconds"],
                      "decode_p95_ms": 1e3 * p95(lat)},
           "wall_start": w["wall_start"], "attempted": done,
           "raised": w["failed"], "error": w["error"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
           "submit_ms": 1e3 * sum(submit) / len(submit)}
    if trace:
        ref_spec = code_spec(cell.config)
        out["trace"] = tr.summary(tr.load_events(tmp / "trace.json"))
        out["work"] = {"frames": done * B,
                       "ops": done * B * opcount.element_ops(ref_spec, L),
                       "bytes": done * B * bytes_a_frame(ref_spec)}
        (tmp / "trace.json").unlink()
    del decoder, flight
    if cuda:
        torch.cuda.empty_cache()
    started = time.perf_counter()
    out["check"] = check(cell, sample.items, pool, spec, dev, control)
    out["check_s"] = time.perf_counter() - started
    return out


def check(cell, sample: list[dict], pool: list, spec, dev, control: bool) -> dict:
    """The comparison, once the window has closed: each sampled batch's LLRs
    decoded by the reference. Returns {"calls": {batch index: {"off":
    frames whose u, payload or crc_ok differ, "gap": the widest path-metric
    gap}}, "frames": frames compared}. `control`: the program's own
    bfloat16 route takes the program's place."""
    from polar_tpu_torch.ops.scl import build_scl_decoder

    ref = Reference(cell.config, dev)
    lower = (build_scl_decoder(spec, int(cell.config["list_size"]), device=dev,
                               llr_dtype=torch.bfloat16) if control else None)
    calls, frames = {}, 0
    for rec in sample:
        llr = pool[rec["pool"]]
        with torch.no_grad():
            res = ref.decode(llr)
            prog = rec["res"] if lower is None else lower(llr)
            off = ((prog.u != res.u).any(1) | (prog.payload != res.payload).any(1)
                   | (prog.crc_ok != res.crc_ok))
        calls[rec["index"]] = {"off": int(off.sum()),
                               "gap": win.pm_gap(prog.pm, res.pm)}
        frames += llr.shape[0]
    return {"calls": calls, "frames": frames, "control": control}
