"""Time the probe kernels P1 (gather_rows), P2 (take_along) and P3
(roll) on the card.

    python -m vpt_tpu_torch.tools.time_probes [--calls 200]

For each case: device microseconds per call (torch.profiler), event
microseconds per call (CUDA events over back-to-back calls) and host
microseconds per call (the host clock over the same loop; both the
median of 3 turns of library, kernel, kernel, library), beside the one
PyTorch call that computes the same function where there is one
(``torch.index_select``, ``torch.gather``, ``torch.roll``), and P2's
design there.  Every kernel result is held exactly against its plain
version first.  Cases: P1 at the main path's corner table (8 M x 31
f32, one random int32 row per 1080p ray; beside it P1 on the same
indices sorted and a copy of its output's 257 MB) and at the probe loop's
(106330, 10) table with B = 65536, P2 at iters 1 on (4096, 128) axis 0,
P2 at iters 64 on both axes at N = 512, 832 and 4096, P3 at (8, 128)
and (4096, 128) with shift 3 on axis 1.  Prints one JSON line per
case, then the host cost of each wrapper's parts (the host clock per
call: the checks, the cached launch, the output's allocation, the
stream, the ctypes call), then the kernels' registers and spills
(ptxas), then the nvidia-smi line.  Run by its
path with another checkout of the package first on PYTHONPATH, it times
that checkout's wrappers (one that has ``probe.take_along_design``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from vpt_tpu_torch.ops import cuda, probe
from vpt_tpu_torch.tools.common import randint, uniform

NS = (512, 832, 4096)
# P1's cases: (rows, width, batch)
CORNER = "gather_rows corner (8000000,31) B=2073600"
GATHER_CASES = {
    CORNER: (8_000_000, 31, 2_073_600),
    "gather_rows loop (106330,10) B=65536": (106_330, 10, 65_536)}


def device_us(fn, n):
    """Mean device microseconds per call of fn() over n calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in pr.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            total += us
    return total / n


def event_host_us(fn, n):
    """(event µs per call, host µs per call) over n back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n, host


def measure(fns, n, rounds=3):
    """{name: {device_us, event_us, host_us}} for each fn: event and host
    µs the median of ``rounds`` turns of the names in order and then in
    reverse (library, kernel, kernel, library), before any profiler
    runs; then device µs over n calls each."""
    ev, host = {k: [] for k in fns}, {k: [] for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(reversed(fns)):
            e, h = event_host_us(fns[k], n)
            ev[k].append(e)
            host[k].append(h)
    return {k: {"device_us": device_us(fns[k], n),
                "event_us": statistics.median(ev[k]),
                "host_us": statistics.median(host[k])} for k in fns}


def host_us(fn, n):
    """Host-clock µs per call of fn() over n calls (then synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def host_parts(dev, n):
    """{wrapper: {part: host µs}} for P2 at (4096, 128), iters 1, and P3
    at (8, 128)."""
    dll = cuda.load_library().dll
    x = uniform((4096, 128), 0, dev)
    i = randint(4096, (4096, 128), 1, dev)
    xr = torch.arange(1024, dtype=torch.float32, device=dev).reshape(8, 128)
    ta = probe._take_along_launch(4096, 128, 0, 1, torch.int32, True,
                                  dev)[2]
    rl = probe._roll_launch(8, 128, 1, 3, True)[1]
    out, out_r = torch.empty_like(x), torch.empty_like(xr)
    s = cuda.current_stream(dev)
    i64 = i.to(torch.int64)
    parts = {
        "take_along": {
            "wrapper": lambda: probe.take_along(x, i, 0),
            "torch.gather": lambda: torch.gather(x, 0, i64),
            "checks": lambda: (
                x.device.type == "cuda" and i.device == x.device
                and x.dtype == torch.float32 and x.dim() == 2
                and i.shape == x.shape and x.is_contiguous()
                and i.is_contiguous()),
            "launch lookup": lambda: probe._take_along_launch(
                4096, 128, 0, 1, torch.int32, True, dev),
            "torch.empty_like": lambda: torch.empty_like(x),
            "cuda.current_stream": lambda: cuda.current_stream(dev),
            "ctypes call": lambda: dll.vpt_take_along_i32(
                x.data_ptr(), i.data_ptr(), out.data_ptr(), ta, s)},
        "roll": {
            "wrapper": lambda: probe.roll(xr, 3, 1),
            "torch.roll": lambda: torch.roll(xr, 3, 1),
            "torch.empty_like": lambda: torch.empty_like(xr),
            "ctypes call": lambda: dll.vpt_roll(
                xr.data_ptr(), out_r.data_ptr(), rl, s)}}
    return {w: {k: host_us(fn, n) for k, fn in ps.items()}
            for w, ps in parts.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    n = args.calls
    limits = probe.device_limits(dev)

    def case(name, x, idx, axis, iters, fns, calls):
        want = probe.take_along_plain(x, idx, axis, iters)
        design = probe.take_along_design(*x.shape, axis, iters, torch.int32,
                                         *limits)
        for k, fn in fns.items():
            if k.startswith("take_along") and not torch.equal(fn(), want):
                raise SystemExit(f"{name}: {k} differs from the plain "
                                 "version")
        print(json.dumps({"case": name, "design": design._asdict(),
                          **measure(fns, calls)}), flush=True)

    for name, (v, w, b) in GATHER_CASES.items():
        g = torch.Generator(device=dev).manual_seed(v)
        table = torch.rand((v, w), generator=g, device=dev)
        idx = torch.randint(0, v, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        if not torch.equal(probe.gather_rows(table, idx),
                           probe.gather_rows_plain(table, idx)):
            raise SystemExit(f"{name}: gather_rows differs from the plain "
                             "version")
        fns = {"torch.index_select": lambda: torch.index_select(table, 0,
                                                                idx),
               "gather_rows": lambda: probe.gather_rows(table, idx)}
        if name == CORNER:
            # what P1 costs with the same rows read in order, and a copy
            # of its output's bytes: where random rows leave it
            srt = torch.sort(idx).values
            out = torch.empty((b, w), device=dev)
            src = torch.rand((b, w), generator=g, device=dev)
            fns.update({"gather_rows, sorted indices":
                        lambda: probe.gather_rows(table, srt),
                        "copy of the output's bytes":
                        lambda: out.copy_(src)})
        print(json.dumps({"case": name, **measure(fns, n)}), flush=True)
        del table, idx, fns
    x = uniform((4096, 128), 0, dev)
    i32 = randint(4096, (4096, 128), 1, dev)
    i64 = i32.to(torch.int64)
    case("take_along (4096,128) axis 0 iters 1", x, i32, 0, 1,
         {"torch.gather": lambda: torch.gather(x, 0, i64),
          "take_along": lambda: probe.take_along(x, i32, 0)}, n)
    for N in NS:
        x = uniform((N, 128), 0, dev)
        for axis in (0, 1):
            idx = randint(x.shape[axis], (N, 128), 1 + axis, dev)
            case(f"take_along ({N},128) axis {axis} iters 64", x, idx, axis,
                 64, {"take_along": lambda: probe.take_along(x, idx, axis,
                                                            64)},
                 max(n // 4, 10))
    for N in (8, 4096):
        xr = torch.arange(N * 128, dtype=torch.float32,
                          device=dev).reshape(N, 128)
        if not torch.equal(probe.roll(xr, 3, 1), probe.roll_plain(xr, 3, 1)):
            raise SystemExit("roll differs from its plain version")
        print(json.dumps({"case": f"roll ({N},128) shift 3 axis 1",
                          **measure({"torch.roll": lambda: torch.roll(
                              xr, 3, 1), "roll": lambda: probe.roll(
                              xr, 3, 1)}, n)}), flush=True)
    print(json.dumps({"host_parts_us": host_parts(dev, n * 10)}),
          flush=True)
    ptx = cuda.ptxas_summary(cuda.load_library().ptxas_log)
    print(json.dumps({"ptxas": {k: v for k, v in ptx.items()
                                if "take_along" in k or "roll" in k
                                or "gather_rows" in k}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
