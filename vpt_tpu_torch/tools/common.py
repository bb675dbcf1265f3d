"""Helpers shared by the probe tools: timing, a NaN-aware equality and
the random inputs (made on the CPU from a seed, then moved, so a CPU and
a CUDA run see the same numbers)."""

from __future__ import annotations

import time

import torch


def time_ms(fn, device, n=8):
    """(mean milliseconds per call of fn() over n calls after one warm-up
    call, the last result): CUDA events on the card, the host clock on
    the CPU."""
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / n, out
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n, out


def nan_equal(a, b):
    """True when two tensors hold equal values, NaN where the other has
    NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def uniform(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(device)


def randint(high, shape, seed, device, dtype=torch.int32):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, shape, generator=g).to(dtype).to(device)
