"""Looped take_along_axis probe on the card: the port of
tools/probe_dyngather.py.

    python -m vpt_tpu_torch.tools.probe_dyngather

For x (N, 128) and indices (N, 128), 64 steps of acc +=
take_along_axis(x, idx, axis); idx = (idx + int32(acc) + i) mod N
(axis 0) or mod 128 (axis 1).  The reference timed it as an XLA loop
and as one Pallas kernel; here as a plain torch loop ("torch") and as
kernel P2 (csrc/take_along.cu, "P2", held exactly against the loop:
"OK"), with the design that ran in brackets: the reference's N, whose
strips P2 walks in shared memory, and N = 16384, past the strip that
fits on axis 0 (the L2 route, "global").  Then the same 64-step loop
around the row gather P1 over the (106330, 10) table, B = 65536.
"""

from __future__ import annotations

import sys

import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.ops.probe import device_limits, gather_rows, \
    take_along, take_along_design, take_along_plain
from vpt_tpu_torch.tools.common import randint, time_ms, uniform

ITERS = 64
NS = (512, 832, 4096)
L2_N = 16384
B, V = 65536, 106330


def _row_loop(tab, idx, iters):
    v = tab.shape[0]
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=idx.device)
    for i in range(iters):
        acc = acc + gather_rows(tab, idx).sum(-1)
        idx = (idx + acc.to(torch.int32) + i) % v
    return acc


def run(device, ns=NS + (L2_N,), iters=ITERS, b=B, v=V, n=8, out=print):
    recs = []

    def line(name, ms, nel, s, ok=None):
        tail = "" if ok is None else ("  OK" if ok else "  MISMATCH")
        out(f"{name}: {ms:.3f} ms/call  {ms * 1e6 / nel:.3f} ns/elem "
            f"(s={s:.0f}){tail}")
        rec = dict(name=name, ms=ms, ns_per_elem=ms * 1e6 / nel)
        if ok is not None:
            rec["ok"] = ok
        recs.append(rec)

    for N in ns:
        x = uniform((N, 128), 0, device)
        nel = N * 128 * iters
        for axis, idx in ((0, randint(N, (N, 128), 1, device)),
                          (1, randint(128, (N, 128), 2, device))):
            ms, want = time_ms(
                lambda: take_along_plain(x, idx, axis, iters), device, n)
            line(f"torch taa axis{axis} N={N}", ms, nel, float(want.sum()))
            ms, got = time_ms(lambda: take_along(x, idx, axis, iters),
                              device, n)
            design = "plain" if device.type != "cuda" else \
                take_along_design(N, 128, axis, iters, idx.dtype,
                                  *device_limits(device)).name
            line(f"P2 taa axis{axis} N={N} [{design}]", ms, nel,
                 float(got.sum()), torch.equal(got, want))

    tab = uniform((v, 10), 0, device)
    flat = randint(v, (b,), 3, device)
    ms, acc = time_ms(lambda: _row_loop(tab, flat, iters), device, n)
    out(f"P1 row-gather B={b}: {ms:.3f} ms/call  "
        f"{ms * 1e6 / (b * iters):.3f} ns/index (s={float(acc.sum()):.0f})")
    recs.append(dict(name=f"P1 row-gather B={b}", ms=ms,
                     ns_per_index=ms * 1e6 / (b * iters)))
    return recs


def main():
    """Run the probe on the card; exit 1 when a kernel disagrees with
    its plain version."""
    if not all(r.get("ok", True) for r in run(DEFAULT_DEVICE)):
        sys.exit(1)


if __name__ == "__main__":
    main()
