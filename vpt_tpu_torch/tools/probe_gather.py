"""Row-gather probe on the card: the port of tools/probe_gather.py.

    python -m vpt_tpu_torch.tools.probe_gather

The reference timed XLA loops of 24 row gathers and tried four Pallas
formulations of the gather on the TPU.  Here every gather is kernel P1
(csrc/gather_rows.cu) and the loops around it are plain torch:

* the in-loop gather from the (106330, 10) table, a width sweep and a
  table-size sweep (ms/call, ns/index over B x 24 indices);
* one sweep point at the main path's corner table, 8 M rows x 31 f32,
  with one random index per 1080p ray: the measured random-row rate
  that sits beside K1's bound (ns/row, GB/s of row bytes);
* the Pallas bodies k_take, k_take_along (the same function), k_index
  (the same but for out-of-range indices, which it clamps: P1 with
  ``clip``) and k_onedim (column 0; as written its (B,) value does not
  fit its (B, 10) output and JAX raises before compiling — here it is P1
  at width 1, on the column in place), each held exactly against the
  plain version, with out-of-range indices planted: "OK".
"""

from __future__ import annotations

import sys

import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.ops.probe import gather_rows, gather_rows_plain
from vpt_tpu_torch.tools.common import nan_equal, randint, time_ms, uniform

B = 65536
V = 106330
ITERS = 24
WIDTHS = (1, 2, 4, 8, 16, 32, 128)
TABLES = (4096, 16384, 65536, 1 << 20)
CORNER_ROWS, CORNER_W, CORNER_BATCH = 8_000_000, 31, 1920 * 1080


def _loop(table, idx, iters):
    """The reference's make_loop body: gather, row sums, reindex."""
    v = table.shape[0]
    acc = torch.zeros(idx.shape[0], dtype=torch.float32, device=idx.device)
    for i in range(iters):
        acc = acc + gather_rows(table, idx).sum(-1)
        idx = (idx + 12345 + i) % v
    return acc


def planted(idx, rows):
    """``idx`` with each out-of-range kind in front: -1, -V, -V - 1, V,
    100 V and 2^31 - 1 for a table of V = ``rows`` rows."""
    edges = torch.tensor([-1, -rows, -rows - 1, rows, 100 * rows,
                          2 ** 31 - 1], dtype=torch.int32, device=idx.device)
    return torch.cat([edges, idx[edges.numel():]])


def run(device, b=B, v=V, iters=ITERS, widths=WIDTHS, tables=TABLES,
        corner=(CORNER_ROWS, CORNER_W, CORNER_BATCH), n=8, out=print):
    """Run the probe; one record per line printed, ``ok`` False where a
    kernel disagreed with its plain version."""
    recs = []

    def timed(label, table, idx):
        ms, _ = time_ms(lambda: _loop(table, idx, iters), device, n)
        ns = ms * 1e6 / (idx.shape[0] * iters)
        out(f"{label}: {ms:.2f} ms/call  {ns:.2f} ns/index")
        recs.append(dict(name=label, ms=ms, ns_per_index=ns))

    table = uniform((v, 10), 0, device)
    idx0 = randint(v, (b,), 1, device)
    timed(f"in-loop take ({v},10)", table, idx0)
    for w in widths:
        timed(f"take ({v},{w})", uniform((v, w), 0, device), idx0)
    for t in tables:
        timed(f"take V={t}", uniform((t, 10), 0, device), idx0 % t)

    rows, width, batch = corner
    ctab = uniform((rows, width), 2, device)
    cidx = randint(rows, (batch,), 3, device)
    ms, got = time_ms(lambda: gather_rows(ctab, cidx), device, n)
    ok = torch.equal(got, gather_rows_plain(ctab, cidx))
    gbs = batch * width * 4 / (ms * 1e-3) / 1e9
    label = f"corner rows ({rows},{width}) B={batch}"
    out(f"{label}: {ms:.3f} ms/call  {ms * 1e6 / batch:.3f} ns/row  "
        f"{gbs:.1f} GB/s{'' if ok else '  MISMATCH'}")
    recs.append(dict(name=label, ms=ms, ns_per_row=ms * 1e6 / batch,
                     row_gb_per_s=gbs, ok=ok))
    del ctab, cidx, got

    idx1, small = planted(idx0, v), planted(idx0 % 4096, 4096)
    for name, tab, idx, clip in (
            ("take", table, idx1, False), ("index", table, idx1, True),
            ("take_along", table, idx1, False),
            ("onedim", table[:, 0], idx1, False),
            ("onedim_small", table[:4096, 0], small, False)):
        got = gather_rows(tab, idx, clip)
        ok = nan_equal(got, gather_rows_plain(tab, idx, clip))
        first = [round(float(x), 4) for x in got[-1].reshape(-1)[:2]]
        out(f"KERNEL {name}: {'OK' if ok else 'MISMATCH'}, {first}")
        recs.append(dict(name=f"KERNEL {name}", ok=ok))
    return recs


def main():
    """Run the probe on the card; exit 1 when a kernel disagrees with
    its plain version."""
    if not all(r.get("ok", True) for r in run(DEFAULT_DEVICE)):
        sys.exit(1)


if __name__ == "__main__":
    main()
