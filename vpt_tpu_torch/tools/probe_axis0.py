"""take_along_axis and roll probe on the card: the port of
tools/probe_axis0.py.

    python -m vpt_tpu_torch.tools.probe_axis0

The reference asked which shapes and index types Mosaic accepts for a
take_along_axis along axis 0 and for pltpu.roll.  Here each shape runs
kernel P2 (csrc/take_along.cu, one step) or P3 (csrc/roll.cu) and is
held exactly against its plain PyTorch version: "OK (first value)".
"""

from __future__ import annotations

import sys

import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.ops.probe import roll, roll_plain, take_along, \
    take_along_plain
from vpt_tpu_torch.tools.common import randint, uniform

CASES = ([(f"axis0 ({n},128) i32", n, 128, torch.int32)
          for n in (8, 128, 256, 1024)]
         + [("axis0 (256,128) u32", 256, 128, torch.uint32),
            ("axis0 (256,256) i32", 256, 256, torch.int32),
            ("axis0 (8,128) via lax.gather", 8, 128, torch.int32)])


def run(device, out=print):
    recs = []

    def report(name, got, want):
        ok = torch.equal(got, want)
        s = float(got.reshape(-1)[0])
        out(f"{name}: {'OK' if ok else 'MISMATCH'} ({s:.3f})")
        recs.append(dict(name=name, ok=ok))

    for name, n, c, dtype in CASES:
        x = uniform((n, c), 0, device)
        idx = randint(n, (n, c), 1, device, dtype)
        report(name, take_along(x, idx, 0), take_along_plain(x, idx, 0))
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=device).reshape(8, 128)
    report("pltpu.roll axis1", roll(x, 3, 1), roll_plain(x, 3, 1))
    return recs


def main():
    """Run the probe on the card; exit 1 when a kernel disagrees with
    its plain version."""
    if not all(r["ok"] for r in run(DEFAULT_DEVICE)):
        sys.exit(1)


if __name__ == "__main__":
    main()
