"""Each CUDA source's nvcc wall seconds, the sources of a checkout's
``csrc/`` compiled as ``ops/cuda.py`` builds them (one process a source,
all started together, this checkout's flags), then linked.

    python -m vpt_tpu_torch.tools.nvcc_times [--csrc DIR] [--out LIB]
        [SOURCE ...]

``--csrc`` another checkout's ``vpt_tpu_torch/csrc`` (default this
one's); the sources default to every ``*.cu`` there; ``--out`` keeps the
linked library (for ``tools/sass_count.py --against``).  Prints one JSON
line: the seconds by source, the link's, and the slowest source's.  The
build is the slowest source's seconds plus the link's.  Needs nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from vpt_tpu_torch.ops import cuda


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=cuda.CSRC)
    ap.add_argument("--out", default=None)
    ap.add_argument("sources", nargs="*")
    args = ap.parse_args(argv)
    csrc = os.path.abspath(args.csrc)
    sources = tuple(args.sources) or tuple(sorted(
        f for f in os.listdir(csrc) if f.endswith(".cu")))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.abspath(args.out or os.path.join(tmp, "lib.so"))
        _, seconds = cuda._build(out, csrc, sources)
    by_source = {s: seconds[s] for s in sources}
    slowest = max(by_source, key=by_source.get)
    print(json.dumps(dict(csrc=csrc, seconds=by_source,
                          link_s=seconds["link"], slowest=slowest,
                          slowest_s=by_source[slowest])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
