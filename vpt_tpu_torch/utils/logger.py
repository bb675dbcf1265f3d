"""Leveled logger (copy of vpt_tpu/utils/logger.py, which the port may
not import): the runtime equivalent of the reference's compile-time log
levels (util/logger.cpp:4-40).  The threshold comes from the
``VPT_LOG_LEVEL`` environment variable (error | warning | log | none)
or ``set_level``.

Usage:
    from vpt_tpu_torch.utils.logger import log, VPT_LOG
    log("scene built", VPT_LOG)
"""

from __future__ import annotations

import os
import sys
import time

VPT_ERROR, VPT_WARNING, VPT_LOG = 0, 1, 2
_NAMES = {VPT_ERROR: "ERROR", VPT_WARNING: "WARNING", VPT_LOG: "LOG"}

_level = {"error": VPT_ERROR, "warning": VPT_WARNING, "log": VPT_LOG,
          "none": -1}.get(os.environ.get("VPT_LOG_LEVEL", "log").lower(),
                          VPT_LOG)


def set_level(level: int):
    """Runtime override of the threshold (messages with level <= the
    threshold are printed; -1 silences everything)."""
    global _level
    _level = level


def get_level() -> int:
    return _level


def log(msg: str, level: int = VPT_LOG):
    """Print ``msg`` to stderr with its level tag if ``level`` is within
    the threshold (format of logger.cpp)."""
    if level <= _level:
        tag = _NAMES.get(level, "LOG")
        ts = time.strftime("%H:%M:%S")
        print(f"[vpt {ts} {tag}] {msg}", file=sys.stderr, flush=True)
