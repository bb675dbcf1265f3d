"""Build and load the port's CUDA kernels (csrc/*.cu).

nvcc compiles every source into an object, all sources at once in
parallel processes, and links them into one shared library with a plain
C interface, loaded with ctypes, at first use — never at import, so the
CPU-only tests import every module.  The library lands in
``csrc/build/`` (gitignored) under a name keyed by the hash of the
sources and flags, so an edited source rebuilds.  ``-fmad=false`` keeps
multiply-adds unfused, as PyTorch's one-op-per-kernel plain versions
are, so a kernel and its plain version round alike; no fast-math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from dataclasses import dataclass

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc")
SOURCES = ("fused_direct.cu", "raygen.cu", "film_accumulate.cu",
           "environment.cu", "walk.cu", "walk_rows.cu", "walk_cells.cu",
           "gather_rows.cu", "take_along.cu", "roll.cu")
HEADERS = ("vpt_common.cuh", "raygen.cuh", "probe_launch.cuh",
           "atmosphere.cuh", "walk.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


@dataclass
class Kernel:
    """A hand-written kernel of the render path and its launch count.

    ``launches`` goes up by one where the wrapper launches the kernel,
    and nowhere else."""

    name: str
    route: str       # "cuda"
    source: str      # path in the repo
    replaces: str    # file:line of the reference function
    launches: int = 0


@dataclass
class Library:
    dll: ctypes.CDLL
    path: str
    ptxas_log: str         # empty when the library was already built
    # each source's nvcc wall seconds, all started together, and the
    # link's (empty when the library was already built)
    nvcc_seconds: dict = None


_LIBRARY: Library | None = None
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def load_library() -> Library:
    """The built kernel library, compiling it on first use."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    build = os.path.abspath(os.path.join(CSRC, "build"))
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, f"libvpt_kernels_{h.hexdigest()[:16]}.so")
    ptxas_log, seconds = "", {}
    if not os.path.exists(path):
        ptxas_log, seconds = _build(path)
    dll = ctypes.CDLL(path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
            ("vpt_fused_direct", [vp] * 3 + [i32] + [vp] * 8),
            ("vpt_fused_direct_primary", [vp] * 3 + [i32] + [vp] * 7),
            ("vpt_fused_launch_info", [i32, i32, i32, i32, i32, vp]),
            ("vpt_primary_rays", [vp, ctypes.c_int, vp, vp, vp]),
            ("vpt_fused_params_size", []),
            ("vpt_fused_ext_size", []),
            ("vpt_fused_cells_size", []),
            ("vpt_raygen_params_size", []),
            ("vpt_film_accumulate", [vp, vp]),
            ("vpt_film_args_size", []),
            ("vpt_environment", [vp] * 8),
            ("vpt_env_params_size", []),
            ("vpt_atm_params_size", []),
            ("vpt_atmosphere_launch_info", [vp]),
            ("vpt_div_known_sweep", [ctypes.c_float, ctypes.c_float,
                                     ctypes.c_ulonglong, ctypes.c_ulonglong,
                                     vp, vp]),
            ("vpt_walk", [i32, i32] + [vp] * 9 + [i32, vp, vp, vp]),
            ("vpt_walk_keys", [i32, vp, vp, i32, vp]),
            ("vpt_walk_params_size", []),
            ("vpt_walk_env_size", []),
            ("vpt_walk_tables_size", []),
            ("vpt_walk_scene_size", []),
            ("vpt_walk_work_size", []),
            ("vpt_walk_launch_info", [i32] * 5 + [vp]),
            ("vpt_gather_rows", [vp] * 5),
            ("vpt_gather_launch_size", []),
            ("vpt_take_along_i32", [vp] * 5),
            ("vpt_take_along_u32", [vp] * 5),
            ("vpt_roll", [vp] * 4),
            ("vpt_probe_launch_size", []),
            ("vpt_device_limits", [i32, vp, vp])):
        getattr(dll, fn).restype = ctypes.c_int
        getattr(dll, fn).argtypes = args
    _LIBRARY = Library(dll, path, ptxas_log, seconds)
    return _LIBRARY


def _build(path: str, csrc: str = CSRC,
           sources: tuple = SOURCES) -> tuple[str, dict]:
    """Compile every source of ``csrc`` to an object (one nvcc each, all
    started together), link them into ``path``; returns the compilers'
    logs and each source's wall seconds (and the link's, under "link")."""
    import threading
    import time
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}"
    procs, outs, seconds = [], {}, {}
    t0 = time.perf_counter()

    def wait(s, proc):
        outs[s] = proc.communicate()[0]
        seconds[s] = time.perf_counter() - t0

    for s in sources:
        obj = f"{tmp}.{s}.o"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(csrc, s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        th = threading.Thread(target=wait, args=(s, proc))
        th.start()
        procs.append((s, obj, proc, th))
    failed = []
    for s, _, proc, th in procs:
        th.join()
        if proc.returncode != 0:
            failed.append(f"{s}:\n{outs[s][-4000:]}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        t1 = time.perf_counter()
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", f"{tmp}.so",
                              *(obj for _, obj, _, _ in procs)],
                             capture_output=True, text=True)
        seconds["link"] = time.perf_counter() - t1
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr[-4000:])
        os.replace(f"{tmp}.so", path)
    finally:
        for _, obj, _, _ in procs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(outs[s] for s in sources), seconds


def ptxas_summary(log: str) -> dict:
    """{mangled kernel name: {registers, stack, spill_stores, spill_loads}}
    from an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# K1's corner rows (csrc/fused_direct.cu, ROWS_*, which lists the
# instances each kind takes)
ROWS_F32, ROWS_F32_OCTANT, ROWS_BF16, ROWS_BF16_OCTANT = 0, 1, 2, 3


def row_kind(dtype: torch.dtype, octant_cols: int) -> int:
    """K1's ROWS_* for corner rows of ``dtype`` with ``octant_cols`` (0 or
    72) octant columns."""
    if dtype == torch.float32:
        return ROWS_F32_OCTANT if octant_cols else ROWS_F32
    if dtype == torch.bfloat16:
        return ROWS_BF16_OCTANT if octant_cols else ROWS_BF16
    raise ValueError(f"corner rows of dtype {dtype}: K1 takes float32 or "
                     "bfloat16")


def current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device`` (torch's
    raw getter where it has one: the Stream object costs microseconds a
    call)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def check_struct(struct, size_fn) -> None:
    """Raise when a ctypes mirror disagrees in size with its C struct."""
    if ctypes.sizeof(struct) != size_fn():
        raise RuntimeError(f"{struct.__name__}: {ctypes.sizeof(struct)} "
                           f"bytes, the kernel expects {size_fn()}")


def check_cuda_tensor(t, name, shape=None, dtype=None, device=None):
    """Raise on a tensor the kernel does not take; ``dtype`` is one type
    or a set of them."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, (set, frozenset)) else {dtype}
    if dtype is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_status(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() after a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
