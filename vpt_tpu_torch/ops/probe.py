"""The gather-probe kernels P1-P3 (csrc/gather_rows.cu, take_along.cu,
roll.cu): the Hopper counterparts of the Pallas kernels in the
repository's tools/probe_gather.py, probe_axis0.py and
probe_dyngather.py, which measured what a TPU gather costs.

Each wrapper launches its kernel on CUDA tensors and runs the plain
PyTorch version beside it on CPU tensors; it raises on anything else.
The plain versions are the reference semantics, held against the Pallas
kernel bodies in tests/test_torch_probes.py.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vpt_tpu_torch.ops import cuda

GATHER_ROWS = cuda.Kernel(
    name="gather_rows", route="cuda",
    source="vpt_tpu_torch/csrc/gather_rows.cu",
    replaces="tools/probe_gather.py:127")
TAKE_ALONG = cuda.Kernel(
    name="take_along", route="cuda",
    source="vpt_tpu_torch/csrc/take_along.cu",
    replaces="tools/probe_axis0.py:42")
ROLL = cuda.Kernel(
    name="roll", route="cuda", source="vpt_tpu_torch/csrc/roll.cu",
    replaces="tools/probe_axis0.py:59")
KERNELS = (GATHER_ROWS, TAKE_ALONG, ROLL)

# P2's launch is shaped for the card's SMs and the dynamic shared memory
# one block may opt into, read from the runtime once per device
# (device_limits); take_along_design defaults to the H100 SXM's.
SMS, SMEM_BLOCK = 132, 232448
# 32-bit index math: element offsets below 2^31; the reindex adds three
# terms in [0, len) in 32 bits, so len <= 2^30
NUMEL_MAX, LEN_MAX = 2 ** 31 - 1, 2 ** 30
DESIGNS = ("global", "smem_cols", "smem_rows")  # csrc/take_along.cu
# P2's launches by design, counted where TAKE_ALONG.launches is
design_launches = dict.fromkeys(DESIGNS, 0)


class _ProbeLaunch(ctypes.Structure):
    """Mirror of csrc/probe_launch.cuh::ProbeLaunch."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "N", "C", "axis", "iters", "shift", "design", "vec", "threads",
        "grid_x", "grid_y", "smem", "per_block", "chains", "strip")] + [
        (f, ctypes.c_uint) for f in (
            "len_magic", "len_shift", "c_magic", "c_shift")]


class _Fns(NamedTuple):
    gather_rows: object
    take_along: dict   # idx dtype -> function
    roll: object
    device_limits: object


_FNS: _Fns | None = None


def _fns() -> _Fns:
    """The library's probe entry points, bound once when it loads."""
    global _FNS
    if _FNS is None:
        dll = cuda.load_library().dll
        cuda.check_struct(_ProbeLaunch, dll.vpt_probe_launch_size)
        cuda.check_struct(_GatherLaunch, dll.vpt_gather_launch_size)
        _FNS = _Fns(dll.vpt_gather_rows,
                    {torch.int32: dll.vpt_take_along_i32,
                     torch.uint32: dll.vpt_take_along_u32}, dll.vpt_roll,
                    dll.vpt_device_limits)
    return _FNS


_LIMITS: dict = {}


def device_limits(dev: torch.device) -> tuple[int, int]:
    """(SMs, opt-in dynamic shared-memory bytes per block) of CUDA device
    ``dev``, from the runtime, once."""
    index = torch.device(dev).index
    if index is None:
        index = torch.cuda.current_device()
    hit = _LIMITS.get(index)
    if hit is None:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        rc = (_FNS or _fns()).device_limits(index, ctypes.byref(sms),
                                            ctypes.byref(smem))
        if rc:
            raise RuntimeError(f"device_limits: cudaError {rc}")
        hit = _LIMITS[index] = (sms.value, smem.value)
    return hit


def _refuse(name, *checks):
    """Raise on the first tensor a kernel does not take: the slow path
    behind each wrapper's one-pass check.  ``checks`` are (tensor,
    label, shape, dtype)."""
    kinds = sorted({t.device.type for t, *_ in checks})
    if kinds != ["cuda"]:
        raise ValueError(f"{name}: tensors on {kinds}; expected all on one "
                         "CUDA device or all on the CPU")
    for t, label, shape, dtype in checks:
        cuda.check_cuda_tensor(t, f"{name}: {label}", shape, dtype,
                               checks[0][0].device)
    raise ValueError(f"{name}: unexpected tensors")


def _launched(rc, kernel):
    if rc:
        cuda.check_status(rc, kernel.name)
    kernel.launches += 1


def divider(d: int) -> tuple[int, int]:
    """(magic, shift) with n // d == (umulhi(n, magic) + n) >> shift for
    every n < 2^31 (d in [1, 2^31)): the per-launch divider of
    csrc/probe_launch.cuh::udiv."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divider: {d} outside [1, 2^31)")
    shift = (d - 1).bit_length()
    return (2 ** 32 * (2 ** shift - d)) // d + 1, shift


# ---- P1: row gather ---------------------------------------------------

def gather_rows_plain(table, idx, clip: bool = False):
    """out[b, :] = table[idx[b], :] for a 2-D table, or out[b] =
    table[idx[b]] for a 1-D one, with any integer ``idx``.

    Indices are read as the Pallas bodies read them: one in [-V, 0)
    counts from the end (V = table rows); beyond [-V, V) a NaN row, as
    jnp.take and jnp.take_along_axis fill (k_take, k_take_along), or with
    ``clip`` the nearest row, as k_index's t[idx] clamps."""
    n = table.shape[0]
    if n == 0:
        return torch.full(idx.shape + table.shape[1:], float("nan"),
                          dtype=table.dtype, device=table.device)
    j = idx.to(torch.int64)
    j = torch.where(j < 0, j + n, j)
    if clip:
        return table[j.clamp(0, n - 1)]
    ok = (j >= 0) & (j < n)
    out = table[torch.where(ok, j, 0)]
    return torch.where(ok.view(ok.shape + (1,) * (table.dim() - 1)), out,
                       float("nan"))


class _GatherLaunch(ctypes.Structure):
    """Mirror of csrc/gather_rows.cu::GatherLaunch."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "n_rows", "width", "row_stride", "batch", "clip", "vec", "rows",
        "threads", "grid")] + [
        (f, ctypes.c_uint) for f in ("rv_magic", "rv_shift")]


# csrc/gather_rows.cu: threads a block, independent loads a thread before
# its first store, and the most rows whose indices a block stages
GATHER_THREADS, GATHER_UNROLL, GATHER_MAX_ROWS = 256, 8, 2048


class GatherDesign(NamedTuple):
    """How P1 runs at one shape (csrc/gather_rows.cu)."""
    vec: int        # floats a load and a store: 4, 2 or 1
    rows: int       # output rows a block owns, their indices staged once
    threads: int    # per block
    grid: int       # blocks


def gather_rows_design(width: int, batch: int, row_stride: int | None = None,
                       offset: int = 0) -> GatherDesign:
    """P1's launch for ``batch`` rows of ``width`` floats from a table
    whose rows lie ``row_stride`` floats apart (``width`` by default) and
    which starts ``offset`` bytes past a 16-byte boundary.

    Loads and stores move float4 where the width, the row stride and the
    offset keep every row 16-byte aligned, float2 where 8-byte, else
    single floats (a 31-float row starts only 4-byte aligned).  A block
    owns as many rows as give each of its 256 threads one pass of 8
    independent loads (at least 1 row, at most 2048)."""
    stride = width if row_stride is None else row_stride
    if width < 1 or not 0 <= stride <= NUMEL_MAX or width > NUMEL_MAX:
        raise ValueError(f"gather_rows: width {width}, row stride {stride} "
                         f"outside 32-bit offsets")
    if not 0 <= batch <= NUMEL_MAX:
        raise ValueError(f"gather_rows: batch {batch} outside 32 bits")
    vec = next(v for v in (4, 2, 1) if width % v == 0 and stride % v == 0
               and offset % (4 * v) == 0)
    rows = max(1, min(GATHER_MAX_ROWS,
                      GATHER_THREADS * GATHER_UNROLL * vec // width))
    return GatherDesign(vec, rows, GATHER_THREADS, -(-batch // rows))


_GATHER_LAUNCHES: dict = {}


def _gather_launch(n_rows, width, stride, batch, offset, clip):
    """A reference to P1's ctypes launch for one shape, computed once."""
    key = (n_rows, width, stride, batch, offset, clip)
    hit = _GATHER_LAUNCHES.get(key)
    if hit is None:
        if n_rows > NUMEL_MAX:
            raise ValueError(f"gather_rows: {n_rows} rows; the kernel "
                             f"resolves indices in 32 bits")
        d = gather_rows_design(width, batch, stride, offset)
        magic, shift = divider(width // d.vec)
        launch = _GatherLaunch(n_rows, width, stride, batch, int(clip),
                               d.vec, d.rows, d.threads, d.grid, magic,
                               shift)
        hit = _GATHER_LAUNCHES[key] = (launch, ctypes.byref(launch))
    return hit[1]


def gather_rows(table, idx, clip: bool = False):
    """P1 on CUDA tensors, the plain version on CPU tensors: ``table``
    (V, W) or (V,) float32, ``idx`` (B,) int32 read as gather_rows_plain
    reads them (``clip`` as k_index).  A table whose columns are adjacent
    (one column of a wider table too) is read in place; another is made
    contiguous first."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx, clip)
    dev = table.device
    if not (dev.type == "cuda" and idx.device == dev
            and table.dtype == torch.float32 and idx.dtype == torch.int32
            and idx.dim() == 1 and idx.is_contiguous()
            and table.dim() in (1, 2)):
        if table.dim() not in (1, 2):
            raise ValueError(f"gather_rows: table must be 1-D or 2-D, got "
                             f"{tuple(table.shape)}")
        _refuse("gather_rows", (table, "table", None, torch.float32),
                (idx, "idx", (idx.numel(),), torch.int32))
    if table.dim() == 2 and table.stride(1) != 1 and table.shape[1] > 1:
        table = table.contiguous()
    n_rows, width = table.shape[0], table.shape[1] if table.dim() == 2 else 1
    batch = idx.shape[0]
    out = torch.empty((batch,) + table.shape[1:], dtype=torch.float32,
                      device=dev)
    if not batch * width:
        return out
    tp = table.data_ptr()
    ref = _gather_launch(n_rows, width, table.stride(0), batch, tp & 15,
                         bool(clip))
    _launched((_FNS or _fns()).gather_rows(
        tp, idx.data_ptr(), out.data_ptr(), ref, cuda.current_stream(dev)),
        GATHER_ROWS)
    return out


# ---- P2: looped take_along_axis ---------------------------------------

def take_along_plain(x, idx, axis: int, iters: int = 1):
    """``iters`` steps of acc += take_along_axis(x, idx, axis);
    idx = (idx + int32(acc) + i) mod x.shape[axis]; returns acc.

    Indices are read as jnp.take_along_axis reads them in the Pallas
    bodies: uint32 as int32 (the same bits), one in [-len, 0) counting
    from the end, one outside [-len, len) reading NaN (the step's reindex
    then brings it in range, so only the first step can).  torch's
    uint32 support is thin, so indices are widened to int64 for
    ``torch.gather``; ``%`` on integer tensors is a floor mod."""
    n = x.shape[axis]
    if idx.dtype == torch.uint32:
        idx = idx.view(torch.int32)
    j = idx.to(torch.int64)
    j = torch.where(j < 0, j + n, j)
    ok = (j >= 0) & (j < n)
    j = torch.where(ok, j, 0)
    acc = torch.where(ok, 0.0, float("nan")).to(x.dtype)
    for i in range(iters):
        acc = acc + torch.gather(x, axis, j)
        j = (j + acc.to(torch.int32) + i) % n
    return acc


class Design(NamedTuple):
    """How P2 runs at one shape (csrc/take_along.cu)."""
    name: str            # one of DESIGNS
    strip: int           # smem_cols: columns per strip; smem_rows: rows
    per_block: int       # smem_cols: chains per block; smem_rows: rows
    smem_bytes: int      # dynamic shared memory per block
    grid: tuple          # (x, y) blocks
    threads: int         # per block
    vec: bool            # 16-byte idx / out / strip copies (C % 4 == 0)
    chains: int          # chains a thread walks at once


def take_along_design(N: int, C: int, axis: int, iters: int, dtype,
                      sms: int = SMS, smem_block: int = SMEM_BLOCK
                      ) -> Design:
    """P2's design at x (N, C), for ``iters`` steps along ``axis`` with
    ``dtype`` indices, on a card of ``sms`` SMs whose blocks may take
    ``smem_block`` bytes of dynamic shared memory; raises on what the
    kernel does not take.

    - axis 0, iters > 1: "smem_cols", strips of k = 8 whole columns (N x
      32 bytes: one sector a row) in shared memory, or 4 where 8 do not
      fit; each strip's N k chains split across sms // strips blocks,
      about one block per SM (each staging asks L2 for N sectors);
    - axis 1, iters > 1: "smem_rows", ceil(N / sms) whole rows per block
      (R * C * 4 bytes), one block per SM;
    - otherwise, or where no strip fits: "global", 4 consecutive
      elements per thread, x from L2.
    A thread walks 1, 2 or 4 chains at once (``chains``)."""
    if axis not in (0, 1):
        raise ValueError(f"take_along: axis {axis}, expected 0 or 1")
    if iters < 1:
        raise ValueError(f"take_along: iters {iters} < 1")
    if dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"take_along: idx dtype {dtype}, expected int32 "
                         "or uint32")
    if dtype == torch.uint32 and iters != 1:
        raise ValueError("take_along: uint32 indices take iters = 1; the "
                         "reindexing update is defined on int32")
    if N < 1 or C < 1 or N * C > NUMEL_MAX:
        raise ValueError(f"take_along: x ({N}, {C}) outside 1..{NUMEL_MAX} "
                         "elements (32-bit offsets)")
    length = N if axis == 0 else C
    if length > LEN_MAX:
        raise ValueError(f"take_along: len {length} > {LEN_MAX}: the "
                         "reindex sums three terms below len in 32 bits")
    vec = C % 4 == 0
    if iters > 1 and axis == 0 and N * 16 <= smem_block:
        k = 8 if N * 32 <= smem_block else 4
        strips, chains = -(-C // k), N * k
        per_block = -(-chains // max(1, sms // strips))
        threads, g = _threads(per_block)
        return Design("smem_cols", k, per_block, N * k * 4,
                      (strips, -(-chains // per_block)), threads, vec, g)
    if iters > 1 and axis == 1 and C * 4 <= smem_block:
        rows = max(1, min(-(-N // sms), smem_block // (4 * C)))
        threads, g = _threads(rows * C)
        return Design("smem_rows", rows, rows, rows * C * 4,
                      (-(-N // rows), 1), threads, vec, g)
    return Design("global", 0, 0, 0, (-(-N * C // 1024), 1), 256, vec, 4)


def _threads(chains: int) -> tuple[int, int]:
    """(threads, chains each walks at once) for a block of ``chains``
    chains: one chain per thread while 1024 threads hold them (threads
    hide each other's latency), else 2 or 4 interleaved."""
    g = next((g for g in (1, 2) if chains <= 1024 * g), 4)
    return min(1024, -(-chains // (32 * g)) * 32), g


_TAKE_LAUNCHES: dict = {}


def _take_along_launch(N, C, axis, iters, dtype, aligned, dev):
    """(design, ctypes launch, a reference to it) for one shape on CUDA
    device ``dev``, computed once."""
    key = (N, C, axis, iters, dtype, aligned, dev.index)
    hit = _TAKE_LAUNCHES.get(key)
    if hit is None:
        d = take_along_design(N, C, axis, iters, dtype,
                              *device_limits(dev))
        if not aligned:
            d = d._replace(vec=False)
        launch = launch_struct(N, C, axis, iters, d)
        hit = _TAKE_LAUNCHES[key] = (d, launch, ctypes.byref(launch))
    return hit


def launch_struct(N, C, axis, iters, d: Design) -> _ProbeLaunch:
    """P2's ctypes launch for design ``d`` at x (N, C)."""
    lm, ls = divider(N if axis == 0 else C)
    cm, cs = divider(C)
    return _ProbeLaunch(
        N, C, axis, iters, 0, DESIGNS.index(d.name), int(d.vec), d.threads,
        d.grid[0], d.grid[1], d.smem_bytes, d.per_block, d.chains, d.strip,
        lm, ls, cm, cs)


def take_along(x, idx, axis: int, iters: int = 1):
    """P2 on CUDA tensors, the plain version on CPU tensors.  ``x`` is
    (N, C) float32; ``idx`` (N, C) int32, or uint32 with ``iters`` = 1,
    read as take_along_plain reads them.  The design that runs is
    take_along_design's for the card; design_launches counts it."""
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return take_along_plain(x, idx, axis, iters)
    dev = x.device
    if not (dev.type == "cuda" and idx.device == dev
            and x.dtype == torch.float32 and x.dim() == 2
            and idx.shape == x.shape and x.is_contiguous()
            and idx.is_contiguous()):
        if x.dim() != 2:
            raise ValueError("take_along: x must be (N, C)")
        _refuse("take_along", (x, "x", None, torch.float32),
                (idx, "idx", tuple(x.shape), None))
    N, C = x.shape
    out = torch.empty_like(x)   # cheaper than torch.empty(shape, ...)
    if not N * C:
        return out
    xp, ip = x.data_ptr(), idx.data_ptr()
    d, _, ref = _take_along_launch(N, C, axis, iters, idx.dtype,
                                   not (xp | ip) & 15, dev)
    fn = (_FNS or _fns()).take_along[idx.dtype]
    _launched(fn(xp, ip, out.data_ptr(), ref, cuda.current_stream(dev)),
              TAKE_ALONG)
    design_launches[d.name] += 1
    return out


# ---- P3: roll ---------------------------------------------------------

def roll_plain(x, shift: int, axis: int):
    return torch.roll(x, shift, axis)


_ROLL_LAUNCHES: dict = {}


def roll_launch(N: int, C: int, axis: int, shift: int,
                aligned: bool = True) -> _ProbeLaunch:
    """P3's launch at x (N, C): 4 consecutive output elements per thread,
    256 threads a block (one block at the probe's (8, 128)); the shift
    taken into [0, len)."""
    return _roll_launch(N, C, axis, shift, aligned)[0]


def _roll_launch(N, C, axis, shift, aligned):
    """(roll_launch's struct, a reference to it), computed once."""
    key = (N, C, axis, shift, aligned)
    hit = _ROLL_LAUNCHES.get(key)
    if hit is None:
        if axis not in (0, 1):
            raise ValueError(f"roll: axis {axis}, expected 0 or 1")
        if N < 1 or C < 1 or N * C > NUMEL_MAX:
            raise ValueError(f"roll: x ({N}, {C}) outside 1..{NUMEL_MAX} "
                             "elements (32-bit offsets)")
        cm, cs = divider(C)
        launch = _ProbeLaunch(
            N, C, axis, 0, shift % (N if axis == 0 else C), 0,
            int(C % 4 == 0 and aligned), 256, -(-N * C // 1024), 1, 0, 0,
            4, 0, 0, 0, cm, cs)
        hit = _ROLL_LAUNCHES[key] = (launch, ctypes.byref(launch))
    return hit


def roll(x, shift: int, axis: int):
    """P3 on a CUDA tensor, the plain version on a CPU one: ``x`` (N, C)
    float32 rolled by ``shift`` along ``axis`` (0 or 1), as np.roll."""
    dev = x.device
    if dev.type == "cpu":
        return roll_plain(x, shift, axis)
    if not (dev.type == "cuda" and x.dtype == torch.float32
            and x.dim() == 2 and x.is_contiguous()):
        if x.dim() != 2:
            raise ValueError("roll: x must be (N, C)")
        _refuse("roll", (x, "x", None, torch.float32))
    N, C = x.shape
    out = torch.empty_like(x)   # cheaper than torch.empty(shape, ...)
    if not N * C:
        return out
    xp = x.data_ptr()
    ref = _roll_launch(N, C, axis, shift, not xp & 15)[1]
    _launched((_FNS or _fns()).roll(xp, out.data_ptr(), ref,
                                    cuda.current_stream(dev)), ROLL)
    return out
