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


def _stream(t):
    return cuda.current_stream(t.device)


def _route(name, *tensors) -> bool:
    """True for the kernel (all CUDA), False for the plain version (all
    CPU); raises on a mix or another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"}:
        raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected "
                         "all on one CUDA device or all on the CPU")
    return True


# ---- P1: row gather ---------------------------------------------------

def gather_rows_plain(table, idx):
    """out[b, :] = table[idx[b], :] for a 2-D table, or out[b] =
    table[idx[b]] for a 1-D one."""
    return table[idx.to(torch.int64)]


def gather_rows(table, idx):
    """P1 on CUDA tensors, the plain version on CPU tensors.  ``table``
    is (V, W) or (V,) float32 (a strided view, such as one column, is
    made contiguous); ``idx`` is (B,) int32 with values in [0, V)."""
    if not _route("gather_rows", table, idx):
        return gather_rows_plain(table, idx)
    if table.dim() not in (1, 2):
        raise ValueError(f"gather_rows: table must be 1-D or 2-D, got "
                         f"{tuple(table.shape)}")
    table = table.contiguous()
    cuda.check_cuda_tensor(table, "table", dtype=torch.float32)
    cuda.check_cuda_tensor(idx, "idx", (idx.numel(),), torch.int32,
                           table.device)
    width = table.shape[1] if table.dim() == 2 else 1
    out = torch.empty((idx.numel(),) + tuple(table.shape[1:]),
                      dtype=torch.float32, device=table.device)
    rc = cuda.load_library().dll.vpt_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0],
        width, idx.numel(), _stream(table))
    cuda.check_status(rc, "gather_rows")
    GATHER_ROWS.launches += 1
    return out


# ---- P2: looped take_along_axis ---------------------------------------

def take_along_plain(x, idx, axis: int, iters: int = 1):
    """``iters`` steps of acc += take_along_axis(x, idx, axis);
    idx = (idx + int32(acc) + i) mod x.shape[axis]; returns acc.  torch's
    uint32 support is thin, so indices are widened to int64 for
    ``torch.gather``; ``%`` on integer tensors is a floor mod."""
    n = x.shape[axis]
    j = idx.to(torch.int64)
    acc = torch.zeros_like(x)
    for i in range(iters):
        acc = acc + torch.gather(x, axis, j)
        j = (j + acc.to(torch.int32) + i) % n
    return acc


def take_along(x, idx, axis: int, iters: int = 1):
    """P2 on CUDA tensors, the plain version on CPU tensors.  ``x`` is
    (N, C) float32; ``idx`` (N, C) int32, or uint32 with ``iters`` = 1,
    with values in [0, x.shape[axis])."""
    if not _route("take_along", x, idx):
        return take_along_plain(x, idx, axis, iters)
    if axis not in (0, 1) or x.dim() != 2:
        raise ValueError("take_along: an (N, C) tensor, axis 0 or 1")
    if iters < 1:
        raise ValueError(f"take_along: iters {iters} < 1")
    cuda.check_cuda_tensor(x, "x", dtype=torch.float32)
    if idx.dtype == torch.uint32 and iters != 1:
        raise ValueError("take_along: uint32 indices take iters = 1; the "
                         "reindexing update is defined on int32")
    if idx.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"take_along: idx dtype {idx.dtype}, expected "
                         "int32 or uint32")
    cuda.check_cuda_tensor(idx, "idx", x.shape, device=x.device)
    out = torch.empty_like(x)
    dll = cuda.load_library().dll
    fn = (dll.vpt_take_along_i32 if idx.dtype == torch.int32
          else dll.vpt_take_along_u32)
    rc = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], axis, iters, _stream(x))
    cuda.check_status(rc, "take_along")
    TAKE_ALONG.launches += 1
    return out


# ---- P3: roll ---------------------------------------------------------

def roll_plain(x, shift: int, axis: int):
    return torch.roll(x, shift, axis)


def roll(x, shift: int, axis: int):
    """P3 on a CUDA tensor, the plain version on a CPU one: ``x`` (N, C)
    float32 rolled by ``shift`` along ``axis`` (0 or 1), as np.roll."""
    if not _route("roll", x):
        return roll_plain(x, shift, axis)
    if axis not in (0, 1) or x.dim() != 2:
        raise ValueError("roll: an (N, C) tensor, axis 0 or 1")
    cuda.check_cuda_tensor(x, "x", dtype=torch.float32)
    out = torch.empty_like(x)
    n = x.shape[axis]
    rc = cuda.load_library().dll.vpt_roll(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], axis,
        shift % n if n else 0, _stream(x))
    cuda.check_status(rc, "roll")
    ROLL.launches += 1
    return out
