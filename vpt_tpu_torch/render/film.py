"""Progressive film (port of vpt_tpu/render/film.py).

``accumulate`` launches kernel K3 (csrc/film_accumulate.cu, in the
ctypes library of ops/cuda.py) on CUDA tensors and runs
``accumulate_plain`` on CPU tensors; the two agree bit for bit.  K3
takes any contiguous float32 tensors: 16-byte accesses where every
pointer allows them, single floats otherwise (``accumulate_design``).
``to_display`` runs once per saved image and stays plain torch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.core.tonemap import aces_tonemap, gamma_encode
from vpt_tpu_torch.ops import cuda

FILM_ACCUMULATE = cuda.Kernel(
    name="film_accumulate", route="cuda",
    source="vpt_tpu_torch/csrc/film_accumulate.cu",
    replaces="vpt_tpu/render/film.py:63")

_FIELDS = ("accum", "alpha", "depth", "cost", "trunc")


@dataclass(frozen=True)
class Film:
    accum: torch.Tensor  # (H, W, 3) running-mean radiance
    alpha: torch.Tensor  # (H, W) running-mean alpha
    depth: torch.Tensor  # (H, W) running-mean first-collision depth
    cost: torch.Tensor   # (H, W) TOTAL walk steps (additive)
    trunc: torch.Tensor  # (H, W) TOTAL step-budget truncations (additive)

    @staticmethod
    def zeros(height: int, width: int, device=DEFAULT_DEVICE) -> "Film":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return Film(accum=z(height, width, 3), alpha=z(height, width),
                    depth=z(height, width), cost=z(height, width),
                    trunc=z(height, width))


def scrub_nan(value, fallback):
    """Replace non-finite pixels with the fallback (QUIRKS #18): any
    non-finite component invalidates the whole pixel."""
    ok = torch.all(torch.isfinite(value), dim=-1, keepdim=True)
    return torch.where(ok, value, fallback)


def accumulate(film: Film, value, alpha, iteration,
               depth: Optional[torch.Tensor] = None,
               cost: Optional[torch.Tensor] = None,
               trunc: Optional[torch.Tensor] = None) -> Film:
    """One progressive step (render_kernel.cu:2278-2287).  CUDA tensors
    launch K3; CPU tensors run the plain version.  ``depth``, ``cost``
    and ``trunc`` may each be None: the film's field is carried over."""
    if value.device.type == "cpu":
        return accumulate_plain(film, value, alpha, iteration, depth, cost,
                                trunc)
    if value.device.type != "cuda":
        raise ValueError(f"accumulate: unsupported device {value.device}")
    return _accumulate_cuda(film, value, alpha, iteration, depth, cost,
                            trunc)


def _inv(iteration):
    it = torch.tensor(float(iteration), dtype=torch.float32)
    return 1.0 / (it + 1.0)


def _inv_f32(iteration) -> float:
    """float(_inv(iteration)), computed without a tensor."""
    return float(np.float32(1.0) / (np.float32(float(iteration))
                                    + np.float32(1.0)))


def accumulate_plain(film: Film, value, alpha, iteration, depth=None,
                     cost=None, trunc=None) -> Film:
    inv = _inv(iteration).to(value.device)
    value = scrub_nan(value, film.accum)
    alpha = torch.where(torch.isfinite(alpha), alpha, 1.0)
    return Film(
        accum=film.accum + (value - film.accum) * inv,
        alpha=film.alpha + (alpha - film.alpha) * inv,
        depth=(film.depth if depth is None
               else film.depth + (depth - film.depth) * inv),
        cost=film.cost if cost is None else film.cost + cost,
        trunc=film.trunc if trunc is None else film.trunc + trunc)


class _FilmArgs(ctypes.Structure):
    """Mirror of csrc/film_accumulate.cu::FilmArgs."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "acc", "alpha", "depth", "cost", "trunc", "v", "a", "d", "c", "t",
        "o_acc", "o_alpha", "o_depth", "o_cost", "o_trunc")] + [
        ("n", ctypes.c_int), ("fields", ctypes.c_int), ("vec", ctypes.c_int),
        ("inv", ctypes.c_float)]


_FN = None


def _fn():
    """The library's K3 entry point, bound once when it loads."""
    global _FN
    if _FN is None:
        dll = cuda.load_library().dll
        cuda.check_struct(_FilmArgs, dll.vpt_film_args_size)
        _FN = dll.vpt_film_accumulate
    return _FN


def accumulate_design(pointers) -> str:
    """K3's route for tensors starting at ``pointers`` (byte addresses):
    "float4" (4 pixels a thread in 16-byte accesses) when every one is
    16-byte aligned, else "scalar" (a pixel a thread)."""
    return "float4" if all(not ptr & 15 for ptr in pointers) else "scalar"


def _accumulate_cuda(film, value, alpha, iteration, depth, cost, trunc):
    """K3 on CUDA tensors: every tensor on value's device, float32 and
    contiguous, value and film.accum (H, W, 3), the rest (H, W); raises
    on anything else.  A field whose sample is None is carried over: the
    kernel neither reads nor writes it."""
    dev = value.device
    if dev.type != "cuda" or alpha.dim() != 2:
        raise ValueError(f"accumulate: value on {dev}, alpha "
                         f"{tuple(alpha.shape)}; K3 takes CUDA tensors, "
                         "alpha (H, W)")
    hw = alpha.shape
    samples = (depth, cost, trunc)
    given = [t is not None for t in samples]
    checks = [(film.accum, "film.accum", hw + (3,)),
              (value, "value", hw + (3,)),
              (film.alpha, "film.alpha", hw), (alpha, "alpha", hw)]
    for name, t in zip(_FIELDS[2:], samples):
        if t is not None:
            checks += [(getattr(film, name), f"film.{name}", hw),
                       (t, name, hw)]
    for t, label, shape in checks:
        if not (t.device == dev and t.dtype == torch.float32
                and t.shape == shape and t.is_contiguous()):
            cuda.check_cuda_tensor(t, f"accumulate: {label}", shape,
                                   torch.float32, dev)
    n = hw[0] * hw[1]
    if 3 * n > 2 ** 31 - 1:
        raise ValueError(f"accumulate: {n} pixels; K3 indexes in 32 bits")
    out = Film(torch.empty_like(film.accum), torch.empty_like(film.alpha),
               *(torch.empty_like(f) if g else f
                 for f, g in zip((film.depth, film.cost, film.trunc),
                                 given)))
    if not n:
        return out
    args = _FilmArgs(
        *(t.data_ptr() for t in (film.accum, film.alpha, film.depth,
                                 film.cost, film.trunc, value, alpha)),
        *(t.data_ptr() if g else None for t, g in zip(samples, given)),
        *(t.data_ptr() for t in (out.accum, out.alpha, out.depth, out.cost,
                                 out.trunc)),
        n, given[0] | given[1] << 1 | given[2] << 2, 0, _inv_f32(iteration))
    args.vec = accumulate_design(
        t.data_ptr() for t, _, _ in checks) == "float4"
    rc = (_FN or _fn())(ctypes.byref(args), cuda.current_stream(dev))
    if rc:
        cuda.check_status(rc, FILM_ACCUMULATE.name)
    FILM_ACCUMULATE.launches += 1
    return out


def to_display(film: Film, exposure_scale=1.0):
    """Radiance film -> uint8 RGB (render_kernel.cu:2292-2312)."""
    val = aces_tonemap(film.accum, exposure_scale)
    return (gamma_encode(val) * 255.0).to(torch.uint8)


def dof_overlay(film: Film, camera, exposure_scale=1.0):
    """Depth-of-field view, uint8 RGB (vpt_tpu/render/film.py:87-103,
    render_kernel.cu:2266-2275): the display value lerped halfway to
    blue before the focus band, green inside it and red beyond it; the
    band's half-width is 1 / lens_radius."""
    base = gamma_encode(aces_tonemap(film.accum, exposure_scale))
    aof = torch.clamp(1.0 / torch.clamp(camera.lens_radius, min=1e-12),
                      0.0, 3.4e38)
    lo = camera.focus_dist - aof
    hi = camera.focus_dist + aof
    d = film.depth[..., None]
    red, green, blue = torch.eye(3, dtype=torch.float32,
                                 device=base.device)
    out = torch.where(d > hi, (base + red) * 0.5, base)
    out = torch.where(d < lo, (base + blue) * 0.5, out)
    out = torch.where((d >= lo) & (d <= hi), (base + green) * 0.5, out)
    return (torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)


def save_film(path: str, film: Film, iteration: int):
    """Checkpoint the progressive state (npz, the reference's keys)."""
    np.savez_compressed(path, **{k: getattr(film, k).cpu().numpy()
                                 for k in _FIELDS},
                        iteration=np.int64(iteration))


def load_film(path: str, device=DEFAULT_DEVICE):
    """(film, iteration); checkpoints without trunc load zeros there."""
    z = np.load(path)
    arrays = {k: z[k] for k in _FIELDS if k in z.files}
    arrays.setdefault("trunc", np.zeros_like(z["cost"]))
    film = Film(**{k: torch.as_tensor(v, device=device)
                   for k, v in arrays.items()})
    return film, int(z["iteration"])
