"""Progressive film (port of vpt_tpu/render/film.py).

``accumulate`` launches kernel K3 (csrc/film_accumulate.py, Triton) on
CUDA tensors and runs ``accumulate_plain`` on CPU tensors.
``to_display`` runs once per saved image and stays plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.core.tonemap import aces_tonemap, gamma_encode
from vpt_tpu_torch.csrc import film_accumulate as k3
from vpt_tpu_torch.ops import cuda

FILM_ACCUMULATE = cuda.Kernel(
    name="film_accumulate", route="triton",
    source="vpt_tpu_torch/csrc/film_accumulate.py",
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
    launch K3 (which needs depth, cost and trunc); CPU tensors run the
    plain version."""
    if value.device.type == "cpu":
        return accumulate_plain(film, value, alpha, iteration, depth, cost,
                                trunc)
    if value.device.type != "cuda":
        raise ValueError(f"accumulate: unsupported device {value.device}")
    return _accumulate_triton(film, value, alpha, iteration, depth, cost,
                              trunc)


def _inv(iteration):
    it = torch.tensor(float(iteration), dtype=torch.float32)
    return 1.0 / (it + 1.0)


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


def _accumulate_triton(film, value, alpha, iteration, depth, cost, trunc):
    if depth is None or cost is None or trunc is None:
        raise ValueError("the CUDA accumulate takes depth, cost and trunc")
    H, W = alpha.shape
    dev = value.device
    cuda.check_cuda_tensor(value, "value", (H, W, 3), torch.float32)
    for name, t in (("alpha", alpha), ("depth", depth), ("cost", cost),
                    ("trunc", trunc)):
        cuda.check_cuda_tensor(t, name, (H, W), torch.float32, dev)
    for name in _FIELDS:
        shape = (H, W, 3) if name == "accum" else (H, W)
        cuda.check_cuda_tensor(getattr(film, name), f"film.{name}", shape,
                               torch.float32, dev)
    out = {name: torch.empty_like(getattr(film, name)) for name in _FIELDS}
    triton, film_accumulate = k3.kernel()
    n = H * W
    block = 1024
    film_accumulate[(triton.cdiv(n, block),)](
        film.accum, film.alpha, film.depth, film.cost, film.trunc,
        value, alpha, depth, cost, trunc,
        out["accum"], out["alpha"], out["depth"], out["cost"], out["trunc"],
        float(_inv(iteration)), n, BLOCK=block, num_warps=4,
        enable_fp_fusion=False)
    FILM_ACCUMULATE.launches += 1
    return Film(**out)


def to_display(film: Film, exposure_scale=1.0):
    """Radiance film -> uint8 RGB (render_kernel.cu:2292-2312)."""
    val = aces_tonemap(film.accum, exposure_scale)
    return (gamma_encode(val) * 255.0).to(torch.uint8)


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
