"""Equirectangular environment maps: the direction -> (u, v) map and the
bilinear lookup (port of vpt_tpu/sky/envmap.py; sample_env_tex,
render_kernel.cu:897-907, in the original).

The port samples the raw (H, W, 3) map with 4 taps, x wrapping and y
clamped.  The reference stores 12-channel corner rows instead
(``pack_env_map``) because the TPU priced a gather per index; that
workaround is not copied (ROADMAP, "not copied").  Both of the
reference's branches evaluate the same bilinear expression, kept here in
its order, so the raw map gives the same numbers.  This is the plain
version of the HDRI case of kernel K4 (csrc/environment.cu).
"""

from __future__ import annotations

import math

import torch

from vpt_tpu_torch.core.vecmath import true_div


def env_uv(direction):
    """Direction -> equirect (u, v): u = atan2(z, x) / (2 pi) + 0.5,
    v = acos(clamp(y, -1, 1)) / pi (render_kernel.cu:901-905)."""
    u = torch.atan2(direction[..., 2], direction[..., 0]) * (
        0.5 / math.pi) + 0.5
    v = true_div(torch.acos(torch.clamp(direction[..., 1], -1.0, 1.0)),
                 math.pi)
    return u, v


def sample_env_map(env_map, direction):
    """Bilinear equirect lookup (cudaFilterModeLinear semantics) of the
    raw (H, W, 3) ``env_map`` in (..., 3) directions."""
    H, W = env_map.shape[:2]
    u, v = env_uv(direction)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), W)
    y0i = y0.to(torch.int64)
    x1i = torch.remainder(x0i + 1, W)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    v00 = env_map[y0i, x0i]
    v01 = env_map[y0i, x1i]
    v10 = env_map[y1i, x0i]
    v11 = env_map[y1i, x1i]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)
