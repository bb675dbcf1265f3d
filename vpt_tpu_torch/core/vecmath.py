"""Vector / AABB math (port of vpt_tpu/core/vecmath.py, the subset the
fused render path uses).

A "vec3" is a tensor of shape (..., 3); transforms are row-vector
(..., 4, 4) matrices, ``p' = p @ M[:3, :3] + M[3, :3]``.  Sums over the
three components are written out left to right, the order the CUDA
kernels (csrc/) use, so the plain versions and the kernels agree to the
rounding of their transcendental functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = float(np.float32(1e-3))              # render_kernel.cu:84
TWO_PI = 2.0 * math.pi                     # rounds to float32 at use


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=eps))[..., None]


def reflect(i, n):
    """Mirror reflection, CUDA helper_math.h semantics: i - 2 n (n.i)."""
    return i - 2.0 * n * dot(n, i)[..., None]


def coordinate_system(v1):
    """(v2, v3) orthogonal to v1 (render_kernel.cu:91-102)."""
    cond = torch.abs(v1[..., 0]) > torch.abs(v1[..., 1])
    zero = torch.zeros_like(v1[..., 0])
    v2 = torch.where(cond[..., None],
                     torch.stack([-v1[..., 2], zero, v1[..., 0]], dim=-1),
                     torch.stack([zero, v1[..., 2], -v1[..., 1]], dim=-1))
    v2 = normalize(v2)
    v3 = normalize(cross(v1, v2))
    return v2, v3


def spherical_direction(sin_theta, cos_theta, phi, x, y, z):
    """render_kernel.cu:104-116."""
    st = sin_theta[..., None]
    return (x * st * torch.cos(phi)[..., None]
            + y * st * torch.sin(phi)[..., None]
            + z * cos_theta[..., None])


def true_div(a, s):
    """``a / s`` for a Python number ``s``, rounded as one float32
    division on every device.  On CUDA torch turns a division by a CPU
    scalar into a product with its reciprocal, which may differ from the
    quotient in the last bit; a 0-d tensor on ``a``'s device is divided
    by, as the CPU, the reference and the kernels divide."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def true_sqrt(a):
    """sqrt(a), correctly rounded on every device, as CUDA's float32 sqrt,
    the reference's and the kernels' are.  torch's float32 sqrt on the
    CPU misses the nearest float for about 0.7% of inputs, so the CPU
    takes the root in float64, which rounds to the nearest float32."""
    if a.device.type == "cpu" and a.dtype == torch.float32:
        return torch.sqrt(a.double()).float()
    return torch.sqrt(a)


def degree_to_cartesian(azimuth, elevation, device=None):
    """Sun direction from azimuth/elevation in degrees (y-up, azimuth in
    the xz plane from +x; render_kernel.cu:125-141).  float32, like the
    reference."""
    az = torch.clamp(torch.tensor(azimuth, dtype=torch.float32), 0.0, 360.0)
    el = torch.clamp(torch.tensor(elevation, dtype=torch.float32),
                     -90.0, 90.0)
    az = torch.deg2rad(az)
    el = torch.deg2rad(90.0 - el)
    x = torch.sin(el) * torch.cos(az)
    y = torch.cos(el)
    z = torch.sin(el) * torch.sin(az)
    return normalize(torch.stack([x, y, z])).to(device)


def transform_point(m, p):
    """[p, 1] @ M for one (4, 4) row-vector matrix."""
    return (p[..., 0:1] * m[0, :3] + p[..., 1:2] * m[1, :3]
            + p[..., 2:3] * m[2, :3] + m[3, :3])


def _amax3(v):
    return torch.maximum(torch.maximum(v[..., 0], v[..., 1]), v[..., 2])


def _amin3(v):
    return torch.minimum(torch.minimum(v[..., 0], v[..., 1]), v[..., 2])


def aabb_intersect(pmin, pmax, origin, direction):
    """Slab test with the reference's tmin<0 -> tmax rule (QUIRKS #19).

    Returns (hit, tmin, tmax): a miss when tmax <= 0 or tmin > tmax; from
    inside the box (tmin < 0) the EXIT distance is returned as tmin
    (AABB.h:182-205)."""
    inv = 1.0 / direction
    t1 = (pmin - origin) * inv
    t2 = (pmax - origin) * inv
    tmin = _amax3(torch.minimum(t1, t2))
    tmax = _amin3(torch.maximum(t1, t2))
    hit = (tmax > 0.0) & (tmin <= tmax)
    tmin_adj = torch.where(tmin < 0.0, tmax, tmin)
    hit = hit & (tmin_adj >= 0.0)
    return hit, tmin_adj, tmax


def aabb_contains(pmin, pmax, p):
    """Inclusive containment (AABB.h Contains, :141-146)."""
    return torch.all((p >= pmin) & (p <= pmax), dim=-1)

