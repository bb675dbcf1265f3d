"""Phase functions: Henyey-Greenstein, single and double lobe (port of
vpt_tpu/core/phase.py).

The reference's HG uses the leading constant pi/4 (``M_PI_4``,
light.h:61) instead of 1/(4 pi): QUIRKS #1, kept by default.  Scalars
(g, f) are float32 0-d tensors so products of scalars round in float32,
as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import (EPS, TWO_PI, coordinate_system,
                                        normalize, spherical_direction)

M_PI_4 = float(np.float32(np.pi / 4.0))          # light.h:61
INV_4_PI = float(np.float32(1.0 / (4.0 * np.pi)))


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def henyey_greenstein(cos_theta, g, normalized: bool = False):
    """HG phase value (light.h:55-64)."""
    g = _f32(g, cos_theta)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    k = INV_4_PI if normalized else M_PI_4
    return k * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp(denom,
                                                               min=1e-20)))


def double_henyey_greenstein(cos_theta, f, g1, g2, normalized=False):
    """Two-lobe HG blend (render_kernel.cu:278-287)."""
    f = _f32(f, cos_theta)
    return (f * henyey_greenstein(cos_theta, g1, normalized)
            + (1.0 - f) * henyey_greenstein(cos_theta, g2, normalized))


def isotropic():
    """1 / (4 pi) (render_kernel.cu:271-275); the HDRI terminal term
    scales the map by it (QUIRKS #8)."""
    return INV_4_PI


def sample_hg(wo, key, g, normalized: bool = False):
    """Direction around ``wo`` from the HG lobe; (new_dir, phase value)
    (render_kernel.cu:306-325).  Draws u1 from split(key)[0] and phi from
    split(key)[1], one element per ray."""
    shape = wo.shape[:-1]
    g = _f32(g, wo)
    k1, k2 = rng.split(key)
    u1 = rng.uniform(k1, shape, wo.device)
    g_b = g.expand(shape)
    sqr_term = (1.0 - g_b * g_b) / (1.0 - g_b + 2.0 * g_b * u1)
    cos_theta_aniso = (1.0 + g_b * g_b - sqr_term * sqr_term) / (
        2.0 * torch.where(torch.abs(g_b) < 1e-6, 1.0, g_b))
    cos_theta = torch.where(torch.abs(g_b) < EPS, 1.0 - 2.0 * u1,
                            cos_theta_aniso)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=0.0))
    phi = TWO_PI * rng.uniform(k2, shape, wo.device)
    v1, v2 = coordinate_system(-wo)
    new_dir = spherical_direction(sin_theta, cos_theta, phi, v1, v2, wo)
    return new_dir, henyey_greenstein(-cos_theta, g_b, normalized)


def sample_double_hg(wi, key, f, g1, g2, normalized: bool = False):
    """Two-lobe HG sampling (render_kernel.cu:330-362): both lobes are
    drawn and the DIRECTIONS lerped by (1-f) (QUIRKS #16)."""
    f = _f32(f, wi)
    wo = -wi
    k1, k2 = rng.split(key)
    d1, p1 = sample_hg(wo, k1, g1, normalized)
    d2, p2 = sample_hg(wo, k2, g2, normalized)
    dir_mix = normalize(d1 + (d2 - d1) * (1.0 - f))
    val_mix = f * p1 + (1.0 - f) * p2
    hi = f > 0.9999
    lo = f < EPS
    new_dir = torch.where(hi, d1, torch.where(lo, d2, dir_mix))
    val = torch.where(hi, p1, torch.where(lo, p2, val_mix))
    return new_dir, val


def phase_eval(params, cos_theta, normalized: bool = False):
    """Single HG with g1, or the two-lobe blend when
    params.use_double_hg (QUIRKS #22)."""
    if params.use_double_hg:
        return double_henyey_greenstein(cos_theta, params.phase_f,
                                        params.phase_g1, params.phase_g2,
                                        normalized)
    return henyey_greenstein(cos_theta, params.phase_g1, normalized)


def phase_sample(params, direction, key, normalized: bool = False):
    """Direction sampling around ``direction``; (new_dir, value)."""
    if params.use_double_hg:
        return sample_double_hg(-direction, key, params.phase_f,
                                params.phase_g1, params.phase_g2,
                                normalized)
    return sample_hg(direction, key, params.phase_g1, normalized)


def sample_spherical(key, shape=(), device=None):
    """A uniform sphere direction and its pdf, isotropic()
    (render_kernel.cu:292-303): phi from split(key)[0], cos_theta from
    split(key)[1], one element per ray."""
    k1, k2 = rng.split(key)
    phi = TWO_PI * rng.uniform(k1, shape, device)
    cos_theta = 1.0 - 2.0 * rng.uniform(k2, shape, device)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=0.0))
    wi = torch.stack([torch.cos(phi) * sin_theta,
                      torch.sin(phi) * sin_theta, cos_theta], dim=-1)
    return wi, torch.full(tuple(shape), isotropic(), dtype=torch.float32,
                          device=device)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """The MIS power heuristic, beta = 2 (light.h:65-69), with the
    reference's 1e-30 guard."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-30)
