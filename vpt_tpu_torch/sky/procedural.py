"""The simple single-scattering sky (port of vpt_tpu/sky/procedural.py;
main.cpp:242-312 in the original, a scratchapixel-style Nishita model).

``sample_sky`` is the plain version of the sky case of kernel K4
(csrc/environment.cu), which repeats its arithmetic operation for
operation: the same 16 x 8 march, the same constants (Python doubles
rounded to float32 where they meet a tensor, as in the reference), norms
written out as sqrt((x*x + y*y) + z*z), and divisions by a constant made
as float32 divisions on every device (``true_div``).  ``sky_constants``
gives K4 those float32 values, and the reciprocals RN(1/HR) and RN(1/HM)
with which K4 divides by HR and HM, correctly rounded, in three
operations (csrc/vpt_common.cuh::div_known2; ``div_known_plain`` is
its exact emulation in numpy, one divisor at a time).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vpt_tpu_torch.core.vecmath import degree_to_cartesian, true_div

ATMOSPHERE_R = 6420e3
EARTH_R = 6360e3
HR = 7994.0
HM = 1200.0
BETA_R = np.array([3.8e-6, 13.5e-6, 33.1e-6], np.float32)
BETA_M = np.array([21e-6, 21e-6, 21e-6], np.float32)
N_SAMPLES = 16
N_SAMPLES_LIGHT = 8
MIE_G = 0.76
OBSERVER_Y = 1000.0 + EARTH_R   # the observer, 1000 m above the ground
RED = (1.0, 0.0, 0.0)           # the reference's sentinel for a miss


def _f32(x) -> float:
    return float(np.float32(x))


def sky_constants() -> dict:
    """The float32 values K4 uses, each the rounding of the Python
    expression ``sample_sky`` hands to torch."""
    g = MIE_G
    return dict(
        earth_r=_f32(EARTH_R), earth_r2=_f32(EARTH_R * EARTH_R),
        atm_r2=_f32(ATMOSPHERE_R * ATMOSPHERE_R), observer_y=_f32(OBSERVER_Y),
        hr=_f32(HR), hm=_f32(HM),
        hr_inv=float(np.float32(1.0) / np.float32(HR)),
        hm_inv=float(np.float32(1.0) / np.float32(HM)),
        c_r=_f32(3.0 / (16.0 * math.pi)), c_m=_f32(3.0 / (8.0 * math.pi)),
        one_minus_g2=_f32(1.0 - g * g), one_plus_g2=_f32(1.0 + g * g),
        two_g=_f32(2.0 * g), two_plus_g2=_f32(2.0 + g * g),
        beta_r=[float(v) for v in BETA_R],
        beta_m=[float(v) for v in BETA_M],
        beta_m11=[float(v) for v in BETA_M * 1.1])


# csrc/vpt_common.cuh::DIV_KNOWN_MIN: below it (and for zero and NaN)
# div_known2 is IEEE division
DIV_KNOWN_MIN = 2.0 ** -100


def _rn32_sum(a, b):
    """RN32(a + b) for float64 arrays holding exact values: the float64
    sum and its error (TwoSum), rounded once to float32, an exact tie
    broken by the sign of the error."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    out = s.astype(np.float32)
    lo = out.astype(np.float64)
    up = np.nextafter(out, np.float32(np.inf)).astype(np.float64)
    dn = np.nextafter(out, np.float32(-np.inf)).astype(np.float64)
    to_up = (s == (lo + up) / 2) & (err > 0)
    to_dn = (s == (lo + dn) / 2) & (err < 0)
    out[to_up] = np.nextafter(out[to_up], np.float32(np.inf))
    out[to_dn] = np.nextafter(out[to_dn], np.float32(-np.inf))
    return out


def div_known_plain(x, d, y):
    """csrc/vpt_common.cuh::div_known2's quotient by one divisor d on a
    float32 array, exactly: q0 = RN32(x y), r = RN32(x - q0 d) (an FMA:
    one rounding of the exact value), RN32(r y + q0), with r = min(r,
    FLT_MAX) and IEEE division where |x| < DIV_KNOWN_MIN or x is NaN.  Every product is exact in
    float64 and the last sum is rounded by ``_rn32_sum``."""
    x = np.asarray(x, np.float32)
    d64, y64 = np.float64(np.float32(d)), np.float64(np.float32(y))
    with np.errstate(all="ignore"):
        x64 = x.astype(np.float64)
        q0 = (x64 * y64).astype(np.float32)
        r = (x64 - q0.astype(np.float64) * d64).astype(np.float32)
        r = np.fmin(r, np.float32(np.finfo(np.float32).max))
        out = _rn32_sum(r.astype(np.float64) * y64, q0.astype(np.float64))
        slow = ~(np.abs(x) >= np.float32(DIV_KNOWN_MIN))
        out[slow] = x[slow] / np.float32(d)
    return out


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _ray_sphere(orig, direction, radius):
    """(hit, t0, t1) with t0 <= t1 for a unit-a quadratic
    (main.cpp:203-217)."""
    b = 2.0 * _dot(direction, orig)
    c = _dot(orig, orig) - radius * radius
    disc = b * b - 4.0 * c
    hit = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    return hit, torch.minimum(t0, t1), torch.maximum(t0, t1)


def sample_sky(direction, azimuth, elevation, intensity):
    """Radiance of the simple sky for (..., 3) directions, observed from
    1000 m above the ground; RED (1, 0, 0) for a ray that misses the
    atmosphere (the reference's debug sentinel, kept).  ``intensity``: a
    (3,) tensor on the directions' device."""
    dev = direction.device
    shape = direction.shape[:-1]
    sun = degree_to_cartesian(azimuth, elevation, dev)
    pos = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    pos[..., 1] = OBSERVER_Y
    beta_r = torch.as_tensor(BETA_R, device=dev)
    beta_m = torch.as_tensor(BETA_M, device=dev)
    beta_m11 = torch.as_tensor(BETA_M * 1.1, device=dev)

    ehit, et0, et1 = _ray_sphere(pos, direction, EARTH_R)
    tmax = torch.where(ehit & (et1 > 0.0), torch.clamp(et0, min=0.0),
                       3.4e38)
    ahit, at0, at1 = _ray_sphere(pos, direction, ATMOSPHERE_R)
    miss = ~ahit | (at1 < 0.0)
    tmin = torch.where(at0 > 0.0, torch.clamp(at0, min=0.0), 0.0)
    tmax = torch.minimum(tmax, at1)

    seg = (tmax - tmin) / N_SAMPLES
    mu = _dot(direction, sun.expand(shape + (3,)))
    phase_r = 3.0 / (16.0 * math.pi) * (1.0 + mu * mu)
    g = MIE_G
    phase_m = ((3.0 / (8.0 * math.pi) * ((1.0 - g * g) * (1.0 + mu * mu)))
               / ((2.0 + g * g)
                  * torch.pow(1.0 + g * g - 2.0 * g * mu, 1.5)))

    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    sum_r = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    sum_m = torch.zeros_like(sum_r)
    od_r, od_m = zeros, zeros
    for i in range(N_SAMPLES):
        t_cur = tmin + seg * (i + 0.5)
        sp = pos + direction * t_cur[..., None]
        height = _norm(sp) - EARTH_R
        hr = torch.exp(true_div(-height, HR)) * seg
        hm = torch.exp(true_div(-height, HM)) * seg
        od_r = od_r + hr
        od_m = od_m + hm
        # light march toward the sun
        _, _, t1l = _ray_sphere(sp, sun.expand(sp.shape), ATMOSPHERE_R)
        segl = t1l / N_SAMPLES_LIGHT
        odl_r, odl_m = zeros, zeros
        below = torch.zeros(shape, dtype=torch.bool, device=dev)
        for j in range(N_SAMPLES_LIGHT):
            tl = segl * (j + 0.5)
            spl = sp + sun * tl[..., None]
            hl = _norm(spl) - EARTH_R
            below = below | (hl < 0.0)
            odl_r = torch.where(below, odl_r, odl_r + torch.exp(
                true_div(-hl, HR)) * segl)
            odl_m = torch.where(below, odl_m, odl_m + torch.exp(
                true_div(-hl, HM)) * segl)
        visible = ~below[..., None]
        tau = (beta_r * (od_r + odl_r)[..., None]
               + beta_m11 * (od_m + odl_m)[..., None])
        atten = torch.exp(-tau)
        sum_r = sum_r + torch.where(visible, atten * hr[..., None], 0.0)
        sum_m = sum_m + torch.where(visible, atten * hm[..., None], 0.0)

    out = (sum_r * beta_r * phase_r[..., None]
           + sum_m * beta_m * phase_m[..., None]) * intensity
    red = torch.tensor(RED, dtype=torch.float32, device=dev)
    return torch.where(miss[..., None], red, out)
