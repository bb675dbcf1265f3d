"""Bruneton precomputed atmospheric scattering (port of
vpt_tpu/sky/bruneton.py; source/atmosphere/ in the original: the host
code atmosphere.cpp, the precompute kernels atmosphere_kernels.cu and
the parameter struct definitions.h).

The model (spectral tables, ``AtmosphereParams`` at three wavelengths),
the precompute (transmittance, single scattering, direct and indirect
irradiance, the scattering density and multiple scattering of orders 2
to n, orders >= 2 stored divided by the Rayleigh phase) and the runtime
lookups (``get_sky_radiance``, ``get_sky_radiance_to_point``,
``get_sun_and_sky_irradiance``, ``get_solar_radiance``) are the
reference's, function for function, in torch on the device of the
params.  The precompute runs texel-parallel, each stage as one program
but the scattering density, whose 1 M texels x 128 directions peak at
69 GB as one program at the full LutDims on an H100
(tools/time_atmosphere.py --memory): it runs in chunks of texels
(``CHUNK_SAMPLES``, 1.1 GB).

The runtime reads the plain LUTs (``tex2d``, ``tex3d``): the reference's
corner-packed rows (``pack_luts``) serve its TPU gathers and are not
ported.  Its packed 2-D lookups are the plain ones bit for bit; its
packed 4-D lookup sums the eight trilinear corners in another order
(tests/test_torch_atmosphere.py measures the gap).

Every division by a Python number is one float32 division on every
device (core/vecmath.py::true_div), and every sum over three components
is written out left to right, so that the runtime here is the plain
version of kernel K4's atmosphere (csrc/environment.cu) operation for
operation.  ``save_luts`` / ``load_luts`` use the reference's npz keys.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.core.vecmath import dot, true_div, true_sqrt

# ---------------------------------------------------------------------------
# Spectral model constants (atmosphere.h:66-96)
# ---------------------------------------------------------------------------

K_SOLAR_IRRADIANCE = np.array([
    1.11776, 1.14259, 1.01249, 1.14716, 1.72765, 1.73054, 1.6887, 1.61253,
    1.91198, 2.03474, 2.02042, 2.02212, 1.93377, 1.95809, 1.91686, 1.8298,
    1.8685, 1.8931, 1.85149, 1.8504, 1.8341, 1.8345, 1.8147, 1.78158, 1.7533,
    1.6965, 1.68194, 1.64654, 1.6048, 1.52143, 1.55622, 1.5113, 1.474, 1.4482,
    1.41018, 1.36775, 1.34188, 1.31429, 1.28303, 1.26758, 1.2367, 1.2082,
    1.18737, 1.14683, 1.12362, 1.1058, 1.07124, 1.04992])
K_OZONE_CROSS_SECTION = np.array([
    1.18e-27, 2.182e-28, 2.818e-28, 6.636e-28, 1.527e-27, 2.763e-27, 5.52e-27,
    8.451e-27, 1.582e-26, 2.316e-26, 3.669e-26, 4.924e-26, 7.752e-26,
    9.016e-26, 1.48e-25, 1.602e-25, 2.139e-25, 2.755e-25, 3.091e-25, 3.5e-25,
    4.266e-25, 4.672e-25, 4.398e-25, 4.701e-25, 5.019e-25, 4.305e-25,
    3.74e-25, 3.215e-25, 2.662e-25, 2.238e-25, 1.852e-25, 1.473e-25,
    1.209e-25, 9.423e-26, 7.455e-26, 6.566e-26, 5.105e-26, 4.15e-26,
    4.228e-26, 3.237e-26, 2.451e-26, 2.801e-26, 2.534e-26, 1.624e-26,
    1.465e-26, 2.078e-26, 1.383e-26, 7.105e-27])
K_DOBSON_UNIT = 2.687e20
K_MAX_OZONE_NUMBER_DENSITY = 300.0 * K_DOBSON_UNIT / 15000.0
K_CONSTANT_SOLAR_IRRADIANCE = 1.5
K_RAYLEIGH = 1.24062e-6
K_RAYLEIGH_SCALE_HEIGHT = 8000.0
K_MIE_SCALE_HEIGHT = 1200.0
K_MIE_ANGSTROM_ALPHA = 0.0
K_MIE_ANGSTROM_BETA = 5.328e-3
K_MIE_SINGLE_SCATTERING_ALBEDO = 0.9
K_GROUND_ALBEDO = 0.01
LAMBDA_MIN, LAMBDA_MAX = 360, 830
LAMBDA_R, LAMBDA_G, LAMBDA_B = 680.0, 550.0, 440.0
MAX_LUMINOUS_EFFICACY = 683.0

# Linear sRGB (D65) from CIE XYZ
XYZ_TO_SRGB = np.array([
    [3.2406, -1.5372, -0.4986],
    [-0.9689, 1.8758, 0.0415],
    [0.0557, -0.2040, 1.0570]])

# texels x directions held at once by the scattering density's chunks
CHUNK_SAMPLES = 1 << 22


def _cie_piecewise_gauss(lam, mu, s1, s2):
    s = np.where(lam < mu, s1, s2)
    return np.exp(-0.5 * ((lam - mu) / s) ** 2)


def cie_xyz_bar(lam):
    """CIE 1931 2-degree colour matching functions by the Wyman-Sloan-
    Shirley multi-lobe Gaussian fit (JCGT 2013), (..., 3)."""
    lam = np.asarray(lam, np.float64)
    x = (1.056 * _cie_piecewise_gauss(lam, 599.8, 37.9, 31.0)
         + 0.362 * _cie_piecewise_gauss(lam, 442.0, 16.0, 26.7)
         - 0.065 * _cie_piecewise_gauss(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _cie_piecewise_gauss(lam, 568.8, 46.9, 40.5)
         + 0.286 * _cie_piecewise_gauss(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _cie_piecewise_gauss(lam, 437.0, 11.8, 36.0)
         + 0.681 * _cie_piecewise_gauss(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


def srgb_coeff(lam):
    """Linear-sRGB response of the CIE observer at ``lam``, (..., 3)
    (atmosphere.cpp:137-145)."""
    return cie_xyz_bar(lam) @ XYZ_TO_SRGB.T


def spectral_radiance_to_luminance_factors(wavelengths, solar,
                                           lambda_power):
    """The APPROXIMATE-luminance k constants (atmosphere.cpp:184-214)."""
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX, 1.0)
    rgb_bar = srgb_coeff(lam)
    irr = np.interp(lam, wavelengths, solar)
    sol_rgb = np.interp([LAMBDA_R, LAMBDA_G, LAMBDA_B], wavelengths, solar)
    lam_ratio = (lam[:, None]
                 / np.array([LAMBDA_R, LAMBDA_G, LAMBDA_B])) ** lambda_power
    k = (rgb_bar * (irr[:, None] / sol_rgb) * lam_ratio).sum(0)
    return k * MAX_LUMINOUS_EFFICACY


def white_point_srgb(wavelengths, solar):
    """The white-balance divisor (atmosphere.cpp:217-233, 677-695)."""
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX, 1.0)
    irr = np.interp(lam, wavelengths, solar)
    xyz = (cie_xyz_bar(lam) * irr[:, None]).sum(0)
    rgb = MAX_LUMINOUS_EFFICACY * (XYZ_TO_SRGB @ xyz)
    return rgb / rgb.mean()


@dataclass(frozen=True)
class LutDims:
    """Texture sizes (constants.h:50-62 at the defaults)."""

    transmittance_w: int = 256
    transmittance_h: int = 64
    r: int = 32
    mu: int = 128
    mu_s: int = 32
    nu: int = 8
    irradiance_w: int = 64
    irradiance_h: int = 16

    @property
    def scattering_w(self):
        return self.nu * self.mu_s

    def shapes(self) -> dict:
        """The shape of each LUT at these dims."""
        s = (self.r, self.mu, self.scattering_w, 3)
        return dict(
            transmittance=(self.transmittance_h, self.transmittance_w, 3),
            scattering=s, single_mie=s,
            irradiance=(self.irradiance_h, self.irradiance_w, 3))


@dataclass(frozen=True)
class AtmosphereParams:
    """Per-RGB-wavelength physical parameters (definitions.h:53-99), as
    float32 tensors on one device; ``use_luminance`` 0 NONE, 1
    APPROXIMATE, 2 PRECOMPUTED."""

    solar_irradiance: torch.Tensor     # (3,)
    sun_angular_radius: torch.Tensor   # ()
    bottom_radius: torch.Tensor        # ()
    top_radius: torch.Tensor           # ()
    rayleigh_scattering: torch.Tensor  # (3,)
    rayleigh_exp_scale: torch.Tensor   # () = -1/Hr
    mie_scattering: torch.Tensor       # (3,)
    mie_extinction: torch.Tensor       # (3,)
    mie_exp_scale: torch.Tensor        # () = -1/Hm
    mie_phase_g: torch.Tensor          # ()
    absorption_extinction: torch.Tensor  # (3,) ozone
    ozone_center: torch.Tensor         # ()
    ozone_width: torch.Tensor          # ()
    ground_albedo: torch.Tensor        # (3,)
    mu_s_min: torch.Tensor             # ()
    sun_radiance_scale: torch.Tensor   # (3,)
    exposure: torch.Tensor             # ()
    white_point: torch.Tensor          # (3,)
    earth_center_y: torch.Tensor       # () = -bottom_radius
    use_luminance: int
    sky_spectral_to_rgb: torch.Tensor  # (3,)
    sun_spectral_to_rgb: torch.Tensor  # (3,)

    def to(self, device) -> "AtmosphereParams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclass(frozen=True)
class AtmosphereLUTs:
    transmittance: torch.Tensor  # (TH, TW, 3)
    scattering: torch.Tensor     # (R, MU, NU*MU_S, 3) rayleigh + multiple
    single_mie: torch.Tensor     # (R, MU, NU*MU_S, 3)
    irradiance: torch.Tensor     # (IH, IW, 3)

    def to(self, device) -> "AtmosphereLUTs":
        return AtmosphereLUTs(*(getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)))


def _spectral_tables(use_ozone=True, use_constant_solar=False):
    """Spectral tables at 10 nm bins (atmosphere.cpp:1195-1224)."""
    wl = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1, 10, dtype=np.float64)
    solar = (np.full_like(wl, K_CONSTANT_SOLAR_IRRADIANCE)
             if use_constant_solar else K_SOLAR_IRRADIANCE)
    rayleigh = K_RAYLEIGH * (wl * 1e-3) ** -4
    mie_all = (K_MIE_ANGSTROM_BETA / K_MIE_SCALE_HEIGHT
               * (wl * 1e-3) ** -K_MIE_ANGSTROM_ALPHA)
    mie_scat = mie_all * K_MIE_SINGLE_SCATTERING_ALBEDO
    absorption = (K_MAX_OZONE_NUMBER_DENSITY * K_OZONE_CROSS_SECTION
                  if use_ozone else np.zeros_like(wl))
    return wl, solar, rayleigh, mie_scat, mie_all, absorption


def model_at_lambdas(lams, use_ozone=True, use_constant_solar=False,
                     exposure=10.0, use_luminance=0,
                     do_white_balance=False, device=DEFAULT_DEVICE):
    """AtmosphereParams with the spectra interpolated at a wavelength
    triple (the per-batch models of the PRECOMPUTED-luminance pipeline,
    atmosphere.cpp:838-858)."""
    wl, solar, rayleigh, mie_scat, mie_all, absorption = _spectral_tables(
        use_ozone, use_constant_solar)
    lams = np.asarray(lams, np.float64)

    def at(tab):
        return np.array([np.interp(lam, wl, tab) for lam in lams])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32,
                            device=device)

    sar = 0.00935 / 2.0
    sol3 = at(solar)
    if use_luminance == 2:
        # PRECOMPUTED: the textures hold illuminance / 683, sky_k folds
        # the efficacy back in (atmosphere.cpp:151-157)
        sky_k = np.full(3, MAX_LUMINOUS_EFFICACY)
    elif use_luminance == 1:
        sky_k = spectral_radiance_to_luminance_factors(wl, solar, -3)
    else:
        sky_k = np.ones(3)
    sun_k = (spectral_radiance_to_luminance_factors(wl, solar, 0)
             if use_luminance else np.ones(3))
    wp = white_point_srgb(wl, solar) if do_white_balance else np.ones(3)
    return AtmosphereParams(
        solar_irradiance=f32(sol3), sun_angular_radius=f32(sar),
        bottom_radius=f32(6360000.0), top_radius=f32(6420000.0),
        rayleigh_scattering=f32(at(rayleigh)),
        rayleigh_exp_scale=f32(-1.0 / K_RAYLEIGH_SCALE_HEIGHT),
        mie_scattering=f32(at(mie_scat)), mie_extinction=f32(at(mie_all)),
        mie_exp_scale=f32(-1.0 / K_MIE_SCALE_HEIGHT), mie_phase_g=f32(0.8),
        absorption_extinction=f32(at(absorption)),
        ozone_center=f32(25000.0), ozone_width=f32(15000.0),
        ground_albedo=f32([K_GROUND_ALBEDO] * 3),
        mu_s_min=f32(np.cos(120.0 / 180.0 * np.pi)),
        sun_radiance_scale=f32(sol3 / (np.pi * sar * sar)),
        exposure=f32(exposure), white_point=f32(wp),
        earth_center_y=f32(-6360000.0), use_luminance=int(use_luminance),
        sky_spectral_to_rgb=f32(sky_k), sun_spectral_to_rgb=f32(sun_k))


def default_model(use_ozone=True, use_constant_solar=False, exposure=10.0,
                  use_luminance=0, do_white_balance=False,
                  device=DEFAULT_DEVICE):
    """The model at the RGB wavelengths (kDefaultLambdas,
    atmosphere.h:97)."""
    return model_at_lambdas(
        np.array([LAMBDA_R, LAMBDA_G, LAMBDA_B]), use_ozone=use_ozone,
        use_constant_solar=use_constant_solar, exposure=exposure,
        use_luminance=use_luminance, do_white_balance=do_white_balance,
        device=device)


# ---------------------------------------------------------------------------
# Geometry (atmosphere_kernels.cu:103-214)
# ---------------------------------------------------------------------------

def _clamp_cosine(mu):
    return torch.clamp(mu, -1.0, 1.0)


def _clamp_radius(p, r):
    return torch.minimum(torch.maximum(r, p.bottom_radius), p.top_radius)


def _safe_sqrt(a):
    return true_sqrt(torch.clamp(a, min=0.0))


def _length(a):
    return _safe_sqrt(dot(a, a))


def _horizon(p):
    """H = sqrt(top^2 - bottom^2), the horizon distance at the ground."""
    return _safe_sqrt(p.top_radius * p.top_radius
                      - p.bottom_radius * p.bottom_radius)


def dist_to_top(p, r, mu):
    disc = r * r * (mu * mu - 1.0) + p.top_radius * p.top_radius
    return torch.clamp(-r * mu + _safe_sqrt(disc), min=0.0)


def dist_to_bottom(p, r, mu):
    disc = r * r * (mu * mu - 1.0) + p.bottom_radius * p.bottom_radius
    return torch.clamp(-r * mu - _safe_sqrt(disc), min=0.0)


def ray_hits_ground(p, r, mu):
    return (mu < 0.0) & (r * r * (mu * mu - 1.0)
                         + p.bottom_radius * p.bottom_radius >= 0.0)


def _uv_from_unit(x, size):
    return 0.5 / size + x * (1.0 - 1.0 / size)


def _unit_from_uv(u, size):
    return true_div(u - 0.5 / size, 1.0 - 1.0 / size)


def rayleigh_density(p, altitude):
    return torch.exp(p.rayleigh_exp_scale * altitude)


def mie_density(p, altitude):
    return torch.exp(p.mie_exp_scale * altitude)


def ozone_density(p, altitude):
    """Tent profile around 25 km (atmosphere.cpp:725-737)."""
    lower = true_div(altitude, 15000.0) - 2.0 / 3.0
    upper = true_div(-altitude, 15000.0) + 8.0 / 3.0
    return torch.clamp(torch.where(altitude < 25000.0, lower, upper),
                       0.0, 1.0)


def _trapezoid_weights(n, device):
    w = torch.ones(n + 1, dtype=torch.float32, device=device)
    w[0] = w[n] = 0.5
    return w


# ---------------------------------------------------------------------------
# Transmittance LUT
# ---------------------------------------------------------------------------

_N_TRANS_SAMPLES = 500  # atmosphere_kernels.cu:72


def _optical_length(p, density_fn, r, mu):
    """Trapezoid integral of a density profile to the top, (N,)."""
    n = _N_TRANS_SAMPLES
    dx = true_div(dist_to_top(p, r, mu), float(n))
    i = torch.arange(n + 1, dtype=torch.float32, device=r.device)
    d = i * dx[:, None]
    rr, mm = r[:, None], mu[:, None]
    r_i = _safe_sqrt(d * d + 2.0 * rr * mm * d + rr * rr)
    y = density_fn(p, r_i - p.bottom_radius)
    return (y * _trapezoid_weights(n, r.device)).sum(-1) * dx


def _transmittance_rmu_from_uv(p, u, v, dims: LutDims):
    x_mu = _unit_from_uv(u, dims.transmittance_w)
    x_r = _unit_from_uv(v, dims.transmittance_h)
    H = _horizon(p)
    rho = H * x_r
    r = _safe_sqrt(rho * rho + p.bottom_radius * p.bottom_radius)
    d_min = p.top_radius - r
    d_max = rho + H
    d = d_min + x_mu * (d_max - d_min)
    mu = torch.where(d == 0.0, 1.0,
                     (H * H - rho * rho - d * d) / (2.0 * r * d))
    return r, _clamp_cosine(mu)


def _transmittance_uv_from_rmu(p, r, mu, dims: LutDims):
    H = _horizon(p)
    rho = _safe_sqrt(r * r - p.bottom_radius * p.bottom_radius)
    d = dist_to_top(p, r, mu)
    d_min = p.top_radius - r
    d_max = rho + H
    x_mu = torch.where(d_max == d_min, 0.0, (d - d_min) / (d_max - d_min))
    x_r = rho / H
    return (_uv_from_unit(x_mu, dims.transmittance_w),
            _uv_from_unit(x_r, dims.transmittance_h))


def _centres(n, device):
    """(arange(n) + 0.5) / n, float32."""
    return true_div(torch.arange(n, dtype=torch.float32, device=device)
                    + 0.5, float(n))


def _grid2d(w, h, device):
    """u (fastest) and v of an (h, w) texel grid, flattened."""
    us, vs = _centres(w, device), _centres(h, device)
    return us.repeat(h), vs.repeat_interleave(w)


def compute_transmittance_lut(p, dims: LutDims):
    """ComputeTransmittanceToTopAtmosphereBoundaryTexture
    (atmosphere_kernels.cu:621-632), (TH, TW, 3)."""
    u, v = _grid2d(dims.transmittance_w, dims.transmittance_h,
                   p.top_radius.device)
    r, mu = _transmittance_rmu_from_uv(p, u, v, dims)
    tau = (p.rayleigh_scattering
           * _optical_length(p, rayleigh_density, r, mu)[:, None]
           + p.mie_extinction
           * _optical_length(p, mie_density, r, mu)[:, None]
           + p.absorption_extinction
           * _optical_length(p, ozone_density, r, mu)[:, None])
    return torch.exp(-tau).reshape(dims.transmittance_h,
                                   dims.transmittance_w, 3)


def _chunked(fn, args, samples_per_texel):
    """fn over the texels of ``args`` (tensors of one length), in chunks
    of at most CHUNK_SAMPLES texel-samples, concatenated."""
    step = max(1, CHUNK_SAMPLES // samples_per_texel)
    return torch.cat([fn(*(a[i:i + step] for a in args))
                      for i in range(0, args[0].shape[0], step)])


def _index(xf, n):
    """The integer index of a floored coordinate in [0, n - 1], clamped
    as the reference's gathers clamp an index out of range: a no-op for a
    finite coordinate, which is in range already; a NaN one (a lane whose
    value the caller discards, e.g. the volumetric integrator's sky
    estimate at the far point of a walk that left the grid) reads a
    texel instead of failing."""
    return torch.clamp(xf.long(), 0, n - 1)


def tex2d(tex, u, v):
    """Bilinear lookup with clamped edges (CUDA tex2D semantics)."""
    H, W = tex.shape[0], tex.shape[1]
    x = torch.clamp(u * W - 0.5, 0.0, W - 1.0)
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = _index(x0f, W), _index(y0f, H)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx) * (1 - fy)
            + (tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx) * fy)


def tex3d(tex, u, v, w):
    """Trilinear lookup; tex (D, H, W, C), coordinates normalized."""
    D, H, W = tex.shape[0], tex.shape[1], tex.shape[2]
    x = torch.clamp(u * W - 0.5, 0.0, W - 1.0)
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    z = torch.clamp(w * D - 0.5, 0.0, D - 1.0)
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    x0, y0, z0 = _index(x0f, W), _index(y0f, H), _index(z0f, D)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    fz = (z - z0f)[..., None]
    c00 = tex[z0, y0, x0] * (1 - fx) + tex[z0, y0, x1] * fx
    c01 = tex[z0, y1, x0] * (1 - fx) + tex[z0, y1, x1] * fx
    c10 = tex[z1, y0, x0] * (1 - fx) + tex[z1, y0, x1] * fx
    c11 = tex[z1, y1, x0] * (1 - fx) + tex[z1, y1, x1] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def transmittance_to_top(p, tex, r, mu, dims: LutDims):
    u, v = _transmittance_uv_from_rmu(p, r, mu, dims)
    return tex2d(tex, u, v)


def transmittance_between(p, tex, r, mu, d, hits_ground, dims: LutDims):
    """GetTransmittance: two LUT lookups on the branch of hits_ground."""
    r_d = _clamp_radius(p, _safe_sqrt(d * d + 2.0 * r * mu * d + r * r))
    mu_d = _clamp_cosine((r * mu + d) / r_d)
    t_up = (transmittance_to_top(p, tex, r, mu, dims)
            / torch.clamp(transmittance_to_top(p, tex, r_d, mu_d, dims),
                          min=1e-20))
    t_dn = (transmittance_to_top(p, tex, r_d, -mu_d, dims)
            / torch.clamp(transmittance_to_top(p, tex, r, -mu, dims),
                          min=1e-20))
    t = torch.where(hits_ground[..., None], t_dn, t_up)
    return torch.clamp(t, max=1.0)


def transmittance_to_sun(p, tex, r, mu_s, dims: LutDims):
    sin_h = p.bottom_radius / r
    cos_h = -_safe_sqrt(torch.clamp(1.0 - sin_h * sin_h, min=0.0))
    visible = torch.clamp(
        (mu_s - cos_h) / torch.clamp(p.sun_angular_radius, min=1e-6) * 0.5
        + 0.5, 0.0, 1.0)
    visible = visible * visible * (3.0 - 2.0 * visible)   # smoothstep
    return transmittance_to_top(p, tex, r, mu_s, dims) * visible[..., None]


# ---------------------------------------------------------------------------
# Scattering texture mapping (atmosphere_kernels.cu:254-363)
# ---------------------------------------------------------------------------

def _mu_s_a_max(p):
    """A of the mu_s mapping: the scaled distance to the top at mu_s_min."""
    d_s_min = p.top_radius - p.bottom_radius
    D_ = dist_to_top(p, p.bottom_radius, p.mu_s_min)
    return (D_ - d_s_min) / (_horizon(p) - d_s_min)


def _scattering_uvwz_from_rmumusnu(p, r, mu, mu_s, nu, hits_ground,
                                   dims: LutDims):
    H = _horizon(p)
    rho = _safe_sqrt(torch.clamp(r * r - p.bottom_radius * p.bottom_radius,
                                 min=0.0))
    u_r = _uv_from_unit(rho / H, dims.r)

    r_mu = r * mu
    disc = r_mu * r_mu - r * r + p.bottom_radius * p.bottom_radius
    d_g = -r_mu - _safe_sqrt(disc)
    d_g_min = r - p.bottom_radius
    d_g_max = rho
    u_mu_g = 0.5 - 0.5 * _uv_from_unit(
        torch.where(d_g_max == d_g_min, 0.0,
                    (d_g - d_g_min) / torch.clamp(d_g_max - d_g_min,
                                                  min=1e-20)),
        dims.mu // 2)
    d_t = -r_mu + _safe_sqrt(disc + H * H)
    d_t_min = p.top_radius - r
    d_t_max = rho + H
    u_mu_t = 0.5 + 0.5 * _uv_from_unit(
        (d_t - d_t_min) / torch.clamp(d_t_max - d_t_min, min=1e-20),
        dims.mu // 2)
    u_mu = torch.where(hits_ground, u_mu_g, u_mu_t)

    d_s = dist_to_top(p, p.bottom_radius, mu_s)
    d_s_min = p.top_radius - p.bottom_radius
    a = (d_s - d_s_min) / (H - d_s_min)
    A = _mu_s_a_max(p)
    u_mu_s = _uv_from_unit(torch.clamp(1.0 - a / A, min=0.0) / (1.0 + a),
                           dims.mu_s)
    u_nu = true_div(nu + 1.0, 2.0)
    return u_nu, u_mu_s, u_mu, u_r


def _rmumusnu_from_scattering_frag(p, fx, fy, fz, dims: LutDims):
    """The inverse mapping for the precompute
    (GetRMuMuSNuFromScatteringTextureCoord, atmosphere_kernels.cu:
    300-363): r, mu, mu_s, nu, ray_r_mu_intersects_ground."""
    frag_nu = torch.floor(true_div(fx, float(dims.mu_s)))
    frag_mu_s = fx - frag_nu * dims.mu_s
    u_nu = true_div(frag_nu, dims.nu - 1.0)
    u_mu_s = _unit_from_uv(true_div(frag_mu_s + 0.5, float(dims.mu_s)),
                           dims.mu_s)
    u_mu = true_div(fy + 0.5, float(dims.mu))
    u_r = _unit_from_uv(true_div(fz + 0.5, float(dims.r)), dims.r)

    H = _horizon(p)
    rho = H * u_r
    r = _safe_sqrt(rho * rho + p.bottom_radius * p.bottom_radius)

    below = u_mu < 0.5
    d_g_min = r - p.bottom_radius
    d_g_max = rho
    x_mu_g = _unit_from_uv(
        1.0 - true_div(2.0 * (fy + 0.5), float(dims.mu)), dims.mu // 2)
    d_g = d_g_min + (d_g_max - d_g_min) * x_mu_g
    mu_g = torch.where(d_g == 0.0, -1.0,
                       -(rho * rho + d_g * d_g) / (2.0 * r * d_g))
    x_mu_t = _unit_from_uv(
        true_div(2.0 * (fy + 0.5), float(dims.mu)) - 1.0, dims.mu // 2)
    d_t_min = p.top_radius - r
    d_t_max = rho + H
    d_t = d_t_min + (d_t_max - d_t_min) * x_mu_t
    mu_t = torch.where(d_t == 0.0, 1.0,
                       (H * H - rho * rho - d_t * d_t) / (2.0 * r * d_t))
    mu = _clamp_cosine(torch.where(below, mu_g, mu_t))

    d_s_min = p.top_radius - p.bottom_radius
    A = _mu_s_a_max(p)
    a = (A - u_mu_s * A) / torch.clamp(1.0 + u_mu_s * A, min=1e-20)
    d_s = d_s_min + torch.minimum(a, A) * (H - d_s_min)
    mu_s = torch.where(d_s == 0.0, 1.0,
                       (H * H - d_s * d_s) / (2.0 * p.bottom_radius * d_s))
    mu_s = _clamp_cosine(mu_s)
    nu = _clamp_cosine(u_nu * 2.0 - 1.0)
    # nu within the range the two directions allow
    root = _safe_sqrt((1.0 - mu * mu) * (1.0 - mu_s * mu_s))
    nu = torch.minimum(torch.maximum(nu, mu * mu_s - root), mu * mu_s + root)
    return r, mu, mu_s, nu, below


def _scattering_frags(dims: LutDims, device):
    """fz, fy, fx (float32) of every texel of the 4-D scattering texture,
    flattened in (r, mu, x) order."""
    n_z, n_y, n_x = dims.r, dims.mu, dims.scattering_w
    fz = torch.arange(n_z, dtype=torch.float32, device=device)
    fy = torch.arange(n_y, dtype=torch.float32, device=device)
    fx = torch.arange(n_x, dtype=torch.float32, device=device)
    return (fz.repeat_interleave(n_y * n_x),
            fy.repeat_interleave(n_x).repeat(n_z), fx.repeat(n_z * n_y))


def _scattering_texel_nu(p, dims: LutDims):
    """nu at every texel of the scattering texture, (r, mu, W)."""
    fz, fy, fx = _scattering_frags(dims, p.top_radius.device)
    nu = _rmumusnu_from_scattering_frag(p, fx, fy, fz, dims)[3]
    return nu.reshape(dims.r, dims.mu, dims.scattering_w)


def sample_scattering(p, tex, r, mu, mu_s, nu, hits_ground, dims: LutDims):
    """The 4-D lookup: two trilinear taps lerped over nu."""
    u_nu, u_mu_s, u_mu, u_r = _scattering_uvwz_from_rmumusnu(
        p, r, mu, mu_s, nu, hits_ground, dims)
    tex_x = u_nu * (dims.nu - 1.0)
    tex_x0 = torch.floor(tex_x)
    lerp = (tex_x - tex_x0)[..., None]
    u0 = true_div(tex_x0 + u_mu_s, float(dims.nu))
    u1 = true_div(tex_x0 + 1.0 + u_mu_s, float(dims.nu))
    return (tex3d(tex, u0, u_mu, u_r) * (1.0 - lerp)
            + tex3d(tex, u1, u_mu, u_r) * lerp)


def rayleigh_phase(nu):
    return 3.0 / (16.0 * math.pi) * (1.0 + nu * nu)


def mie_phase(g, nu):
    k = 3.0 / (8.0 * math.pi) * (1.0 - g * g) / (2.0 + g * g)
    return k * (1.0 + nu * nu) / torch.pow(
        torch.clamp(1.0 + g * g - 2.0 * g * nu, min=1e-12), 1.5)


# ---------------------------------------------------------------------------
# Single scattering
# ---------------------------------------------------------------------------

_N_SCAT_SAMPLES = 50


def _march_samples(p, r, mu, hg, n):
    """(dx, d) of an n-interval trapezoid march to the ground or the top:
    dx (N,), d (N, n + 1)."""
    dmax = torch.where(hg, dist_to_bottom(p, r, mu), dist_to_top(p, r, mu))
    dx = true_div(dmax, float(n))
    i = torch.arange(n + 1, dtype=torch.float32, device=r.device)
    return dx, i * dx[:, None]


def compute_single_scattering_lut(p, ttex, dims: LutDims):
    """(rayleigh, mie) single scattering, (R, MU, W, 3) each."""
    n = _N_SCAT_SAMPLES
    w = _trapezoid_weights(n, ttex.device)[:, None]

    fz, fy, fx = _scattering_frags(dims, ttex.device)
    r, mu, mu_s, nu, hg = _rmumusnu_from_scattering_frag(p, fx, fy, fz, dims)
    dx, d = _march_samples(p, r, mu, hg, n)
    rr, mm, ms, nn = (x[:, None] for x in (r, mu, mu_s, nu))
    hgb = hg[:, None].expand(d.shape)
    r_d = _clamp_radius(p, _safe_sqrt(d * d + 2.0 * rr * mm * d + rr * rr))
    mu_s_d = _clamp_cosine((rr * ms + d * nn) / r_d)
    trans = (transmittance_between(p, ttex, rr, mm, d, hgb, dims)
             * transmittance_to_sun(p, ttex, r_d, mu_s_d, dims))
    ray = trans * rayleigh_density(p, r_d - p.bottom_radius)[..., None]
    mie = trans * mie_density(p, r_d - p.bottom_radius)[..., None]
    ray = (ray * w).sum(1) * dx[:, None]
    mie = (mie * w).sum(1) * dx[:, None]
    shape = (dims.r, dims.mu, dims.scattering_w, 3)
    return ((ray * p.solar_irradiance * p.rayleigh_scattering).reshape(shape),
            (mie * p.solar_irradiance * p.mie_scattering).reshape(shape))


# ---------------------------------------------------------------------------
# Irradiance
# ---------------------------------------------------------------------------

def _irradiance_rmus_from_uv(p, u, v, dims: LutDims):
    x_mu_s = _unit_from_uv(u, dims.irradiance_w)
    x_r = _unit_from_uv(v, dims.irradiance_h)
    r = p.bottom_radius + x_r * (p.top_radius - p.bottom_radius)
    mu_s = _clamp_cosine(2.0 * x_mu_s - 1.0)
    return r, mu_s


def _irradiance_uv_from_rmus(p, r, mu_s, dims: LutDims):
    x_r = (r - p.bottom_radius) / (p.top_radius - p.bottom_radius)
    x_mu_s = mu_s * 0.5 + 0.5
    return (_uv_from_unit(x_mu_s, dims.irradiance_w),
            _uv_from_unit(x_r, dims.irradiance_h))


def compute_direct_irradiance_lut(p, ttex, dims: LutDims):
    u, v = _grid2d(dims.irradiance_w, dims.irradiance_h, ttex.device)
    r, mu_s = _irradiance_rmus_from_uv(p, u, v, dims)
    alpha_s = p.sun_angular_radius
    avg_cos = torch.where(
        mu_s < -alpha_s, 0.0,
        torch.where(mu_s > alpha_s, mu_s,
                    (mu_s + alpha_s) ** 2 / (4.0 * alpha_s)))
    out = (p.solar_irradiance * transmittance_to_top(p, ttex, r, mu_s, dims)
           * avg_cos[:, None])
    return out.reshape(dims.irradiance_h, dims.irradiance_w, 3)


def sample_irradiance(p, itex, r, mu_s, dims: LutDims):
    u, v = _irradiance_uv_from_rmus(p, r, mu_s, dims)
    return tex2d(itex, u, v)


# ---------------------------------------------------------------------------
# Multiple scattering (orders 2..n)
# ---------------------------------------------------------------------------

_SPHERE_SAMPLES_THETA = 16  # atmosphere_kernels.cu:432, dtheta = pi / 16
_SPHERE_SAMPLES_PHI = 8


def _sphere_dirs(n_t, n_p, dtheta, dphi, device):
    """cos/sin of theta and phi over an (n_t, 2 n_p) grid, flattened."""
    theta = (torch.arange(n_t, dtype=torch.float32, device=device)
             + 0.5) * dtheta
    phi = (torch.arange(2 * n_p, dtype=torch.float32, device=device)
           + 0.5) * dphi
    tg = theta.repeat_interleave(2 * n_p)
    pg = phi.repeat(n_t)
    return torch.cos(tg), torch.sin(tg), torch.cos(pg), torch.sin(pg)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _combined_scattering_for_density(p, ray_tex, mie_tex, multi_tex, r, mu,
                                     mu_s, nu, hits_ground, order, dims):
    """Radiance arriving at (r, omega) from the previous order."""
    if order == 2:
        ray = sample_scattering(p, ray_tex, r, mu, mu_s, nu, hits_ground,
                                dims)
        mie = sample_scattering(p, mie_tex, r, mu, mu_s, nu, hits_ground,
                                dims)
        return (ray * rayleigh_phase(nu)[..., None]
                + mie * mie_phase(p.mie_phase_g, nu)[..., None])
    return sample_scattering(p, multi_tex, r, mu, mu_s, nu, hits_ground,
                             dims)


def compute_scattering_density_lut(p, ttex, ray_tex, mie_tex, multi_tex,
                                   itex, order: int, dims: LutDims):
    """ComputeScatteringDensityTexture (atmosphere_kernels.cu:411-483,
    702-717): the in-scattered radiance J at each texel, the previous
    order integrated over the sphere with its ground bounce."""
    dev = ttex.device
    n_t, n_p = _SPHERE_SAMPLES_THETA, _SPHERE_SAMPLES_PHI
    dtheta, dphi = math.pi / n_t, math.pi / n_p
    cos_t, sin_t, cos_p, sin_p = _sphere_dirs(n_t, n_p, dtheta, dphi, dev)
    domega = (dtheta * dphi) * sin_t
    wi = (sin_t * cos_p, sin_t * sin_p, cos_t)
    n_dir = cos_t.shape[0]

    def texels(fz, fy, fx):
        r, mu, mu_s, nu, _ = _rmumusnu_from_scattering_frag(
            p, fx, fy, fz, dims)
        # local frame: zenith z, the view in the xz plane
        omega = (_safe_sqrt(1.0 - mu * mu), torch.zeros_like(mu), mu)
        sun_x = torch.where(omega[0] < 1e-5, 1.0,
                            (nu - mu * mu_s)
                            / torch.clamp(omega[0], min=1e-5))
        sun_x = _clamp_cosine(sun_x)
        sun_y = _safe_sqrt(torch.clamp(1.0 - sun_x ** 2 - mu_s ** 2,
                                       min=0.0))
        omega_s = (sun_x, sun_y, mu_s)
        rr = r[:, None].expand(-1, n_dir)
        ct = cos_t[None].expand(r.shape[0], -1)
        ms = mu_s[:, None].expand(-1, n_dir)
        hits_g = ray_hits_ground(p, rr, ct)
        nu1 = _clamp_cosine(_dot3([c[:, None] for c in omega_s], wi))
        li = _combined_scattering_for_density(
            p, ray_tex, mie_tex, multi_tex, rr, ct, ms, nu1, hits_g, order,
            dims)
        # the ground bounce: the irradiance at the sun cosine of the
        # ground point, (r mu_s + d nu1) / bottom_radius
        d_g = dist_to_bottom(p, rr, ct)
        trans_g = transmittance_between(p, ttex, rr, ct, d_g, hits_g, dims)
        mu_s_g = _clamp_cosine((rr * ms + d_g * nu1) / p.bottom_radius)
        irr_g = sample_irradiance(
            p, itex, p.bottom_radius.expand(mu_s_g.shape), mu_s_g, dims)
        li = li + torch.where(hits_g[..., None],
                              trans_g * true_div(p.ground_albedo, math.pi) * irr_g,
                              0.0)
        nu2 = _clamp_cosine(_dot3([c[:, None] for c in omega], wi))
        dens_r = rayleigh_density(p, r - p.bottom_radius)[:, None]
        dens_m = mie_density(p, r - p.bottom_radius)[:, None]
        contrib = li * (
            p.rayleigh_scattering * (dens_r * rayleigh_phase(nu2))[..., None]
            + p.mie_scattering
            * (dens_m * mie_phase(p.mie_phase_g, nu2))[..., None])
        return (contrib * domega[:, None]).sum(1)

    out = _chunked(texels, _scattering_frags(dims, dev), n_dir)
    return out.reshape(dims.r, dims.mu, dims.scattering_w, 3)


def compute_indirect_irradiance_lut(p, ray_tex, mie_tex, multi_tex,
                                    order: int, dims: LutDims):
    """ComputeIndirectIrradianceTexture (atmosphere_kernels.cu:548-570)."""
    dev = ray_tex.device
    n_t, n_p = _SPHERE_SAMPLES_THETA // 2, _SPHERE_SAMPLES_PHI
    dtheta, dphi = math.pi / (2.0 * n_t), math.pi / n_p
    cos_t, sin_t, cos_p, sin_p = _sphere_dirs(n_t, n_p, dtheta, dphi, dev)
    domega = (dtheta * dphi) * sin_t * cos_t   # cosine-weighted
    wi = (sin_t * cos_p, sin_t * sin_p, cos_t)
    u, v = _grid2d(dims.irradiance_w, dims.irradiance_h, dev)
    r, mu_s = _irradiance_rmus_from_uv(p, u, v, dims)
    omega_s = (_safe_sqrt(1.0 - mu_s * mu_s), torch.zeros_like(mu_s), mu_s)
    nu = _dot3([c[:, None] for c in omega_s], wi)
    n, n_dir = r.shape[0], cos_t.shape[0]
    hg = torch.zeros((n, n_dir), dtype=torch.bool, device=dev)
    li = _combined_scattering_for_density(
        p, ray_tex, mie_tex, multi_tex, r[:, None].expand(-1, n_dir),
        cos_t[None].expand(n, -1), mu_s[:, None].expand(-1, n_dir), nu, hg,
        order + 1, dims)
    out = (li * domega[:, None]).sum(1)
    return out.reshape(dims.irradiance_h, dims.irradiance_w, 3)


def compute_multiple_scattering_lut(p, ttex, density_tex, dims: LutDims):
    """ComputeMultipleScatteringTexture (atmosphere_kernels.cu:485-516):
    the scattering density J integrated along the ray."""
    n = 50
    w = _trapezoid_weights(n, ttex.device)[:, None]

    fz, fy, fx = _scattering_frags(dims, ttex.device)
    r, mu, mu_s, nu, hg = _rmumusnu_from_scattering_frag(p, fx, fy, fz, dims)
    dx, d = _march_samples(p, r, mu, hg, n)
    rr, mm, ms, nn = (x[:, None] for x in (r, mu, mu_s, nu))
    hgb = hg[:, None].expand(d.shape)
    r_d = _clamp_radius(p, _safe_sqrt(d * d + 2.0 * rr * mm * d + rr * rr))
    mu_d = _clamp_cosine((rr * mm + d) / r_d)
    mu_s_d = _clamp_cosine((rr * ms + d * nn) / r_d)
    ji = sample_scattering(p, density_tex, r_d, mu_d, mu_s_d,
                           nn.expand(d.shape), hgb, dims)
    trans = transmittance_between(p, ttex, rr, mm, d, hgb, dims)
    out = (ji * trans * w).sum(1) * dx[:, None]
    return out.reshape(dims.r, dims.mu, dims.scattering_w, 3)


# ---------------------------------------------------------------------------
# The precompute (atmosphere.cpp precompute(), :888-1114)
# ---------------------------------------------------------------------------

def precompute(params: AtmosphereParams, dims: LutDims = LutDims(),
               num_scattering_orders: int = 4,
               timings: dict | None = None) -> AtmosphereLUTs:
    """The four LUTs on the params' device.  ``timings``, where given,
    receives each stage's seconds (the device synchronized after each)."""
    import time
    dev = params.top_radius.device
    t = [time.perf_counter()]

    def mark(name):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[name] = timings.get(name, 0.0) + now - t[0]
            t[0] = now

    ttex = compute_transmittance_lut(params, dims)
    mark("transmittance")
    direct_irr = compute_direct_irradiance_lut(params, ttex, dims)
    ray_tex, mie_tex = compute_single_scattering_lut(params, ttex, dims)
    mark("single")
    # the output irradiance holds the indirect orders only (Bruneton);
    # the direct irradiance feeds order 2's ground bounce
    scattering_acc = ray_tex
    irradiance_acc = torch.zeros_like(direct_irr)
    irr_prev = direct_irr
    multi_tex = torch.zeros_like(ray_tex)
    # orders >= 2 are stored divided by the Rayleigh phase at the
    # texel's nu (atmosphere_kernels.cu:696); multi_tex stays raw for
    # the next order
    inv_ray_phase = 1.0 / rayleigh_phase(
        _scattering_texel_nu(params, dims))[..., None]
    for order in range(2, num_scattering_orders + 1):
        density = compute_scattering_density_lut(
            params, ttex, ray_tex, mie_tex, multi_tex, irr_prev, order, dims)
        mark("density")
        indirect = compute_indirect_irradiance_lut(
            params, ray_tex, mie_tex, multi_tex, order - 1, dims)
        multi_tex = compute_multiple_scattering_lut(params, ttex, density,
                                                    dims)
        del density
        scattering_acc = scattering_acc + multi_tex * inv_ray_phase
        irradiance_acc = irradiance_acc + indirect
        irr_prev = indirect
        mark("multiple")
    return AtmosphereLUTs(transmittance=ttex, scattering=scattering_acc,
                          single_mie=mie_tex, irradiance=irradiance_acc)


def precompute_luminance(dims: LutDims = LutDims(),
                         num_scattering_orders: int = 4,
                         num_wavelengths: int = 15, use_ozone=True,
                         use_constant_solar=False,
                         device=DEFAULT_DEVICE) -> AtmosphereLUTs:
    """The PRECOMPUTED-luminance pipeline (atmosphere.cpp:828-872,
    1230-1275): the precompute in 3-wavelength batches over [360, 830]
    nm, each batch's textures blended through its 3x3
    luminance_from_radiance matrix (rows the sRGB responses of the batch
    wavelengths times dlambda) and summed; the textures hold illuminance
    / 683.  The transmittance is recomputed at the RGB wavelengths at
    the end (atmosphere.cpp:866-871)."""
    n_iter = (num_wavelengths + 2) // 3
    dlambda = (LAMBDA_MAX - LAMBDA_MIN) / (3.0 * n_iter)
    acc = None
    for i in range(n_iter):
        lams = np.array([LAMBDA_MIN + (3 * i + 0.5) * dlambda,
                         LAMBDA_MIN + (3 * i + 1.5) * dlambda,
                         LAMBDA_MIN + (3 * i + 2.5) * dlambda])
        # rows: sRGB component, columns: batch wavelength
        lfr = torch.tensor(srgb_coeff(lams).T * dlambda, dtype=torch.float32,
                           device=device)
        p_i = model_at_lambdas(lams, use_ozone=use_ozone,
                               use_constant_solar=use_constant_solar,
                               device=device)
        luts_i = precompute(p_i, dims=dims,
                            num_scattering_orders=num_scattering_orders)

        def blend(tex):
            return torch.stack([tex[..., 0] * lfr[r, 0]
                                + tex[..., 1] * lfr[r, 1]
                                + tex[..., 2] * lfr[r, 2]
                                for r in range(3)], dim=-1)

        batch = (blend(luts_i.scattering), blend(luts_i.single_mie),
                 blend(luts_i.irradiance))
        acc = batch if acc is None else tuple(a + b
                                              for a, b in zip(acc, batch))
    rgb = default_model(use_ozone=use_ozone,
                        use_constant_solar=use_constant_solar, device=device)
    return AtmosphereLUTs(transmittance=compute_transmittance_lut(rgb, dims),
                          scattering=acc[0], single_mie=acc[1],
                          irradiance=acc[2])


# ---------------------------------------------------------------------------
# Runtime lookups (render_kernel.cu:369-895)
# ---------------------------------------------------------------------------

def _combined_scattering(p, luts, r, mu, mu_s, nu, hits_ground, dims):
    return (sample_scattering(p, luts.scattering, r, mu, mu_s, nu,
                              hits_ground, dims),
            sample_scattering(p, luts.single_mie, r, mu, mu_s, nu,
                              hits_ground, dims))


def _enter_atmosphere(p, camera, view_ray):
    """(camera, r, rmu, d_top, in_space): a camera in space moved to the
    top of the atmosphere along the view ray where the ray meets it."""
    r = _length(camera)
    rmu = dot(camera, view_ray)
    d_top = -rmu - _safe_sqrt(rmu * rmu - r * r
                              + p.top_radius * p.top_radius)
    in_space = (r > p.top_radius) & (d_top > 0.0)
    camera = torch.where(in_space[..., None],
                         camera + view_ray * d_top[..., None], camera)
    r = torch.where(in_space, p.top_radius, r)
    rmu = torch.where(in_space, rmu + d_top, rmu)
    return camera, r, rmu, d_top, in_space


def get_sky_radiance(p, luts, camera, view_ray, sun_direction,
                     dims: LutDims = LutDims()):
    """GetSkyRadiance (render_kernel.cu:694-747): the sky's radiance seen
    from ``camera`` (earth-centred) along view_ray, and the
    transmittance for the sun disc: 0 on a ground hit, 1 for a ray from
    space that misses the atmosphere (the disc survives,
    render_kernel.cu:712-714)."""
    camera, r, rmu, _, _ = _enter_atmosphere(p, camera, view_ray)
    outside = r > p.top_radius
    mu = rmu / torch.clamp(r, min=1e-6)
    mu_s = dot(camera, sun_direction) / torch.clamp(r, min=1e-6)
    nu = dot(view_ray, sun_direction)
    hits_ground = ray_hits_ground(p, r, mu)
    trans = torch.where(
        hits_ground[..., None], 0.0,
        torch.where(outside[..., None], 1.0,
                    transmittance_to_top(p, luts.transmittance, r, mu,
                                         dims)))
    scat, mie = _combined_scattering(p, luts, r, mu, mu_s, nu, hits_ground,
                                     dims)
    radiance = (scat * rayleigh_phase(nu)[..., None]
                + mie * mie_phase(p.mie_phase_g, nu)[..., None])
    radiance = torch.where(outside[..., None], 0.0, radiance)
    return radiance, trans


def get_sky_radiance_to_point(p, luts, camera, point, sun_direction,
                              dims: LutDims = LutDims()):
    """GetSkyRadianceToPoint (render_kernel.cu:749-810): the aerial
    perspective between the camera and a point."""
    view_ray = point - camera
    d = _length(view_ray)
    view_ray = view_ray / torch.clamp(d[..., None], min=1e-9)
    camera, r, rmu, d_top, in_space = _enter_atmosphere(p, camera, view_ray)
    d = torch.where(in_space, d - d_top, d)
    mu = rmu / torch.clamp(r, min=1e-6)
    mu_s = dot(camera, sun_direction) / torch.clamp(r, min=1e-6)
    nu = dot(view_ray, sun_direction)
    hits_ground = ray_hits_ground(p, r, mu)
    trans = transmittance_between(p, luts.transmittance, r, mu, d,
                                  hits_ground, dims)
    scat, mie = _combined_scattering(p, luts, r, mu, mu_s, nu, hits_ground,
                                     dims)
    r_p = _clamp_radius(p, _safe_sqrt(d * d + 2.0 * r * mu * d + r * r))
    mu_p = (r * mu + d) / r_p
    mu_s_p = (r * mu_s + d * nu) / r_p
    scat_p, mie_p = _combined_scattering(p, luts, r_p, mu_p, mu_s_p, nu,
                                         hits_ground, dims)
    scat = scat - trans * scat_p
    mie = mie - trans * mie_p
    radiance = (torch.clamp(scat, min=0.0) * rayleigh_phase(nu)[..., None]
                + torch.clamp(mie, min=0.0)
                * mie_phase(p.mie_phase_g, nu)[..., None])
    return radiance, trans


def get_sun_and_sky_irradiance(p, luts, point, normal, sun_direction,
                               dims: LutDims = LutDims()):
    """GetSunAndSkyIrradiance (render_kernel.cu:812-828): (sun, sky)."""
    r = _length(point)
    mu_s = dot(point, sun_direction) / torch.clamp(r, min=1e-6)
    sky = (sample_irradiance(p, luts.irradiance, r, mu_s, dims)
           * (1.0 + dot(point, normal)[..., None]
              / torch.clamp(r, min=1e-6)[..., None]) * 0.5)
    sun = (p.solar_irradiance
           * transmittance_to_sun(p, luts.transmittance, r, mu_s, dims)
           * torch.clamp(dot(normal, sun_direction), min=0.0)[..., None])
    return sun, sky


def get_solar_radiance(p):
    """GetSolarRadiance (render_kernel.cu:830-835)."""
    return p.solar_irradiance / (math.pi * p.sun_angular_radius ** 2)


# ---------------------------------------------------------------------------
# The LUT cache (the reference caches EXRs, atmosphere.cpp:247-456)
# ---------------------------------------------------------------------------

def save_luts(path: str, luts: AtmosphereLUTs):
    np.savez_compressed(
        path, **{f.name: getattr(luts, f.name).cpu().numpy()
                 for f in dataclasses.fields(luts)})


def load_luts(path: str, device=DEFAULT_DEVICE) -> AtmosphereLUTs:
    z = np.load(path)
    return AtmosphereLUTs(**{
        f.name: torch.as_tensor(np.asarray(z[f.name], np.float32),
                                device=device)
        for f in dataclasses.fields(AtmosphereLUTs)})
