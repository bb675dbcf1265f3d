"""The atmosphere at render time (port of vpt_tpu/sky/runtime.py; the
device-side ``sample_atmosphere`` of render_kernel.cu:839-895): the sky
and the ground from the Bruneton LUTs, the sun disc, and the reference's
exposure / white-point curve; the equirect sky cache; the planet seen
from orbit.

``sample_atmosphere`` and ``sample_sky_cache`` are the plain versions of
kernel K4's ATMOSPHERE and SKY_CACHE kinds (csrc/environment.cu), which
repeat their arithmetic operation for operation.  The plain versions
evaluate the ground and the sky for every ray and pick one, as the
reference does; the kernel evaluates only the branch a ray takes.  The
sun direction and cos(sun angular radius) are computed on the CPU, so
that every device uses the same float32 values.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from dataclasses import dataclass

import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.core.vecmath import (degree_to_cartesian, dot,
                                        normalize, true_div, true_sqrt)
from vpt_tpu_torch.sky import bruneton as br

LUMINANCE_MODES = {"none": 0, "approximate": 1, "precomputed": 2}


@dataclass(frozen=True)
class K4Luts:
    """The LUTs in the layout of kernel K4's ATMOSPHERE kind
    (csrc/environment.cu), every texel a whole number of 16-byte words:
    the transmittance (TH, TW, 4) and the irradiance (IH, IW, 4), rgb and
    a zero; the scattering and the single Mie interleaved, (R, MU, NU *
    MU_S, 8): scattering rgb, 0, single Mie rgb, 0, so that one 4-D tap
    of both is one 32-byte sector.  Contiguous; each value the (..., 3)
    LUT's bit for bit."""

    transmittance: torch.Tensor
    scattering_mie: torch.Tensor
    irradiance: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel() * 4
                   for f in dataclasses.fields(self))


def pack_k4_luts(luts: br.AtmosphereLUTs) -> K4Luts:
    """The (..., 3) LUTs in K4's layout, on their device."""
    def rgb0(t):
        return torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
    return K4Luts(
        transmittance=rgb0(luts.transmittance).contiguous(),
        scattering_mie=torch.cat([rgb0(luts.scattering),
                                  rgb0(luts.single_mie)],
                                 dim=-1).contiguous(),
        irradiance=rgb0(luts.irradiance).contiguous())


@dataclass(frozen=True)
class Atmosphere:
    """A scene's atmosphere: the model, its LUTs and their dims."""

    params: br.AtmosphereParams
    luts: br.AtmosphereLUTs
    dims: br.LutDims = dataclasses.field(default_factory=br.LutDims)

    def to(self, device) -> "Atmosphere":
        """This atmosphere on ``device``: itself where its tensors are
        there already (so its packed LUTs are kept), else a copy."""
        moved = Atmosphere(self.params.to(device), self.luts.to(device),
                           self.dims)
        same = all(getattr(moved.luts, f.name) is getattr(self.luts, f.name)
                   for f in dataclasses.fields(self.luts)) and \
            moved.params.top_radius is self.params.top_radius
        return self if same else moved

    @functools.cached_property
    def k4_luts(self) -> K4Luts:
        """The LUTs in K4's layout (pack_k4_luts), packed at first use and
        kept: once per atmosphere, for every launch of the live kind."""
        return pack_k4_luts(self.luts)


def check_luts(luts: br.AtmosphereLUTs, dims: br.LutDims):
    """Raise ValueError when a LUT's shape is not the one ``dims`` gives
    (a cache file made at other dims would be read at the wrong
    texels)."""
    for name, shape in dims.shapes().items():
        got = tuple(getattr(luts, name).shape)
        if got != shape:
            raise ValueError(f"atmosphere LUT {name}: shape {got}, the "
                             f"dims {dims} give {shape}")


def make_atmosphere(dims: br.LutDims = br.LutDims(), cache_path=None,
                    use_ozone=True, use_constant_solar=False,
                    exposure=10.0, luminance_mode: str = "none",
                    do_white_balance: bool = False,
                    num_wavelengths: int = 15, device=DEFAULT_DEVICE,
                    timings: dict | None = None) -> Atmosphere:
    """Precompute the LUTs on ``device``, or load them from the npz cache
    (atmosphere::init(), atmosphere.cpp:1177-1291).  luminance_mode:
    "none", "approximate" (radiance LUTs, the spectral k constants at
    run time) or "precomputed" (``num_wavelengths`` wavelengths in
    3-wavelength batches).  ``timings`` receives the precompute's stage
    seconds (bruneton.precompute)."""
    use_lum = LUMINANCE_MODES[luminance_mode]
    params = br.default_model(use_ozone=use_ozone,
                              use_constant_solar=use_constant_solar,
                              exposure=exposure, use_luminance=use_lum,
                              do_white_balance=do_white_balance,
                              device=device)
    if cache_path and os.path.exists(cache_path):
        luts = br.load_luts(cache_path, device=device)
    else:
        if use_lum == 2:
            luts = br.precompute_luminance(
                dims=dims, num_wavelengths=num_wavelengths,
                use_ozone=use_ozone, use_constant_solar=use_constant_solar,
                device=device)
        else:
            luts = br.precompute(params, dims=dims, timings=timings)
        if cache_path:
            br.save_luts(cache_path, luts)
    check_luts(luts, dims)
    return Atmosphere(params=params, luts=luts, dims=dims)


def sun_direction(azimuth, elevation, device):
    return degree_to_cartesian(azimuth, elevation, "cpu").to(device)


def cos_sun_radius(p: br.AtmosphereParams):
    """cos(sun angular radius), computed on the CPU."""
    return torch.cos(p.sun_angular_radius.cpu()).to(
        p.sun_angular_radius.device)


def earth_center(p: br.AtmosphereParams):
    return (torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                         device=p.earth_center_y.device) * p.earth_center_y)


def luminance_factors(p: br.AtmosphereParams):
    """(sky_k, sun_k): the radiance-to-luminance constants, ones in NONE
    mode (render_kernel.cu:745, 821-833)."""
    if p.use_luminance != 0:
        return p.sky_spectral_to_rgb, p.sun_spectral_to_rgb
    one = torch.ones(3, dtype=torch.float32, device=p.exposure.device)
    return one, one


def curve_exposure(p: br.AtmosphereParams):
    """The exposure of the curve: exposure, or exposure * 1e-5 in the
    luminance modes."""
    return p.exposure if p.use_luminance == 0 else p.exposure * 1e-5


def ground_hit(p: br.AtmosphereParams, ray_pos, ray_dir):
    """The ground hit of sample_atmosphere (render_kernel.cu:847-860):
    (camera, the position relative to the planet's centre; view, the
    unit direction; dist, the distance to the ground sphere; hits_ground,
    the rays that take the ground branch).  K4's ATMOSPHERE kind makes
    the same decision (environment.cu::ray_head)."""
    camera = ray_pos - earth_center(p)
    view = normalize(ray_dir)
    p_dot_v = dot(camera, view)
    p_dot_p = dot(camera, camera)
    disc = p.bottom_radius * p.bottom_radius - (p_dot_p - p_dot_v * p_dot_v)
    dist = -p_dot_v - true_sqrt(torch.clamp(disc, min=0.0))
    return camera, view, dist, (dist > 0.0) & (disc >= 0.0)


def _sample_atmosphere_pre(atm: Atmosphere, ray_pos, ray_dir, azimuth,
                           elevation, dims: br.LutDims):
    """render_kernel.cu:839-877 without the sun disc and the curve:
    (radiance before the curve, transmittance to space), the part a sky
    cache bakes."""
    p, luts = atm.params, atm.luts
    sun = sun_direction(azimuth, elevation, ray_pos.device)
    camera, view, dist, hits_ground = ground_hit(p, ray_pos, ray_dir)
    sky_k, sun_k = luminance_factors(p)

    gp = camera + view * dist[..., None]
    normal = normalize(gp)
    sun_irr, sky_irr = br.get_sun_and_sky_irradiance(p, luts, gp, normal,
                                                     sun, dims)
    ground = (true_div(p.ground_albedo, math.pi)
              * (sun_irr * sun_k + sky_irr * sky_k))
    in_scatter, trans_g = br.get_sky_radiance_to_point(p, luts, camera, gp,
                                                       sun, dims)
    ground = ground * trans_g + in_scatter * sky_k

    radiance, trans = br.get_sky_radiance(p, luts, camera, view, sun, dims)
    radiance = radiance * sky_k
    hg = hits_ground[..., None]
    return (torch.where(hg, ground, radiance),
            torch.where(hg, torch.zeros_like(trans), trans))


def _compose_sun_disc(p, pre, trans, view, sun):
    """The analytic sun disc and the exposure / white-point curve
    (render_kernel.cu:862-886)."""
    _, sun_k = luminance_factors(p)
    disc = (dot(view, sun) > cos_sun_radius(p))[..., None]
    out = pre + torch.where(disc, trans * br.get_solar_radiance(p) * sun_k,
                            0.0)
    return torch.pow(
        torch.clamp(1.0 - torch.exp(-out / p.white_point
                                    * curve_exposure(p)), min=0.0),
        1.0 / 2.2)


def sample_atmosphere(atm: Atmosphere, ray_pos, ray_dir, azimuth,
                      elevation, dims: br.LutDims):
    """render_kernel.cu:839-895: the ground or the sky, the sun disc, the
    curve (the reference bakes its tonemap into the environment)."""
    pre, trans = _sample_atmosphere_pre(atm, ray_pos, ray_dir, azimuth,
                                        elevation, dims)
    return _compose_sun_disc(atm.params, pre, trans, normalize(ray_dir),
                             sun_direction(azimuth, elevation,
                                           ray_dir.device))


def cache_directions(height: int, width: int, device):
    """The equirect texel centres' directions, (height * width, 3): theta
    from +y down the rows, phi from +x toward +z along the columns."""
    th = true_div(torch.arange(height, dtype=torch.float32, device=device)
                  + 0.5, float(height)) * math.pi
    ph = true_div(torch.arange(width, dtype=torch.float32, device=device)
                  + 0.5, float(width)) * (2.0 * math.pi)
    tg = th.repeat_interleave(width)
    pg = ph.repeat(height)
    st = torch.sin(tg)
    return torch.stack([st * torch.cos(pg), torch.cos(tg),
                        st * torch.sin(pg)], dim=-1)


def bake_sky_cache(atm: Atmosphere, anchor_pos, azimuth, elevation,
                   height: int = 256, width: int = 512):
    """The sky seen from ``anchor_pos`` baked into an (H, W, 6) equirect
    texture [radiance before the curve | transmittance] on the
    atmosphere's device.  The reference stores each texel's four
    bilinear corners in one (H, W, 24) row; this texture is their first
    six channels, and the lookup reads the four taps.  Valid near the
    anchor and for this sun only."""
    dev = atm.params.top_radius.device
    dirs = cache_directions(height, width, dev)
    pos = torch.as_tensor(anchor_pos, dtype=torch.float32,
                          device=dev).reshape(1, 3).expand(dirs.shape)
    pre, trans = _sample_atmosphere_pre(atm, pos, dirs, azimuth, elevation,
                                        atm.dims)
    return torch.cat([pre, trans], dim=-1).reshape(height, width, 6)


def sample_sky_cache(p, cache, ray_dir, azimuth, elevation):
    """The baked cache's bilinear lookup, the sun disc and the curve."""
    view = normalize(ray_dir)
    h, w = cache.shape[0], cache.shape[1]
    theta = torch.acos(torch.clamp(view[..., 1], -1.0, 1.0))
    phi = torch.remainder(torch.atan2(view[..., 2], view[..., 0]),
                          2.0 * math.pi)
    y = torch.clamp(true_div(theta, math.pi) * h - 0.5, 0.0, h - 1.0)
    x = true_div(phi, 2.0 * math.pi) * w - 0.5
    y0f, x0f = torch.floor(y), torch.floor(x)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    y0 = y0f.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x0 = torch.remainder(x0f.long(), w)     # x wraps, y clamps
    x1 = torch.remainder(x0 + 1, w)
    v = ((cache[y0, x0] * (1 - fx) + cache[y0, x1] * fx) * (1 - fy)
         + (cache[y1, x0] * (1 - fx) + cache[y1, x1] * fx) * fy)
    return _compose_sun_disc(p, v[..., 0:3], v[..., 3:6], view,
                             sun_direction(azimuth, elevation,
                                           ray_dir.device))


def earth_rays(p: br.AtmosphereParams, width: int, height: int,
               altitude_factor: float = 2.5, vfov_deg: float = 50.0):
    """render_earth's camera rays, (H * W, 3) positions and unit
    directions: a camera altitude_factor top radii from the planet's
    centre on its +z axis, looking at the centre."""
    dev = p.top_radius.device
    cam_r = p.top_radius * altitude_factor
    cam_pos = earth_center(p) + torch.stack(
        [torch.zeros_like(cam_r), torch.zeros_like(cam_r), cam_r])
    half = torch.tan(torch.deg2rad(torch.tensor(vfov_deg,
                                                dtype=torch.float32)) * 0.5)
    half = half.to(dev)
    ys = (0.5 - true_div(torch.arange(height, dtype=torch.float32,
                                      device=dev) + 0.5, float(height))
          ) * 2.0 * half
    xs = (true_div(torch.arange(width, dtype=torch.float32, device=dev)
                   + 0.5, float(width)) - 0.5) * 2.0 * half \
        * (width / height)
    xg = xs.repeat(height)
    yg = ys.repeat_interleave(width)
    dirs = normalize(torch.stack([xg, yg, -torch.ones_like(xg)], dim=-1))
    return cam_pos.reshape(1, 3).expand(dirs.shape).contiguous(), dirs


def render_earth(atm: Atmosphere, width: int = 512, height: int = 512,
                 azimuth: float = 150.0, elevation: float = 30.0,
                 altitude_factor: float = 2.5, vfov_deg: float = 50.0):
    """The planet from orbit (render_kernel.cu:2138-2180): each pixel of
    an (H, W, 3) image in [0, 1] evaluates the whole model, ground,
    limb, sky and sun disc, with the curve.  On a CUDA atmosphere K4's
    ATMOSPHERE kind evaluates it on L = 0 and beta = 1
    (render/integrator.py::add_atmosphere), which gives x exactly."""
    pos, dirs = earth_rays(atm.params, width, height, altitude_factor,
                           vfov_deg)
    if pos.device.type == "cuda":
        from vpt_tpu_torch.render.integrator import atmosphere_on_rays
        img = atmosphere_on_rays(atm, pos, dirs, azimuth, elevation)
    else:
        img = sample_atmosphere(atm, pos, dirs, azimuth, elevation,
                                atm.dims)
    return img.reshape(height, width, 3)


def sample_atmosphere_scene(scene, params, ray_pos, ray_dir):
    """The scene's atmosphere toward ray_dir from ray_pos: the baked
    cache where the scene has one, else the live model."""
    atm = scene.atmosphere
    if scene.sky_cache is not None:
        return sample_sky_cache(atm.params, scene.sky_cache, ray_dir,
                                params.azimuth, params.elevation)
    return sample_atmosphere(atm, ray_pos, ray_dir, params.azimuth,
                             params.elevation, atm.dims)
