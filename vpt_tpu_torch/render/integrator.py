"""The reference engine's direct integrator (port of
vpt_tpu/render/integrator.py), the terminal environment lookup
(``environment_radiance``, :26-45) and kernel K4, which adds it to each
finished ray's radiance on the card.

``direct_integrator`` traces one tile of rays with the reference's
nested lane-masked loops (render_kernel.cu:1760-1857; QUIRKS #5, #6,
#19): a bounce loop to ray_depth, at each bounce the closest object, up
to volume_depth delta-tracking walks through the volume, the next-event
estimates at a medium event, the object check after it and the sphere's
shading.  On CPU tensors it runs ``direct_integrator_plain``, that loop
in torch; on CUDA tensors kernel K5's ``walk_direct`` (render/walk.py,
csrc/walk.cu), one thread a ray, and K4 after it.

``environment_radiance`` is K4's plain version.  ``add_environment``
computes L + environment_radiance(pos, dir) * beta: on CPU tensors with
the plain version, on CUDA tensors with K4 (csrc/environment.cu), in
place on L.  K4 takes the environments that depend on the direction,
each a kind of its own: HDRI with a map, the simple sky (ATMOSPHERE
without an atmosphere), the live Bruneton atmosphere (ATMOSPHERE with
one; it also reads the ray's retired position, which K1 and K5 then
write) and its baked sky cache.  K1 and K5 add BLACK and CONSTANT
themselves, so those launch no K4.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.phase import isotropic, phase_sample
from vpt_tpu_torch.core.vecmath import (EPS, aabb_intersect, cross,
                                        degree_to_cartesian, dot, length,
                                        normalize, reflect, true_div)
from vpt_tpu_torch.ops import cuda
from vpt_tpu_torch.render.nee import (environment_light_radiance,
                                      estimate_point_lights, estimate_sun)
from vpt_tpu_torch.render.params import Environment
from vpt_tpu_torch.render.tracking import (_sphere_block, delta_track,
                                           estimate_emission, transmittance,
                                           vec3_param)

ENVIRONMENT = cuda.Kernel(
    name="environment", route="cuda",
    source="vpt_tpu_torch/csrc/environment.cu",
    replaces="vpt_tpu/render/integrator.py:26")
# K4's atmosphere kinds, each counted on its own
ENVIRONMENT_ATMOSPHERE = cuda.Kernel(
    name="environment_atmosphere", route="cuda",
    source="vpt_tpu_torch/csrc/environment.cu",
    replaces="vpt_tpu/sky/runtime.py:161")
ENVIRONMENT_SKY_CACHE = cuda.Kernel(
    name="environment_sky_cache", route="cuda",
    source="vpt_tpu_torch/csrc/environment.cu",
    replaces="vpt_tpu/sky/runtime.py:203")
ENV_SKY, ENV_HDRI, ENV_ATMOSPHERE, ENV_SKY_CACHE = 0, 1, 2, 3


def environment_radiance(scene, params, pos, wi):
    """Radiance arriving along ``wi`` from the environment
    (render_kernel.cu:1838-1850): ATMOSPHERE -> the simple sky
    * sky_color * sky_mult (sky_color applied twice, as in the
    reference); HDRI -> the map * sky_color * isotropic() (QUIRKS #8), 0
    without a map; BLACK -> 0; CONSTANT -> sky_color * sky_mult."""
    et = params.environment_type
    if et == int(Environment.BLACK):
        return torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                           device=pos.device)
    if et == int(Environment.CONSTANT):
        sky = vec3_param(params.sky_color, pos.device) * params.sky_mult
        return sky.expand(pos.shape[:-1] + (3,))
    if et == int(Environment.HDRI):
        if scene.env_map is None:
            return torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                               device=pos.device)
        from vpt_tpu_torch.sky.envmap import sample_env_map
        return (sample_env_map(scene.env_map, wi)
                * vec3_param(params.sky_color, wi.device) * isotropic())
    li = environment_light_radiance(scene, params, pos, wi)
    return li * vec3_param(params.sky_color, wi.device) * params.sky_mult


def _closest_object(scene, pos, direction):
    """get_closest_object (render_kernel.cu:1118-1135): (obj, t_min), obj
    0 none, 1 the volume's root box, 2 the sphere, with the AABB's tmin <
    0 -> tmax quirk (vpt_tpu/render/integrator.py:49-59)."""
    hit1, t1, _ = aabb_intersect(scene.root_pmin, scene.root_pmax, pos,
                                 direction)
    hit2, t2 = _sphere_block(scene, pos, direction)
    obj = torch.where(hit1 & (~hit2 | (t1 < t2)), 1,
                      torch.where(hit2, 2, 0))
    t_min = torch.where(obj == 1, t1, torch.where(obj == 2, t2, 0.0))
    return obj, t_min


def _shade_sphere(scene, params, key, pos, direction, beta, L, mask):
    """The sphere's surface event (render_kernel.cu:1807-1834): the
    roughness lerp of the mirror and a cosine-hemisphere direction from
    uniform(key, (B, 2)), and the direct sun through a shadow walk on
    fold_in(key, 3); applied where ``mask`` (vpt_tpu/render/
    integrator.py:62-99)."""
    sph, dev = scene.sphere, pos.device
    normal = normalize((pos - sph.center) / sph.radius)
    nl = torch.where((dot(normal, direction) < 0.0)[:, None], normal,
                     -normal)
    u = rng.uniform(key, (pos.shape[0], 2), dev)
    phi = 2.0 * math.pi * u[:, 0]
    r2 = u[:, 1]
    r2s = torch.sqrt(r2)
    w = normalize(nl)
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=dev)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    ref_axis = torch.where((torch.abs(w[:, 0]) > 0.1)[:, None], y_axis,
                           x_axis)
    uax = normalize(cross(ref_axis, w))
    vax = cross(w, uax)
    hemi = normalize(uax * (torch.cos(phi) * r2s)[:, None]
                     + vax * (torch.sin(phi) * r2s)[:, None]
                     + w * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[:,
                                                                      None])
    mirror = reflect(direction, nl)
    new_dir = mirror + (hemi - mirror) * sph.roughness
    new_pos = pos + normal * EPS
    new_beta = beta * sph.color
    sun = degree_to_cartesian(params.azimuth, params.elevation, dev)
    v_tr = transmittance(scene, params, rng.fold_in(key, 3), new_pos,
                         sun.expand_as(pos).contiguous(), active=mask)
    cos_l = torch.clamp(dot(sun.expand_as(normal), normal), min=0.0)
    sun_add = (vec3_param(params.sun_color, dev) * params.sun_mult
               * (v_tr * cos_l)[:, None] * new_beta)
    m = mask[:, None]
    return (torch.where(m, new_pos, pos), torch.where(m, new_dir, direction),
            torch.where(m, new_beta, beta), L + torch.where(m, sun_add, 0.0))


def _finish_walk(L, alpha, cost, depth):
    """The integrators' outputs: (L, alpha <= 1, cost, trunc 0, depth),
    float32, as the fused engine returns them."""
    return (L, torch.clamp(alpha, max=1.0), cost.to(torch.float32),
            torch.zeros_like(alpha), depth)


def direct_integrator(scene, params, key, origin, direction):
    """Trace one tile of (B, 3) rays with the direct integrator: (L,
    alpha, cost, trunc, depth), float32 (B,) each but L; cost counts the
    primary walks' steps, depth is the first event's distance (the
    depth_calculator AOV, render_kernel.cu:1859-1889), trunc is 0.  CUDA
    tensors launch K5's walk_direct (and K4 after it for an environment
    that depends on the direction); CPU tensors run the plain loop."""
    if origin.device.type == "cpu":
        return direct_integrator_plain(scene, params, key, origin,
                                       direction)
    from vpt_tpu_torch.render import walk
    return walk.walk_direct(scene, params, key, origin, direction)


def direct_integrator_plain(scene, params, key, origin, direction):
    """The reference's direct integrator in torch, lane-masked loop for
    loop (vpt_tpu/render/integrator.py:102-191): bounce i draws from
    fold_in(key, i); its v-th volume walk from fold_in(kd, 100 + v) and
    that walk's HG direction from fold_in(fold_in(kd, 100 + v), 1); the
    sun, point-light and emission estimates from fold_in(kd, 2 .. 4), the
    sphere from fold_in(kd, 5).  ``mi`` carries the last active walk's
    outcome; the HG direction changes before the estimates (QUIRKS #6);
    emission is not scaled by beta (QUIRKS #5); a walk that leaves the
    box never re-enters it (QUIRKS #19)."""
    B, dev = origin.shape[0], origin.device
    pos, dirn = origin, direction
    beta = torch.ones((B, 3), dtype=torch.float32, device=dev)
    L = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros(B, dtype=torch.float32, device=dev)
    env_pos = origin
    depth_aov = torch.zeros(B, dtype=torch.float32, device=dev)
    cost = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for depth_i in range(params.ray_depth):
        if bool(done.all()):
            break
        kd = rng.fold_in(key, depth_i)
        obj, t_min = _closest_object(scene, pos, dirn)
        in_vol = (obj == 1) & ~done
        pos_v = torch.where(in_vol[:, None],
                            pos + dirn * (t_min + EPS)[:, None], pos)
        mi = torch.zeros(B, dtype=torch.bool, device=dev)
        for vd in range(params.volume_depth):
            kv = rng.fold_in(kd, 100 + vd)
            new_pos, mi_v, val, _, alpha_add, steps = delta_track(
                scene, params, kv, pos_v, dirn, in_vol)
            beta = torch.where(in_vol[:, None], beta * val, beta)
            alpha = alpha + torch.where(in_vol, alpha_add, 0.0)
            cost = cost + torch.where(in_vol, steps, 0)
            pos_v = torch.where(in_vol[:, None], new_pos, pos_v)
            mi = torch.where(in_vol, mi_v, mi)
            sdir, _ = phase_sample(params, dirn, rng.fold_in(kv, 1))
            dirn = torch.where((mi_v & in_vol)[:, None], sdir, dirn)
            in_vol = in_vol & mi_v
        pos = torch.where(((obj == 1) & ~done)[:, None], pos_v, pos)

        first = depth_i == 0
        if first:
            depth_aov = torch.where(mi, length(origin - pos), depth_aov)
        if bool(mi.any()):
            sun = estimate_sun(scene, params, rng.fold_in(kd, 2), pos, dirn,
                               active=mi)
            L = L + torch.where(mi[:, None], sun * beta, 0.0)
            if scene.lights.count > 0:
                pl = estimate_point_lights(scene, params, rng.fold_in(kd, 3),
                                           pos, dirn, active=mi)
                L = L + torch.where(mi[:, None], pl * beta, 0.0)
            if scene.atlas.has_emission:
                em = estimate_emission(scene, params, rng.fold_in(kd, 4),
                                       pos, dirn, active=mi)
                L = L + torch.where(mi[:, None], em, 0.0)

        obj2, t2 = _closest_object(scene, pos, dirn)
        sph_mask = (obj2 == 2) & ~done
        if first:
            depth_aov = torch.where(sph_mask & ~mi, t2, depth_aov)
        if bool(sph_mask.any()):
            pos_s, dir_s, beta_s, L = _shade_sphere(
                scene, params, rng.fold_in(kd, 5), pos + dirn * t2[:, None],
                dirn, beta, L, sph_mask)
            m = sph_mask[:, None]
            pos = torch.where(m, pos_s, pos)
            dirn = torch.where(m, dir_s, dirn)
            beta = torch.where(m, beta_s, beta)
            env_pos = torch.where(m, pos, env_pos)
        done = done | ((obj == 0) & (obj2 != 2))
    L = L + environment_radiance(scene, params, env_pos, dirn) * beta
    return _finish_walk(L, alpha, cost, depth_aov)


def defers_environment(scene, params) -> bool:
    """True when the terminal environment depends on the direction (the
    simple sky, or HDRI with a map): K1 then hands each ray's beta and
    direction to K4 instead of adding the environment itself."""
    et = params.environment_type
    return (et == int(Environment.ATMOSPHERE)
            or (et == int(Environment.HDRI) and scene.env_map is not None))


def needs_env_pos(scene, params) -> bool:
    """True for the live Bruneton atmosphere (ATMOSPHERE with an attached
    atmosphere and no baked cache), which reads each ray's retired
    position: K1 then writes it beside beta and the direction."""
    return (params.environment_type == int(Environment.ATMOSPHERE)
            and getattr(scene, "atmosphere", None) is not None
            and getattr(scene, "sky_cache", None) is None)


class _EnvParams(ctypes.Structure):
    """Mirror of ``EnvParams`` in csrc/environment.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("n", "kind", "map_h", "map_w")] \
        + [(n, ctypes.c_float * 3) for n in ("sun", "color")] \
        + [(n, ctypes.c_float) for n in (
            "mult", "u_scale", "pi", "earth_r", "earth_r2", "atm_r2",
            "observer_y", "hr", "hm", "hr_inv", "hm_inv", "c_r", "c_m",
            "one_minus_g2", "one_plus_g2", "two_g", "two_plus_g2")] \
        + [(n, ctypes.c_float * 3) for n in ("beta_r", "beta_m",
                                             "beta_m11")]


# the uv constants' slots in _AtmParams.uv0 / uv1: one per texture axis
UV_TW, UV_TH, UV_R, UV_MU, UV_MUS, UV_IW, UV_IH = range(7)


class _AtmParams(ctypes.Structure):
    """Mirror of ``AtmParams`` in csrc/atmosphere.cuh (K4's and K5's
    Bruneton device code): the atmosphere kinds' LUTs (ATMOSPHERE's in K4's layout, sky/runtime.py::K4Luts),
    dims and float32 constants, each computed by the plain version's own
    torch expression (``atmosphere_params``)."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "trans", "irr", "scat_mie", "cache")] + [
        (n, ctypes.c_int) for n in (
            "tw", "th", "r", "mu", "mu_s", "nu", "iw", "ih", "cache_h",
            "cache_w")] + [
        (n, ctypes.c_float) for n in (
            "bottom", "top", "bottom2", "top2", "H", "HH", "d_s_min",
            "H_m_dsmin", "A", "t_m_b", "sar_c", "cos_sar", "ray_c",
            "mie_k", "one_plus_g2", "two_g", "exposure", "nu_m1",
            "nu_f")] + [
        ("uv0", ctypes.c_float * 7), ("uv1", ctypes.c_float * 7)] + [
        (n, ctypes.c_float * 3) for n in (
            "center", "sun", "solar_irr", "solar_rad", "albedo_pi",
            "sky_k", "sun_k", "wp")]


@dataclass
class EnvLaunch:
    """K4's launch arguments for one (scene, params), built once."""

    params: _EnvParams
    env_map: Optional[torch.Tensor]   # (H, W, 3) float32 on the card
    atm: Optional[_AtmParams] = None  # the atmosphere kinds'
    tables: tuple = ()                # the tensors atm points at


def _c3(values):
    return (ctypes.c_float * 3)(*[float(v) for v in values])


def _f(t) -> float:
    return float(t.detach().cpu())


def atmosphere_params(atm, azimuth, elevation,
                      cache: torch.Tensor | None = None):
    """(_AtmParams, the tensors it points at) of an atmosphere
    (sky/runtime.py::Atmosphere on the card) and its baked cache, for
    the SKY_CACHE kind, or None, for the ATMOSPHERE kind, which reads
    the atmosphere's LUTs in K4's layout (``atm.k4_luts``, packed once
    per atmosphere): every constant is the value the plain version's
    torch expression gives, computed on the CPU in float32 (IEEE
    operations, so the same bits as on the card)."""
    from vpt_tpu_torch.sky import bruneton as br
    from vpt_tpu_torch.sky import runtime as rt
    cuda.check_struct(_AtmParams,
                      cuda.load_library().dll.vpt_atm_params_size)
    dims, luts = atm.dims, atm.luts
    rt.check_luts(luts, dims)
    dev = luts.transmittance.device
    for f in dataclasses.fields(luts):
        cuda.check_cuda_tensor(getattr(luts, f.name),
                               f"atmosphere LUT {f.name}",
                               dtype=torch.float32, device=dev)
    p = atm.params.to("cpu")
    a = _AtmParams()
    if cache is None:
        k4 = atm.k4_luts
        tables = [k4.transmittance, k4.irradiance, k4.scattering_mie]
        for t, align in zip(tables, (16, 16, 32)):
            if t.data_ptr() % align:
                raise ValueError(f"K4's LUTs: a table not {align}-byte "
                                 "aligned")
        a.trans, a.irr, a.scat_mie = (t.data_ptr() for t in tables)
    else:
        cuda.check_cuda_tensor(cache, "sky_cache", dtype=torch.float32,
                               device=dev)
        if cache.dim() != 3 or cache.shape[2] != 6:
            raise ValueError(f"sky_cache: shape {tuple(cache.shape)}, "
                             "expected (H, W, 6)")
        a.cache = cache.data_ptr()
        a.cache_h, a.cache_w = cache.shape[0], cache.shape[1]
        tables = [cache]
    a.tw, a.th, a.r, a.mu = (dims.transmittance_w, dims.transmittance_h,
                             dims.r, dims.mu)
    a.mu_s, a.nu, a.iw, a.ih = (dims.mu_s, dims.nu, dims.irradiance_w,
                                dims.irradiance_h)
    a.bottom, a.top = _f(p.bottom_radius), _f(p.top_radius)
    a.bottom2 = _f(p.bottom_radius * p.bottom_radius)
    a.top2 = _f(p.top_radius * p.top_radius)
    H = br._horizon(p)
    a.H, a.HH = _f(H), _f(H * H)
    d_s_min = p.top_radius - p.bottom_radius
    a.d_s_min, a.H_m_dsmin = _f(d_s_min), _f(H - d_s_min)
    a.A = _f(br._mu_s_a_max(p))
    a.t_m_b = _f(p.top_radius - p.bottom_radius)
    a.sar_c = _f(torch.clamp(p.sun_angular_radius, min=1e-6))
    a.cos_sar = _f(rt.cos_sun_radius(p))
    a.ray_c = float(np.float32(3.0 / (16.0 * math.pi)))
    g = p.mie_phase_g
    a.mie_k = _f(3.0 / (8.0 * math.pi) * (1.0 - g * g) / (2.0 + g * g))
    a.one_plus_g2, a.two_g = _f(1.0 + g * g), _f(2.0 * g)
    a.exposure = _f(rt.curve_exposure(p))
    a.nu_m1, a.nu_f = dims.nu - 1.0, float(dims.nu)
    for slot, size in ((UV_TW, dims.transmittance_w),
                       (UV_TH, dims.transmittance_h), (UV_R, dims.r),
                       (UV_MU, dims.mu // 2), (UV_MUS, dims.mu_s),
                       (UV_IW, dims.irradiance_w),
                       (UV_IH, dims.irradiance_h)):
        a.uv0[slot] = float(np.float32(0.5 / size))
        a.uv1[slot] = float(np.float32(1.0 - 1.0 / size))
    sky_k, sun_k = rt.luminance_factors(p)
    for name, v in (("center", rt.earth_center(p)),
                    ("sun", rt.sun_direction(azimuth, elevation, "cpu")),
                    ("solar_irr", p.solar_irradiance),
                    ("solar_rad", br.get_solar_radiance(p)),
                    ("albedo_pi", true_div(p.ground_albedo, math.pi)),
                    ("sky_k", sky_k), ("sun_k", sun_k),
                    ("wp", p.white_point)):
        setattr(a, name, _c3(v.tolist()))
    return a, tuple(tables)


def prepare_environment(scene, params) -> EnvLaunch:
    """K4's parameter struct: the sun direction from
    core/vecmath.py::degree_to_cartesian, as the plain version makes it,
    the sky's float32 constants, the map for HDRI, and for the Bruneton
    atmosphere its LUTs, its baked cache where the scene has one, and
    its constants (atmosphere_params)."""
    if not defers_environment(scene, params):
        raise ValueError("K4 takes the simple sky, HDRI with a map or the "
                         "Bruneton atmosphere")
    cuda.check_struct(_EnvParams,
                      cuda.load_library().dll.vpt_env_params_size)
    from vpt_tpu_torch.sky.procedural import sky_constants
    p = _EnvParams()
    p.sun = _c3(degree_to_cartesian(params.azimuth, params.elevation,
                                    "cpu").tolist())
    p.color = _c3(vec3_param(params.sky_color).tolist())
    env_map = None
    atm, tables = None, ()
    if params.environment_type == int(Environment.HDRI):
        env_map = scene.env_map
        cuda.check_cuda_tensor(env_map, "env_map", dtype=torch.float32)
        if env_map.dim() != 3 or env_map.shape[2] != 3:
            raise ValueError(f"env_map: shape {tuple(env_map.shape)}, "
                             "expected (H, W, 3)")
        if env_map.numel() > 2 ** 31 - 1:
            raise ValueError("env_map: K4 indexes the map in 32 bits")
        p.kind, p.mult = ENV_HDRI, isotropic()
        p.u_scale, p.pi = 0.5 / math.pi, math.pi
        p.map_h, p.map_w = env_map.shape[0], env_map.shape[1]
    elif getattr(scene, "atmosphere", None) is not None:
        atm, tables = atmosphere_params(scene.atmosphere, params.azimuth,
                                        params.elevation, scene.sky_cache)
        p.kind = ENV_SKY_CACHE if scene.sky_cache is not None \
            else ENV_ATMOSPHERE
        p.mult = float(params.sky_mult)
    else:
        p.kind, p.mult = ENV_SKY, float(params.sky_mult)
    for name, v in sky_constants().items():
        setattr(p, name, _c3(v) if isinstance(v, list) else v)
    return EnvLaunch(p, env_map, atm, tables)


_KIND_COUNTERS = {ENV_ATMOSPHERE: ENVIRONMENT_ATMOSPHERE,
                  ENV_SKY_CACHE: ENVIRONMENT_SKY_CACHE}


def add_environment(scene, params, L, beta, dirn, pos=None,
                    launch: EnvLaunch | None = None):
    """L + environment_radiance(scene, params, pos, dirn) * beta for
    (B, 3) tensors; ``pos``, the rays' retired positions, is read by the
    live Bruneton atmosphere only (needs_env_pos) and may be None
    elsewhere.  CPU tensors: the plain version, a new tensor.  CUDA
    tensors: K4 (``launch`` from prepare_environment, or None to prepare
    it here) adds the term in place on L, which it returns."""
    live = needs_env_pos(scene, params)
    if live and pos is None:
        raise ValueError("add_environment: the live atmosphere needs the "
                         "rays' positions")
    if L.device.type == "cpu":
        return L + environment_radiance(
            scene, params, dirn if pos is None else pos, dirn) * beta
    if L.device.type != "cuda":
        raise ValueError(f"add_environment: unsupported device {L.device}")
    if launch is None:
        launch = prepare_environment(scene, params)
    return _launch_k4(launch, L, beta, dirn, pos if live else None)


def _launch_k4(launch: EnvLaunch, L, beta, dirn, pos=None):
    """K4 on (B, 3) CUDA tensors, in place on L; ``pos`` for the
    ATMOSPHERE kind."""
    n = L.shape[0]
    named = [(L, "L"), (beta, "beta"), (dirn, "dirn")]
    if launch.params.kind == ENV_ATMOSPHERE:
        if pos is None:
            raise ValueError("K4's ATMOSPHERE kind reads the positions")
        named.append((pos, "pos"))
    for t, name in named:
        cuda.check_cuda_tensor(t, f"add_environment: {name}", (n, 3),
                               torch.float32, L.device)
    if 3 * n > 2 ** 31 - 1:
        raise ValueError(f"add_environment: {n} rays; K4 indexes in 32 "
                         "bits")
    if launch.env_map is not None and launch.env_map.device != L.device:
        raise ValueError("add_environment: the map is on another device")
    p = _EnvParams.from_buffer_copy(launch.params)
    p.n = n
    if launch.tables and launch.tables[0].device != L.device:
        raise ValueError("add_environment: the LUTs are on another device")
    rc = cuda.load_library().dll.vpt_environment(
        ctypes.byref(p), L.data_ptr(), beta.data_ptr(), dirn.data_ptr(),
        None if launch.env_map is None else launch.env_map.data_ptr(),
        cuda.current_stream(L.device),
        None if launch.atm is None else ctypes.byref(launch.atm),
        None if pos is None else pos.data_ptr())
    counter = _KIND_COUNTERS.get(p.kind, ENVIRONMENT)
    cuda.check_status(rc, counter.name)
    counter.launches += 1
    return L


def atmosphere_on_rays(atm, pos, dirn, azimuth, elevation):
    """sky/runtime.py::sample_atmosphere on (B, 3) CUDA rays through K4's
    ATMOSPHERE kind, on L = 0 and beta = 1 with sky_mult and sky_color 1
    (0 + (x * 1) * 1 * 1 is x): ``vpt-torch earth``'s image."""
    p = _EnvParams()
    p.kind, p.mult = ENV_ATMOSPHERE, 1.0
    p.color = _c3((1.0, 1.0, 1.0))
    a, tables = atmosphere_params(atm, azimuth, elevation)
    L = torch.zeros_like(dirn)
    return _launch_k4(EnvLaunch(p, None, a, tables), L,
                      torch.ones_like(dirn), dirn.contiguous(),
                      pos.contiguous())


def atmosphere_launch_info() -> dict:
    """The ATMOSPHERE kind's schedule on the current card, from the CUDA
    runtime: SMs, resident blocks per SM, threads per block, registers
    and local (spill and stack) bytes per thread."""
    info = (ctypes.c_int * 5)()
    cuda.check_status(cuda.load_library().dll.vpt_atmosphere_launch_info(
        info), "atmosphere launch info")
    return dict(zip(("sms", "blocks_per_sm", "threads", "registers",
                     "local_bytes"), info))


def div_known_sweep(d: float, y: float, lo: int = 0, hi: int = 2 ** 32,
                    device="cuda", chunk: int = 2 ** 22):
    """Hold csrc/vpt_common.cuh::div_known2 (d and y as both divisors and
    both reciprocals) to IEEE float32 division x / d for every 32-bit
    pattern x in [lo, hi): (the number of patterns whose results differ
    in a bit and are not both NaN, the first of them or None).  On a CUDA device the sweep kernel
    (environment.cu::vpt_div_known_sweep) computes both on the card; on
    the CPU ``sky.procedural.div_known_plain`` against numpy's float32
    division, ``chunk`` patterns at a time.  A test of K4's divisions,
    not on the render path."""
    import numpy as np
    from vpt_tpu_torch.sky.procedural import div_known_plain
    if not 0 <= lo <= hi <= 2 ** 32:
        raise ValueError(f"div_known_sweep: [{lo}, {hi}) is not within "
                         "[0, 2^32)")
    dev = torch.device(device)
    if dev.type == "cpu":
        bad, first = 0, None
        d32 = np.float32(d)
        for a in range(lo, hi, chunk):
            bits = np.arange(a, min(a + chunk, hi), dtype=np.uint64)
            x = bits.astype(np.uint32).view(np.float32)
            got = div_known_plain(x, d, y)
            with np.errstate(all="ignore"):
                want = x / d32
            diff = (got.view(np.uint32) != want.view(np.uint32)) & ~(
                np.isnan(got) & np.isnan(want))
            if diff.any():
                bad += int(diff.sum())
                if first is None:
                    first = int(bits[np.argmax(diff)])
        return bad, first
    if dev.type != "cuda":
        raise ValueError(f"div_known_sweep: unsupported device {dev}")
    out = torch.tensor([0, -1], dtype=torch.int64, device=dev)
    rc = cuda.load_library().dll.vpt_div_known_sweep(
        float(d), float(y), lo, hi, out.data_ptr(), cuda.current_stream(dev))
    cuda.check_status(rc, "div_known_sweep")
    bad, first = out.cpu().tolist()
    return bad, (None if bad == 0 else first)
