"""Next-event estimation (port of vpt_tpu/render/nee.py): the sun, the
point lights and the two-strategy sky MIS of the reference and
volumetric engines, and the environment's radiance toward a direction,
which the terminal lookup reads too.

All functions are batched over (B, 3) rays; ``direction`` is the ray's
already HG-scattered direction (QUIRKS #6).  Each replays the
reference's threefry draws, one element per ray.  Their per-ray form on
the card is in kernel K5 (csrc/walk.cu).
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.phase import (isotropic, phase_eval, phase_sample,
                                      power_heuristic, sample_spherical)
from vpt_tpu_torch.core.vecmath import (degree_to_cartesian, dot, length,
                                        normalize)
from vpt_tpu_torch.render.params import Environment
from vpt_tpu_torch.render.tracking import transmittance, vec3_param

LIGHT_BUDGET = 11  # 10..0 inclusive (render_kernel.cu:1459), QUIRKS #3


def environment_light_radiance(scene, params, pos, wi):
    """Li toward ``wi`` from ``pos``: ATMOSPHERE -> the attached Bruneton
    atmosphere (its baked cache where it has one,
    sky/runtime.py::sample_atmosphere_scene), else the simple sky; HDRI
    -> the map, 0 without one; CONSTANT -> sky_color; BLACK -> 0.
    sky_mult is applied by the caller, as in the reference."""
    et = params.environment_type
    if et == int(Environment.BLACK):
        return torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                           device=pos.device)
    if et == int(Environment.CONSTANT):
        return vec3_param(params.sky_color, pos.device).expand(
            pos.shape[:-1] + (3,))
    if et == int(Environment.HDRI):
        if scene.env_map is None:
            return torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                               device=pos.device)
        from vpt_tpu_torch.sky.envmap import sample_env_map
        return sample_env_map(scene.env_map, wi)
    if getattr(scene, "atmosphere", None) is not None:
        from vpt_tpu_torch.sky.runtime import (Atmosphere,
                                               sample_atmosphere_scene)
        if not isinstance(scene.atmosphere, Atmosphere):
            raise TypeError(f"scene.atmosphere: {type(scene.atmosphere)}, "
                            "expected sky.runtime.Atmosphere")
        return sample_atmosphere_scene(scene, params, pos, wi)
    from vpt_tpu_torch.sky.procedural import sample_sky
    return sample_sky(wi, params.azimuth, params.elevation,
                      vec3_param(params.sky_color, wi.device))


def estimate_sun(scene, params, key, pos, direction, tr_fn=transmittance,
                 active=None):
    """Sun NEE (render_kernel.cu:1478-1516): Tr * phase(cos) * sun_color
    * sun_mult, the shadow walk on fold_in(key, 0); ``tr_fn`` swaps the
    transmittance estimator (vpt_tpu/render/nee.py:50-62).  Here and in
    the other estimates, lanes outside ``active`` walk no step and their
    values are to be ignored."""
    dev = pos.device
    wi = degree_to_cartesian(params.azimuth, params.elevation, dev)
    phase_pdf = phase_eval(params, dot(direction, wi.expand_as(direction)))
    tr = tr_fn(scene, params, rng.fold_in(key, 0), pos,
               wi.expand_as(pos).contiguous(), active=active)
    return ((tr * phase_pdf)[:, None] * vec3_param(params.sun_color, dev)
            * params.sun_mult)


def estimate_point_lights(scene, params, key, pos, direction,
                          tr_fn=transmittance, active=None):
    """Point-light NEE with the reference's budget (QUIRKS #3): min(L, 11)
    uniform picks, light min(int(u L), L - 1), summed without
    normalisation; the falloff after reference_falloff (QUIRKS #2).  Pick
    w draws its light from fold_in(fold_in(key, w), 0) and walks on
    fold_in(fold_in(key, w), 1) (vpt_tpu/render/nee.py:65-93)."""
    B, dev = pos.shape[0], pos.device
    n = scene.lights.count
    total = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    for w in range(min(n, LIGHT_BUDGET)):
        kw = rng.fold_in(key, w)
        u = rng.uniform(rng.fold_in(kw, 0), (B,), dev)
        idx = torch.clamp((u * n).to(torch.int64), max=n - 1)
        lpos = scene.lights.pos[idx]
        wi = normalize(lpos - pos)
        tr = tr_fn(scene, params, rng.fold_in(kw, 1), pos, wi,
                   active=active)
        phase_pdf = phase_eval(params, dot(direction, wi))
        if params.reference_falloff:
            sqr = length(lpos * lpos - pos * pos)
        else:
            d = lpos - pos
            sqr = dot(d, d)
        falloff = 1.0 / torch.clamp(sqr, min=1e-12)
        total = total + scene.lights.color[idx] * (
            scene.lights.power[idx] * phase_pdf * falloff * tr)[:, None]
    return total


def uses_env_cdf(scene, params) -> bool:
    """The sky NEE samples the CDF: under ATMOSPHERE, or HDRI with
    hdri_importance (QUIRKS #24: else uniform sphere), where the scene
    has one."""
    et = params.environment_type
    return getattr(scene, "env_cdf", None) is not None and (
        et == int(Environment.ATMOSPHERE)
        or (et == int(Environment.HDRI) and params.hdri_importance))


def _sample_env_direction(scene, params, key, shape, device):
    """The light strategy's direction and pdf, and whether the CDF drew
    it: u1 and u2 from split(key) through the CDF, else the uniform
    sphere on key (vpt_tpu/render/nee.py:96-114)."""
    if uses_env_cdf(scene, params):
        from vpt_tpu_torch.sky.cdf import sample_env_cdf
        k1, k2 = rng.split(key)
        return sample_env_cdf(scene.env_cdf, rng.uniform(k1, shape, device),
                              rng.uniform(k2, shape, device)), True
    return sample_spherical(key, shape, device), False


def _pdf_env_direction(scene, params, wi, used_cdf: bool):
    if used_cdf:
        from vpt_tpu_torch.sky.cdf import pdf_env_cdf
        return pdf_env_cdf(scene.env_cdf, wi)
    return torch.full(wi.shape[:-1], isotropic(), dtype=torch.float32,
                      device=wi.device)


def estimate_sky(scene, params, key, pos, direction, active=None):
    """Two-strategy MIS sky NEE (render_kernel.cu:1356-1443): (a) a light
    sample (the CDF or the uniform sphere) weighted by the power heuristic
    against the phase pdf, (b) a phase sample weighted against the light
    pdf, each with its own shadow walk; keys split(key, 4) = light,
    phase, walk a, walk b; the 1e-20 guard and the ``ok`` masks kept
    (vpt_tpu/render/nee.py:124-155).  sky_mult is the caller's."""
    shape, dev = pos.shape[:-1], pos.device
    k_light, k_phase, k_tr1, k_tr2 = rng.split(key, 4)

    (wi, light_pdf), used_cdf = _sample_env_direction(scene, params,
                                                      k_light, shape, dev)
    li = environment_light_radiance(scene, params, pos, wi)
    phase_pdf = phase_eval(params, dot(direction, wi))
    tr = transmittance(scene, params, k_tr1, pos, wi, active)
    weight = power_heuristic(1.0, light_pdf, 1.0, phase_pdf)
    ok = (light_pdf > 0.0) & (phase_pdf > 0.0)
    contrib_a = li * (tr * phase_pdf * weight
                      / torch.clamp(light_pdf, min=1e-20))[..., None]
    ld = torch.where(ok[..., None], contrib_a, 0.0)

    wi_b, phase_pdf_b = phase_sample(params, direction, k_phase)
    light_pdf_b = _pdf_env_direction(scene, params, wi_b, used_cdf)
    weight_b = power_heuristic(1.0, phase_pdf_b, 1.0, light_pdf_b)
    tr_b = transmittance(scene, params, k_tr2, pos, wi_b, active)
    li_b = environment_light_radiance(scene, params, pos, wi_b)
    ok_b = (phase_pdf_b > 0.0) & (light_pdf_b > 0.0)
    contrib_b = li_b * (tr_b * weight_b)[..., None]
    return ld + torch.where(ok_b[..., None], contrib_b, 0.0)
