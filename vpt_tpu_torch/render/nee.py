"""The environment's radiance toward a direction (port of
vpt_tpu/render/nee.py::environment_light_radiance, :24-47).

Only the terminal lookup reads it here, for the Bruneton atmosphere
with the ray's retired position.  The sky's next-event estimate
(``estimate_sky``) and the environment CDF (``sky/cdf.py``) belong to
the reference and volumetric engines and come with them (ROADMAP A.8).
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.render.params import Environment
from vpt_tpu_torch.render.tracking import vec3_param


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
