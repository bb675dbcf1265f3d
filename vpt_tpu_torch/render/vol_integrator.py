"""The volumetric integrator: PBRT-style multiple scattering
(render_kernel.cu:1712-1756; port of vpt_tpu/render/vol_integrator.py)
with ``uniform_sample_one_light`` (:1519-1554; QUIRKS #9: nLights = 3
whichever lights are on).

Unlike the direct integrator it has no closest-object dispatch: the walk
goes on from each collision along the scattered direction, so light
scatters many times inside the volume.  ``vol_integrator`` runs the
plain loop on CPU tensors and kernel K5's ``walk_volumetric``
(render/walk.py, csrc/walk.cu) on CUDA tensors, K4 after it for an
environment that depends on the direction.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.phase import phase_sample
from vpt_tpu_torch.core.vecmath import EPS, aabb_intersect, length
from vpt_tpu_torch.render.integrator import (_finish_walk,
                                             environment_radiance)
from vpt_tpu_torch.render.nee import (estimate_point_lights, estimate_sky,
                                      estimate_sun)
from vpt_tpu_torch.render.tracking import delta_track, estimate_emission

N_LIGHTS = 3  # QUIRKS #9 (render_kernel.cu:1531)


def uniform_sample_one_light(scene, params, key, pos, direction,
                             active=None):
    """One of {sun, point lights, sky} picked by int(3 u), u from
    fold_in(key, 0), times 3; the sun on fold_in(key, 1), the point
    lights on fold_in(key, 2), the sky's MIS on fold_in(key, 3) times
    sky_mult (vpt_tpu/render/vol_integrator.py:25-43).  Each estimate
    walks only the ``active`` lanes (all by default) that picked it; the
    others' values are to be ignored."""
    B, dev = pos.shape[0], pos.device
    pick = (rng.uniform(rng.fold_in(key, 0), (B,), dev) * N_LIGHTS).to(
        torch.int32)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    L = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    sun = estimate_sun(scene, params, rng.fold_in(key, 1), pos, direction,
                       active=active & (pick == 0))
    L = L + torch.where((pick == 0)[:, None], sun, 0.0)
    if scene.lights.count > 0:
        pl = estimate_point_lights(scene, params, rng.fold_in(key, 2), pos,
                                   direction, active=active & (pick == 1))
        L = L + torch.where((pick == 1)[:, None], pl, 0.0)
    sky = estimate_sky(scene, params, rng.fold_in(key, 3), pos, direction,
                       active=active & (pick >= 2)) * params.sky_mult
    L = L + torch.where((pick >= 2)[:, None], sky, 0.0)
    return L * float(N_LIGHTS)


def vol_integrator(scene, params, key, origin, direction):
    """Trace one tile of (B, 3) rays with the volumetric integrator: (L,
    alpha, cost, trunc, depth) as render/integrator.py::
    direct_integrator returns them.  CUDA tensors launch K5's
    walk_volumetric (and K4 after it); CPU tensors run the plain loop."""
    if origin.device.type == "cpu":
        return vol_integrator_plain(scene, params, key, origin, direction)
    from vpt_tpu_torch.render import walk
    return walk.walk_volumetric(scene, params, key, origin, direction)


def vol_integrator_plain(scene, params, key, origin, direction):
    """The reference's volumetric integrator in torch, loop for loop
    (vpt_tpu/render/vol_integrator.py:46-104): from the root box's entry,
    bounce i walks on fold_in(fold_in(key, i), 0), estimates one light on
    fold_in(kd, 1) and the emission on fold_in(kd, 2) at a medium event,
    then scatters on fold_in(kd, 3); a walk that leaves the medium ends
    the ray.  The terminal lookup starts from the origin while |beta| >
    0.9999, from the last position otherwise (render_kernel.cu:
    1750-1752)."""
    B, dev = origin.shape[0], origin.device
    hit, t_entry, _ = aabb_intersect(scene.root_pmin, scene.root_pmax,
                                     origin, direction)
    pos = torch.where(hit[:, None],
                      origin + direction * (t_entry + EPS)[:, None], origin)
    dirn = direction
    beta = torch.ones((B, 3), dtype=torch.float32, device=dev)
    L = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros(B, dtype=torch.float32, device=dev)
    depth_aov = torch.zeros(B, dtype=torch.float32, device=dev)
    cost = torch.zeros(B, dtype=torch.int32, device=dev)
    active = hit
    for depth_i in range(params.ray_depth):
        if not bool(active.any()):
            break
        kd = rng.fold_in(key, depth_i)
        new_pos, mi, val, _, alpha_add, steps = delta_track(
            scene, params, rng.fold_in(kd, 0), pos, dirn, active)
        a3 = active[:, None]
        beta = torch.where(a3, beta * val, beta)
        alpha = alpha + torch.where(active, alpha_add, 0.0)
        cost = cost + torch.where(active, steps, 0)
        pos = torch.where(a3, new_pos, pos)
        active = active & ~torch.all(beta == 0.0, dim=-1)
        mi = mi & active
        if depth_i == 0:
            depth_aov = torch.where(mi, length(origin - pos), depth_aov)
        ld = uniform_sample_one_light(scene, params, rng.fold_in(kd, 1),
                                      pos, dirn, active=mi)
        L = L + torch.where(mi[:, None], beta * ld, 0.0)
        if scene.atlas.has_emission:
            em = estimate_emission(scene, params, rng.fold_in(kd, 2), pos,
                                   dirn, active=mi)
            L = L + torch.where(mi[:, None], em, 0.0)
        sdir, _ = phase_sample(params, dirn, rng.fold_in(kd, 3))
        dirn = torch.where(mi[:, None], sdir, dirn)
        active = active & mi
    untouched = length(beta) > 0.9999
    env_from = torch.where(untouched[:, None], origin, pos)
    L = L + environment_radiance(scene, params, env_from, dirn) * beta
    return _finish_walk(L, alpha, cost, depth_aov)
