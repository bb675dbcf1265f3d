"""The fused engine: the direct-integrator path trace as one lane-masked
state machine (port of vpt_tpu/render/fused.py::fused_direct, one ray
per lane; single-instance and instanced scenes).

Every ray is in one phase of the walk it is running:

    SEEK   — classify the next segment (volume box / sphere / done)
    MARCH  — banded delta tracking of the primary walk
    SHADOW — residual-ratio transmittance (sun NEE, point-light NEE and
             the sphere's sun shading) — tracked shadows only
    EMIT   — the rate-weighted emission walk from a medium event along
             its scattered direction, on scenes with an emission channel
    DONE   — terminal (environment applied after the loop)

and one step advances every live ray by one step of its walk, with one
corner-row fetch, or on an instanced scene one majorant cell row and
the listed instances' rows (render/tracking.py::_cells_banded_fetch;
K1's CELLS instances), or, without cell lists, the majorant grid's
packed row and every instance's rows in order (``_loop_banded_fetch``;
its CELLS instances with LOOP).  ``shadow_mode="cached"`` reads every
NEE transmittance from the baked taus of that same row, or, in the loop,
from one row of the world tau grid at the event (accel/shadow.py::
world_tau_fetch).  An instanced scene's MARCH and EMIT walks cover the
root box (``_walk_box``); its emission sums and its Cd takes the max
over the instances (scene_emission, scene_color), and its EMIT walks
jump no empty box, whose bounds come from the density alone.

``fused_direct`` launches kernel K1 (csrc/fused_direct.cu: persistent
warps, one ray per lane with the walk state in registers, idle lanes
refilled with new rays) on CUDA tensors and runs ``fused_direct_plain``
— the lane-masked loop written in torch — on CPU tensors.
``_fused_direct_primary_cuda`` is K1's in-kernel-ray route: each lane
makes its own primary ray with K2's code (csrc/raygen.cuh), so no ray
buffer is written or read.  All replay the reference's threefry draws:
the pre-loop seek uses ``uniform(fold_in(key, 1<<20), (B, 5))``, step
``s`` of a ray uses ``uniform(fold_in(key, s), (B, 5))`` and HG
sampling ``fold_in(fold_in(key, s), 7)``, so K1's schedule does not
change its output.

The terminal environment: K1 adds BLACK and CONSTANT itself when a ray
retires; for HDRI with a map, the simple sky and the Bruneton atmosphere
(ATMOSPHERE) it writes each ray's beta and direction beside its outputs,
and for the live atmosphere also its env_pos (the origin, moved to the
sphere's anchor by a sphere event only, as the reference keeps it), and
kernel K4 (render/integrator.py::add_environment, csrc/environment.cu)
adds env(env_pos, direction) * beta to L after it, as the reference
applies the environment after its loop.

``queue`` (render/params.py::resolve_queue): at Q = 16 each ray may take
max_fused_steps * 16 steps, and a ray still walking at the end is
written as the reference's unretired queue slot: L, alpha, cost and
depth 0, unfinished 1, and beta 0 with the ray's primary direction for
the environment term.  Rays that finish are the same bits at any Q.

``volume_depth`` > 1: every medium event but the last of a walk scatters
(HG) and restarts MARCH from the collision, with no NEE.

A single grid's corner rows may be bfloat16 and may carry the 72 octant
columns (volume/grid.py): the plain loop reads them through the fetch,
widened to float32; K1 takes them in instances of their own
(``FUSED_DIRECT_BF16``, ``FUSED_DIRECT_OCTANT``).

Not in this slice (NotImplementedError): the queue path
(``rays_per_lane > 1``) and instanced scenes whose corner rows are
bfloat16 or carry octant columns (ROADMAP A.10).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from vpt_tpu_torch.accel.shadow import (cached_light_channels,
                                        world_tau_cell, world_tau_fetch)
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.phase import phase_eval, phase_sample
from vpt_tpu_torch.core.vecmath import (EPS, TWO_PI, aabb_contains,
                                        aabb_intersect, cross,
                                        degree_to_cartesian, dot, length,
                                        normalize, reflect)
from vpt_tpu_torch.ops import cuda
from vpt_tpu_torch.render.integrator import (EnvLaunch, add_environment,
                                             defers_environment,
                                             environment_radiance,
                                             needs_env_pos,
                                             prepare_environment)
from vpt_tpu_torch.render.params import Environment, check_fused
from vpt_tpu_torch.render.tracking import (FetchResult, _cells_banded_fetch,
                                           _emission_lut, _loop_banded_fetch,
                                           _sphere_block, _use_cells,
                                           cell_layout, cell_size,
                                           density_color_lut, scene_color,
                                           scene_emission,
                                           unified_fetch_full, vec3_param)
from vpt_tpu_torch.scene.scene import check_instanced
from vpt_tpu_torch.volume.grid import unified_layout

P_SEEK, P_MARCH, P_SHADOW, P_EMIT, P_DONE = 0, 1, 2, 3, 4
AS_SUN, AS_PT, AS_SPHERE = 0, 1, 2
SEEK_FOLD = 1 << 20
HG_FOLD = 7

FUSED_DIRECT = cuda.Kernel(
    name="fused_direct", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/fused.py:100")
FUSED_DIRECT_PRIMARY = cuda.Kernel(
    name="fused_direct_primary", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/fused.py:100")
# K1's EXT variant, on either route (counted beside the route's own
# counter): emission, color or volume_depth > 1; with it the emission LUT
# (vpt_tpu/render/tracking.py:245) and Cd are read in the kernel
FUSED_DIRECT_EXT = cuda.Kernel(
    name="fused_direct_ext", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/fused.py:100")
# K1's CELLS variant, on either route (counted beside the route's own
# counter): instanced scenes with cell lists, the cell fetch of
# vpt_tpu/render/tracking.py:150 in the kernel
FUSED_DIRECT_CELLS = cuda.Kernel(
    name="fused_direct_cells", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/fused.py:100")
# K1's CELLS instances with LOOP (counted beside the route's own
# counter): instanced scenes without cell lists, the static loop of
# vpt_tpu/render/tracking.py:230 over the packed rows, and the world tau
# grid's row at an event in cached mode
FUSED_DIRECT_LOOP = cuda.Kernel(
    name="fused_direct_loop", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/tracking.py:230")
# the CELLS instances with EXT (counted beside the route's, EXT's and
# CELLS' or LOOP's counters): emission, color or volume_depth > 1 on an
# instanced scene, vpt_tpu/render/tracking.py:261 scene_emission and
# :284 scene_color in the kernel
FUSED_DIRECT_CELLS_EXT = cuda.Kernel(
    name="fused_direct_cells_ext", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/tracking.py:261")
# K1's instances for bfloat16 corner rows, with the octant exit compiled in
# and taken where the rows carry the octant columns, on either route
# (counted beside the route's own counter)
FUSED_DIRECT_BF16 = cuda.Kernel(
    name="fused_direct_bf16", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/tracking.py:407")
# K1's instances for float32 corner rows with the octant columns, on
# either route (counted beside the route's own counter)
FUSED_DIRECT_OCTANT = cuda.Kernel(
    name="fused_direct_octant", route="cuda",
    source="vpt_tpu_torch/csrc/fused_direct.cu",
    replaces="vpt_tpu/render/tracking.py:502")
# the counter of the instances that each kind of rows takes
_ROWS_KERNEL = {cuda.ROWS_BF16: FUSED_DIRECT_BF16,
                cuda.ROWS_BF16_OCTANT: FUSED_DIRECT_BF16,
                cuda.ROWS_F32_OCTANT: FUSED_DIRECT_OCTANT}
# K1's schedule per shadow mode, chosen by timing on the H100 (PERF.md):
# a warp refills its idle lanes once at least refill_min (1..32) are
# idle, each taking the next slot of the global counter, the slots
# walking a frame in tiles of tile_w x tile_h rays (0 x 0: in ray order).
SCHEDULE = {
    "cached": dict(refill_min=24, tile_w=0, tile_h=0),
    "tracked": dict(refill_min=32, tile_w=8, tile_h=4),
}


def _constants(scene, params, device):
    """float32 scalars and vectors shared by the plain loop and K1."""
    f32 = dict(dtype=torch.float32, device=device)
    sigma_max = scene.max_extinction.to(device)
    sigma_c = scene.min_extinction.to(device)
    sigma_r = torch.clamp(sigma_max - sigma_c, min=1e-12)
    ext = vec3_param(params.extinction, device)
    return dict(
        sigma_max=sigma_max, sigma_c=sigma_c, sigma_r=sigma_r,
        inv_rate_march=1.0 / torch.clamp(sigma_max * params.density_mult,
                                         min=1e-12),
        rate_inv_shadow=torch.tensor(params.tr_depth, **f32) / sigma_r,
        rate_inv_emit=torch.tensor(params.tr_depth, **f32) / torch.clamp(
            sigma_max * ext[0], min=1e-12),
        ext=ext,
        albedo=vec3_param(params.albedo, device),
        sun_dir=degree_to_cartesian(params.azimuth, params.elevation,
                                    device),
        sun_cs=vec3_param(params.sun_color, device) * params.sun_mult,
        sky=vec3_param(params.sky_color, device) * params.sky_mult)


def _walk_box(scene):
    """The box a MARCH or EMIT walk covers: the instance's own box on a
    single instance (the root's 1-unit pad holds no density), the root
    box on an instanced scene (vpt_tpu/render/fused.py:49-58)."""
    if scene.instances.count == 1:
        return scene.instances.pmin[0], scene.instances.pmax[0]
    return scene.root_pmin, scene.root_pmax


def _check_scene(scene, params):
    check_fused(params)
    n = scene.instances.count
    check_instanced(n, scene.atlas.density_corners.dtype,
                    scene.atlas.octant_cols)
    if n != 1 and scene.majorant is None:
        raise ValueError("an instanced scene needs its majorant grid "
                         "(scene/scene.py::build_scene)")
    n_lights = scene.lights.count
    if params.shadow_mode == "cached":
        n_ch = cached_light_channels(scene)
        if n_ch != n_lights:
            raise ValueError(
                f"shadow cache has {n_ch} light channels but the scene has "
                f"{n_lights} point lights — re-run accel.shadow."
                "attach_shadow_cache on this scene")


def fused_direct(scene, params, key, origin, direction, launch=None,
                 queue: int = 1):
    """Trace one tile of rays.  Returns (L (B,3), alpha, cost,
    unfinished, depth), all float32: cost = loop steps spent walking,
    unfinished = step-budget truncation flag.  ``queue``: 1, or the
    reference's queue length from resolve_queue (the module's
    docstring).

    CUDA tensors launch kernel K1, and K4 after it for an environment
    that depends on the direction (``launch``: an optional prepare_fused
    result for this scene and params); CPU tensors run the plain
    version."""
    if origin.device.type == "cpu":
        return fused_direct_plain(scene, params, key, origin, direction,
                                  queue)
    if origin.device.type != "cuda":
        raise ValueError(f"fused_direct: unsupported device {origin.device}")
    return _fused_direct_cuda(scene, params, key, origin, direction, launch,
                              queue=queue)


def fused_direct_plain(scene, params, key, origin, direction,
                       queue: int = 1, deferred: bool = False):
    """The lane-masked loop in torch, step for step the reference's
    ``body`` at Q = 1 (vpt_tpu/render/fused.py:393-791), run for
    max_fused_steps * queue steps; at queue > 1 the rays still walking
    are written as unretired queue slots (:745-767).  ``deferred``:
    return L before the environment, with beta, the direction and
    env_pos after the five outputs, what K1 hands K4."""
    _check_scene(scene, params)
    dev = origin.device
    B = origin.shape[0]
    k = _constants(scene, params, dev)
    sigma_max, sigma_c, sigma_r = k["sigma_max"], k["sigma_c"], k["sigma_r"]
    sun_dir = k["sun_dir"].expand(B, 3)
    cached = params.shadow_mode == "cached"
    n_lights = scene.lights.count
    n_pt_walks = min(n_lights, 11)  # QUIRKS #3 budget
    root_min, root_max = scene.root_pmin, scene.root_pmax
    walk_min, walk_max = _walk_box(scene)
    cells = _use_cells(scene)
    single = scene.instances.count == 1
    emissive = scene.atlas.has_emission
    vdepth = params.volume_depth

    def W(m, new, old):
        if old.dim() == 2:
            m = m[..., None]
        return torch.where(m, new, old)

    def march_init(pos, dirn):
        hit, t_in, t_out = aabb_intersect(walk_min, walk_max, pos, dirn)
        t_box = torch.where(hit, torch.clamp(t_out, min=0.0), 0.0)
        inside = aabb_contains(walk_min, walk_max, pos)
        skip0 = torch.where(hit & ~inside, torch.clamp(t_in, min=0.0), 0.0)
        sph_hit, t_sph = _sphere_block(scene, pos, dirn)
        dist = torch.where(sph_hit & (t_sph < t_box), t_sph, t_box)
        return dist, torch.minimum(skip0, dist)

    def shadow_init(start, w):
        inside = aabb_contains(root_min, root_max, start)
        hit, t_entry, _ = aabb_intersect(root_min, root_max, start, w)
        miss = ~inside & ~hit
        spos = W(~inside & hit, start + w * (t_entry + EPS)[..., None],
                 start)
        _, _, dist = aabb_intersect(root_min, root_max, spos, w)
        dist = torch.clamp(dist, min=0.0)
        sph_hit, _ = _sphere_block(scene, spos, w)
        tr0 = torch.exp(-sigma_c * dist)
        tr0 = torch.where(miss, 1.0, torch.where(sph_hit, 0.0, tr0))
        dist = torch.where(miss | sph_hit, 0.0, dist)
        return spos, dist, tr0

    def cached_tr(tau, point, w):
        _, _, d = aabb_intersect(root_min, root_max, point, w)
        d = torch.clamp(d, min=0.0)
        sph_occ, _ = _sphere_block(scene, point, w)
        tr = torch.exp(-sigma_c * d - (tau - sigma_c * d) / params.tr_depth)
        return torch.where(sph_occ, 0.0, torch.clamp(tr, 0.0, 1.0))

    def sphere_event(u, pos, dirn, beta):
        sph = scene.sphere
        normal = normalize((pos - sph.center) / sph.radius)
        facing = dot(normal, dirn) < 0.0
        nl = W(facing, normal, -normal)
        phi = TWO_PI * u[:, 2]
        r2 = u[:, 3]
        r2s = torch.sqrt(r2)
        w = normalize(nl)
        pick = torch.abs(w[..., 0]) > 0.1
        y_axis = torch.tensor([0.0, 1.0, 0.0], device=dev)
        x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
        ref_axis = torch.where(pick[..., None], y_axis, x_axis)
        uax = normalize(cross(ref_axis, w))
        vax = cross(w, uax)
        hemi = normalize(
            uax * (torch.cos(phi) * r2s)[..., None]
            + vax * (torch.sin(phi) * r2s)[..., None]
            + w * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[..., None])
        mirror = reflect(dirn, nl)
        new_dir = mirror + (hemi - mirror) * sph.roughness
        anchor = pos + normal * EPS
        beta = beta * sph.color
        cos_l = torch.clamp(dot(sun_dir, normal), min=0.0)
        return anchor, new_dir, beta, k["sun_cs"] * cos_l[..., None]

    def seek_block(s, u):
        seeking = s["phase"] == P_SEEK
        pos, dirn = s["pos"], s["dirn"]
        hit1, t1, _ = aabb_intersect(root_min, root_max, pos, dirn)
        hit2, t2 = _sphere_block(scene, pos, dirn)
        entry = pos + dirn * (t1 + EPS)[..., None]
        m_dist, m_skip = march_init(entry, dirn)
        hit1_eff = hit1 & (m_dist > 0.0)
        obj = torch.where(hit1_eff & (~hit2 | (t1 < t2)), 1,
                          torch.where(hit2, 2, 0))
        budget_ok = s["depth_n"] < params.ray_depth
        go_done = seeking & ((obj == 0) | ~budget_ok)
        go_march = seeking & (obj == 1) & budget_ok
        go_sphere = seeking & (obj == 2) & budget_ok
        s["phase"] = torch.where(go_done, P_DONE, s["phase"])

        s["pos"] = W(go_march, entry, s["pos"])
        s["dist"] = W(go_march, m_dist, s["dist"])
        for f in ("t", "tbox"):
            s[f] = W(go_march, 0.0, s[f])
        s["skip"] = W(go_march, m_skip, s["skip"])
        s["phase"] = W(go_march, P_MARCH, s["phase"])
        s["vd"] = W(go_march, 0, s["vd"])
        s["depth_n"] = s["depth_n"] + go_march.to(torch.int32)

        sp_hit_pos = pos + dirn * t2[..., None]
        s_anchor, s_dir, s_beta, s_contrib = sphere_event(
            u, sp_hit_pos, dirn, s["beta"])
        s["depth_aov"] = W(go_sphere & (s["depth_aov"] == 0.0), t2,
                           s["depth_aov"])
        s["anchor"] = W(go_sphere, s_anchor, s["anchor"])
        s["sdir"] = W(go_sphere, s_dir, s["sdir"])
        s["beta"] = W(go_sphere, s_beta, s["beta"])
        s["env_pos"] = W(go_sphere, s_anchor, s["env_pos"])
        s["contrib"] = W(go_sphere, s_contrib, s["contrib"])
        w_pos, w_dist, w_tr0 = shadow_init(s_anchor, sun_dir)
        s["pos"] = W(go_sphere, w_pos, s["pos"])
        s["dirn"] = W(go_sphere, sun_dir, s["dirn"])
        s["dist"] = W(go_sphere, w_dist, s["dist"])
        s["tr"] = W(go_sphere, w_tr0, s["tr"])
        for f in ("t", "skip", "tbox"):
            s[f] = W(go_sphere, 0.0, s[f])
        s["ascode"] = W(go_sphere, AS_SPHERE, s["ascode"])
        s["phase"] = W(go_sphere, P_SHADOW, s["phase"])
        s["depth_n"] = s["depth_n"] + go_sphere.to(torch.int32)

    def body(s, kstep):
        u = rng.uniform(kstep, (B, 5), dev)
        seek_block(s, u)
        marching = s["phase"] == P_MARCH
        shadowing = s["phase"] == P_SHADOW
        emitting = s["phase"] == P_EMIT
        walking = marching | shadowing | emitting
        # SHADOW jumps guaranteed-empty boxes, and EMIT on a single
        # instance, whose zero band is emission-free too (volume/grid.py::
        # _corner_pack's emit_zyx); an instanced scene's majorant cells
        # come from the density alone
        can_jump = (shadowing | emitting) if single else shadowing
        skip, tbox, t, dist = s["skip"], s["tbox"], s["t"], s["dist"]

        rate_inv = torch.where(marching, k["inv_rate_march"],
                               torch.where(shadowing, k["rate_inv_shadow"],
                                           k["rate_inv_emit"]))
        e_glob = -torch.log1p(-u[:, 0]) * rate_inv
        e_loc = -torch.log1p(-u[:, 4]) / torch.clamp(
            tbox * params.density_mult, min=1e-12)
        in_box = marching & (tbox > 0.0) & (e_loc <= skip)
        dt = torch.where(marching, torch.where(in_box, e_loc, skip + e_glob),
                         torch.where(can_jump,
                                     torch.where(tbox <= 0.0, skip, 0.0)
                                     + e_glob, e_glob))
        t_new = torch.where(walking, t + dt, t)
        exited = walking & (t_new >= dist)
        cursor = s["pos"] + s["dirn"] * t_new[..., None]

        if cells:
            fr = FetchResult(*_cells_banded_fetch(scene, cursor, s["dirn"],
                                                  with_tau=cached))
        elif not single:
            fr = FetchResult(*_loop_banded_fetch(scene, cursor, s["dirn"]),
                             world_tau_fetch(scene, cursor) if cached
                             else None)
        else:
            fr = unified_fetch_full(scene, params, cursor, s["dirn"],
                                    with_tau=cached)
        density, s_new, tbox_new = fr.density, fr.s_box, fr.t_box
        t_old = tbox
        s["skip"] = torch.where(walking, torch.where(exited, 0.0, s_new),
                                skip)
        s["tbox"] = torch.where(walking,
                                torch.where(exited, 0.0, tbox_new), tbox)
        s["t"] = torch.where(walking & ~exited, t_new, t)
        sampled = walking & ~exited
        # an empty box covering the rest of the walk ends it, but an EMIT
        # walk's only where it may jump (can_jump)
        covers = ((sampled if single else sampled & ~emitting)
                  & (tbox_new <= 0.0) & (s_new > 0.0)
                  & (t_new + s_new >= dist))

        bound = torch.where(in_box, t_old, sigma_max)
        m_sampled = sampled & marching
        s["alpha"] = s["alpha"] + torch.where(
            m_sampled, density * (sigma_max / bound), 0.0)
        accept = m_sampled & (density / bound > u[:, 1])
        # volume_depth > 1: only the walk's last medium event estimates
        # the lights and the emission; the others scatter and march on
        nee_now = accept & (s["vd"] >= vdepth - 1) if vdepth > 1 else accept

        s_sampled = sampled & shadowing
        factor = 1.0 - (density - sigma_c) / sigma_r
        s["tr"] = torch.where(s_sampled, s["tr"] * factor, s["tr"])
        tr_dead = shadowing & (torch.abs(s["tr"]) < EPS)
        if emissive:
            # L += emission, unscaled by beta (QUIRKS #5/#21)
            em = (_emission_lut(scene, params, fr.emission_raw,
                                fr.emission_valid) if single
                  else scene_emission(scene, cursor, params))
            s["L"] = s["L"] + torch.where((sampled & emitting)[..., None],
                                         em, 0.0)
        s["cost"] = s["cost"] + walking.to(torch.int32)

        lut = density_color_lut(scene, params, density)
        if single:
            cd = fr.color if fr.color is not None else 1.0
        else:
            cd = scene_color(scene, cursor) if scene.atlas.has_color else 1.0
        coll_val = (k["albedo"] * cd * lut / k["ext"]
                    * params.energy_inject)
        s["beta"] = W(accept, s["beta"] * coll_val, s["beta"])
        hg_dir, _ = phase_sample(params, s["dirn"],
                                 rng.fold_in(kstep, HG_FOLD))
        s["anchor"] = W(accept, cursor, s["anchor"])
        s["sdir"] = W(accept, hg_dir, s["sdir"])
        s["depth_aov"] = W(accept & (s["depth_aov"] == 0.0),
                           length(cursor - origin), s["depth_aov"])

        sdir, anchor = s["sdir"], s["anchor"]
        cos_sun = dot(sdir, sun_dir)
        sun_contrib = k["sun_cs"] * phase_eval(params, cos_sun)[..., None]
        if cached:
            taus = fr.tau
            nee = sun_contrib * cached_tr(taus[..., 0], cursor,
                                          sun_dir)[..., None]
            pt_w = n_pt_walks / max(n_lights, 1)
            for i in range(n_lights):
                lp = scene.lights.pos[i]
                wi = normalize(lp - cursor)
                cos_pt = dot(sdir, wi)
                if params.reference_falloff:  # QUIRKS #2
                    sqr = length(lp * lp - cursor * cursor)
                else:
                    sqr = dot(lp - cursor, lp - cursor)
                falloff = 1.0 / torch.clamp(sqr, min=1e-12)
                pt_contrib = scene.lights.color[i] * (
                    scene.lights.power[i] * phase_eval(params, cos_pt)
                    * falloff * pt_w)[..., None]
                nee = nee + pt_contrib * cached_tr(taus[..., 1 + i], cursor,
                                                   wi)[..., None]
            s["L"] = s["L"] + torch.where(nee_now[..., None],
                                         nee * s["beta"], 0.0)
        else:
            s["nshadow"] = W(nee_now, n_pt_walks, s["nshadow"])
            w_pos, w_dist, w_tr0 = shadow_init(anchor, sun_dir)
            s["pos"] = W(nee_now, w_pos, s["pos"])
            s["dirn"] = W(nee_now, sun_dir, s["dirn"])
            s["dist"] = W(nee_now, w_dist, s["dist"])
            s["tr"] = W(nee_now, w_tr0, s["tr"])
            for f in ("t", "skip", "tbox"):
                s[f] = W(nee_now, 0.0, s[f])
            s["contrib"] = W(nee_now, sun_contrib, s["contrib"])
            s["ascode"] = W(nee_now, AS_SUN, s["ascode"])
            s["phase"] = W(nee_now, P_SHADOW, s["phase"])

        if vdepth > 1:
            # an event before the last: restart the primary walk from the
            # collision along the scattered direction
            more = accept & ~nee_now
            vm_dist, _ = march_init(cursor, hg_dir)
            s["pos"] = W(more, cursor, s["pos"])
            s["dirn"] = W(more, hg_dir, s["dirn"])
            s["dist"] = W(more, vm_dist, s["dist"])
            for f in ("t", "skip", "tbox"):
                s[f] = W(more, 0.0, s[f])
            s["vd"] = W(more, s["vd"] + 1, s["vd"])

        # primary walk exit without interaction: DONE unless the sphere
        # lies ahead (QUIRKS #19: the box is never re-entered)
        m_exit = (exited | (covers & ~accept)) & marching
        exit_pos = s["pos"] + s["dirn"] * s["t"][..., None]
        sph_ahead, _ = _sphere_block(scene, exit_pos, s["dirn"])
        s["pos"] = W(m_exit, exit_pos, s["pos"])
        s["phase"] = W(m_exit, torch.where(sph_ahead, P_SEEK, P_DONE),
                       s["phase"])

        s_end = shadowing & (exited | tr_dead | covers) & ~accept
        tr_fin = torch.clamp(s["tr"], 0.0, 1.0)
        s["L"] = s["L"] + torch.where(
            s_end[..., None], s["contrib"] * tr_fin[..., None] * s["beta"],
            0.0)
        start_pt = s_end & (s["nshadow"] > 0)
        walks_done = s_end & ~start_pt
        if n_lights > 0:
            idx = torch.clamp((u[:, 2] * n_lights).to(torch.int64),
                              max=n_lights - 1)
            lpos = scene.lights.pos[idx]
            lcol = scene.lights.color[idx]
            lpow = scene.lights.power[idx]
            wi = normalize(lpos - anchor)
            cos_pt = dot(sdir, wi)
            if params.reference_falloff:
                sqr = length(lpos * lpos - anchor * anchor)
            else:
                sqr = dot(lpos - anchor, lpos - anchor)
            falloff = 1.0 / torch.clamp(sqr, min=1e-12)
            pt_contrib = lcol * (lpow * phase_eval(params, cos_pt)
                                 * falloff)[..., None]
            w_pos, w_dist, w_tr0 = shadow_init(anchor, wi)
            s["pos"] = W(start_pt, w_pos, s["pos"])
            s["dirn"] = W(start_pt, wi, s["dirn"])
            s["dist"] = W(start_pt, w_dist, s["dist"])
            s["tr"] = W(start_pt, w_tr0, s["tr"])
            for f in ("t", "skip", "tbox"):
                s[f] = W(start_pt, 0.0, s[f])
            s["contrib"] = W(start_pt, pt_contrib, s["contrib"])
            s["nshadow"] = W(start_pt, s["nshadow"] - 1, s["nshadow"])
            s["ascode"] = W(start_pt, AS_PT, s["ascode"])

        # all shadow walks done -> the emission walk from the collision
        # point along the scattered direction, on an emissive scene; else
        # resume the path, classified here (the scattered segment can
        # only end at the sphere or the environment)
        resume = walks_done & (s["ascode"] != AS_SPHERE)
        if cached:
            resume = resume | nee_now
        resume_seek = walks_done & (s["ascode"] == AS_SPHERE)
        sph_res, _ = _sphere_block(scene, anchor, sdir)
        s["pos"] = W(resume, anchor, s["pos"])
        s["dirn"] = W(resume, sdir, s["dirn"])
        if emissive:
            _, _, e_dist = aabb_intersect(walk_min, walk_max, anchor, sdir)
            s["dist"] = W(resume, torch.clamp(e_dist, min=0.0), s["dist"])
            for f in ("t", "skip", "tbox"):
                s[f] = W(resume, 0.0, s[f])
            s["phase"] = W(resume, P_EMIT, s["phase"])
        else:
            s["phase"] = W(resume, torch.where(sph_res, P_SEEK, P_DONE),
                           s["phase"])
        s["pos"] = W(resume_seek, anchor, s["pos"])
        s["dirn"] = W(resume_seek, sdir, s["dirn"])
        s["phase"] = W(resume_seek, P_SEEK, s["phase"])

        # EMIT walk end: out of the box, or in an empty box that covers
        # the rest of the walk
        e_end = emitting & (exited | covers)
        s["pos"] = W(e_end, anchor, s["pos"])
        s["dirn"] = W(e_end, sdir, s["dirn"])
        s["phase"] = W(e_end, torch.where(sph_res, P_SEEK, P_DONE),
                       s["phase"])

    zf = torch.zeros(B, dtype=torch.float32, device=dev)
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    s = dict(pos=origin, dirn=direction, anchor=origin, sdir=direction,
             env_pos=origin, beta=torch.ones_like(origin),
             L=torch.zeros_like(origin), alpha=zf, tr=torch.ones_like(zf),
             contrib=torch.zeros_like(origin), dist=zf, t=zf, skip=zf,
             tbox=zf, phase=torch.full((B,), P_SEEK, dtype=torch.int32, device=dev),
             ascode=zi, nshadow=zi, depth_n=zi, depth_aov=zf, cost=zi,
             vd=zi)
    k0 = rng.fold_in(key, SEEK_FOLD)
    seek_block(s, rng.uniform(k0, (B, 5), dev))
    for step in range(params.max_fused_steps * queue):
        if not bool((s["phase"] != P_DONE).any()):
            break
        body(s, rng.fold_in(key, step))

    L, beta, dirn, env_pos = s["L"], s["beta"], s["dirn"], s["env_pos"]
    alpha = torch.clamp(s["alpha"], max=1.0)
    cost, depth = s["cost"].to(torch.float32), s["depth_aov"]
    cut = s["phase"] != P_DONE
    if queue > 1:
        # the reference's unretired slots: outputs 0, and the
        # environment term on beta 0 in the slot's primary direction
        L, beta = W(cut, 0.0, L), W(cut, 0.0, beta)
        dirn, env_pos = W(cut, direction, dirn), W(cut, origin, env_pos)
        alpha, cost, depth = (torch.where(cut, 0.0, x)
                              for x in (alpha, cost, depth))
    if deferred:
        return (L, alpha, cost, cut.to(torch.float32), depth, beta, dirn,
                env_pos)
    L = L + environment_radiance(scene, params, env_pos, dirn) * beta
    return L, alpha, cost, cut.to(torch.float32), depth


def warp_efficiency(cost, warp: int = 32) -> float:
    """Share of lane-steps that do work when rays run in launch order,
    ``warp`` at a time, each group holding all its lanes until its
    longest ray ends: sum(cost) / sum(warp * max cost of the group).  A
    tail group shorter than ``warp`` still holds ``warp`` lanes.  1.0
    when no ray takes a step."""
    c = cost.reshape(-1).to(torch.float64)
    pad = (-c.numel()) % warp
    if pad:
        c = torch.cat([c, c.new_zeros(pad)])
    held = float(c.reshape(-1, warp).amax(1).sum()) * warp
    return float(c.sum()) / held if held > 0 else 1.0


def launch_info(rays_in_kernel: bool, max_fused_steps: int,
                defer_env: bool = False, ext: bool = False,
                cells: bool = False, rows: int = cuda.ROWS_F32,
                loop: bool = False) -> dict:
    """K1's schedule on the current card for one route at
    ``max_fused_steps`` (which sizes the key cache, whatever the queue),
    for BLACK/CONSTANT or (``defer_env`` 1) HDRI and the skies or (2) the
    live Bruneton atmosphere, with env_pos, density-only
    or (``ext``) emission, color or volume_depth > 1, on a single grid or
    (``cells``) an instanced scene with cell lists, or without them
    (``cells`` and ``loop``), for corner rows of ``rows``
    (ops/cuda.py::row_kind),
    from the CUDA runtime: SMs, resident blocks per SM,
    threads per block, registers and local bytes per thread, dynamic
    shared bytes per block.  The grid is SMs x blocks per SM blocks
    (fewer for a small frame)."""
    info = (ctypes.c_int * 6)()
    variant = 2 * int(cells) + 2 * int(cells and loop) + int(ext)
    cuda.check_status(cuda.load_library().dll.vpt_fused_launch_info(
        int(rays_in_kernel), int(defer_env), variant, rows, max_fused_steps,
        info), "fused_direct launch info")
    return dict(zip(("sms", "blocks_per_sm", "threads", "registers",
                     "local_bytes", "shared_bytes"), info))


class _FusedParams(ctypes.Structure):
    """Mirror of ``FusedParams`` in csrc/fused_direct.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "max_steps", "ray_depth", "n_lights", "n_pt_walks", "cached",
        "reference_falloff", "use_double_hg", "env_constant", "row_w",
        "tau_off", "grid_off", "refill_min", "tile_w", "tile_h",
        "frame_w")] + [
        ("dim", ctypes.c_int * 3), ("key", ctypes.c_uint * 2)] + [
        (n, ctypes.c_float) for n in (
            "sigma_max", "sigma_c", "sigma_r", "inv_rate_march",
            "rate_inv_shadow", "density_mult", "tr_depth", "pt_w",
            "emission_pivot", "energy_inject", "g1", "g2", "phase_f",
            "sph_radius", "sph_rough")] + [
        (n, ctypes.c_float * 3) for n in (
            "albedo", "ext", "sun_dir", "sun_cs", "sky", "root_min",
            "root_max", "walk_min", "walk_max", "gbmin", "gdim",
            "sph_center", "sph_color")] + [
        ("inv_xf", ctypes.c_float * 12)] + [
        (n, ctypes.c_int) for n in ("sph_enabled", "key_steps", "queued",
                                    "defer_env")]


class _ExtParams(ctypes.Structure):
    """Mirror of ``ExtParams`` in csrc/fused_direct.cu: what only K1's EXT
    variant reads."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "em_off", "col_off", "volume_depth")] + [
        (n, ctypes.c_float) for n in ("emission_scale", "rate_inv_emit")]


class _CellParams(ctypes.Structure):
    """Mirror of ``CellParams`` in csrc/fused_direct.cu: the cell table
    of an instanced scene, which only K1's CELLS variant reads."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("rows", "inst", "wtau")] + [
        (n, ctypes.c_int) for n in ("R", "row_w", "ids_off", "k", "octant",
                                    "loop")] + [
        ("wdim", ctypes.c_int * 3), ("cs", ctypes.c_float * 3),
        ("wcell", ctypes.c_float)]


def _f3(t):
    return (ctypes.c_float * 3)(*t.detach().cpu().reshape(3).tolist())


@dataclass
class FusedLaunch:
    """K1's launch arguments for one (scene, params), built once: a
    launch then reads nothing back from the card, so the host queues the
    next sample while the card runs this one.  ``next_ray`` is K1's ray
    counter, zeroed by each launch on its stream: launches that share a
    FusedLaunch must share a stream."""

    params: _FusedParams
    corners: torch.Tensor
    lights: torch.Tensor
    lut: torch.Tensor        # (512, 3): density color LUT, emission LUT
    next_ray: torch.Tensor
    env: EnvLaunch | None = None   # K4's, for a deferred environment
    # the EXT variant's arguments; by default a density-only scene's
    ext: _ExtParams = field(
        default_factory=lambda: _ExtParams(-1, -1, 1, 0.0, 0.0))
    # the CELLS variant's, on an instanced scene (its tables in `tables`)
    cells: _CellParams | None = None
    tables: tuple = ()
    # the corner rows' element type and octant columns (ops/cuda.py::
    # row_kind), which pick K1's instances
    rows: int = cuda.ROWS_F32


def prepare_fused(scene, params) -> FusedLaunch:
    """Check the scene and fill K1's parameter struct (syncs once)."""
    _check_scene(scene, params)
    dev = scene.device
    corners = scene.atlas.density_corners
    cuda.check_cuda_tensor(corners, "density_corners",
                           dtype={torch.float32, torch.bfloat16})
    for name in ("density_color_lut", "emission_lut"):
        cuda.check_cuda_tensor(getattr(scene, name), name, (256, 3),
                               torch.float32, dev)
    lut = torch.cat([scene.density_color_lut, scene.emission_lut])
    n_lights = scene.lights.count
    lights = torch.cat([scene.lights.pos, scene.lights.color,
                        scene.lights.power[:, None]], dim=1)
    lights = (lights if n_lights else torch.zeros((1, 7), device=dev))
    lights = lights.to(device=dev, dtype=torch.float32).contiguous()
    cuda.check_struct(_FusedParams,
                      cuda.load_library().dll.vpt_fused_params_size)
    cuda.check_struct(_ExtParams, cuda.load_library().dll.vpt_fused_ext_size)
    cuda.check_struct(_CellParams,
                      cuda.load_library().dll.vpt_fused_cells_size)

    k = _constants(scene, params, dev)
    row = scene.instances.packed_rows[0].cpu()
    sph = scene.sphere
    p = _FusedParams()
    # the step budget is set per launch (_launch_args); the keys of the
    # first max_fused_steps steps (at most K1's KEY_CACHE) are cached
    p.max_steps = p.key_steps = params.max_fused_steps
    p.ray_depth = params.ray_depth
    p.n_lights = n_lights
    p.n_pt_walks = min(n_lights, 11)
    p.cached = int(params.shadow_mode == "cached")
    p.reference_falloff = int(params.reference_falloff)
    p.use_double_hg = int(params.use_double_hg)
    p.env_constant = int(params.environment_type
                         == int(Environment.CONSTANT))
    defer = defers_environment(scene, params)
    p.defer_env = 2 if needs_env_pos(scene, params) else int(defer)
    p.row_w = corners.shape[1]
    x = _ExtParams()
    x.em_off, x.col_off, p.tau_off = unified_layout(scene.atlas)
    x.volume_depth = params.volume_depth
    x.emission_scale = params.emission_scale
    x.rate_inv_emit = float(k["rate_inv_emit"])
    p.grid_off = int(row[18])
    for name, v in SCHEDULE[params.shadow_mode].items():
        setattr(p, name, v)
    p.dim = (ctypes.c_int * 3)(*[int(v) for v in row[15:18].tolist()])
    for name in ("sigma_max", "sigma_c", "sigma_r", "inv_rate_march",
                 "rate_inv_shadow"):
        setattr(p, name, float(k[name]))
    p.density_mult = params.density_mult
    p.tr_depth = params.tr_depth
    p.pt_w = min(n_lights, 11) / max(n_lights, 1)
    p.emission_pivot = params.emission_pivot
    p.energy_inject = params.energy_inject
    p.g1, p.g2, p.phase_f = params.phase_g1, params.phase_g2, params.phase_f
    for name in ("albedo", "ext", "sun_dir", "sun_cs", "sky"):
        setattr(p, name, _f3(k[name]))
    p.root_min, p.root_max = _f3(scene.root_pmin), _f3(scene.root_pmax)
    p.gbmin, p.gdim = _f3(row[12:15]), _f3(row[15:18])
    p.inv_xf = (ctypes.c_float * 12)(
        *scene.instances.inv_xform[0, :, :3].cpu().reshape(12).tolist())
    p.sph_center, p.sph_color = _f3(sph.center), _f3(sph.color)
    p.sph_radius = float(sph.radius)
    p.sph_rough = float(sph.roughness)
    p.sph_enabled = int(bool(sph.enabled))
    walk_min, walk_max = _walk_box(scene)
    p.walk_min, p.walk_max = _f3(walk_min), _f3(walk_max)
    cells, tables = None, ()
    if scene.instances.count != 1:
        cells, tables = _cell_params(scene, p.cached)
        # the taus of an instanced scene follow the ids in the cell rows,
        # or start the world tau grid's rows in loop mode
        p.tau_off = 0 if cells.loop else cells.ids_off + cells.k
        if (p.cached and not cells.loop
                and cells.row_w < p.tau_off + 8 * (1 + n_lights)):
            raise ValueError("cell rows carry no shadow cache")
    elif p.cached and p.row_w < p.tau_off + 8 * (1 + n_lights):
        raise ValueError("corner rows carry no shadow cache")
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    env = prepare_environment(scene, params) if defer else None
    return FusedLaunch(p, corners, lights, lut, next_ray, env, x, cells,
                       tables, cuda.row_kind(corners.dtype,
                                             scene.atlas.octant_cols))


def _cell_params(scene, cached: bool):
    """(CellParams, the tables it points at) of an instanced scene: its
    cell rows, or in loop mode its packed rows and, in cached mode, its
    world tau grid."""
    dev = scene.device
    loop = not _use_cells(scene)
    rows = scene.majorant.packed if loop else scene.majorant.cell_rows
    inst = scene.instances.packed_rows
    cuda.check_cuda_tensor(rows, "majorant rows", dtype=torch.float32,
                           device=dev)
    cuda.check_cuda_tensor(inst, "packed_rows", (scene.instances.count, 24),
                           torch.float32, dev)
    ids_off, k = ((rows.shape[1], scene.instances.count) if loop
                  else cell_layout(scene)[:2])
    c = _CellParams(rows.data_ptr(), inst.data_ptr(), None,
                    scene.majorant.resolution, rows.shape[1], ids_off, k,
                    int(ids_off >= 79), int(loop))
    c.cs = _f3(cell_size(scene))
    tables = (rows, inst)
    if loop and cached:
        wt = scene.world_tau
        cuda.check_cuda_tensor(wt, "world_tau", dtype=torch.float32,
                               device=dev)
        c.wtau = wt.data_ptr()
        c.wdim = (ctypes.c_int * 3)(wt.shape[2], wt.shape[1], wt.shape[0])
        c.wcell = float(world_tau_cell(scene))
        tables += (wt,)
    return c, tables


def extended(x: _ExtParams) -> bool:
    """K1's EXT variant runs the launch (fused_direct.cu::extended)."""
    return x.em_off >= 0 or x.col_off >= 0 or x.volume_depth > 1


def _launch_args(launch: FusedLaunch, B: int, key, frame_width, queue=1):
    """This launch's parameter struct and its output buffer: 7 S floats,
    S = B rounded up to a multiple of 4, holding L (B, 3) at 0 and alpha,
    cost, unfinished and depth at 3 S .. 6 S, returned as contiguous
    views that each start 16-byte aligned, as K3 takes them; with a
    deferred environment 13 S, beta (B, 3) at 7 S and the direction
    (B, 3) at 10 S, K4's inputs, and for the live atmosphere 16 S, env_pos
    (B, 3) at 13 S.  Rays of no known frame
    (``frame_width`` None) are scheduled in ray order."""
    p = _FusedParams.from_buffer_copy(launch.params)
    p.B = B
    p.max_steps = p.key_steps * queue
    p.queued = int(queue > 1)
    if frame_width is None:
        p.tile_w = p.tile_h = 0
    p.frame_w = frame_width or B
    p.key[0], p.key[1] = int(key[0]), int(key[1])
    return (p,) + out_buffer(B, p.defer_env, launch.corners.device)


def out_buffer(B: int, defer_env: int, device):
    """(out, views): the output buffer of K1 and K5 for B rays, 7, 13 or
    16 S floats for defer_env 0, 1 or 2 (S = B rounded up to a multiple
    of 4), and its views (L, alpha, cost, unfinished, depth[, beta,
    direction[, env_pos]]), each starting 16-byte aligned."""
    S = -(-B // 4) * 4
    n_s = (7, 13, 16)[defer_env]
    out = torch.empty(n_s * S, dtype=torch.float32, device=device)
    views = (out[:3 * B].view(B, 3),) + tuple(
        out[i * S:i * S + B] for i in range(3, 7))
    views += tuple(out[i * S:i * S + 3 * B].view(B, 3)
                   for i in range(7, n_s, 3))
    return out, views


def _finish(scene, params, launch: FusedLaunch, views):
    """K1's five outputs, after K4 has added the environment for a
    deferred one (in place on L)."""
    if launch.env is not None:
        L, beta, dirn = views[0], views[5], views[6]
        pos = views[7] if len(views) > 7 else None
        add_environment(scene, params, L, beta, dirn, pos, launch=launch.env)
    return views[:5]


def _fused_direct_cuda(scene, params, key, origin, direction,
                       launch: FusedLaunch | None = None, frame_width=None,
                       queue: int = 1):
    """Launch K1 on the rays in ``origin`` and ``direction`` on the
    current stream, and K4 after it for a deferred environment
    (``launch`` from prepare_fused for this scene and params, or None to
    prepare it here).  ``frame_width``: the rays are a frame of that many
    columns, to be scheduled by tiles as the in-kernel-ray route
    schedules them.  ``queue`` as in fused_direct."""
    if launch is None:
        launch = prepare_fused(scene, params)
    return _finish(scene, params, launch, _launch_k1(
        launch, key, origin, direction, frame_width, queue))


def _launch_k1(launch: FusedLaunch, key, origin, direction,
               frame_width=None, queue: int = 1):
    """K1 alone on the buffer route: its output views (_launch_args),
    beta, the direction and env_pos included for a deferred
    environment."""
    dev = launch.corners.device
    B = origin.shape[0]
    cuda.check_cuda_tensor(origin, "origin", (B, 3), torch.float32, dev)
    cuda.check_cuda_tensor(direction, "direction", (B, 3), torch.float32,
                           dev)
    p, out, views = _launch_args(launch, B, key, frame_width, queue)
    rc = cuda.load_library().dll.vpt_fused_direct(
        ctypes.byref(p), ctypes.byref(launch.ext), _cells_arg(launch),
        launch.rows, origin.data_ptr(),
        direction.data_ptr(), launch.corners.data_ptr(),
        launch.lights.data_ptr(), launch.lut.data_ptr(), out.data_ptr(),
        launch.next_ray.data_ptr(), cuda.current_stream(dev))
    cuda.check_status(rc, "fused_direct")
    FUSED_DIRECT.launches += 1
    _count_variants(launch)
    return views


def rows_kernel(scene):
    """The counter of K1's instances that a single grid's rows take beside
    the route's own: FUSED_DIRECT_BF16 for bfloat16 rows,
    FUSED_DIRECT_OCTANT for float32 rows with octant columns; None for
    float32 rows without them."""
    return _ROWS_KERNEL.get(cuda.row_kind(scene.atlas.density_corners.dtype,
                                          scene.atlas.octant_cols))


def _count_variants(launch: FusedLaunch):
    """One launch of K1 on either route, on the counters of the variant
    and the rows' instances it ran."""
    FUSED_DIRECT_EXT.launches += extended(launch.ext)
    if launch.cells is not None:
        if launch.cells.loop:
            FUSED_DIRECT_LOOP.launches += 1
        else:
            FUSED_DIRECT_CELLS.launches += 1
        FUSED_DIRECT_CELLS_EXT.launches += extended(launch.ext)
    if launch.rows in _ROWS_KERNEL:
        _ROWS_KERNEL[launch.rows].launches += 1


def _cells_arg(launch: FusedLaunch):
    """K1's cell-table argument: the CELLS variant's struct, or null."""
    return None if launch.cells is None else ctypes.byref(launch.cells)


def _fused_direct_primary_cuda(scene, params, key, raygen,
                               launch: FusedLaunch | None = None,
                               queue: int = 1):
    """Launch K1 on its in-kernel-ray route: each lane makes its primary
    ray from ``raygen`` (render/renderer.py::_RaygenParams with the
    sample's keys set; B = H * W rays in pixel order), so no ray buffer
    exists; K4 after it for a deferred environment.  Same outputs as
    fused_direct on K2's rays."""
    if launch is None:
        launch = prepare_fused(scene, params)
    return _finish(scene, params, launch,
                   _launch_k1_primary(launch, key, raygen, queue))


def _launch_k1_primary(launch: FusedLaunch, key, raygen, queue: int = 1):
    """K1 alone on the in-kernel-ray route: its output views, as
    _launch_k1's."""
    p, out, views = _launch_args(launch, raygen.H * raygen.W, key,
                                 raygen.W, queue)
    rc = cuda.load_library().dll.vpt_fused_direct_primary(
        ctypes.byref(p), ctypes.byref(launch.ext), _cells_arg(launch),
        launch.rows, ctypes.byref(raygen),
        launch.corners.data_ptr(), launch.lights.data_ptr(),
        launch.lut.data_ptr(), out.data_ptr(), launch.next_ray.data_ptr(),
        cuda.current_stream(launch.corners.device))
    cuda.check_status(rc, "fused_direct_primary")
    FUSED_DIRECT_PRIMARY.launches += 1
    _count_variants(launch)
    return views
