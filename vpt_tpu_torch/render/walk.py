"""Kernel K5 (csrc/walk.cu): the reference engine's walks on the card.

``walk_direct`` runs render/integrator.py::direct_integrator and
``walk_volumetric`` render/vol_integrator.py::vol_integrator on CUDA
rays, one thread a ray; their plain versions are
``direct_integrator_plain`` and ``vol_integrator_plain``.  K5 writes L,
alpha, cost, trunc (0) and depth as K1 lays them out
(render/fused.py::out_buffer), adds BLACK and CONSTANT itself, and for
the simple sky, HDRI with a map and the Bruneton atmosphere hands each
ray's beta, direction (and for the live atmosphere env_pos) to K4
(render/integrator.py::add_environment), launched after it.

With ``tile`` > 0 one launch takes the reference's tiles of ``tile``
rays (vpt_tpu/render/renderer.py:186-215, :276-281), each ray drawing
under fold_in(key, 1000 + its tile) at its index in the tile: the
renderer's route (render/renderer.py::_trace_walks) with fused_tile.

On the card K5 takes single-grid scenes in float32 corner rows without
octant columns, density-only or EXT (emission, color, volume_depth > 1).
Everything else raises NotImplementedError before any launch
(``check_walk_scene``), naming its ROADMAP item; nothing falls back to a
plain version on the card.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from vpt_tpu_torch.core.vecmath import degree_to_cartesian
from vpt_tpu_torch.ops import cuda
from vpt_tpu_torch.render.fused import out_buffer
from vpt_tpu_torch.render.integrator import (EnvLaunch, _c3, _EnvParams,
                                             _f, add_environment,
                                             defers_environment,
                                             needs_env_pos,
                                             prepare_environment)
from vpt_tpu_torch.render.nee import LIGHT_BUDGET, uses_env_cdf
from vpt_tpu_torch.render.params import Environment, check_slice
from vpt_tpu_torch.render.tracking import _over, vec3_param
from vpt_tpu_torch.volume.grid import unified_layout

WALK_DIRECT = cuda.Kernel(
    name="walk_direct", route="cuda", source="vpt_tpu_torch/csrc/walk.cu",
    replaces="vpt_tpu/render/integrator.py:102")
WALK_VOLUMETRIC = cuda.Kernel(
    name="walk_volumetric", route="cuda",
    source="vpt_tpu_torch/csrc/walk.cu",
    replaces="vpt_tpu/render/vol_integrator.py:46")
# the sky next-event estimate's environment (walk.cu's NEE_*)
NEE_BLACK, NEE_CONSTANT, NEE_HDRI, NEE_SKY = range(4)
INSTANCED_ITEM = ("ROADMAP A.8, K5 on instanced scenes and on bfloat16 "
                  "rows and octant columns")
ATMOSPHERE_NEE_ITEM = ("ROADMAP A.8, walk_volumetric's sky NEE under the "
                       "Bruneton atmosphere")


class _WalkParams(ctypes.Structure):
    """Mirror of ``WalkParams`` in csrc/walk.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "tile", "ray_depth", "volume_depth", "max_steps", "n_lights",
        "n_pt_walks", "reference_falloff", "use_double_hg", "defer_env",
        "env_constant", "nee_env", "use_cdf", "cdf_h", "cdf_w", "row_w",
        "em_off", "col_off", "grid_off", "sph_enabled")] + [
        ("dim", ctypes.c_int * 3), ("key", ctypes.c_uint * 2)] + [
        (n, ctypes.c_float) for n in (
            "max_ext", "inv_rate", "sigma_c", "sigma_r", "rate_inv_tr",
            "rate_inv_emit", "emission_pivot", "emission_scale",
            "energy_inject", "g1", "g2", "phase_f", "sph_radius",
            "sph_rough", "sun_mult", "sky_mult", "marginal_int")] + [
        (n, ctypes.c_float * 3) for n in (
            "albedo", "ext", "sun_dir", "sun_color", "sky_color", "sky",
            "root_min", "root_max", "gbmin", "gdim", "sph_center",
            "sph_color")] + [
        ("inv_xf", ctypes.c_float * 12)]


class _WalkTables(ctypes.Structure):
    """Mirror of ``WalkTables`` in csrc/walk.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "corners", "lights", "lut", "map", "cdf_func", "cdf", "m_func",
        "m_cdf")]


@dataclass
class WalkLaunch:
    """K5's launch arguments for one (scene, params), built once."""

    volumetric: bool
    ext: bool
    params: _WalkParams
    env: _EnvParams
    tables: _WalkTables
    tensors: tuple                  # what the tables point at
    k4: EnvLaunch | None = None     # K4's, for a deferred environment


def check_walk_scene(scene, params, volumetric: bool) -> None:
    """Raise before any launch for what K5 does not take on the card:
    instanced scenes, bfloat16 rows, octant columns, and the volumetric
    integrator's sky estimate under the Bruneton atmosphere."""
    check_slice(params)
    if scene.instances.count != 1:
        raise NotImplementedError(
            f"K5 on an instanced scene ({INSTANCED_ITEM})")
    if (scene.atlas.density_corners.dtype != torch.float32
            or scene.atlas.octant_cols):
        raise NotImplementedError("K5 on bfloat16 corner rows or octant "
                                  f"columns ({INSTANCED_ITEM})")
    if (volumetric and params.environment_type == int(Environment.ATMOSPHERE)
            and getattr(scene, "atmosphere", None) is not None):
        raise NotImplementedError(f"the sky NEE with a Bruneton atmosphere "
                                  f"({ATMOSPHERE_NEE_ITEM})")


def _nee_env(scene, params) -> int:
    et = params.environment_type
    if et == int(Environment.CONSTANT):
        return NEE_CONSTANT
    if et == int(Environment.HDRI):
        return NEE_HDRI if scene.env_map is not None else NEE_BLACK
    if et == int(Environment.ATMOSPHERE):
        return NEE_SKY
    return NEE_BLACK


def _walk_env(scene, params) -> _EnvParams:
    """The environment the sky estimate reads: the simple sky's constants
    (sky/procedural.py::sky_constants) with the sun and sky_color, the
    map's size and its uv constants (as render/integrator.py::
    prepare_environment fills K4's)."""
    from vpt_tpu_torch.sky.procedural import sky_constants
    e = _EnvParams()
    e.sun = _c3(degree_to_cartesian(params.azimuth, params.elevation,
                                    "cpu").tolist())
    e.color = _c3(vec3_param(params.sky_color).tolist())
    e.mult, e.u_scale, e.pi = 1.0, 0.5 / math.pi, math.pi
    if scene.env_map is not None:
        e.map_h, e.map_w = scene.env_map.shape[0], scene.env_map.shape[1]
    for name, v in sky_constants().items():
        setattr(e, name, _c3(v) if isinstance(v, list) else v)
    return e


def prepare_walk(scene, params, volumetric: bool) -> WalkLaunch:
    """Check the scene (check_walk_scene) and fill K5's structs: every
    float32 constant the plain version computes, by its own torch
    expression on the scene's device."""
    check_walk_scene(scene, params, volumetric)
    lib = cuda.load_library().dll
    cuda.check_struct(_WalkParams, lib.vpt_walk_params_size)
    cuda.check_struct(_EnvParams, lib.vpt_walk_env_size)
    cuda.check_struct(_WalkTables, lib.vpt_walk_tables_size)
    dev = scene.device
    corners = scene.atlas.density_corners
    cuda.check_cuda_tensor(corners, "density_corners", dtype=torch.float32)
    for name in ("density_color_lut", "emission_lut"):
        cuda.check_cuda_tensor(getattr(scene, name), name, (256, 3),
                               torch.float32, dev)
    lut = torch.cat([scene.density_color_lut, scene.emission_lut])
    n_lights = scene.lights.count
    lights = (torch.cat([scene.lights.pos, scene.lights.color,
                         scene.lights.power[:, None]], dim=1) if n_lights
              else torch.zeros((1, 7), device=dev))
    lights = lights.to(device=dev, dtype=torch.float32).contiguous()

    p = _WalkParams()
    p.ray_depth = params.ray_depth
    p.volume_depth = params.volume_depth
    p.max_steps = params.max_track_steps
    p.n_lights, p.n_pt_walks = n_lights, min(n_lights, LIGHT_BUDGET)
    p.reference_falloff = int(params.reference_falloff)
    p.use_double_hg = int(params.use_double_hg)
    p.defer_env = (2 if needs_env_pos(scene, params)
                   else int(defers_environment(scene, params)))
    p.env_constant = int(params.environment_type
                         == int(Environment.CONSTANT))
    p.nee_env = _nee_env(scene, params)
    p.row_w = corners.shape[1]
    p.em_off, p.col_off, _ = unified_layout(scene.atlas)
    row = scene.instances.packed_rows[0].cpu()
    p.grid_off = int(row[18])
    p.dim = (ctypes.c_int * 3)(*[int(v) for v in row[15:18].tolist()])
    p.gbmin, p.gdim = _c3(row[12:15].tolist()), _c3(row[15:18].tolist())
    p.inv_xf = (ctypes.c_float * 12)(
        *scene.instances.inv_xform[0, :, :3].cpu().reshape(12).tolist())
    sph = scene.sphere
    p.sph_enabled = int(bool(sph.enabled))
    p.sph_center, p.sph_color = _c3(sph.center.tolist()), _c3(
        sph.color.tolist())
    p.sph_radius, p.sph_rough = _f(sph.radius), _f(sph.roughness)

    max_ext, min_ext = scene.max_extinction, scene.min_extinction
    ext = vec3_param(params.extinction, dev)
    sigma_r = torch.clamp(max_ext - min_ext, min=1e-12)
    p.max_ext, p.sigma_c, p.sigma_r = _f(max_ext), _f(min_ext), _f(sigma_r)
    p.inv_rate = _f(1.0 / torch.clamp(max_ext * params.density_mult,
                                      min=1e-12))
    p.rate_inv_tr = _f(_over(params.tr_depth, sigma_r))
    p.rate_inv_emit = _f(_over(params.tr_depth,
                               torch.clamp(max_ext * ext[0], min=1e-12)))
    for name in ("emission_pivot", "emission_scale", "energy_inject",
                 "sun_mult", "sky_mult"):
        setattr(p, name, getattr(params, name))
    p.g1, p.g2, p.phase_f = params.phase_g1, params.phase_g2, params.phase_f
    p.albedo = _c3(vec3_param(params.albedo).tolist())
    p.ext = _c3(ext.tolist())
    p.sun_color = _c3(vec3_param(params.sun_color).tolist())
    p.sky_color = _c3(vec3_param(params.sky_color).tolist())
    p.sky = _c3((vec3_param(params.sky_color) * params.sky_mult).tolist())
    p.sun_dir = _c3(degree_to_cartesian(params.azimuth, params.elevation,
                                        "cpu").tolist())
    p.root_min = _c3(scene.root_pmin.tolist())
    p.root_max = _c3(scene.root_pmax.tolist())

    t = _WalkTables(corners.data_ptr(), lights.data_ptr(), lut.data_ptr())
    tensors = [corners, lights, lut]
    if p.nee_env == NEE_HDRI:
        cuda.check_cuda_tensor(scene.env_map, "env_map", dtype=torch.float32,
                               device=dev)
        t.map = scene.env_map.data_ptr()
        tensors.append(scene.env_map)
    if volumetric and p.nee_env in (NEE_HDRI, NEE_SKY) and uses_env_cdf(
            scene, params):
        cdf = scene.env_cdf
        p.use_cdf = 1
        p.cdf_h, p.cdf_w = cdf.cdf.shape
        p.marginal_int = _f(cdf.marginal_int)
        for name, tab in (("cdf_func", cdf.func), ("cdf", cdf.cdf),
                          ("m_func", cdf.marginal_func),
                          ("m_cdf", cdf.marginal_cdf)):
            cuda.check_cuda_tensor(tab, f"env_cdf {name}",
                                   dtype=torch.float32, device=dev)
            setattr(t, name, tab.data_ptr())
            tensors.append(tab)
    ext_variant = p.em_off >= 0 or p.col_off >= 0 or p.volume_depth > 1
    k4 = prepare_environment(scene, params) if p.defer_env else None
    return WalkLaunch(volumetric, ext_variant, p, _walk_env(scene, params),
                      t, tuple(tensors), k4)


def _launch_k5(launch: WalkLaunch, key, origin, direction, tile: int,
               stats=None):
    """K5 alone: its output views (fused.out_buffer, as K1's): L,
    alpha, cost, trunc, depth, and for a deferred environment beta, the
    direction and env_pos.  ``stats``: a (3,) int64 tensor on the card
    the launch adds the rays' bounces, walk steps and sky evaluations
    to, or None."""
    dev = launch.tensors[0].device
    B = origin.shape[0]
    cuda.check_cuda_tensor(origin, "origin", (B, 3), torch.float32, dev)
    cuda.check_cuda_tensor(direction, "direction", (B, 3), torch.float32,
                           dev)
    p = _WalkParams.from_buffer_copy(launch.params)
    p.B, p.tile = B, tile
    p.key[0], p.key[1] = int(key[0]), int(key[1])
    out, views = out_buffer(B, p.defer_env, dev)
    rc = cuda.load_library().dll.vpt_walk(
        int(launch.volumetric), int(launch.ext), ctypes.byref(p),
        ctypes.byref(launch.env), ctypes.byref(launch.tables),
        origin.data_ptr(), direction.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        cuda.current_stream(dev))
    counter = WALK_VOLUMETRIC if launch.volumetric else WALK_DIRECT
    cuda.check_status(rc, counter.name)
    counter.launches += 1
    return views


def _run(scene, params, key, origin, direction, volumetric, launch, tile,
         stats):
    if launch is None:
        launch = prepare_walk(scene, params, volumetric)
    elif launch.volumetric != volumetric:
        raise ValueError("a launch prepared for the other integrator")
    if stats is not None:
        cuda.check_cuda_tensor(stats, "stats", (3,), torch.int64,
                               origin.device)
    views = _launch_k5(launch, key, origin, direction, tile, stats)
    if launch.k4 is not None:
        add_environment(scene, params, views[0], views[5], views[6],
                        views[7] if len(views) > 7 else None,
                        launch=launch.k4)
    return views[:5]


def walk_direct(scene, params, key, origin, direction, launch=None,
                tile: int = 0, stats=None):
    """K5's walk_direct on CUDA rays, K4 after it for a deferred
    environment: direct_integrator's (L, alpha, cost, trunc, depth).
    ``tile`` 0: one tile under ``key``; else tiles of ``tile`` rays under
    fold_in(key, 1000 + t).  ``stats``: as _launch_k5's (a ray's bounces
    are its loop's iterations)."""
    return _run(scene, params, key, origin, direction, False, launch, tile,
                stats)


def walk_volumetric(scene, params, key, origin, direction, launch=None,
                    tile: int = 0, stats=None):
    """K5's walk_volumetric on CUDA rays, as walk_direct (a ray's bounces
    are its scattering events)."""
    return _run(scene, params, key, origin, direction, True, launch, tile,
                stats)


def launch_info(volumetric: bool, ext: bool) -> dict:
    """One K5 instance's registers and local bytes per thread, threads
    per block and resident blocks per SM, from the CUDA runtime."""
    info = (ctypes.c_int * 4)()
    cuda.check_status(cuda.load_library().dll.vpt_walk_launch_info(
        int(volumetric), int(ext), info), "walk launch info")
    return dict(zip(("registers", "local_bytes", "threads",
                     "blocks_per_sm"), info))
