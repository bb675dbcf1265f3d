"""Kernel K5 (csrc/walk.cu): the reference engine's walks on the card.

``walk_direct`` runs render/integrator.py::direct_integrator on CUDA rays
on persistent warps (a lane a ray, a bounce a turn, refilled from a
counter), ``walk_volumetric`` render/vol_integrator.py::vol_integrator
as a wavefront of stage kernels over compacted path queues (per bounce:
the keys, EXTEND, NEE with each warp on one light kind, SCATTER); both
read the per-tile key table (``key_layout``, ``key_table_plain``).
Their plain versions are ``direct_integrator_plain`` and
``vol_integrator_plain``.  The launch's device buffers (the key table,
the counters, the path states and queues) are allocated once per launch
size (``_work``) and reused across samples.  K5 writes L, alpha, cost,
trunc (0) and depth as K1 lays them out
(render/fused.py::out_buffer), adds BLACK and CONSTANT itself, and for
the simple sky, HDRI with a map and the Bruneton atmosphere hands each
ray's beta, direction (and for the live atmosphere env_pos) to K4
(render/integrator.py::add_environment), launched after it.

With ``tile`` > 0 one launch takes the reference's tiles of ``tile``
rays (vpt_tpu/render/renderer.py:186-215, :276-281), each ray drawing
under fold_in(key, 1000 + its tile) at its index in the tile: the
renderer's route (render/renderer.py::_trace_walks) with fused_tile.

On the card K5 takes every scene and sky the plain walks take
(``scene_kind``, ``sky_kind``; each a template argument of the kernels
that read it): single grids in float32 corner rows with or without the
octant columns, or in bfloat16 rows; instanced scenes with cell lists
and without (the static loop); density-only or EXT (emission, color,
volume_depth > 1); and the volumetric integrator's sky estimate under
the Bruneton atmosphere, live or baked.  What build_scene refuses
(bfloat16 rows or octant columns on an instanced scene, ROADMAP A.10)
raises before any launch (``check_walk_scene``); nothing falls back to
a plain version on the card.  Each launch counts its stage kernels'
instances by name (``instance_names``, ``VARIANTS``) beside the
per-stage counters.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import degree_to_cartesian
from vpt_tpu_torch.ops import cuda
from vpt_tpu_torch.render.fused import out_buffer
from vpt_tpu_torch.render.integrator import (EnvLaunch, _AtmParams, _c3,
                                             _EnvParams, _f, add_environment,
                                             defers_environment,
                                             needs_env_pos,
                                             prepare_environment)
from vpt_tpu_torch.render.nee import LIGHT_BUDGET, uses_env_cdf
from vpt_tpu_torch.render.params import Environment, check_slice
from vpt_tpu_torch.render.tracking import (_over, _use_cells, cell_layout,
                                           cell_size, vec3_param)
from vpt_tpu_torch.volume.grid import unified_layout

_SOURCE = "vpt_tpu_torch/csrc/walk.cu"
# one launch a _launch_k5 call: walk_direct's persistent kernel, and
# walk_volumetric's wavefront as a whole
WALK_DIRECT = cuda.Kernel(
    name="walk_direct", route="cuda", source=_SOURCE,
    replaces="vpt_tpu/render/integrator.py:102")
WALK_VOLUMETRIC = cuda.Kernel(
    name="walk_volumetric", route="cuda", source=_SOURCE,
    replaces="vpt_tpu/render/vol_integrator.py:46")
# the kernels of a launch, each counted where it is launched: the key
# table (both integrators; the walks' fold_in(key, step) and subkeys), and
# walk_volumetric's stages, once a bounce each
WALK_KEYS = cuda.Kernel(
    name="walk_keys", route="cuda", source=_SOURCE,
    replaces="vpt_tpu/render/tracking.py:600")
WALK_EXTEND = cuda.Kernel(
    name="walk_extend", route="cuda", source=_SOURCE,
    replaces="vpt_tpu/render/vol_integrator.py:57")
WALK_NEE = cuda.Kernel(
    name="walk_nee", route="cuda", source=_SOURCE,
    replaces="vpt_tpu/render/vol_integrator.py:25")
WALK_SCATTER = cuda.Kernel(
    name="walk_scatter", route="cuda", source=_SOURCE,
    replaces="vpt_tpu/render/vol_integrator.py:77")
# vpt_walk's launch kinds (walk.cu's L_*), in order
LAUNCH_KINDS = (WALK_KEYS, WALK_DIRECT, WALK_EXTEND, WALK_NEE, WALK_SCATTER)
STAGES = ("keys", "direct", "extend", "nee", "scatter")
# walk_volumetric's stage kernels
STAGE_KERNELS = (WALK_EXTEND, WALK_NEE, WALK_SCATTER)
# the walk steps a stats tensor of N_STATS_STAGES counters holds by stage
# (stats[3 + k]): EXTEND, NEE's sun, point lights and sky, SCATTER
STEP_STAGES = ("extend", "sun", "point", "sky", "scatter")
N_STATS, N_STATS_STAGES = 3, 8
# vpt_walk's status where a timed launch's hold kernel ended before the
# host had queued the launch (cudaErrorNotReady)
HOLD_TOO_SHORT = 600
# walk.cu's path queues and counters (N_QUEUES x B ints; N_COUNTS per
# bounce: the queue lengths C_LIVE .. C_SCATTER first)
N_QUEUES, N_COUNTS = 6, 11
PATH_FLOATS = 24   # PathState
# the key table: the step keys of each walk for s < KEY_STEPS (a later
# step folds its key in the thread), and walk_direct's bounces below
# DIRECT_KEY_DEPTHS (a deeper bounce folds its keys in the thread;
# walk_volumetric's table holds the bounce its stages run)
KEY_STEPS, DIRECT_KEY_DEPTHS = 256, 4
# the sky next-event estimate's environment (walk.cu's NEE_*)
NEE_BLACK, NEE_CONSTANT, NEE_HDRI, NEE_SKY = range(4)
# walk.cuh's scene kinds (SC_*) and the sky kinds of the volumetric
# integrator's NEE (SKY_*), each with the tag its instances' names carry
SC_F32, SC_F32_OCT, SC_BF16, SC_CELLS, SC_LOOP = range(5)
SCENE_TAGS = ("", "octant", "bf16", "cells", "loop")
SKY_RUNTIME, SKY_ATMOSPHERE, SKY_CACHE = range(3)
SKY_TAGS = ("", "atmosphere", "sky_cache")
# the counters of the instances beyond SC_F32 under the run-time sky,
# by name (instance_names), made at their first launch
VARIANTS: dict = {}


class _WalkParams(ctypes.Structure):
    """Mirror of ``WalkParams`` in csrc/walk.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "B", "tile", "ray_depth", "volume_depth", "max_steps", "n_lights",
        "n_pt_walks", "reference_falloff", "use_double_hg", "defer_env",
        "env_constant", "nee_env", "use_cdf", "cdf_h", "cdf_w", "row_w",
        "em_off", "col_off", "grid_off", "sph_enabled", "n_tiles",
        "key_scalars", "key_walks", "key_steps", "key_depths")] + [
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


class _WalkScene(ctypes.Structure):
    """Mirror of ``WalkScene`` in csrc/walk.cuh."""

    _fields_ = [("cells", ctypes.c_void_p), ("inst", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("kind", "sky", "octant", "R", "cell_w",
                                    "ids_off", "k")] + [
        ("cs", ctypes.c_float * 3), ("atm", _AtmParams)]


class _WalkWork(ctypes.Structure):
    """Mirror of ``WalkWork`` in csrc/walk.cu."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "state", "queue", "counts", "keys")]


@dataclass
class WalkLaunch:
    """K5's launch arguments for one (scene, params), built once; ``work``
    the device buffers of the last launch size (_work)."""

    volumetric: bool
    ext: bool
    params: _WalkParams
    env: _EnvParams
    tables: _WalkTables
    tensors: tuple                  # what the tables point at
    k4: EnvLaunch | None = None     # K4's, for a deferred environment
    work: tuple | None = None       # (B, tile, _WalkWork, its tensors)
    # the scene and sky kinds and what their kernels read beyond the
    # tables (SC_F32 under the run-time sky: kind and sky 0, no tables)
    scene: _WalkScene = field(default_factory=_WalkScene)


TILE_FOLD = 1000   # the reference's tile keys: fold_in(key, 1000 + t)

# The per-tile key table (csrc/walk.cu's slot_key): a slab per tile and
# bounce of key_scalars keys, then key_walks blocks of key_steps step
# keys.  walk_volumetric's scalar slots (kd = fold_in(tile key, depth),
# kl = fold_in(kd, 1), ks = fold_in(kl, 3)):
V_WALK, V_PICK, V_SUN, V_SKY_TR, V_EMIT = 0, 1, 2, 3, 5
V_SKY_U, V_SKY_HG, V_SCATTER_HG, V_POINT = 6, 8, 12, 16
# walk_direct's, after its 5 * volume_depth volume-walk slots
D_SUN, D_EMIT, D_SPH, D_SPH_TR, D_POINT = range(5)


@dataclass(frozen=True)
class KeyLayout:
    """A slab's layout: ``scalars`` keys, then a block of ``steps`` step
    keys for each slot of ``walks`` (the walk keys they fold)."""

    volumetric: bool
    volume_depth: int
    use_double_hg: bool
    scalars: int
    walks: tuple
    steps: int

    @property
    def slab(self) -> int:
        return self.scalars + len(self.walks) * self.steps


def key_layout(volumetric: bool, n_pt_walks: int, volume_depth: int,
               has_emit: bool, sphere: bool, use_double_hg: bool,
               steps: int) -> KeyLayout:
    """csrc/walk.cu's slab for these settings: n_scalars, walk_slot."""
    if volumetric:
        walks = [V_WALK, V_SUN, V_SKY_TR, V_SKY_TR + 1]
        walks += [V_POINT + 2 * w + 1 for w in range(n_pt_walks)]
        walks += [V_EMIT] if has_emit else []
        scalars = V_POINT + 2 * n_pt_walks
    else:
        d = 5 * volume_depth
        walks = list(range(volume_depth)) + [d + D_SUN]
        walks += [d + D_POINT + 2 * w + 1 for w in range(n_pt_walks)]
        walks += [d + D_EMIT] if has_emit else []
        walks += [d + D_SPH_TR] if sphere else []
        scalars = d + D_POINT + 2 * n_pt_walks
    return KeyLayout(volumetric, volume_depth, bool(use_double_hg), scalars,
                     tuple(walks), steps)


def _fold(k, n):
    """fold_in(k, n) (= split(k)[n]) on keys of python ints or int64
    tensors and a counter of either."""
    return rng.threefry2x32(k[0], k[1], 0, n)


def _hg_key(layout: KeyLayout, k, i: int):
    if layout.use_double_hg:
        return _fold(_fold(k, i >> 1), i & 1)
    if i < 2:
        return _fold(k, i)
    zero = k[0] * 0
    return (zero, zero)


def slot_key(layout: KeyLayout, kd, slot: int):
    """The key in ``slot`` of the slab of bounce key ``kd``: the fold_in /
    split chains of vpt_tpu's integrators (walk.cu's slot_key)."""
    if layout.volumetric:
        if slot == V_WALK:
            return _fold(kd, 0)
        if slot == V_EMIT:
            return _fold(kd, 2)
        if V_SCATTER_HG <= slot < V_POINT:
            return _hg_key(layout, _fold(kd, 3), slot - V_SCATTER_HG)
        kl = _fold(kd, 1)
        if slot == V_PICK:
            return _fold(kl, 0)
        if slot == V_SUN:
            return _fold(_fold(kl, 1), 0)
        if slot >= V_POINT:
            kw = _fold(_fold(kl, 2), (slot - V_POINT) >> 1)
            return _fold(kw, (slot - V_POINT) & 1)
        ks = _fold(kl, 3)
        if slot < V_EMIT:
            return _fold(ks, 2 + slot - V_SKY_TR)
        if slot < V_SKY_HG:
            return _fold(_fold(ks, 0), slot - V_SKY_U)
        return _hg_key(layout, _fold(ks, 1), slot - V_SKY_HG)
    nv = layout.volume_depth
    if slot < nv:
        return _fold(kd, 100 + slot)
    if slot < 5 * nv:
        v = (slot - nv) >> 2
        return _hg_key(layout, _fold(_fold(kd, 100 + v), 1), (slot - nv) & 3)
    slot -= 5 * nv
    if slot == D_SUN:
        return _fold(_fold(kd, 2), 0)
    if slot == D_EMIT:
        return _fold(kd, 4)
    if slot == D_SPH:
        return _fold(kd, 5)
    if slot == D_SPH_TR:
        return _fold(_fold(kd, 5), 3)
    slot -= D_POINT
    return _fold(_fold(_fold(kd, 3), slot >> 1), slot & 1)


def key_table_plain(layout: KeyLayout, key, n_tiles: int, tile: int, d0: int,
                    depths: int, device="cpu") -> torch.Tensor:
    """walk_keys_kernel's table in torch: (n_tiles, depths, slab, 2) int64
    uint32 words, bounce d0 + i's slab of tile t at [t, i]; tile t's key
    fold_in(key, 1000 + t), or ``key`` itself for tile 0."""
    t = torch.arange(n_tiles, dtype=torch.int64, device=device)
    k = (torch.full_like(t, key[0]), torch.full_like(t, key[1]))
    kt = _fold(k, TILE_FOLD + t) if tile > 0 else k
    s = torch.arange(layout.steps, dtype=torch.int64, device=device)
    out = torch.empty((n_tiles, depths, layout.slab, 2), dtype=torch.int64,
                      device=device)
    for i in range(depths):
        kd = _fold(kt, d0 + i)
        for slot in range(layout.scalars):
            out[:, i, slot, 0], out[:, i, slot, 1] = slot_key(layout, kd,
                                                              slot)
        for j, ws in enumerate(layout.walks):
            b = slot_key(layout, kd, ws)
            a = layout.scalars + j * layout.steps
            out[:, i, a:a + layout.steps, 0], out[
                :, i, a:a + layout.steps, 1] = _fold(
                (b[0][:, None], b[1][:, None]), s[None, :])
    return out


def launch_layout(launch: "WalkLaunch") -> KeyLayout:
    """The key layout a prepared launch's kernels read."""
    p = launch.params
    return key_layout(launch.volumetric, p.n_pt_walks, p.volume_depth,
                      p.em_off >= 0, bool(p.sph_enabled),
                      bool(p.use_double_hg), p.key_steps)


def scene_kind(scene) -> int:
    """walk.cuh's scene kind of ``scene``, as tracking.unified_fetch picks
    its branch: cell lists, the static loop, or a single grid by its
    rows."""
    if _use_cells(scene):
        return SC_CELLS
    if scene.instances.count > 1:
        return SC_LOOP
    if scene.atlas.density_corners.dtype == torch.bfloat16:
        return SC_BF16
    return SC_F32_OCT if scene.atlas.octant_cols else SC_F32


def sky_kind(scene, params, volumetric: bool) -> int:
    """The sky kind of the volumetric integrator's NEE: the Bruneton
    atmosphere's, live or baked, under ATMOSPHERE with one attached (the
    direct integrator reads no sky in K5)."""
    if (not volumetric
            or params.environment_type != int(Environment.ATMOSPHERE)
            or getattr(scene, "atmosphere", None) is None):
        return SKY_RUNTIME
    return SKY_CACHE if scene.sky_cache is not None else SKY_ATMOSPHERE


def instance_names(volumetric: bool, ext: bool, sc: int, sky: int) -> dict:
    """{LAUNCH_KINDS name: the name of the instance a launch runs for it},
    for the stages whose instance is not SC_F32's under the run-time sky:
    the kernel, the scene's tag, "_ext" for EXT, the sky's tag for NEE
    (walk_scatter reads the scene only on EXT, and SC_F32_OCT's emission
    is SC_F32's: walk.cuh::scatter_sc)."""
    tag, names = SCENE_TAGS[sc], {}
    suffix = "_ext" if ext else ""
    if sc != SC_F32:
        names["walk_direct" if not volumetric else "walk_extend"] = (
            f"walk_{'extend' if volumetric else 'direct'}_{tag}{suffix}")
    if volumetric:
        nee = "walk_nee" + (f"_{tag}" if sc != SC_F32 else "") + (
            f"_{SKY_TAGS[sky]}" if sky != SKY_RUNTIME else "")
        if nee != "walk_nee":
            names["walk_nee"] = nee
        if ext and sc not in (SC_F32, SC_F32_OCT):
            names["walk_scatter"] = f"walk_scatter_{tag}_ext"
    return names


_VARIANT_SITES = {
    "walk_direct": "vpt_tpu/render/integrator.py:102",
    "walk_extend": "vpt_tpu/render/vol_integrator.py:57",
    "walk_nee": "vpt_tpu/render/vol_integrator.py:25",
    "walk_scatter": "vpt_tpu/render/vol_integrator.py:77"}
# the sources that instantiate each scene kind's kernels beyond SC_F32's,
# and the reference's code each kind adds to the walk
_KIND_SOURCES = {SC_F32: "vpt_tpu_torch/csrc/walk_rows.cu",
                 SC_F32_OCT: "vpt_tpu_torch/csrc/walk_rows.cu",
                 SC_BF16: "vpt_tpu_torch/csrc/walk_rows.cu",
                 SC_CELLS: "vpt_tpu_torch/csrc/walk_cells.cu",
                 SC_LOOP: "vpt_tpu_torch/csrc/walk_cells.cu"}
KIND_SITES = {
    "octant": "vpt_tpu/render/tracking.py:502 + accel/majorant.py:232",
    "bf16": "vpt_tpu/render/tracking.py:445 (astype) + :502",
    "cells": "vpt_tpu/render/tracking.py:150, :230, :261, :284",
    "loop": "vpt_tpu/render/tracking.py:320 (:361-395), :230, :261, :284",
    "atmosphere": "vpt_tpu/render/nee.py:23-47 + sky/runtime.py:161",
    "sky_cache": "vpt_tpu/render/nee.py:23-47 + sky/runtime.py:203"}


def variant(name: str, stage: str, sc: int) -> cuda.Kernel:
    """The counter of instance ``name`` of ``stage`` on scene kind ``sc``
    (VARIANTS)."""
    if name not in VARIANTS:
        VARIANTS[name] = cuda.Kernel(name=name, route="cuda",
                                     source=_KIND_SOURCES[sc],
                                     replaces=_VARIANT_SITES[stage])
    return VARIANTS[name]


def check_walk_scene(scene, params, volumetric: bool) -> None:
    """Raise before any launch for what K5 does not take on the card:
    an unported parameter (check_slice), and what build_scene refuses,
    an instanced scene in bfloat16 rows or with the octant
    columns in its corner rows (ROADMAP A.10), or one without a majorant
    grid."""
    check_slice(params)
    if scene.instances.count > 1 or _use_cells(scene):
        if (scene.atlas.density_corners.dtype != torch.float32
                or scene.atlas.octant_cols):
            raise NotImplementedError(
                "K5 on an instanced scene in bfloat16 rows or with octant "
                "columns in its corner rows (ROADMAP A.10)")
        if scene.majorant is None:
            raise ValueError("an instanced scene without a majorant grid: "
                             "its walk reads the grid's bounds")


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
    cuda.check_struct(_WalkScene, lib.vpt_walk_scene_size)
    cuda.check_struct(_WalkWork, lib.vpt_walk_work_size)
    dev = scene.device
    corners = scene.atlas.density_corners
    sc = scene_kind(scene)
    cuda.check_cuda_tensor(corners, "density_corners", dtype=(
        torch.bfloat16 if sc == SC_BF16 else torch.float32))
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
    layout = key_layout(volumetric, p.n_pt_walks, p.volume_depth,
                        p.em_off >= 0, bool(p.sph_enabled),
                        bool(p.use_double_hg), min(p.max_steps, KEY_STEPS))
    p.key_scalars, p.key_walks = layout.scalars, len(layout.walks)
    p.key_steps = layout.steps
    p.key_depths = (1 if volumetric else
                    max(1, min(p.ray_depth, DIRECT_KEY_DEPTHS)))
    k4 = prepare_environment(scene, params) if p.defer_env else None
    ws = _WalkScene()
    ws.kind, ws.sky = sc, sky_kind(scene, params, volumetric)
    ws.octant = int(bool(scene.atlas.octant_cols))
    if sc in (SC_CELLS, SC_LOOP):
        major = scene.majorant
        rows = major.cell_rows if sc == SC_CELLS else major.packed
        inst = scene.instances.packed_rows
        cuda.check_cuda_tensor(rows, "majorant rows", dtype=torch.float32,
                               device=dev)
        cuda.check_cuda_tensor(inst, "packed_rows",
                               (scene.instances.count, 24), torch.float32,
                               dev)
        ws.cells, ws.inst = rows.data_ptr(), inst.data_ptr()
        ws.R, ws.cell_w = major.resolution, rows.shape[1]
        ws.ids_off, ws.k = ((rows.shape[1], scene.instances.count)
                            if sc == SC_LOOP else cell_layout(scene)[:2])
        ws.octant = int(major.packed.shape[1] >= 79)
        ws.cs = _c3(cell_size(scene).tolist())
        tensors += [rows, inst]
    if ws.sky != SKY_RUNTIME:
        ws.atm = k4.atm   # the atmosphere's LUTs or cache, as K4 reads them
    return WalkLaunch(volumetric, ext_variant, p, _walk_env(scene, params),
                      t, tuple(tensors), k4, scene=ws)


def n_tiles(B: int, tile: int) -> int:
    """The tiles of a launch of B rays: ceil(B / tile), or 1 for tile 0."""
    return -(-B // tile) if tile > 0 else 1


def _work(launch: WalkLaunch, p: _WalkParams, dev):
    """The launch's device buffers for p.B rays in p.tile tiles, kept on
    the launch and reused while the size stays: the key table (n_tiles x
    key_depths slabs), the counters, and for walk_volumetric's stages the
    path states (PATH_FLOATS a ray) and the N_QUEUES queues."""
    if launch.work is not None and launch.work[:2] == (p.B, p.tile):
        return launch.work[2]
    slab = p.key_scalars + p.key_walks * p.key_steps
    keys = torch.empty(2 * p.n_tiles * p.key_depths * slab,
                       dtype=torch.int32, device=dev)
    counts = torch.empty(N_COUNTS * (max(p.ray_depth, 1) + 1),
                         dtype=torch.int32, device=dev)
    tensors = [keys, counts]
    w = _WalkWork(None, None, counts.data_ptr(), keys.data_ptr())
    if launch.volumetric:
        state = torch.empty(PATH_FLOATS * p.B, dtype=torch.float32,
                            device=dev)
        queue = torch.empty(N_QUEUES * p.B, dtype=torch.int32, device=dev)
        w.state, w.queue = state.data_ptr(), queue.data_ptr()
        tensors += [state, queue]
    launch.work = (p.B, p.tile, w, tuple(tensors))
    return w


def _launch_params(launch: WalkLaunch, B: int, tile: int, key):
    p = _WalkParams.from_buffer_copy(launch.params)
    p.B, p.tile = B, tile
    p.n_tiles = n_tiles(B, tile)
    p.key[0], p.key[1] = int(key[0]), int(key[1])
    return p


def _launch_k5(launch: WalkLaunch, key, origin, direction, tile: int,
               stats=None, kernel_ms=None):
    """K5 alone: its output views (fused.out_buffer, as K1's): L,
    alpha, cost, trunc, depth, and for a deferred environment beta, the
    direction and env_pos.  ``stats``: an int64 tensor on the card of
    N_STATS counters the launch adds the rays' bounces, walk steps and sky
    evaluations to (or N_STATS_STAGES: then also walk_volumetric's walk
    steps by stage, STEP_STAGES' order), or None.  ``kernel_ms``: a dict
    that each LAUNCH_KINDS name's device ms in this launch is added to
    (CUDA events between its kernels, the launch queued behind a hold
    kernel so that no host gap falls inside a time; the call waits for
    the launch), or None."""
    dev = launch.tensors[0].device
    B = origin.shape[0]
    cuda.check_cuda_tensor(origin, "origin", (B, 3), torch.float32, dev)
    cuda.check_cuda_tensor(direction, "direction", (B, 3), torch.float32,
                           dev)
    p = _launch_params(launch, B, tile, key)
    w = _work(launch, p, dev)
    out, views = out_buffer(B, p.defer_env, dev)
    launches = (ctypes.c_int * len(LAUNCH_KINDS))()
    ms = None if kernel_ms is None else (ctypes.c_float * len(LAUNCH_KINDS))()
    rc = cuda.load_library().dll.vpt_walk(
        int(launch.volumetric), int(launch.ext), ctypes.byref(p),
        ctypes.byref(launch.env), ctypes.byref(launch.tables),
        ctypes.byref(launch.scene), ctypes.byref(w), origin.data_ptr(),
        direction.data_ptr(),
        out.data_ptr(), None if stats is None else stats.data_ptr(),
        0 if stats is None else stats.numel(), launches, ms,
        cuda.current_stream(dev))
    counter = WALK_VOLUMETRIC if launch.volumetric else WALK_DIRECT
    if ms is not None and rc == HOLD_TOO_SHORT:
        raise RuntimeError(f"{counter.name}: the card reached the timed "
                           f"launch before the host had queued it")
    cuda.check_status(rc, counter.name)
    if ms is not None:
        for k, t in zip(LAUNCH_KINDS, ms):
            kernel_ms[k.name] = kernel_ms.get(k.name, 0.0) + t
    names = instance_names(launch.volumetric, launch.ext, launch.scene.kind,
                           launch.scene.sky)
    for k, n in zip(LAUNCH_KINDS, launches):
        if k is not WALK_DIRECT:
            k.launches += n
        if k.name in names:
            variant(names[k.name], k.name, launch.scene.kind).launches += (
                n if k is not WALK_DIRECT else 1)
    counter.launches += 1
    return views


def queue_lengths(launch: WalkLaunch) -> dict:
    """walk_volumetric's queue lengths by bounce after its last launch
    (the counters it left on the card): the live paths EXTEND walked, the
    paths each NEE kind and SCATTER took."""
    if launch.work is None or not launch.volumetric:
        raise ValueError("no walk_volumetric launch on this WalkLaunch")
    B = launch.work[0]
    depth = max(launch.params.ray_depth, 1)
    c = launch.work[3][1].view(-1, N_COUNTS)[:depth].cpu()
    live = [B] + c[1:, 0].tolist()
    return dict(live=live, sun=c[:, 1].tolist(), point=c[:, 2].tolist(),
                sky=c[:, 3].tolist(), scatter=c[:, 4].tolist())


def key_table(launch: WalkLaunch, key, B: int, tile: int, d0: int = 0):
    """walk_keys_kernel's table for a launch of B rays in tiles of
    ``tile`` and bounces [d0, d0 + key_depths), as key_table_plain's
    (n_tiles, key_depths, slab, 2) int64 words: for the check against
    it."""
    p = _launch_params(launch, B, tile, key)
    layout = launch_layout(launch)
    dev = launch.tensors[0].device
    keys = torch.empty(2 * p.n_tiles * p.key_depths * layout.slab,
                       dtype=torch.int32, device=dev)
    cuda.check_status(cuda.load_library().dll.vpt_walk_keys(
        int(launch.volumetric), ctypes.byref(p), keys.data_ptr(), d0,
        cuda.current_stream(dev)), WALK_KEYS.name)
    return (keys.view(p.n_tiles, p.key_depths, layout.slab, 2).to(
        torch.int64) & rng.MASK)


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


def launch_info(volumetric: bool, ext: bool, stage: str | None = None,
                sc: int = SC_F32, sky: int = SKY_RUNTIME) -> dict:
    """One K5 kernel's registers and local bytes per thread, threads per
    block and resident blocks per SM, from the CUDA runtime.  ``stage``:
    one of STAGES ("keys"; walk_direct's "direct"; walk_volumetric's
    "extend", "nee", "scatter"), by default the integrator's walk
    ("direct", or "extend"); ``sc`` and ``sky`` the scene and sky kinds
    whose instance it is."""
    stage = stage or ("extend" if volumetric else "direct")
    info = (ctypes.c_int * 4)()
    cuda.check_status(cuda.load_library().dll.vpt_walk_launch_info(
        int(volumetric), int(ext), STAGES.index(stage), sc, sky, info),
        "walk launch info")
    return dict(zip(("registers", "local_bytes", "threads",
                     "blocks_per_sm"), info))
