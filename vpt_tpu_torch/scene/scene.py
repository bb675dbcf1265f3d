"""Scene container and builder (port of vpt_tpu/scene/scene.py:117-274).

Single-instance scenes carry no majorant grid: their full-fetch path
never reads it (vpt_tpu/render/fused.py:182, tracking.py:120-122).
Instanced scenes, of one grid or several, carry it: with per-cell
instance lists once they have more instances than
``instance_list_threshold``, else its packed rows alone, which the
static per-instance loop reads (accel/majorant.py).  Their rows are
float32 without octant columns (ROADMAP A.10); a single instance's rows
may be bfloat16 and carry the octant columns (volume/grid.py).  The
LUTs not given are loaded from the EXR assets as the reference loads
them (scene/assets.py), white where none is found.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.scene.assets import (load_blackbody_lut,
                                        load_density_color_lut)
from vpt_tpu_torch.scene.geometry import Sphere
from vpt_tpu_torch.volume.grid import HostGrid, VolumeAtlas, build_atlas


@dataclass(frozen=True)
class Instances:
    grid_id: torch.Tensor      # (N,) int32
    xform: torch.Tensor        # (N, 4, 4) f32 index->world (row-vector)
    inv_xform: torch.Tensor    # (N, 4, 4) f32 world->index
    pmin: torch.Tensor         # (N, 3) world-space AABB
    pmax: torch.Tensor         # (N, 3)
    # [0:12] inv_xform rows, [12:15] grid bbox_min, [15:18] grid dim,
    # [18] density offset, [19] emission offset, [20] color offset,
    # [21] grid max_density, [22:24] pad (vpt_tpu/scene/scene.py:37-49)
    packed_rows: torch.Tensor  # (N, 24) f32

    @property
    def count(self) -> int:
        return self.grid_id.shape[0]


@dataclass(frozen=True)
class MajorantGrid:
    """The flat super-grid over the root box (accel/majorant.py), with
    the reference's fields (vpt_tpu/scene/scene.py:55-79)."""

    max_density: torch.Tensor  # (R, R, R) f32, [z, y, x]
    occupied: torch.Tensor     # (R, R, R) bool
    skip_dist: torch.Tensor    # (R, R, R) int32 chebyshev cells
    packed: torch.Tensor       # (R^3, 7 [+ 72 octant]) f32
    cell_instances: Optional[torch.Tensor] = None  # (R^3, K) int32
    # [T_box, ext 6, octant 72?, ids K, taus 8 (1 + L)?] f32
    cell_rows: Optional[torch.Tensor] = None

    @property
    def resolution(self) -> int:
        return self.occupied.shape[0]


@dataclass(frozen=True)
class Scene:
    atlas: VolumeAtlas
    instances: Instances
    root_pmin: torch.Tensor        # (3,)
    root_pmax: torch.Tensor        # (3,)
    max_extinction: torch.Tensor   # ()
    min_extinction: torch.Tensor   # ()
    lights: PointLights
    sphere: Sphere
    camera: Camera
    emission_lut: torch.Tensor       # (256, 3)
    density_color_lut: torch.Tensor  # (256, 3)
    # the raw (H, W, 3) equirect radiance map of an HDRI environment;
    # the reference keeps corner-packed rows whose [..., 0:3] is this map
    env_map: Optional[torch.Tensor] = None
    # instanced scenes; None on a single instance
    majorant: Optional[MajorantGrid] = None
    # the world tau grid of an instanced scene without cell lists,
    # (nz, ny, nx, 8 (1 + L)) corner-packed taus toward the sun and each
    # point light over the root box (accel/shadow.py); with cell lists the
    # taus fold into the cell rows instead
    world_tau: Optional[torch.Tensor] = None
    # the Bruneton atmosphere (sky/runtime.py::Atmosphere) read by the
    # ATMOSPHERE environment in place of the simple sky, and its baked
    # (H, W, 6) equirect cache
    atmosphere: Optional[object] = None
    sky_cache: Optional[torch.Tensor] = None
    # the environment's importance CDF (sky/cdf.py::EnvCDF), read by the
    # sky's next-event estimate of the reference and volumetric engines
    env_cdf: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.atlas.density_corners.device


def _world_bounds(host: HostGrid, xform: np.ndarray):
    """AABB of the transformed index-space bbox corners
    (GPU_VDB::Bounds, gpu_vdb.h:131-146)."""
    bmin = host.bbox_min.astype(np.float64)
    bmax = (host.bbox_min + host.dim - 1).astype(np.float64)
    corners = np.array([[x, y, z] for z in (bmin[2], bmax[2])
                        for y in (bmin[1], bmax[1])
                        for x in (bmin[0], bmax[0])])
    w = corners @ xform[:3, :3] + xform[3, :3]
    return w.min(axis=0), w.max(axis=0)


def _pack_instance_rows(atlas: VolumeAtlas, instance_grid_ids,
                        inv_xforms: np.ndarray) -> np.ndarray:
    """The (N, 24) instance rows (Instances; vpt_tpu/scene/scene.py:
    139-154): the world->index transform, then the grid's bbox_min, dim,
    channel offsets and max density."""
    gids = np.asarray(instance_grid_ids, np.int64)
    rows = np.zeros((len(gids), 24), np.float32)
    rows[:, 0:12] = inv_xforms[:, :4, :3].reshape(len(gids), 12)
    rows[:, 12:15] = atlas.bmin.cpu().numpy()[gids]
    rows[:, 15:18] = atlas.dim.cpu().numpy()[gids].astype(np.float32)
    rows[:, 18] = atlas.offset.cpu().numpy()[gids].astype(np.float32)
    rows[:, 19] = atlas.emission_offset.cpu().numpy()[gids].astype(
        np.float32)
    rows[:, 20] = atlas.color_offset.cpu().numpy()[gids].astype(np.float32)
    rows[:, 21] = atlas.max_density.cpu().numpy()[gids]
    return rows


def check_instanced(n_instances: int, corner_dtype, octant_cols: int):
    """Raise for the instanced scenes the port does not render: bfloat16
    corner rows or octant columns (ROADMAP A.10)."""
    if n_instances > 1 and (octant_cols or corner_dtype not in (
            "float32", torch.float32)):
        raise NotImplementedError(
            "octant columns or bfloat16 corner rows on an instanced scene "
            "are not ported yet (ROADMAP A.10)")


def default_camera(root_pmin, root_pmax, aspect=1.0,
                   device=DEFAULT_DEVICE):
    """build_scene's default framing (main.cpp:1320-1334)."""
    center = (root_pmin + root_pmax) / 2
    dist = float(np.linalg.norm(root_pmax - root_pmin)) * 1.5
    return Camera.make(center + np.array([0.0, 0.0, dist]), center,
                       vfov=30.0, aspect=aspect, device=device)


def build_scene(host_grids: list[HostGrid],
                instance_grid_ids=None, instance_xforms=None,
                camera: Camera | None = None,
                lights: PointLights | None = None,
                sphere: Sphere | None = None,
                emission_lut: np.ndarray | None = None,
                density_color_lut: np.ndarray | None = None,
                band_divisors: tuple | None = None,
                majorant_resolution: int = 64,
                instance_list_threshold: int = 8,
                octant_cells: bool | str = "auto",
                corner_dtype: str = "float32",
                octant_boxes: bool | str = "auto",
                device=DEFAULT_DEVICE, timings: dict | None = None) -> Scene:
    """Assemble a Scene on ``device``.  ``instance_xforms[i]`` is
    instance i's index->world transform (default: each grid's own file
    transform, one instance each).  Root bounds = the union of the
    instance bounds padded by 1 (bvh_builder.cpp:76-78); corner rows from
    volume/grid.py, in ``corner_dtype`` ("float32" or "bfloat16"), with
    the 72 octant columns where ``octant_boxes`` ("auto" resolves to
    False, as the reference's: vpt_tpu/scene/scene.py:205-215); with more
    than ``instance_list_threshold`` instances the majorant grid with
    cell lists at ``majorant_resolution``.  ``timings``, where given,
    receives the seconds of the majorant grid's stages
    (accel/majorant.py::build_majorant_grid)."""
    if instance_grid_ids is None:
        instance_grid_ids = np.arange(len(host_grids))
        instance_xforms = [g.transform for g in host_grids]
    instance_grid_ids = np.asarray(instance_grid_ids, np.int32)
    n = len(instance_grid_ids)
    if octant_boxes == "auto":
        octant_boxes = False
    check_instanced(n, corner_dtype, int(bool(octant_boxes)))
    if n > 1 and not majorant_resolution:
        raise NotImplementedError(
            "an instanced scene without a majorant grid "
            "(majorant_resolution=0) is not ported: its walk reads the "
            "grid's bounds, as use_majorant=True does")
    grids = [host_grids[int(gid)] for gid in instance_grid_ids]
    xforms = np.stack([np.asarray(x, np.float64) for x in instance_xforms])
    inv = np.linalg.inv(xforms)
    bounds = [_world_bounds(g, xf) for g, xf in zip(grids, xforms)]
    pmin = np.stack([b[0] for b in bounds])
    pmax = np.stack([b[1] for b in bounds])
    root_pmin = pmin.min(axis=0) - 1.0
    root_pmax = pmax.max(axis=0) + 1.0
    atlas = build_atlas(host_grids, band_divisors=band_divisors,
                        device=device, corner_dtype=corner_dtype,
                        octant_boxes=bool(octant_boxes))
    majorant = None
    if n > 1:
        from vpt_tpu_torch.accel.majorant import build_majorant_grid
        majorant = build_majorant_grid(
            host_grids, instance_grid_ids, xforms, root_pmin, root_pmax,
            majorant_resolution,
            build_instance_lists=n > instance_list_threshold,
            octant_cells=octant_cells, device=device, timings=timings)
    f32 = dict(dtype=torch.float32, device=device)
    if camera is None:
        camera = default_camera(root_pmin, root_pmax, device=device)
    luts = []
    for lut, load in ((emission_lut, load_blackbody_lut),
                      (density_color_lut, load_density_color_lut)):
        if lut is None:
            lut = load()
        luts.append(np.ones((256, 3), np.float32) if lut is None else lut)
    inv32 = inv.astype(np.float32)
    return Scene(
        atlas=atlas,
        instances=Instances(
            grid_id=torch.as_tensor(instance_grid_ids, device=device),
            xform=torch.as_tensor(xforms, **f32),
            inv_xform=torch.as_tensor(inv32, **f32),
            pmin=torch.as_tensor(pmin, **f32),
            pmax=torch.as_tensor(pmax, **f32),
            packed_rows=torch.as_tensor(
                _pack_instance_rows(atlas, instance_grid_ids, inv32), **f32)),
        root_pmin=torch.as_tensor(root_pmin, **f32),
        root_pmax=torch.as_tensor(root_pmax, **f32),
        max_extinction=torch.tensor(max(g.max_density for g in grids),
                                    **f32),
        min_extinction=torch.tensor(min(g.min_density for g in grids),
                                    **f32),
        lights=(lights if lights is not None
                else PointLights.empty(device)).to(device),
        sphere=(sphere if sphere is not None
                else Sphere.make(device=device)).to(device),
        camera=camera.to(device),
        emission_lut=torch.as_tensor(luts[0], **f32),
        density_color_lut=torch.as_tensor(luts[1], **f32),
        majorant=majorant)


def attach_env_map(scene: Scene, env_map, importance_sample: bool = True,
                   full_res_cdf: bool = False) -> Scene:
    """Attach an equirect HDR environment, (H, W, 3), on the scene's
    device (create_environment, main.cpp:945-978), and with
    ``importance_sample`` its importance CDF (sky/cdf.py), built on the
    host at the reference's 180^2 resample, or at the map's own
    resolution with ``full_res_cdf`` (vpt_tpu/scene/scene.py:310-327).
    Only the sky's next-event estimate reads the CDF."""
    env = torch.as_tensor(np.asarray(env_map, np.float32))
    if env.dim() != 3 or env.shape[2] != 3:
        raise ValueError(f"env_map: shape {tuple(env.shape)}, expected "
                         "(H, W, 3)")
    cdf = None
    if importance_sample:
        from vpt_tpu_torch.sky.cdf import CDF_RES, build_envmap_cdf
        cdf = build_envmap_cdf(env, res=None if full_res_cdf
                               else CDF_RES).to(scene.device)
    return dataclasses.replace(scene, env_map=env.to(scene.device)
                               .contiguous(), env_cdf=cdf)


def attach_sky_cdf(scene: Scene, azimuth=150.0, elevation=30.0,
                   sky_color=(1.0, 1.0, 1.0)) -> Scene:
    """The simple sky's importance CDF for this sun (sky/cdf.py::
    build_sky_cdf, built on the host), which the sky's next-event
    estimate then samples under ATMOSPHERE; rebuild it when the sun
    moves, as the reference does (main.cpp:1702-1705)."""
    from vpt_tpu_torch.sky.cdf import build_sky_cdf
    cdf = build_sky_cdf(azimuth, elevation, sky_color, device="cpu")
    return dataclasses.replace(scene, env_cdf=cdf.to(scene.device))


def attach_atmosphere(scene: Scene, atmosphere=None, cache_path=None,
                      dims=None) -> Scene:
    """Attach a Bruneton atmosphere (earth_atmosphere.init(), main.cpp:1504
    / atmosphere.cpp:1177; vpt_tpu/scene/scene.py:283): ``atmosphere``
    (sky/runtime.py::Atmosphere, moved to the scene's device), or one
    precomputed or loaded from ``cache_path`` at ``dims`` on the scene's
    device."""
    from vpt_tpu_torch.sky.bruneton import LutDims
    from vpt_tpu_torch.sky.runtime import make_atmosphere
    if atmosphere is None:
        atmosphere = make_atmosphere(dims or LutDims(),
                                     cache_path=cache_path,
                                     device=scene.device)
    return dataclasses.replace(scene,
                               atmosphere=atmosphere.to(scene.device))


def attach_sky_cache(scene: Scene, azimuth: float, elevation: float,
                     height: int = 256, width: int = 512) -> Scene:
    """Bake the attached atmosphere, seen from the scene's centre, into an
    equirect cache (sky/runtime.py::bake_sky_cache; vpt_tpu/scene/
    scene.py:330): the terminal ATMOSPHERE lookup then reads one bilinear
    fetch.  For this sun only: re-bake when it moves."""
    if scene.atmosphere is None:
        raise ValueError("attach_sky_cache needs an attached atmosphere "
                         "(attach_atmosphere first)")
    from vpt_tpu_torch.sky.runtime import bake_sky_cache
    # the root box's centre as the reference's float32 numpy halves it
    centre = (scene.root_pmin.cpu().numpy()
              + scene.root_pmax.cpu().numpy()) / np.float32(2)
    cache = bake_sky_cache(scene.atmosphere, centre, azimuth, elevation,
                           height, width)
    return dataclasses.replace(scene, sky_cache=cache.contiguous())


def load_hdr_env_scene(hdr_path: str, **kw) -> Scene:
    """A scene from a `.hdr` file alone: the default procedural volume
    lit by the map (vpt_tpu/scene/scene.py:349-355; main.cpp:1276-1297).
    ``kw`` goes to build_scene."""
    from vpt_tpu_torch.utils.hdr import load_hdr
    from vpt_tpu_torch.volume.procedural import default_procedural_grid
    device = kw.get("device", DEFAULT_DEVICE)
    scene = build_scene([default_procedural_grid(device=device)], **kw)
    return attach_env_map(scene, load_hdr(hdr_path))
