"""Scene container and the single-instance builder (port of
vpt_tpu/scene/scene.py:117-274).

The reference's majorant grid is not built: the single-instance
full-fetch path never reads it (vpt_tpu/render/fused.py:182,
tracking.py:120-122).  The LUTs not given are loaded from the EXR assets
as the reference loads them (scene/assets.py), white where none is
found.
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


def _pack_instance_rows(atlas: VolumeAtlas, inv_xform: np.ndarray):
    rows = np.zeros((1, 24), np.float32)
    rows[0, 0:12] = inv_xform[:4, :3].reshape(12)
    rows[0, 12:15] = atlas.bmin[0].cpu().numpy()
    rows[0, 15:18] = atlas.dim[0].cpu().numpy().astype(np.float32)
    rows[0, 18] = float(atlas.offset[0])
    rows[0, 19] = float(atlas.emission_offset[0])
    rows[0, 20] = float(atlas.color_offset[0])
    rows[0, 21] = float(atlas.max_density[0])
    return rows


def default_camera(root_pmin, root_pmax, aspect=1.0,
                   device=DEFAULT_DEVICE):
    """build_scene's default framing (main.cpp:1320-1334)."""
    center = (root_pmin + root_pmax) / 2
    dist = float(np.linalg.norm(root_pmax - root_pmin)) * 1.5
    return Camera.make(center + np.array([0.0, 0.0, dist]), center,
                       vfov=30.0, aspect=aspect, device=device)


def build_scene(host_grids: list[HostGrid], camera: Camera | None = None,
                lights: PointLights | None = None,
                sphere: Sphere | None = None,
                emission_lut: np.ndarray | None = None,
                density_color_lut: np.ndarray | None = None,
                band_divisors: tuple | None = None,
                device=DEFAULT_DEVICE) -> Scene:
    """Assemble a single-instance Scene on ``device``: the grid's own
    file transform, root bounds = instance bounds padded by 1
    (bvh_builder.cpp:76-78), corner rows from volume/grid.py."""
    if len(host_grids) != 1:
        raise NotImplementedError("instanced scenes are not ported yet")
    g = host_grids[0]
    xform = np.asarray(g.transform, np.float64)
    inv = np.linalg.inv(xform)
    pmin, pmax = _world_bounds(g, xform)
    root_pmin = pmin - 1.0
    root_pmax = pmax + 1.0
    atlas = build_atlas(host_grids, band_divisors=band_divisors,
                        device=device)
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
            grid_id=torch.zeros(1, dtype=torch.int32, device=device),
            xform=torch.as_tensor(xform[None], **f32),
            inv_xform=torch.as_tensor(inv32[None], **f32),
            pmin=torch.as_tensor(pmin[None], **f32),
            pmax=torch.as_tensor(pmax[None], **f32),
            packed_rows=torch.as_tensor(_pack_instance_rows(atlas, inv32),
                                        **f32)),
        root_pmin=torch.as_tensor(root_pmin, **f32),
        root_pmax=torch.as_tensor(root_pmax, **f32),
        max_extinction=torch.tensor(g.max_density, **f32),
        min_extinction=torch.tensor(g.min_density, **f32),
        lights=(lights if lights is not None
                else PointLights.empty(device)).to(device),
        sphere=(sphere if sphere is not None
                else Sphere.make(device=device)).to(device),
        camera=camera.to(device),
        emission_lut=torch.as_tensor(luts[0], **f32),
        density_color_lut=torch.as_tensor(luts[1], **f32))


def attach_env_map(scene: Scene, env_map) -> Scene:
    """Attach an equirect HDR environment, (H, W, 3), on the scene's
    device (create_environment, main.cpp:945-978).  The reference also
    builds the map's importance CDF here; only its sky NEE
    (``estimate_sky``, reference and volumetric engines) reads it, so
    the port builds none until those engines come (ROADMAP A.8)."""
    env = torch.as_tensor(np.asarray(env_map, np.float32),
                          device=scene.device)
    if env.dim() != 3 or env.shape[2] != 3:
        raise ValueError(f"env_map: shape {tuple(env.shape)}, expected "
                         "(H, W, 3)")
    return dataclasses.replace(scene, env_map=env.contiguous())


def load_hdr_env_scene(hdr_path: str, **kw) -> Scene:
    """A scene from a `.hdr` file alone: the default procedural volume
    lit by the map (vpt_tpu/scene/scene.py:349-355; main.cpp:1276-1297).
    ``kw`` goes to build_scene."""
    from vpt_tpu_torch.utils.hdr import load_hdr
    from vpt_tpu_torch.volume.procedural import default_procedural_grid
    device = kw.get("device", DEFAULT_DEVICE)
    scene = build_scene([default_procedural_grid(device=device)], **kw)
    return attach_env_map(scene, load_hdr(hdr_path))
