"""Carry a scene's tables across as plain arrays.

``scene_from_arrays`` turns the leaves of a reference ``Scene`` — handed
over as numpy arrays keyed by their dotted field path, e.g.
``"atlas.density_corners"`` or ``"camera.origin"`` — into the port's
``Scene`` on ``device``.  With it both packages render the identical
tables.  ``scene_to_arrays`` is its inverse for the port's own scenes.
An ``env_map`` leaf may be the reference's (H, W, 12) corner-packed rows
or the port's raw (H, W, 3) map: its first 3 channels are the raw map
either way.  An instanced scene carries its majorant grid
(``"majorant.packed"``, and ``"majorant.cell_rows"`` ... where it has
cell lists) and its world tau grid (``"world_tau"``); a single
instance's majorant grid is dropped, since its walk never reads it.
The environment CDF is carried as its tables
(``"env_cdf.func"`` ...).  A Bruneton atmosphere is carried as its model
(``"atmosphere.params.*"``), its LUTs (``"atmosphere.luts.*"``) and its
dims (``"atmosphere.dims.*"``); the reference's corner-packed LUTs
(``"atmosphere.packed.*"``) are dropped, the port reads the plain ones.
A ``sky_cache`` leaf may be the reference's (H, W, 24) corner-packed rows
or the port's (H, W, 6) texture: its first 6 channels are the texture.
bfloat16 corner rows come as the reference's ml_dtypes array, read by
its dtype's name as 16-bit patterns (ml_dtypes is not imported), or as
the ``uint16`` view that ``scene_to_arrays`` writes (numpy has no
bfloat16 of its own), with ``"atlas.density_corners_dtype"`` naming the
type; ``"atlas.octant_cols"`` (0 or 72) goes with them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.scene.geometry import Sphere
from vpt_tpu_torch.scene.scene import (Instances, MajorantGrid, Scene,
                                       check_instanced)
from vpt_tpu_torch.volume.grid import VolumeAtlas

_GROUPS = {"atlas": VolumeAtlas, "instances": Instances,
           "lights": PointLights, "sphere": Sphere, "camera": Camera}
_TOP = ("root_pmin", "root_pmax", "max_extinction", "min_extinction",
        "emission_lut", "density_color_lut")


BF16 = "bfloat16"


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def _corner_rows(arrays: dict, device):
    """The corner rows: bfloat16 from the reference's ml_dtypes array or
    from a uint16 view with its dtype key (the same 16 bits), else
    float32."""
    a = np.asarray(arrays["atlas.density_corners"])
    if str(arrays.get("atlas.density_corners_dtype", a.dtype.name)) == BF16:
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return _tensor(a, device)


def scene_from_arrays(arrays: dict, device=DEFAULT_DEVICE) -> Scene:
    """Port Scene from ``{dotted leaf name: numpy array}``.

    Raises NotImplementedError for what this slice does not render:
    instanced scenes in bfloat16 rows or with octant columns."""
    n = np.asarray(arrays["instances.grid_id"]).shape[0]
    parts = {}
    for group, cls in _GROUPS.items():
        kw = {}
        for f in dataclasses.fields(cls):
            name = f"{group}.{f.name}"
            if name == "atlas.octant_cols":
                kw[f.name] = int(arrays.get(name, 0))
            elif name == "atlas.density_corners":
                kw[f.name] = _corner_rows(arrays, device)
            else:
                kw[f.name] = _tensor(arrays[name], device)
        parts[group] = cls(**kw)
    check_instanced(n, parts["atlas"].density_corners.dtype,
                    parts["atlas"].octant_cols)
    parts.update({k: _tensor(arrays[k], device) for k in _TOP})
    if n > 1 and "majorant.packed" in arrays:
        parts["majorant"] = MajorantGrid(**{
            f.name: _tensor(arrays[f"majorant.{f.name}"], device)
            for f in dataclasses.fields(MajorantGrid)
            if f"majorant.{f.name}" in arrays})
        if "world_tau" in arrays:
            parts["world_tau"] = _tensor(arrays["world_tau"], device)
    if "env_map" in arrays:
        # the reference's corner-packed rows: [..., 0:3] is the raw map
        parts["env_map"] = _tensor(
            np.ascontiguousarray(np.asarray(arrays["env_map"])[..., 0:3]),
            device)
    if "env_cdf.cdf" in arrays:
        from vpt_tpu_torch.sky.cdf import EnvCDF
        parts["env_cdf"] = EnvCDF(**{
            f.name: _tensor(arrays[f"env_cdf.{f.name}"], device)
            for f in dataclasses.fields(EnvCDF)})
    if "atmosphere.luts.transmittance" in arrays:
        parts["atmosphere"] = _atmosphere_from_arrays(arrays, device)
    if "sky_cache" in arrays:
        parts["sky_cache"] = _tensor(np.ascontiguousarray(
            np.asarray(arrays["sky_cache"])[..., 0:6]), device)
    return Scene(**parts)


def _atmosphere_from_arrays(arrays: dict, device):
    from vpt_tpu_torch.sky.bruneton import (AtmosphereLUTs,
                                            AtmosphereParams, LutDims)
    from vpt_tpu_torch.sky.runtime import Atmosphere, check_luts

    def group(cls, prefix, conv):
        return cls(**{f.name: conv(arrays[f"{prefix}.{f.name}"])
                      for f in dataclasses.fields(cls)})

    def param(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return int(a)
        return _tensor(a, device)

    atm = Atmosphere(
        params=group(AtmosphereParams, "atmosphere.params", param),
        luts=group(AtmosphereLUTs, "atmosphere.luts",
                   lambda a: _tensor(a, device)),
        dims=group(LutDims, "atmosphere.dims", int))
    check_luts(atm.luts, atm.dims)
    return atm


def scene_to_arrays(scene: Scene) -> dict:
    """Inverse of scene_from_arrays."""
    out = {}
    for group in _GROUPS:
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, int):
                out[f"{group}.{f.name}"] = np.asarray(v)
            elif v.dtype == torch.bfloat16:
                out[f"{group}.{f.name}"] = v.cpu().view(
                    torch.int16).numpy().view(np.uint16)
                out[f"{group}.{f.name}_dtype"] = np.asarray(BF16)
            else:
                out[f"{group}.{f.name}"] = v.cpu().numpy()
    for k in _TOP:
        out[k] = getattr(scene, k).cpu().numpy()
    if scene.env_map is not None:
        out["env_map"] = scene.env_map.cpu().numpy()
    if scene.majorant is not None:
        for f in dataclasses.fields(scene.majorant):
            v = getattr(scene.majorant, f.name)
            if v is not None:
                out[f"majorant.{f.name}"] = v.cpu().numpy()
    if scene.world_tau is not None:
        out["world_tau"] = scene.world_tau.cpu().numpy()
    if scene.env_cdf is not None:
        for f in dataclasses.fields(scene.env_cdf):
            out[f"env_cdf.{f.name}"] = getattr(scene.env_cdf,
                                               f.name).cpu().numpy()
    if scene.atmosphere is not None:
        atm = scene.atmosphere
        for group in ("params", "luts", "dims"):
            obj = getattr(atm, group)
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                out[f"atmosphere.{group}.{f.name}"] = (
                    v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
    if scene.sky_cache is not None:
        out["sky_cache"] = scene.sky_cache.cpu().numpy()
    return out
