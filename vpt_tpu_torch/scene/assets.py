"""The built-in LUT assets: the blackbody emission LUT and the density
color LUT (port of vpt_tpu/scene/assets.py:10-40, the reference's
ASSET_PATH files, main.cpp:1378-1403).

The directories are searched in the reference's order: ``$VPT_ASSET_PATH``,
then the repository's ``assets/``.  (The reference also searches one
fixed absolute directory of its own.)  Without the files ``build_scene``
falls back to white LUTs, as the reference's does.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_ASSET_DIRS = [
    os.environ.get("VPT_ASSET_PATH", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets"),
]


def _find(name: str) -> str | None:
    for d in DEFAULT_ASSET_DIRS:
        if d and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    return None


def load_lut(name: str) -> np.ndarray | None:
    """(256, 3) float32 RGB LUT from a 256x1 EXR, None when no asset
    directory holds ``name``; a file of another length is resized as
    numpy resizes (repeated, or cut)."""
    path = _find(name)
    if path is None:
        return None
    from vpt_tpu_torch.utils.exr import read_exr_rgb
    lut = read_exr_rgb(path).reshape(-1, 3)
    if lut.shape[0] != 256:
        lut = np.resize(lut, (256, 3))
    return np.ascontiguousarray(lut, np.float32)


def load_blackbody_lut() -> np.ndarray | None:
    return load_lut("blackbody_texture.exr")


def load_density_color_lut() -> np.ndarray | None:
    return load_lut("density_color_texture2.exr")


def ramp_lut() -> np.ndarray:
    """A synthetic (256, 3) blackbody-like emission LUT: black through
    red and yellow to white, for scenes rendered without the EXR assets
    (the tests and chip_smoke.py use it, so emission is not white)."""
    t = np.linspace(0.0, 1.0, 256, dtype=np.float32)[:, None]
    return np.clip(3.0 * t - np.arange(3, dtype=np.float32), 0.0,
                   1.0).astype(np.float32)
