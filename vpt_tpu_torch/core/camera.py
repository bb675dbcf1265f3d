"""Thin-lens camera (port of vpt_tpu/core/camera.py; camera.h:110-136).

Lens points come from a polar disk map over two threefry draws
(QUIRKS #17) — drawn even at aperture 0, where the offset is 0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.device import DEFAULT_DEVICE
from vpt_tpu_torch.core.vecmath import TWO_PI, cross, normalize


@dataclass(frozen=True)
class Camera:
    """Precomputed camera frame (all float32 tensors)."""

    origin: torch.Tensor             # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor         # (3,)
    vertical: torch.Tensor           # (3,)
    u: torch.Tensor                  # (3,) right
    v: torch.Tensor                  # (3,) up
    w: torch.Tensor                  # (3,) backward
    lens_radius: torch.Tensor        # ()
    focus_dist: torch.Tensor         # ()

    @staticmethod
    def make(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=30.0, aspect=1.0,
             aperture=0.0, device=DEFAULT_DEVICE) -> "Camera":
        """camera::update_camera (camera.h:110-129); the focus plane sits
        at the lookat distance."""
        f32 = dict(dtype=torch.float32)
        lookfrom = torch.as_tensor(lookfrom, **f32)
        lookat = torch.as_tensor(lookat, **f32)
        vup = torch.as_tensor(vup, **f32)
        focus_dist = torch.linalg.norm(lookfrom - lookat)
        lens_radius = torch.tensor(aperture, **f32) / 2.0
        theta = torch.deg2rad(torch.tensor(vfov, **f32))
        half_height = torch.tan(theta / 2.0)
        half_width = aspect * half_height
        w = normalize(lookfrom - lookat)
        u = normalize(cross(vup, w))
        v = cross(w, u)
        llc = (lookfrom - half_width * focus_dist * u
               - half_height * focus_dist * v - focus_dist * w)
        cam = Camera(origin=lookfrom, lower_left_corner=llc,
                     horizontal=2.0 * half_width * focus_dist * u,
                     vertical=2.0 * half_height * focus_dist * v,
                     u=u, v=v, w=w, lens_radius=lens_radius,
                     focus_dist=focus_dist)
        return cam.to(device)

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    def get_rays(self, s, t, key):
        """Primary rays for film coords (s, t) in [0,1), batched.
        Returns (origin, normalized direction) (camera.h:131-136)."""
        k1, k2 = rng.split(key)
        shape = s.shape
        r = torch.sqrt(rng.uniform(k1, shape, s.device))
        phi = TWO_PI * rng.uniform(k2, shape, s.device)
        rd = self.lens_radius * r
        offset = (self.u * (rd * torch.cos(phi))[..., None]
                  + self.v * (rd * torch.sin(phi))[..., None])
        origin = self.origin + offset
        direction = (self.lower_left_corner + s[..., None] * self.horizontal
                     + t[..., None] * self.vertical - origin)
        return origin, normalize(direction)
