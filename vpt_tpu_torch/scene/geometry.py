"""The reference sphere (port of vpt_tpu/scene/geometry.py:29-41, 90-104;
geometry.h).  Enabled by default at (0, 1000, 0), r = 1: tracking walks
treat a hit as an opaque occluder and the direct integrator shades it."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE


@dataclass(frozen=True)
class Sphere:
    center: torch.Tensor     # (3,)
    radius: torch.Tensor     # ()
    color: torch.Tensor      # (3,)
    roughness: torch.Tensor  # ()
    enabled: torch.Tensor    # () bool

    @staticmethod
    def make(center=(0.0, 1000.0, 0.0), radius=1.0, color=(10.0, 0.0, 0.0),
             roughness=1.0, enabled=True,
             device=DEFAULT_DEVICE) -> "Sphere":
        f32 = dict(dtype=torch.float32, device=device)
        return Sphere(center=torch.as_tensor(center, **f32),
                      radius=torch.as_tensor(radius, **f32),
                      color=torch.as_tensor(color, **f32),
                      roughness=torch.as_tensor(roughness, **f32),
                      enabled=torch.as_tensor(enabled, dtype=torch.bool,
                                              device=device))

    def to(self, device) -> "Sphere":
        return Sphere(self.center.to(device), self.radius.to(device),
                      self.color.to(device), self.roughness.to(device),
                      self.enabled.to(device))


def _sphere_roots(center, radius, ray_pos, ray_dir):
    """(hit, tmin, tmax) with the reference's root ordering: sorted
    roots, tmin<0 -> tmax, a miss when both are negative
    (geometry.h:114-140)."""
    orig = ray_pos - center
    a = (ray_dir[..., 0] * ray_dir[..., 0] + ray_dir[..., 1] * ray_dir[..., 1]
         + ray_dir[..., 2] * ray_dir[..., 2])
    b = 2.0 * (ray_dir[..., 0] * orig[..., 0] + ray_dir[..., 1] * orig[..., 1]
               + ray_dir[..., 2] * orig[..., 2])
    c = (orig[..., 0] * orig[..., 0] + orig[..., 1] * orig[..., 1]
         + orig[..., 2] * orig[..., 2]) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    tmin = torch.where(tmin < 0.0, tmax, tmin)
    hit = ok & (tmin >= 0.0)
    return hit, tmin, tmax
