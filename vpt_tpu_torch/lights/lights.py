"""Point lights (port of vpt_tpu/lights/lights.py; light.h:91-153)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE


@dataclass(frozen=True)
class PointLights:
    pos: torch.Tensor    # (L, 3)
    color: torch.Tensor  # (L, 3)
    power: torch.Tensor  # (L,)

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def make(pos, color, power, device=DEFAULT_DEVICE) -> "PointLights":
        f32 = dict(dtype=torch.float32, device=device)
        return PointLights(
            pos=torch.as_tensor(np.atleast_2d(pos), **f32),
            color=torch.as_tensor(np.atleast_2d(color), **f32),
            power=torch.as_tensor(np.atleast_1d(power), **f32))

    @staticmethod
    def empty(device=DEFAULT_DEVICE) -> "PointLights":
        return PointLights(pos=torch.zeros((0, 3), device=device),
                           color=torch.zeros((0, 3), device=device),
                           power=torch.zeros((0,), device=device))

    def to(self, device) -> "PointLights":
        return PointLights(self.pos.to(device), self.color.to(device),
                           self.power.to(device))
