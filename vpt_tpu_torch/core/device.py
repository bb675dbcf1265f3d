"""The port's default device: the card.

Every entry point that builds tensors (scene, grid, film, camera,
lights, draws) takes ``device=DEFAULT_DEVICE``.  A caller who wants the
CPU says so (``device="cpu"``, or ``--cpu`` on the CLI); nothing falls
back to the CPU when there is no card — torch's own CUDA error is
raised instead.  Helpers that take their device from a tensor argument
keep doing so.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = torch.device("cuda")
