"""Render configuration (port of vpt_tpu/render/params.py): the same
field names and defaults as the reference's ``RenderParams``.

PyTorch runs eagerly, so the reference's static/dynamic pytree split has
no counterpart here: every field is a plain python value.  Fields that
only shape the reference's TPU scheduling (``fused_tile``,
``rays_per_lane``, ``block_tiles``, ``seek_passes``, ``queue_tiled2d``,
``strat_schedule``, ``fused_loop_mode``) are kept for name parity; the
port traces a frame as one tile of one ray per lane (see
render/renderer.py).  ``rays_per_lane`` = 0 (AUTO) still decides the
step budget: ``resolve_queue`` makes the reference's decision.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class Environment(enum.IntEnum):
    """environment_type (kernel_params.h) + two extensions."""

    ATMOSPHERE = 0
    HDRI = 1
    BLACK = 2      # extension: no environment light
    CONSTANT = 3   # extension: uniform sky_color * sky_mult


class Integrator(enum.IntEnum):
    """kernel_params.integrator (render_kernel.cu:2254-2260)."""

    DIRECT = 0
    VOLUMETRIC = 1


@dataclass(frozen=True)
class RenderParams:
    width: int = 512
    height: int = 512
    ray_depth: int = 50
    volume_depth: int = 1
    max_track_steps: int = 256
    max_fused_steps: int = 128
    integrator: int = int(Integrator.DIRECT)
    environment_type: int = int(Environment.ATMOSPHERE)
    engine: str = "fused"
    seed: int = 0
    jitter: str = "white"
    fused_loop_mode: str = "while"
    fused_tile: int = 16384
    rays_per_lane: int = 0
    block_tiles: int = 64
    seek_passes: int = 0
    queue_tiled2d: bool = True
    strat_schedule: bool = False
    march_tile: int = 65536
    march_samples: int = 160
    shadow_samples: int = 96
    use_double_hg: bool = False
    use_majorant: bool = True
    shadow_mode: str = "tracked"
    hdri_importance: bool = False
    reference_hg_constant: bool = True
    reference_falloff: bool = True

    exposure_scale: float = 1.0
    azimuth: float = 150.0
    elevation: float = 30.0
    sun_color: object = 1.0
    sun_mult: float = 1.0
    sky_color: object = 1.0
    sky_mult: float = 1.0
    phase_g1: float = 0.0
    phase_g2: float = 0.0
    phase_f: float = 1.0
    tr_depth: float = 1.0
    density_mult: float = 1.0
    albedo: object = 1.0
    extinction: object = 1.0
    energy_inject: float = 1.0
    emission_scale: float = 0.0
    emission_pivot: float = 1.0

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)


# vpt_tpu/render/renderer.py:_AUTO_Q and _AUTO_TILE // 2: AUTO turns on
# ray queues of 16 rays per lane for a fused DIRECT batch this large
AUTO_QUEUE = 16
AUTO_QUEUE_MIN_RAYS = 262144 // 2


def resolve_queue(params: RenderParams, n_rays: int) -> int:
    """The reference's queue length Q for a batch of ``n_rays`` rays
    (vpt_tpu/render/renderer.py::_resolve_auto_queue, :100-113):
    ``rays_per_lane`` 0 (AUTO) with the fused engine and the DIRECT
    integrator at n_rays >= 131072 gives 16, anything else 1.

    The port builds no queues.  Q = 16 means two things to
    fused_direct: each ray gets max_fused_steps * 16 steps (the most a
    lane of the reference has for its 16 rays), and a ray still walking
    at the end is written as the reference writes an unretired queue
    slot (L, alpha, cost and depth 0, unfinished 1, no environment)."""
    if params.rays_per_lane > 1:
        raise NotImplementedError("ray queues (rays_per_lane > 1) are a "
                                  "TPU scheduling device, not ported")
    if (params.rays_per_lane == 0 and params.engine == "fused"
            and params.integrator == int(Integrator.DIRECT)
            and n_rays >= AUTO_QUEUE_MIN_RAYS):
        return AUTO_QUEUE
    return 1


def check_slice(params: RenderParams) -> None:
    """Raise NotImplementedError for every option the port does not
    render yet — never render something else in its place.  The renderer
    takes the fused and the reference engine, each with either
    integrator (the volumetric one on any engine, as the reference's
    _engine_fn, vpt_tpu/render/renderer.py:64-93)."""
    if params.engine not in ("fused", "reference"):
        raise NotImplementedError(f"engine {params.engine!r}: 'fused' and "
                                  "'reference' are ported (ROADMAP A.8, "
                                  "render/march.py)")
    Integrator(params.integrator)   # ValueError when unknown
    Environment(params.environment_type)   # ValueError when unknown
    if params.jitter != "white":
        raise NotImplementedError(f"jitter {params.jitter!r}: only "
                                  "'white' is ported")
    if params.rays_per_lane > 1:
        raise NotImplementedError("ray queues (rays_per_lane > 1) are a "
                                  "TPU scheduling device, not ported")
    if not params.use_majorant:
        raise NotImplementedError("use_majorant=False is not ported")
    if params.shadow_mode not in ("tracked", "cached"):
        raise ValueError(f"shadow_mode {params.shadow_mode!r}")
    if params.fused_loop_mode not in ("while", "fori"):
        raise ValueError(f"fused_loop_mode {params.fused_loop_mode!r}")


def check_fused(params: RenderParams) -> None:
    """check_slice, and the fused engine's own: the direct integrator on
    engine 'fused' (the renderer sends the others elsewhere)."""
    check_slice(params)
    if params.engine != "fused":
        raise NotImplementedError(f"engine {params.engine!r}: fused_direct "
                                  "is the fused engine")
    if params.integrator != int(Integrator.DIRECT):
        raise NotImplementedError("fused_direct runs the DIRECT integrator")


def walk_engine(params: RenderParams) -> bool:
    """True when the renderer traces with the reference engine's walks:
    the volumetric integrator on any engine, or the reference engine."""
    return (params.integrator == int(Integrator.VOLUMETRIC)
            or params.engine == "reference")
