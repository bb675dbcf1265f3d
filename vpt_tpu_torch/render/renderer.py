"""Render orchestration: primary rays, the fused trace, the progressive
step and the ProgressiveRenderer host loop (port of
vpt_tpu/render/renderer.py).

The port traces the whole frame as ONE tile of one ray per lane: the
reference's ray queues, cost-ordered blocks, tiled2d deal and
stratification are TPU scheduling devices and are not ported.  So the
port matches the reference draw for draw whenever the reference itself
runs one Q = 1 tile (H*W <= fused_tile and below its auto-queue
threshold of 131072 rays), as at test sizes.  At and above that
threshold the reference's queues still set the step budget:
``render_rays`` passes resolve_queue's Q to fused_direct (16 rays per
lane: 16 x max_fused_steps steps a ray, a ray still walking at the end
written as an unretired queue slot).

The keys: ``render_key(seed, it)``; jitter from ``fold_in(key, 17)``;
the camera and trace keys from ``split(key)``; the single tile's key
``fold_in(trace_key, 1000)``.

The reference engine and the volumetric integrator (``_trace_walks``)
trace in the reference's tiles of ``fused_tile`` rays, tile t under
``fold_in(trace_key, 1000 + t)``: on the card K2 and then kernel K5
(render/walk.py) over every tile in one launch, K4 after it for the sky,
HDRI and the atmosphere; on the CPU the plain integrators tile by tile.

On a CUDA scene with cached shadows ``render_rays`` launches K1 (and K4
after it for HDRI or the simple sky) on its in-kernel-ray route: each
lane makes its primary ray with K2's code (csrc/raygen.cuh), so the
sample writes and reads no ray buffer.  With
tracked shadows it launches K2 (csrc/raygen.cu) and K1 on K2's ray
buffers, which ran faster on the H100 than the in-kernel-ray route
there (PERF.md).  ``primary_rays`` launches K2 for a CUDA camera and
runs ``primary_rays_plain`` on the CPU; on the CPU ``render_rays``
chains primary_rays and fused_direct.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import true_div
from vpt_tpu_torch.ops import cuda
from vpt_tpu_torch.render.film import Film, accumulate, to_display
from vpt_tpu_torch.render import walk
from vpt_tpu_torch.render.fused import (FusedLaunch, _fused_direct_cuda,
                                        _fused_direct_primary_cuda,
                                        fused_direct, prepare_fused)
from vpt_tpu_torch.render.integrator import direct_integrator
from vpt_tpu_torch.render.params import (Integrator, RenderParams,
                                         check_slice, resolve_queue,
                                         walk_engine)
from vpt_tpu_torch.render.vol_integrator import vol_integrator

JITTER_FOLD = 17
TILE_FOLD = 1000

# K1's ray source on a CUDA scene, per shadow mode, chosen by timing on
# the H100 (PERF.md): rays made in K1's lanes for cached shadows; for
# tracked shadows K2's buffers, with which K1 ran faster
RAYS_IN_KERNEL = {"cached": True, "tracked": False}

RAYGEN = cuda.Kernel(
    name="primary_rays", route="cuda", source="vpt_tpu_torch/csrc/raygen.cu",
    replaces="vpt_tpu/render/renderer.py:37")


def _pixel_jitter(params, key, height, width, device="cpu"):
    """Sub-pixel jitter: threefry white noise, (H, W, 2)."""
    if params.jitter != "white":
        raise NotImplementedError("blue-noise jitter is not ported yet")
    return rng.uniform(key, (height, width, 2), device)


def primary_rays_plain(camera, params, key):
    """Jittered film coordinates -> thin-lens primary rays, (H*W, 3)
    origins and directions, in pixel order."""
    H, W = params.height, params.width
    dev = camera.origin.device
    jit = _pixel_jitter(params, rng.fold_in(key, JITTER_FOLD), H, W, dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    # true divisions on every device, as K2 divides (csrc/raygen.cuh)
    u = true_div(xs + jit[..., 0], W).reshape(-1)
    v = true_div(ys + jit[..., 1], H).reshape(-1)
    k_lens, _ = rng.split(key)
    return camera.get_rays(u, v, k_lens)


def lens_draws_needed(camera) -> bool:
    """False exactly when the lens draws cannot change a bit of a primary
    ray, so K2 (csrc/raygen.cu) skips them: ``lens_radius`` is
    +-0, the lens frame u, v is finite (each offset component is then
    +-0) and the origin is finite with no component -0.0 (origin + (+-0)
    is then origin in round-to-nearest; -0.0 + +0.0 is +0.0).  The plain
    version draws at every aperture, as the reference does."""
    if float(camera.lens_radius) != 0.0:
        return True
    frame = camera.u.tolist() + camera.v.tolist()
    origin = camera.origin.tolist()
    return (not all(math.isfinite(c) for c in frame + origin)
            or any(c == 0.0 and math.copysign(1.0, c) < 0 for c in origin))


class _RaygenParams(ctypes.Structure):
    """Mirror of ``RaygenParams`` in csrc/raygen.cuh.  ``prepare_raygen``
    also sets ``lens_draws`` (lens_draws_needed's answer), a Python
    attribute beside the fields, which K2's launch passes on."""

    _fields_ = ([("H", ctypes.c_int), ("W", ctypes.c_int)]
                + [(n, ctypes.c_uint * 2) for n in ("k_jit", "k_lens_r",
                                                    "k_lens_phi")]
                + [(n, ctypes.c_float * 3) for n in (
                    "origin", "llc", "horizontal", "vertical", "u", "v")]
                + [("lens_radius", ctypes.c_float)])


def prepare_raygen(camera, params) -> _RaygenParams:
    """K2's parameter struct for one camera and frame size (syncs once;
    the keys are set per launch), with lens_draws_needed's answer."""
    if camera.origin.device.type != "cuda":
        raise ValueError("primary_rays: the kernel takes a CUDA camera")
    if params.jitter != "white":
        raise NotImplementedError("blue-noise jitter is not ported yet")
    cuda.check_struct(_RaygenParams,
                      cuda.load_library().dll.vpt_raygen_params_size)
    p = _RaygenParams()
    p.H, p.W = params.height, params.width
    for name, t in (("origin", camera.origin),
                    ("llc", camera.lower_left_corner),
                    ("horizontal", camera.horizontal),
                    ("vertical", camera.vertical), ("u", camera.u),
                    ("v", camera.v)):
        setattr(p, name, (ctypes.c_float * 3)(*t.cpu().tolist()))
    p.lens_radius = float(camera.lens_radius)
    p.lens_draws = lens_draws_needed(camera)
    return p


def _raygen_for_sample(launch: _RaygenParams, key) -> _RaygenParams:
    """K2's parameters with the keys of sample ``key`` set."""
    p = _RaygenParams.from_buffer_copy(launch)
    k_lens, _ = rng.split(key)
    k_r, k_phi = rng.split(k_lens)
    for name, k in (("k_jit", rng.fold_in(key, JITTER_FOLD)),
                    ("k_lens_r", k_r), ("k_lens_phi", k_phi)):
        setattr(p, name, (ctypes.c_uint * 2)(*k))
    return p


def _primary_rays_cuda(camera, params, key, launch=None):
    """Launch K2 on the current stream (``launch`` from prepare_raygen,
    or None to prepare it here)."""
    if launch is None:
        launch = prepare_raygen(camera, params)
    dev = camera.origin.device
    p = _raygen_for_sample(launch, key)
    n = p.H * p.W
    origin = torch.empty((n, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rc = cuda.load_library().dll.vpt_primary_rays(
        ctypes.byref(p), int(launch.lens_draws), origin.data_ptr(),
        direction.data_ptr(), cuda.current_stream(dev))
    cuda.check_status(rc, "primary_rays")
    RAYGEN.launches += 1
    return origin, direction


def primary_rays(camera, params, key, launch=None):
    """K2 on a CUDA camera, the plain version on a CPU one."""
    dev = camera.origin.device
    if dev.type == "cpu":
        return primary_rays_plain(camera, params, key)
    if dev.type != "cuda":
        raise ValueError(f"primary_rays: unsupported device {dev}")
    return _primary_rays_cuda(camera, params, key, launch)


@dataclass
class Launches:
    """The prepared kernel arguments of one (scene, params): K2's, and
    K1's for the fused engine or K5's for the reference engine's walks."""

    raygen: _RaygenParams
    fused: FusedLaunch | None = None
    walk: walk.WalkLaunch | None = None


def _volumetric(params) -> bool:
    return params.integrator == int(Integrator.VOLUMETRIC)


def prepare(scene, params) -> Launches | None:
    """Prepared K2 and K1 or K5 arguments for a CUDA scene; None on the
    CPU."""
    if scene.device.type != "cuda":
        return None
    raygen = prepare_raygen(scene.camera, params)
    if walk_engine(params):
        return Launches(raygen, walk=walk.prepare_walk(scene, params,
                                                       _volumetric(params)))
    return Launches(raygen, prepare_fused(scene, params))


def tile_key(key):
    """The key of fused_direct's one tile for sample ``key``."""
    return rng.fold_in(rng.split(key)[1], TILE_FOLD)


def frame_queue(params) -> int:
    """The queue length of one full-frame sample (resolve_queue)."""
    return resolve_queue(params, params.width * params.height)


def _trace_primary_cuda(scene, params, key, launches=None):
    """One sample through K1's in-kernel-ray route (``launches`` from
    prepare, or None to prepare them here): fused_direct's flat outputs
    on the rays primary_rays would make, with no ray buffer."""
    launches = launches or Launches(prepare_raygen(scene.camera, params),
                                    prepare_fused(scene, params))
    return _fused_direct_primary_cuda(
        scene, params, tile_key(key),
        _raygen_for_sample(launches.raygen, key), launches.fused,
        frame_queue(params))


def _trace_buffers_cuda(scene, params, key, launches=None):
    """One sample through K2 and K1's buffer route, the frame scheduled
    as on the in-kernel-ray route: the same outputs, bit for bit."""
    launches = launches or Launches(prepare_raygen(scene.camera, params),
                                    prepare_fused(scene, params))
    rays = _primary_rays_cuda(scene.camera, params, key, launches.raygen)
    return _fused_direct_cuda(
        scene, params, tile_key(key), *rays, launches.fused, params.width,
        frame_queue(params))


def _trace_walks(scene, params, key, launches=None):
    """One sample through the reference engine's walks (the direct or the
    volumetric integrator) on the primary rays, in the reference's tiles
    of fused_tile rays (vpt_tpu/render/renderer.py:186-215): tile t
    draws under fold_in(trace key, 1000 + t).  CUDA: K2, then K5 on every
    tile in one launch (and K4 after it); CPU: the plain integrator tile
    by tile."""
    volumetric = _volumetric(params)
    trace_key = rng.split(key)[1]
    if scene.camera.origin.device.type == "cuda":
        launches = launches or prepare(scene, params)
        origin, direction = _primary_rays_cuda(scene.camera, params, key,
                                               launches.raygen)
        tile = min(params.fused_tile, max(origin.shape[0], 1))
        run = walk.walk_volumetric if volumetric else walk.walk_direct
        return run(scene, params, trace_key, origin, direction,
                   launches.walk, tile)
    origin, direction = primary_rays(scene.camera, params, key)
    B = origin.shape[0]
    tile = min(params.fused_tile, max(B, 1))
    run = vol_integrator if volumetric else direct_integrator
    outs = [run(scene, params, rng.fold_in(trace_key, TILE_FOLD + ti),
                origin[a:a + tile], direction[a:a + tile])
            for ti, a in enumerate(range(0, B, tile))]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def render_rays(scene, params, key, launches: Launches | None = None):
    """One full-frame sample: (value (H,W,3), alpha (H,W), aux dict of
    (H,W) AOVs cost/depth/trunc).  The reference engine and the
    volumetric integrator trace through their walks (_trace_walks); the
    fused engine on a CUDA scene runs K1 on the ray source of
    RAYS_IN_KERNEL (and K4 after it for HDRI or the simple sky), on a CPU
    scene the plain primary_rays and fused_direct.  The fused step budget
    is the frame's queue length (frame_queue)."""
    H, W = params.height, params.width
    if walk_engine(params):
        L, alpha, cost, unfinished, depth = _trace_walks(scene, params, key,
                                                         launches)
    elif scene.camera.origin.device.type == "cuda":
        trace = (_trace_primary_cuda if RAYS_IN_KERNEL[params.shadow_mode]
                 else _trace_buffers_cuda)
        L, alpha, cost, unfinished, depth = trace(scene, params, key,
                                                  launches)
    else:
        origin, direction = primary_rays(scene.camera, params, key)
        L, alpha, cost, unfinished, depth = fused_direct(
            scene, params, tile_key(key), origin, direction,
            queue=frame_queue(params))
    aux = dict(cost=cost, depth=depth, trunc=unfinished)
    return (L.reshape(H, W, 3), alpha.reshape(H, W),
            {k: v.reshape(H, W) for k, v in aux.items()})


def _render_step(scene, params, film, iteration, launches=None):
    key = rng.render_key(params.seed, iteration)
    value, alpha, aux = render_rays(scene, params, key, launches)
    return accumulate(film, value, alpha, iteration, depth=aux["depth"],
                      cost=aux["cost"], trunc=aux["trunc"])


class ProgressiveRenderer:
    """Host-side progressive accumulation loop: each ``step()`` adds one
    sample per pixel (main.cpp:1823-1829).  ``scene`` and ``params`` may
    be reassigned on a live renderer, as the reference's viewer does;
    each assignment prepares the kernels' arguments anew."""

    def __init__(self, scene, params: RenderParams):
        check_slice(params)
        self._scene, self._params = scene, params
        self.launches = prepare(scene, params)
        self.film = Film.zeros(params.height, params.width, scene.device)
        self.iteration = 0

    @property
    def scene(self):
        return self._scene

    @scene.setter
    def scene(self, scene):
        self._scene = scene
        self.launches = prepare(scene, self._params)

    @property
    def params(self) -> RenderParams:
        return self._params

    @params.setter
    def params(self, params: RenderParams):
        check_slice(params)
        self._params = params
        self.launches = prepare(self._scene, params)

    def step(self, n: int = 1) -> Film:
        for _ in range(n):
            self.film = _render_step(self.scene, self.params, self.film,
                                     self.iteration, self.launches)
            self.iteration += 1
        return self.film

    def render(self, spp: int) -> Film:
        self.step(spp)
        if self.film.accum.is_cuda:
            torch.cuda.synchronize(self.film.accum.device)
        return self.film

    def reset(self):
        self.film = Film.zeros(self.params.height, self.params.width,
                               self.scene.device)
        self.iteration = 0

    def display_image(self) -> np.ndarray:
        return to_display(self.film, self.params.exposure_scale).cpu().numpy()
