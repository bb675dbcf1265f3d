"""The terminal environment lookup (port of
vpt_tpu/render/integrator.py::environment_radiance, :26-45) and kernel
K4, which adds it to each finished ray's radiance on the card.

``environment_radiance`` is K4's plain version.  ``add_environment``
computes L + environment_radiance(dir) * beta: on CPU tensors with the
plain version, on CUDA tensors with K4 (csrc/environment.cu), in place
on L.  K4 takes the two environments that depend on the direction, HDRI
with a map and the simple sky (ATMOSPHERE); K1 adds BLACK and CONSTANT
itself when a ray retires, so those launch no K4.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from vpt_tpu_torch.core.phase import isotropic
from vpt_tpu_torch.core.vecmath import degree_to_cartesian
from vpt_tpu_torch.ops import cuda
from vpt_tpu_torch.render.nee import environment_light_radiance
from vpt_tpu_torch.render.params import Environment
from vpt_tpu_torch.render.tracking import vec3_param

ENVIRONMENT = cuda.Kernel(
    name="environment", route="cuda",
    source="vpt_tpu_torch/csrc/environment.cu",
    replaces="vpt_tpu/render/integrator.py:26")
ENV_SKY, ENV_HDRI = 0, 1


def environment_radiance(scene, params, pos, wi):
    """Radiance arriving along ``wi`` from the environment
    (render_kernel.cu:1838-1850): ATMOSPHERE -> the simple sky
    * sky_color * sky_mult (sky_color applied twice, as in the
    reference); HDRI -> the map * sky_color * isotropic() (QUIRKS #8), 0
    without a map; BLACK -> 0; CONSTANT -> sky_color * sky_mult."""
    et = params.environment_type
    if et == int(Environment.BLACK):
        return torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                           device=pos.device)
    if et == int(Environment.CONSTANT):
        sky = vec3_param(params.sky_color, pos.device) * params.sky_mult
        return sky.expand(pos.shape[:-1] + (3,))
    if et == int(Environment.HDRI):
        if scene.env_map is None:
            return torch.zeros(pos.shape[:-1] + (3,), dtype=torch.float32,
                               device=pos.device)
        from vpt_tpu_torch.sky.envmap import sample_env_map
        return (sample_env_map(scene.env_map, wi)
                * vec3_param(params.sky_color, wi.device) * isotropic())
    li = environment_light_radiance(scene, params, pos, wi)
    return li * vec3_param(params.sky_color, wi.device) * params.sky_mult


def defers_environment(scene, params) -> bool:
    """True when the terminal environment depends on the direction (the
    simple sky, or HDRI with a map): K1 then hands each ray's beta and
    direction to K4 instead of adding the environment itself."""
    et = params.environment_type
    return (et == int(Environment.ATMOSPHERE)
            or (et == int(Environment.HDRI) and scene.env_map is not None))


class _EnvParams(ctypes.Structure):
    """Mirror of ``EnvParams`` in csrc/environment.cu."""

    _fields_ = [(n, ctypes.c_int) for n in ("n", "kind", "map_h", "map_w")] \
        + [(n, ctypes.c_float * 3) for n in ("sun", "color")] \
        + [(n, ctypes.c_float) for n in (
            "mult", "u_scale", "pi", "earth_r", "earth_r2", "atm_r2",
            "observer_y", "hr", "hm", "hr_inv", "hm_inv", "c_r", "c_m",
            "one_minus_g2", "one_plus_g2", "two_g", "two_plus_g2")] \
        + [(n, ctypes.c_float * 3) for n in ("beta_r", "beta_m",
                                             "beta_m11")]


@dataclass
class EnvLaunch:
    """K4's launch arguments for one (scene, params), built once."""

    params: _EnvParams
    env_map: Optional[torch.Tensor]   # (H, W, 3) float32 on the card


def _c3(values):
    return (ctypes.c_float * 3)(*[float(v) for v in values])


def prepare_environment(scene, params) -> EnvLaunch:
    """K4's parameter struct: the sun direction from
    core/vecmath.py::degree_to_cartesian, as the plain version makes it,
    the sky's float32 constants, and the map for HDRI."""
    if not defers_environment(scene, params):
        raise ValueError("K4 takes the simple sky or HDRI with a map")
    if getattr(scene, "atmosphere", None) is not None:
        raise NotImplementedError("the Bruneton atmosphere is not ported "
                                  "yet (ROADMAP A.7)")
    cuda.check_struct(_EnvParams,
                      cuda.load_library().dll.vpt_env_params_size)
    from vpt_tpu_torch.sky.procedural import sky_constants
    p = _EnvParams()
    p.sun = _c3(degree_to_cartesian(params.azimuth, params.elevation,
                                    "cpu").tolist())
    p.color = _c3(vec3_param(params.sky_color).tolist())
    env_map = None
    if params.environment_type == int(Environment.HDRI):
        env_map = scene.env_map
        cuda.check_cuda_tensor(env_map, "env_map", dtype=torch.float32)
        if env_map.dim() != 3 or env_map.shape[2] != 3:
            raise ValueError(f"env_map: shape {tuple(env_map.shape)}, "
                             "expected (H, W, 3)")
        if env_map.numel() > 2 ** 31 - 1:
            raise ValueError("env_map: K4 indexes the map in 32 bits")
        p.kind, p.mult = ENV_HDRI, isotropic()
        p.u_scale, p.pi = 0.5 / math.pi, math.pi
        p.map_h, p.map_w = env_map.shape[0], env_map.shape[1]
    else:
        p.kind, p.mult = ENV_SKY, float(params.sky_mult)
    for name, v in sky_constants().items():
        setattr(p, name, _c3(v) if isinstance(v, list) else v)
    return EnvLaunch(p, env_map)


def add_environment(scene, params, L, beta, dirn,
                    launch: EnvLaunch | None = None):
    """L + environment_radiance(scene, params, dirn, dirn) * beta for
    (B, 3) tensors (the position matters only to the Bruneton
    atmosphere, which is not ported).  CPU tensors: the plain version, a
    new tensor.  CUDA tensors: K4 (``launch`` from prepare_environment,
    or None to prepare it here) adds the term in place on L, which it
    returns."""
    if L.device.type == "cpu":
        return L + environment_radiance(scene, params, dirn, dirn) * beta
    if L.device.type != "cuda":
        raise ValueError(f"add_environment: unsupported device {L.device}")
    if launch is None:
        launch = prepare_environment(scene, params)
    n = L.shape[0]
    for t, name in ((L, "L"), (beta, "beta"), (dirn, "dirn")):
        cuda.check_cuda_tensor(t, f"add_environment: {name}", (n, 3),
                               torch.float32, L.device)
    if 3 * n > 2 ** 31 - 1:
        raise ValueError(f"add_environment: {n} rays; K4 indexes in 32 "
                         "bits")
    if launch.env_map is not None and launch.env_map.device != L.device:
        raise ValueError("add_environment: the map is on another device")
    p = _EnvParams.from_buffer_copy(launch.params)
    p.n = n
    rc = cuda.load_library().dll.vpt_environment(
        ctypes.byref(p), L.data_ptr(), beta.data_ptr(), dirn.data_ptr(),
        None if launch.env_map is None else launch.env_map.data_ptr(),
        cuda.current_stream(L.device))
    cuda.check_status(rc, ENVIRONMENT.name)
    ENVIRONMENT.launches += 1
    return L


def div_known_sweep(d: float, y: float, lo: int = 0, hi: int = 2 ** 32,
                    device="cuda", chunk: int = 2 ** 22):
    """Hold csrc/vpt_common.cuh::div_known2 (d and y as both divisors and
    both reciprocals) to IEEE float32 division x / d for every 32-bit
    pattern x in [lo, hi): (the number of patterns whose results differ
    in a bit and are not both NaN, the first of them or None).  On a CUDA device the sweep kernel
    (environment.cu::vpt_div_known_sweep) computes both on the card; on
    the CPU ``sky.procedural.div_known_plain`` against numpy's float32
    division, ``chunk`` patterns at a time.  A test of K4's divisions,
    not on the render path."""
    import numpy as np
    from vpt_tpu_torch.sky.procedural import div_known_plain
    if not 0 <= lo <= hi <= 2 ** 32:
        raise ValueError(f"div_known_sweep: [{lo}, {hi}) is not within "
                         "[0, 2^32)")
    dev = torch.device(device)
    if dev.type == "cpu":
        bad, first = 0, None
        d32 = np.float32(d)
        for a in range(lo, hi, chunk):
            bits = np.arange(a, min(a + chunk, hi), dtype=np.uint64)
            x = bits.astype(np.uint32).view(np.float32)
            got = div_known_plain(x, d, y)
            with np.errstate(all="ignore"):
                want = x / d32
            diff = (got.view(np.uint32) != want.view(np.uint32)) & ~(
                np.isnan(got) & np.isnan(want))
            if diff.any():
                bad += int(diff.sum())
                if first is None:
                    first = int(bits[np.argmax(diff)])
        return bad, first
    if dev.type != "cuda":
        raise ValueError(f"div_known_sweep: unsupported device {dev}")
    out = torch.tensor([0, -1], dtype=torch.int64, device=dev)
    rc = cuda.load_library().dll.vpt_div_known_sweep(
        float(d), float(y), lo, hi, out.data_ptr(), cuda.current_stream(dev))
    cuda.check_status(rc, "div_known_sweep")
    bad, first = out.cpu().tolist()
    return bad, (None if bad == 0 else first)
