"""Helpers shared by the tools and chip_smoke.py: timing, the card's
peak rates and a kernel's bound, a NaN-aware equality, the random inputs
(made on the CPU from a seed, then moved, so a CPU and a CUDA run see
the same numbers), the reference bench's config 2-4 volume, map and
corner rows, its config 5 cloudscape (numpy, copied from bench.py), its
union scenes config5_union and config5_4k, and its bigvol_512 scene, the
c5 golden's instanced scene (copied from tests/golden_scenes.py), and
two instanced configurations of the port's own: ``loop8`` (the static
per-instance loop, two grids) and ``config5_ext`` (config 5 with
emission and color)."""

from __future__ import annotations

import time

import torch

HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12  # H100 SXM data sheet


def bound(n_bytes, n_ops):
    """(least ms the card could take to move n_bytes and do n_ops
    float32 operations, and which of the two sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, device, n=8):
    """(mean milliseconds per call of fn() over n calls after one warm-up
    call, the last result): CUDA events on the card, the host clock on
    the CPU."""
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / n, out
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n, out


def mixed_warp_share(hits_ground, warp: int = 32) -> float:
    """The share of warps (``warp`` consecutive rays, the last one
    short) whose rays take both of sky/runtime.py::sample_atmosphere's
    branches (``hits_ground``, ground_hit's)."""
    n = hits_ground.shape[0]
    pad = torch.zeros((-n) % warp, dtype=torch.int8,
                      device=hits_ground.device)
    g = torch.cat([hits_ground.to(torch.int8), pad]).view(-1, warp)
    counts = g.sum(1)
    sizes = torch.full_like(counts, warp)
    sizes[-1] = warp - pad.numel()
    return float(((counts > 0) & (counts < sizes)).double().mean())


def nan_equal(a, b):
    """True when two tensors hold equal values, NaN where the other has
    NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def uniform(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(device)


def randint(high, shape, seed, device, dtype=torch.int32):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, shape, generator=g).to(dtype).to(device)


def device_times(prof):
    """{kernel name: (device ms, launches seen)} from a torch.profiler
    run; empty when the profiler saw no device time.  The profiler may
    miss a launch at the edge of its window, so a kernel's mean time is
    its ms over the launches seen."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + us / 1e3, n + e.count)
    return out


def profiled_ms(fn, n, name=""):
    """Device ms per call of fn() over n calls, by torch.profiler: the
    mean time of each kernel whose name holds ``name`` (every kernel by
    default), summed over those kernels, each launched once a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ms / k for key, (ms, k) in device_times(pr).items()
               if name in key)


def c3_map(h, w):
    """The c3_hdri_color golden's environment map at h x w: a vertical
    gradient with one hot texel (float32, (h, w, 3))."""
    import numpy as np
    ty = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None]
    env = (np.array([0.3, 0.5, 1.0], np.float32) * ty
           + np.array([0.9, 0.6, 0.3], np.float32) * (1.0 - ty))
    env = np.broadcast_to(env, (h, w, 3)).copy()
    env[h // 4, w // 3] = [40.0, 38.0, 30.0]
    return env


def bench_blob(n=64, emission=False, color=False):
    """The reference bench's compact turbulent puff at n^3 (bench.py:
    367-389, its config 2 and 3 volume): a HostGrid with emission =
    0.9 density and color (0.9 d, 0.4 + 0.3 d, 0.2) where asked, voxels
    of 0.1."""
    import numpy as np

    from vpt_tpu_torch.volume.grid import HostGrid
    z, y, x = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    base = np.clip(1.0 - r / (n / 3.2), 0.0, 1.0)
    ang = np.sin(x * 0.4) * np.sin(y * 0.35) * np.sin(z * 0.3)
    dens = np.clip(base * (0.5 + 0.8 * ang), 0.0, 1.0).astype(np.float32)
    em = (dens * 0.9).astype(np.float32) if emission else None
    col = None
    if color:
        col = np.stack([0.9 * dens, 0.4 + 0.3 * dens,
                        0.2 * np.ones_like(dens)], -1).astype(np.float32)
    return HostGrid(
        density_zyx=dens, emission_zyx=em, color_zyx=col,
        bbox_min=np.zeros(3, np.int32), dim=np.array([n, n, n], np.int32),
        transform=np.diag([0.1, 0.1, 0.1, 1.0]), voxel_size=0.1,
        max_density=float(dens.max()), min_density=1e-6)


# bench.py builds configs 2-4 with these corner rows (bench.py:589-590,
# :614-615, :664-665)
BENCH_ROWS = dict(octant_boxes=True, corner_dtype="bfloat16")


def bench_env_map(h=128, w=256):
    """The reference bench's config 3 environment (bench.py:608-613): a
    vertical gradient with a bright "sun" texel, float32 (h, w, 3)."""
    import numpy as np
    ty = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None]
    env = (np.array([0.35, 0.55, 1.0], np.float32) * ty
           + np.array([0.9, 0.6, 0.3], np.float32) * (1 - ty))
    env = np.broadcast_to(env, (h, w, 3)).copy()
    env[h // 4, w // 3] = [60.0, 55.0, 45.0]
    return env


def cloud_xforms(n_inst, seed=7):
    """The reference bench's config 5 instances (bench.py:630-641): n_inst
    copies of grid 0 at uniform positions over 120 x 14 x 120 world
    units, each scaled 0.1 U(0.7, 1.6).  (grid ids, 4x4 transforms)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids, xforms = [], []
    for _ in range(n_inst):
        t = np.array([rng.uniform(0, 120), rng.uniform(0, 14),
                      rng.uniform(0, 120)])
        sc = rng.uniform(0.7, 1.6)
        xf = np.diag([0.1 * sc, 0.1 * sc, 0.1 * sc, 1.0])
        xf[3, :3] = t
        ids.append(0)
        xforms.append(xf)
    return ids, xforms


def aim_cloud(scene, aspect=1.0):
    """The bench's config 5 camera (bench.py:643-647): 30 above and 90 in
    front of the root box's centre, vfov 50, square unless asked."""
    import dataclasses

    import numpy as np

    from vpt_tpu_torch.core.camera import Camera
    c = (scene.root_pmin.cpu().numpy() + scene.root_pmax.cpu().numpy()) / 2
    return dataclasses.replace(scene, camera=Camera.make(
        c + np.array([0.0, 30.0, 90.0]), c, vfov=50.0, aspect=aspect,
        device=scene.device))


def c5_params(w, h, mode, **kw):
    """The bench's config 5 parameters (bench.py:389-391, :651-652):
    CONSTANT, ray_depth 50, 128 fused steps, the sun at 150/30."""
    from vpt_tpu_torch.render.params import Environment, RenderParams
    return RenderParams(width=w, height=h, ray_depth=50, max_fused_steps=128,
                        shadow_mode=mode, azimuth=150.0, elevation=30.0,
                        environment_type=int(Environment.CONSTANT), **kw)


def config5_ext_scene(device=None, timings=None):
    """Config 5 (bench.py:629-704: cloud_xforms(1024), R 64, aim_cloud)
    with emission and color: 1024 instances of bench_blob(24,
    emission=True, color=True), the ramp emission LUT; the cell lists
    cover each instance's whole box.  ``timings`` as build_scene's."""
    from vpt_tpu_torch.scene.assets import ramp_lut
    from vpt_tpu_torch.scene.scene import build_scene
    ids, xforms = cloud_xforms(1024)
    return aim_cloud(build_scene(
        [bench_blob(n=24, emission=True, color=True)], instance_grid_ids=ids,
        instance_xforms=xforms, emission_lut=ramp_lut(),
        device=_device(device), timings=timings))


# config5_union and config5_4k (bench.py:710-800): the instances of the
# 24^3 puff resampled at 320 along the root box's longest axis, the
# bench's rows, the sun baked into them
UNION_RESOLUTION = 320
UNION_CONFIGS = {"config5_union": (1024, 7), "config5_4k": (4096, 11)}


def union_scene(name, device=None, timings=None):
    """config5_union or config5_4k as bench.py builds it:
    build_union_scene over cloud_xforms(n, seed) at UNION_RESOLUTION in
    BENCH_ROWS, attach_shadow_cache at 150/30, aim_cloud.  ``timings``,
    where given, receives resample_s, build_s (the corner pack) and
    bake_s."""
    from vpt_tpu_torch.accel.shadow import attach_shadow_cache
    from vpt_tpu_torch.volume.union import build_union_scene
    dev = _device(device)
    t = {} if timings is None else timings
    n_inst, seed = UNION_CONFIGS[name]
    ids, xforms = cloud_xforms(n_inst, seed=seed)
    s = build_union_scene([bench_blob(n=24)], ids, xforms,
                          resolution=UNION_RESOLUTION, device=dev,
                          timings=t, **BENCH_ROWS)
    t0 = time.perf_counter()
    s = attach_shadow_cache(s, 150.0, 30.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t["bake_s"] = time.perf_counter() - t0
    return aim_cloud(s)


def union_error(name, device=None):
    """The union's field error at UNION_RESOLUTION as the bench reports it
    (bench.py:735-745: union_error_at_resolution, n 2048, seed 3)."""
    from vpt_tpu_torch.volume.union import union_error_at_resolution
    n_inst, seed = UNION_CONFIGS[name]
    ids, xforms = cloud_xforms(n_inst, seed=seed)
    return union_error_at_resolution([bench_blob(n=24)], ids, xforms,
                                     UNION_RESOLUTION, n=2048, seed=3,
                                     device=_device(device))


# loop8: 8 instances of two grids at config 2's scale, below the
# instance-list threshold, so the walk takes the static per-instance loop
LOOP8_SPACING = 5.0
LOOP8_GRIDS = (0, 1, 0, 1, 1, 0, 1, 0)


def loop8_scene(device=None, timings=None):
    """Eight instances of two 64^3 grids, voxels of 0.1: 4 of
    bench_blob(64, emission=True, color=True) and 4 of bench_blob(64,
    color=True), on a 4 x 2 lattice LOOP8_SPACING apart in x and z (the
    puffs, 4 units across, apart; their 6.4-unit boxes overlap), the grids
    alternating; the ramp emission LUT; one point light 12 above and 6
    in front of the root box's centre, power 400; aim_loop8's camera.
    Both grids carry color, so no slot reads white."""
    import numpy as np

    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.scene.assets import ramp_lut
    from vpt_tpu_torch.scene.scene import _world_bounds, build_scene
    dev = _device(device)
    grids = [bench_blob(emission=True, color=True), bench_blob(color=True)]
    xforms = []
    for i in range(8):
        xf = np.diag([0.1, 0.1, 0.1, 1.0])
        xf[3, :3] = (LOOP8_SPACING * (i % 4), 0.0, LOOP8_SPACING * (i // 4))
        xforms.append(xf)
    b = [_world_bounds(grids[g], x) for g, x in zip(LOOP8_GRIDS, xforms)]
    centre = (np.stack([lo for lo, _ in b]).min(0)
              + np.stack([hi for _, hi in b]).max(0)) / 2
    s = build_scene(
        grids, instance_grid_ids=list(LOOP8_GRIDS), instance_xforms=xforms,
        lights=PointLights.make([centre + [0.0, 12.0, 6.0]], [[1.0, 1.0, 1.0]],
                                [400.0], device=dev),
        emission_lut=ramp_lut(), device=dev, timings=timings)
    return aim_loop8(s)


def aim_loop8(scene, aspect=1.0):
    """loop8's camera: 6 above and 22 in front of the root box's centre,
    vfov 50, square unless asked."""
    import dataclasses

    import numpy as np

    from vpt_tpu_torch.core.camera import Camera
    c = (scene.root_pmin.cpu().numpy() + scene.root_pmax.cpu().numpy()) / 2
    return dataclasses.replace(scene, camera=Camera.make(
        c + np.array([0.0, 6.0, 22.0]), c, vfov=50.0, aspect=aspect,
        device=scene.device))


def loop8_params(w, h, mode, **kw):
    """loop8's parameters: BLACK, config 2's emission_scale 2, ray_depth
    50, 128 fused steps, the sun at 150/30."""
    from vpt_tpu_torch.render.params import Environment, RenderParams
    return RenderParams(width=w, height=h, ray_depth=50, max_fused_steps=128,
                        shadow_mode=mode, azimuth=150.0, elevation=30.0,
                        emission_scale=2.0,
                        environment_type=int(Environment.BLACK), **kw)


def _device(device):
    return torch.device(device) if device is not None else torch.device(
        "cuda", 0)


def golden_blob(n=12):
    """tests/golden_scenes.py::_blob: a radial n^3 blob, voxels of 0.2."""
    import numpy as np

    from vpt_tpu_torch.volume.grid import HostGrid
    z, y, x = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    dens = np.clip(1.0 - r / (n / 2.4), 0.0, 1.0).astype(np.float32)
    return HostGrid(density_zyx=dens, emission_zyx=None, color_zyx=None,
                    bbox_min=np.zeros(3, np.int32),
                    dim=np.array([n, n, n], np.int32),
                    transform=np.diag([0.2, 0.2, 0.2, 1.0]), voxel_size=0.2,
                    max_density=float(dens.max()), min_density=1e-6)


def golden_c5_instances():
    """The c5 golden's 27 instances (tests/golden_scenes.py:88-97): a 3^3
    lattice 4 apart, jittered by U(-1, 1) from seed 3, voxels of 0.2."""
    import numpy as np
    rng = np.random.RandomState(3)
    ids, xforms = [], []
    for i in range(27):
        iz, iy, ix = np.unravel_index(i, (3, 3, 3))
        xf = np.diag([0.2, 0.2, 0.2, 1.0])
        xf[3, :3] = (np.array([ix, iy, iz], np.float64) * 4.0
                     + rng.uniform(-1, 1, 3))
        ids.append(0)
        xforms.append(xf)
    return ids, xforms


def golden_camera(scene, dist_scale=1.2):
    """tests/golden_scenes.py::_camera on the scene's device."""
    import dataclasses

    import numpy as np

    from vpt_tpu_torch.core.camera import Camera
    lo, hi = scene.root_pmin.cpu().numpy(), scene.root_pmax.cpu().numpy()
    c = (lo + hi) / 2
    d = float(np.linalg.norm(hi - lo)) * dist_scale
    return dataclasses.replace(scene, camera=Camera.make(
        c + np.array([0.0, 0.15 * d, d]), c, vfov=45.0, aspect=1.0,
        device=scene.device))


# the reference bench's bigvol_512 (bench.py:526-575): a 512^3 fBm-Perlin
# grid at voxel size 1, scale 0.012, seed 5, in bfloat16 corner rows
BIGVOL_N, BIGVOL_SCALE, BIGVOL_SEED = 512, 0.012, 5
BIGVOL_DENSITY_MULT = 0.04


def bigvol_scene(n=BIGVOL_N, device=None, timings=None):
    """bench.py's bigvol scene at n^3 on ``device``: the fBm grid over
    [-n/2, n/2]^3 (its noise in 64-slice slabs), one point light at (0,
    2.2 h, 3 h) of power 8 h^2 (h = n / 2), bfloat16 corner rows without
    octant columns, the sun and the light baked (attach_shadow_cache, 150
    / 30; tau_downsample auto: 2 from 32 M voxels), then the raw density
    dropped, as the bench's keep_raw_density=False; the camera at (0, 1,
    10) h / 3.5 from the centre, vfov 40, square.  ``timings``, where
    given, receives procedural_s, build_s and bake_s."""
    import dataclasses

    import numpy as np

    from vpt_tpu_torch.accel.shadow import attach_shadow_cache
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.scene.scene import build_scene
    from vpt_tpu_torch.volume.procedural import create_procedural_grid
    dev = _device(device)
    t = {} if timings is None else timings

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    half = n / 2.0
    t0 = time.perf_counter()
    grid = create_procedural_grid(vmin=(-half,) * 3, vmax=(half,) * 3,
                                  res=1.0, scale=BIGVOL_SCALE,
                                  seed=BIGVOL_SEED, chunk_z=64, device=dev)
    t["procedural_s"] = time.perf_counter() - t0
    lights = PointLights.make([[0.0, half * 2.2, half * 3.0]],
                              [[1.0, 1.0, 1.0]], [half * half * 8.0],
                              device=dev)
    t0 = time.perf_counter()
    s = build_scene([grid], lights=lights, corner_dtype="bfloat16",
                    device=dev)
    sync()
    t["build_s"] = time.perf_counter() - t0
    del grid
    t0 = time.perf_counter()
    s = attach_shadow_cache(s, 150.0, 30.0)
    sync()
    t["bake_s"] = time.perf_counter() - t0
    s = dataclasses.replace(s, atlas=dataclasses.replace(
        s.atlas, density=torch.zeros(1, device=dev)))
    c = (s.root_pmin + s.root_pmax).cpu().numpy() / 2
    return dataclasses.replace(s, camera=Camera.make(
        c + np.array([0.0, 1.0, 10.0]) * (half / 3.5), c, vfov=40.0,
        aspect=1.0, device=dev))


def bigvol_params():
    """The bench's bigvol parameters (bench.py:389-391, :567-568): 512^2,
    cached, BLACK, density_mult 0.04, ray_depth 50, 128 fused steps."""
    from vpt_tpu_torch.render.params import Environment, RenderParams
    return RenderParams(width=512, height=512, ray_depth=50, volume_depth=1,
                        max_track_steps=256, max_fused_steps=128,
                        shadow_mode="cached", azimuth=150.0, elevation=30.0,
                        density_mult=BIGVOL_DENSITY_MULT,
                        environment_type=int(Environment.BLACK))
