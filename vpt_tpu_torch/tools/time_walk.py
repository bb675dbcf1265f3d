"""Kernel K5 (csrc/walk.cu) on the card: the reference engine and the
volumetric integrator, timed and held to their plain versions.

    python -m vpt_tpu_torch.tools.time_walk

chip_smoke.py runs it as its phases ``reference`` and ``volumetric``; it
prints one JSON line for each, and returns them for the kernels line.

* ``reference``: the main path's scene (the procedural 200^3 grid, one
  point light, the sun, BLACK) through ProgressiveRenderer with
  engine="reference" at 1920x1080, ray_depth 50, 2 warm-up and 8 timed
  spp: ms/spp, Mrays/s, the primary walks' steps per ray, walk_direct
  and K3 launched once a sample and K1 never, the image finite and not
  black.  K5 alone on one sample's rays, timed by CUDA events, and once
  more counting its bounces, walk steps and sky evaluations (the bound's
  inputs).  `vpt-torch render procedural --engine reference` with that
  light, BLACK, at 1080p, 8 spp: the PNG decodes, the EXR is finite and
  not black, walk_direct once a sample.  K5 against direct_integrator_plain on the card at 256x256,
  one tile of all the rays, on that scene (density only) and on config
  2's puff with emission in float32 rows (EXT).
* ``volumetric``: ``vpt-torch render procedural --integrator
  volumetric`` as a user types it (the simple sky, 1920x1080, ray_depth
  50, 8 spp): the PNG decodes, the EXR is finite and not black, and each
  sample launches walk_volumetric once and K4 once; then the same scene
  under the c3 golden's HDRI map (512 x 256) at 512x512 with
  hdri_importance, so the CDF strategy runs; ms/spp, steps and bounces
  per ray.  K5 against vol_integrator_plain at 256x256, ray_depth 8, on
  the sky, on the HDRI through the CDF and on the EXT puff.

The rule of a match (chip_smoke.py's phase 6): >= 99% of rays agree (L
within rtol 1e-4 + atol 1e-6, alpha within 1e-5, cost and trunc exact)
and the image means within 0.5%; the bit-for-bit share is printed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.render import film as film_mod
from vpt_tpu_torch.render import fused, integrator, renderer, walk
from vpt_tpu_torch.render.params import Environment, RenderParams
from vpt_tpu_torch.tools.common import bound, c3_map

SEED = 0
GRID_N = 200
LIGHT_POS, LIGHT_POWER = (0.0, 150.0, 150.0), 20000.0
AZIMUTH, ELEVATION = 150.0, 30.0
W, H = 1920, 1080
RAY_DEPTH = 50
WARMUP_SPP, TIMED_SPP = 2, 8
PARITY, VOL_PARITY_DEPTH = 256, 8
HDRI_SIZE, HDRI_MAP = 512, (256, 512)
EMIT_CAMERA = (0.0, 1.0, 9.0)   # config 2's camera (the bench's aim)
MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
# K5's operations, counted from csrc/walk.cu as K1's are (a threefry-2x32
# is 80 integer operations, counted at the float32 rate): a walk step is
# a step key and one or two draws (3 threefry at most) and ~200 float
# operations (the fetch's transform, trilinear sum and box exits, the
# flight and the accept); a bounce ~8 threefry (its keys, the walks' and
# the estimates' keys, the HG draws) and ~300 float operations; a sky
# evaluation is K4's sky march, 4858 (chip_smoke.py's K4_SKY_OPS_PER_RAY).
K5_OPS_PER_STEP = 3 * 80 + 200
K5_OPS_PER_BOUNCE = 8 * 80 + 300
SKY_OPS = 4858
ROW_BYTES = 15 * 4   # the columns a step loads (emission on EXT not counted)


def match(got, want):
    """K5's outputs against the plain version's: the share of rays that
    agree by the rule, the bit-for-bit share, the relative difference of
    the image means and max |dL|."""
    Lk, Lp = got[0], want[0]
    ok = ((Lk - Lp).abs() <= 1e-6 + 1e-4 * Lp.abs()).all(-1)
    ok &= (got[1] - want[1]).abs() <= 1e-5
    ok &= (got[2] == want[2]) & (got[3] == want[3])
    same = torch.ones_like(ok)
    for a, b in zip(got, want):
        eq = a.view(torch.int32) == b.view(torch.int32)
        same &= eq.reshape(eq.shape[0], -1).all(-1)
    mk, mp = float(Lk.double().mean()), float(Lp.double().mean())
    return dict(share=float(ok.double().mean()),
                bit_share=float(same.double().mean()),
                mean_rel=abs(mk - mp) / max(abs(mp), 1e-12),
                max_abs=float((Lk - Lp).abs().max()), rays=int(ok.numel()),
                mean=mp)


def main_scene(dev):
    """chip_smoke.py's phase-3 scene: the procedural 200^3 grid, one point
    light, the sun (no shadow cache: the reference engine walks its
    shadows)."""
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.scene.scene import build_scene
    from vpt_tpu_torch.volume.procedural import create_procedural_grid
    half = GRID_N / 2
    grid = create_procedural_grid(vmin=(-half,) * 3, vmax=(half,) * 3,
                                  device=dev)
    lights = PointLights.make([LIGHT_POS], [[1.0, 1.0, 1.0]], [LIGHT_POWER],
                              device=dev)
    return build_scene([grid], lights=lights, device=dev)


def config2_f32(dev):
    """Config 2's puff (the bench's 64^3 blob, emission 0.9 density) in
    float32 rows without octant columns, the ramp emission LUT, its
    camera 9 in front of and 1 above its centre."""
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.scene.assets import ramp_lut
    from vpt_tpu_torch.scene.scene import build_scene
    from vpt_tpu_torch.tools.common import bench_blob
    s = build_scene([bench_blob(emission=True)], emission_lut=ramp_lut(),
                    device=dev)
    c = (s.root_pmin + s.root_pmax).cpu().numpy() / 2
    return dataclasses.replace(s, camera=Camera.make(
        c + np.array(EMIT_CAMERA), c, vfov=40.0, aspect=1.0, device=dev))


def framed(scene, w, h):
    from vpt_tpu_torch.app.cli import default_framing
    return dataclasses.replace(scene, camera=default_framing(scene, w, h))


def params(w, h, **kw):
    return RenderParams(width=w, height=h, seed=SEED, ray_depth=RAY_DEPTH,
                        azimuth=AZIMUTH, elevation=ELEVATION,
                        environment_type=int(Environment.BLACK)).replace(
                            **kw)


def counters():
    return {k.name: k for k in (
        walk.WALK_DIRECT, walk.WALK_VOLUMETRIC, film_mod.FILM_ACCUMULATE,
        fused.FUSED_DIRECT, fused.FUSED_DIRECT_PRIMARY, renderer.RAYGEN,
        integrator.ENVIRONMENT)}


def render(scene, p, dev, spp=TIMED_SPP):
    """WARMUP_SPP, then ``spp`` timed through ProgressiveRenderer, every
    counter set to 0 just before the timed spp and read just after:
    ms/spp, Mrays/s, the primary walks' steps per ray, the launches, and
    whether the image is finite and not black."""
    r = renderer.ProgressiveRenderer(scene, p)
    r.step(WARMUP_SPP)
    torch.cuda.synchronize(dev)
    ks = counters()
    for k in ks.values():
        k.launches = 0
    t0 = time.perf_counter()
    r.step(spp)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / spp
    n = p.width * p.height
    acc = r.film.accum
    return dict(ms_per_spp=ms, mrays_per_s=n / ms / 1e3,
                steps_per_ray=float(r.film.cost.double().sum())
                / (n * (WARMUP_SPP + spp)),
                launches={name: k.launches for name, k in ks.items()},
                finite=bool(torch.isfinite(acc).all()),
                mean=float(acc.double().mean()))


def k5_alone(scene, p, dev, volumetric, reps=3):
    """K5 alone on one sample's primary rays (K2's), no K4: its device
    ms by CUDA events over ``reps`` launches, then one launch counting
    the rays' bounces, walk steps and sky evaluations; and the bound of
    that work (common.bound: the rays, the outputs, each row visited
    once, and K5_OPS_* a step, a bounce and a sky evaluation).  The warp
    efficiency of its one-thread-a-ray schedule, from the cost AOV (the
    primary walks' steps of each ray: fused.warp_efficiency at 32)."""
    key = rng.render_key(SEED, 0)
    o, d = renderer._primary_rays_cuda(scene.camera, p, key)
    launch = walk.prepare_walk(scene, p, volumetric)
    tkey, tile = rng.split(key)[1], min(p.fused_tile, o.shape[0])
    walk._launch_k5(launch, tkey, o, d, tile)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        walk._launch_k5(launch, tkey, o, d, tile)
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / reps
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    views = walk._launch_k5(launch, tkey, o, d, tile, stats)
    bounces, steps, sky = (int(v) for v in stats.tolist())
    n = o.shape[0]
    rows = min(steps, scene.atlas.density_corners.shape[0])
    out_bytes = 4 * (7 + 6 * bool(launch.params.defer_env))
    b = bound(n * (24 + out_bytes) + rows * ROW_BYTES,
              steps * K5_OPS_PER_STEP + bounces * K5_OPS_PER_BOUNCE
              + sky * SKY_OPS)
    return dict(ms=ms, rays=n, bounces_per_ray=bounces / n,
                steps_per_ray=steps / n, sky_evals_per_ray=sky / n,
                primary_steps_per_ray=float(views[2].double().mean()),
                warp_efficiency=fused.warp_efficiency(views[2]),
                bound=b)


def parity(scene, p, dev, volumetric):
    """K5 (and K4 after it) against the plain integrator on the card on
    the PARITY^2 frame's rays as one tile under the sample's tile key:
    match()'s numbers, the plain version's ms (one call, host clock after
    a sync) and K5's."""
    from vpt_tpu_torch.render.integrator import direct_integrator_plain
    from vpt_tpu_torch.render.vol_integrator import vol_integrator_plain
    key = rng.render_key(SEED, 1)
    o, d = renderer._primary_rays_cuda(scene.camera, p, key)
    tkey = renderer.tile_key(key)
    run = walk.walk_volumetric if volumetric else walk.walk_direct
    plain = vol_integrator_plain if volumetric else direct_integrator_plain
    got = run(scene, p, tkey, o, d)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = run(scene, p, tkey, o, d)
    torch.cuda.synchronize(dev)
    k_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = plain(scene, p, tkey, o, d)
    torch.cuda.synchronize(dev)
    out = match(got, want)
    out.update(plain_ms=(time.perf_counter() - t0) * 1e3, kernel_ms=k_ms)
    return out


def check(where, m):
    if not (m["share"] >= MIN_SHARE and m["mean_rel"] <= MAX_MEAN_REL
            and m["mean"] > 0):
        raise RuntimeError(f"{where}: K5 disagrees with its plain version "
                           f"or renders black: {m}")


def reference_phase(dev, scene=None):
    """The ``reference`` phase's record (the module's docstring)."""
    scene = main_scene(dev) if scene is None else scene
    p = params(W, H, engine="reference")
    main = framed(scene, W, H)
    rec = dict(size=[W, H], ray_depth=RAY_DEPTH, spp=TIMED_SPP,
               render=render(main, p, dev))
    got = rec["render"]["launches"]
    if (got["walk_direct"] != TIMED_SPP
            or got["film_accumulate"] != TIMED_SPP
            or got["fused_direct"] or got["fused_direct_primary"]):
        raise RuntimeError(f"reference: launches {got}")
    if not (rec["render"]["finite"] and rec["render"]["mean"] > 0):
        raise RuntimeError(f"reference: the image is not finite or black: "
                           f"{rec['render']}")
    rec["k5_alone"] = k5_alone(main, p, dev, False)
    rec["cli"] = cli_run(
        dev, ["--engine", "reference", "--env-type", "black", "--light",
              *(str(v) for v in LIGHT_POS), "1", "1", "1", str(LIGHT_POWER)],
        "walk_direct", 0)
    pp = params(PARITY, PARITY, engine="reference")
    c2 = config2_f32(dev)
    rec["parity"] = {
        "density": parity(framed(scene, PARITY, PARITY), pp, dev, False),
        "ext_config2_f32": parity(c2, pp.replace(emission_scale=2.0), dev,
                                  False)}
    for name, m in rec["parity"].items():
        check(f"reference/{name}", m)
    rec["launch_info"] = {f"ext{e}": walk.launch_info(False, bool(e))
                          for e in (0, 1)}
    return rec


def cli_run(dev, argv, kernel, k4_launches, tmp=None):
    """`vpt-torch render procedural ARGV` at 1920x1080, ray_depth 50, 8
    spp, --save-exr, every counter set to 0 just before: its stats,
    ms/spp and launches; fails unless the PNG decodes to the frame, the
    EXR is finite and not black, ``kernel`` launched once a sample, K4
    ``k4_launches`` times a sample and K1 never."""
    from vpt_tpu_torch.app import cli
    from vpt_tpu_torch.utils.exr import read_exr_rgb
    from vpt_tpu_torch.utils.io import read_png
    ks = counters()
    for k in ks.values():
        k.launches = 0
    stats = {}
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        png = os.path.join(d, "walk.png")
        cli.main(["render", "procedural", *argv, "-o", png, "--width",
                  str(W), "--height", str(H), "--ray-depth", str(RAY_DEPTH),
                  "--spp", str(TIMED_SPP), "--save-exr"], stats)
        img = read_png(png)
        rad = read_exr_rgb(os.path.join(d, "walk.exr"))
    launches = {name: k.launches for name, k in ks.items()}
    rec = dict(stats, argv=argv, png_shape=list(img.shape),
               exr_finite=bool(np.isfinite(rad).all()),
               exr_mean=float(rad.mean()),
               ms_per_spp=stats["render_s"] * 1e3 / TIMED_SPP,
               launches=launches)
    if (img.shape != (H, W, 3) or not np.isfinite(rad).all()
            or rad.mean() <= 0 or launches[kernel] != TIMED_SPP
            or launches["environment"] != k4_launches * TIMED_SPP
            or launches["fused_direct"] or launches["fused_direct_primary"]):
        raise RuntimeError(f"the CLI run {argv}: {rec}")
    return rec


def volumetric_phase(dev, scene=None, tmp=None):
    """The ``volumetric`` phase's record (the module's docstring)."""
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.scene.scene import attach_env_map
    rec = {"cli": cli_run(dev, ["--integrator", "volumetric"],
                          "walk_volumetric", 1, tmp)}
    scene = main_scene(dev) if scene is None else scene
    # the CLI's scene: the same grid without the point light
    sky = dataclasses.replace(scene, lights=PointLights.empty(dev))
    pv = params(W, H, integrator=1,
                environment_type=int(Environment.ATMOSPHERE))
    rec["k5_alone_sky"] = k5_alone(framed(sky, W, H), pv, dev, True)
    hdri = attach_env_map(sky, c3_map(*HDRI_MAP))
    ph = params(HDRI_SIZE, HDRI_SIZE, integrator=1, hdri_importance=True,
                environment_type=int(Environment.HDRI))
    hd = framed(hdri, HDRI_SIZE, HDRI_SIZE)
    rec["hdri_cdf"] = render(hd, ph, dev)
    rec["hdri_cdf"]["k5_alone"] = k5_alone(hd, ph, dev, True)
    if not (rec["hdri_cdf"]["finite"] and rec["hdri_cdf"]["mean"] > 0
            and rec["hdri_cdf"]["launches"]["walk_volumetric"] == TIMED_SPP):
        raise RuntimeError(f"volumetric: HDRI: {rec['hdri_cdf']}")
    pp = dict(integrator=1, ray_depth=VOL_PARITY_DEPTH)
    rec["parity"] = {
        "sky": parity(framed(sky, PARITY, PARITY), params(
            PARITY, PARITY, environment_type=int(Environment.ATMOSPHERE),
            **pp), dev, True),
        "hdri_cdf": parity(framed(hdri, PARITY, PARITY), params(
            PARITY, PARITY, environment_type=int(Environment.HDRI),
            hdri_importance=True, **pp), dev, True),
        "ext_config2_f32": parity(config2_f32(dev), params(
            PARITY, PARITY, emission_scale=2.0, **pp), dev, True)}
    for name, m in rec["parity"].items():
        check(f"volumetric/{name}", m)
    rec["launch_info"] = {f"ext{e}": walk.launch_info(True, bool(e))
                          for e in (0, 1)}
    return rec


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("time_walk: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    scene = main_scene(dev)
    for name, fn in (("reference", reference_phase),
                     ("volumetric", volumetric_phase)):
        print(json.dumps({"phase": name, **fn(dev, scene)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
