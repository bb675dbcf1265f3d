"""Time kernels K4 (the environment) and K2 (primary rays) on the card at
1080p.

    python -m vpt_tpu_torch.tools.time_env [--calls 50] [--turns 3]
        [--spp 16] [--atmosphere-cache PATH]

The camera is the CLI's default framing of chip_smoke.py's 200^3 grid
box, at 1920x1080; no volume is built.  Cases, each timed by CUDA events
over --calls back-to-back warm calls, --turns times (the turns
interleave the cases):

* ``k2 aperture 0`` and ``k2 aperture 0.5``: K2
  (``renderer._primary_rays_cuda``) on sample 0's key, the lens draws
  skipped and taken;
* ``k4 sky`` and ``k4 hdri``: K4 (``integrator.add_environment``) on
  K2's 1080p directions at aperture 0, beta 1, in place on L: the simple
  sky, and HDRI on chip_smoke.py's 512x256 c3 map;
* ``k4 atmosphere half 512x512``, ``... half 1920x1080`` and ``... full
  1920x1080``: K4's ATMOSPHERE kind, in place on L, on the rays K1
  retires in one sample of the reference bench's config 4
  (tools/time_atmosphere.py: the 64^3 puff in the bench's rows, the
  camera 9 in front of its centre and 0.5 above, the sun at 150/30,
  ray_depth 50, tracked) with the live atmosphere at the bench's half
  LutDims and at the full LutDims (the CLI's; precomputed on the card,
  or loaded from --atmosphere-cache, which the first run writes);
* ``k4 sky_cache 1920x1080``: K4's SKY_CACHE kind on the same scene's
  rays with the half-dims atmosphere baked into its 256 x 512 cache;
* ``earth 512x512``: ``sky.runtime.render_earth`` at the full LutDims
  (`vpt-torch earth`'s image), its events time the entry point.

Then, once a turn, config 4 live and tracked at 1920x1080 through the
renderer (--spp timed samples after 2, wall ms/spp and the film's
SHA-256, equal for two checkouts whose films agree bit for bit).

Each turn also takes the kernel's device time per call (torch.profiler
over --calls calls, the kernels whose name holds ``primary_rays`` or
``environment``): where the wrapper's host work outlasts the kernel, as
K2's does, the event time measures the host.

Each kernel is held against its plain version on the card once
(``primary_rays_plain`` bit for bit; ``environment_radiance``: the
atmosphere bit for bit, the sky and HDRI by max abs and max relative
error, exit 1 after the report above K4_RTOL or on a bit that differs).
Prints one JSON line per case, then the SM clock nvidia-smi reads while
the sky runs, then the nvidia-smi line.  It calls the renderer's, the
integrator's and the atmosphere's entry points, so run by its path with
another checkout of the package first on PYTHONPATH it times that
checkout (one whose tools/common.py has c3_map, profiled_ms, bench_blob
and BENCH_ROWS).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import time
import types

import numpy as np
import torch

from vpt_tpu_torch.app.cli import default_framing
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import Camera
from vpt_tpu_torch.render import fused, integrator, renderer
from vpt_tpu_torch.render.params import Environment, RenderParams
from vpt_tpu_torch.scene.scene import (attach_atmosphere,
                                       attach_sky_cache, build_scene)
from vpt_tpu_torch.sky import bruneton as br
from vpt_tpu_torch.sky import runtime as rt
from vpt_tpu_torch.tools.common import (BENCH_ROWS, bench_blob, c3_map,
                                        profiled_ms, time_ms)

W, H = 1920, 1080
HALF = 100.0          # chip_smoke.py's grid box: [-100, 100]^3
K4_RTOL = 1e-5
HDR_H, HDR_W = 256, 512
# config 4 (tools/time_atmosphere.py, bench.py:649-681)
C4_CAMERA_OFFSET = (0.0, 0.5, 9.0)
C4_HALF_DIMS = dict(transmittance_w=128, transmittance_h=32, r=16, mu=64,
                    mu_s=16, nu=4, irradiance_w=32, irradiance_h=8)
C4_SIZES = ((512, 512), (W, H))
AZIMUTH, ELEVATION = 150.0, 30.0


def camera(dev, aperture):
    """The CLI's default framing of the box [-HALF, HALF]^3 at W x H."""
    box = types.SimpleNamespace(
        root_pmin=torch.full((3,), -HALF), root_pmax=torch.full((3,), HALF),
        device=dev)
    return default_framing(box, W, H, aperture=aperture)


def config4(dev, atm, w, h, scene=None, baked=False):
    """Config 4 at w x h with ``atm`` attached, live or (``baked``) baked
    into its 256 x 512 sky cache, tracked: (scene, params, K4's launch,
    and K1's L, beta, direction and env_pos, None when baked, of sample
    1); ``scene`` a config-4 scene to re-aim instead of building one."""
    if scene is None:
        scene = build_scene([bench_blob()], device=dev, **BENCH_ROWS)
    c = (scene.root_pmin + scene.root_pmax).cpu().numpy() / 2
    scene = attach_atmosphere(dataclasses.replace(
        scene, camera=Camera.make(c + np.array(C4_CAMERA_OFFSET), c,
                                  vfov=40.0, aspect=w / h, device=dev),
        sky_cache=None), atmosphere=atm)
    if baked:
        scene = attach_sky_cache(scene, AZIMUTH, ELEVATION, 256, 512)
    pe = RenderParams(width=w, height=h, ray_depth=50, max_fused_steps=128,
                      shadow_mode="tracked", azimuth=AZIMUTH,
                      elevation=ELEVATION,
                      environment_type=int(Environment.ATMOSPHERE))
    key = rng.render_key(0, 1)
    o, d = renderer._primary_rays_cuda(scene.camera, pe, key)
    launch = fused.prepare_fused(scene, pe)
    views = fused._launch_k1(launch, renderer.tile_key(key), o, d, w,
                             renderer.frame_queue(pe))
    return (scene, pe, launch.env, views[0], views[5], views[6],
            views[7] if len(views) > 7 else None)


def film_sha(film) -> str:
    h = hashlib.sha256()
    for f in ("accum", "alpha", "depth", "cost", "trunc"):
        h.update(getattr(film, f).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--spp", type=int, default=16,
                    help="timed samples of config 4's 1080p render")
    ap.add_argument("--atmosphere-cache", default=None,
                    help="npz of the full LutDims' LUTs, written when absent")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    key = rng.render_key(0, 0)
    p = RenderParams(width=W, height=H, seed=0, azimuth=150.0,
                     elevation=30.0)
    cases, checks = {}, {}
    for aperture in (0.0, 0.5):
        cam = camera(dev, aperture)
        launch = renderer.prepare_raygen(cam, p)
        got = renderer._primary_rays_cuda(cam, p, key, launch)
        want = renderer.primary_rays_plain(cam, p, key)
        checks[f"k2 aperture {aperture}"] = dict(bit_equal=all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got, want)))
        cases[f"k2 aperture {aperture}"] = (
            lambda cam=cam, launch=launch: renderer._primary_rays_cuda(
                cam, p, key, launch))
        if aperture == 0.0:
            dirn = got[1]
    beta = torch.ones_like(dirn)
    envs = {"sky": (types.SimpleNamespace(env_map=None, atmosphere=None),
                    Environment.ATMOSPHERE),
            "hdri": (types.SimpleNamespace(env_map=torch.as_tensor(
                c3_map(HDR_H, HDR_W), device=dev), atmosphere=None),
                Environment.HDRI)}
    for name, (scene, et) in envs.items():
        pe = p.replace(environment_type=int(et))
        launch = integrator.prepare_environment(scene, pe)
        L0 = torch.zeros_like(dirn)
        got = integrator.add_environment(scene, pe, L0.clone(), beta, dirn,
                                         launch=launch)
        want = L0 + integrator.environment_radiance(scene, pe, dirn,
                                                    dirn) * beta
        diff = (got - want).abs()
        checks[f"k4 {name}"] = dict(
            max_abs=float(diff.max()),
            max_rel=float((diff / want.abs().clamp_min(1e-30)).max()))
        Lw = L0.clone()
        cases[f"k4 {name}"] = (
            lambda scene=scene, pe=pe, launch=launch, Lw=Lw:
            integrator.add_environment(scene, pe, Lw, beta, dirn,
                                       launch=launch))
    for name in list(cases):
        cases[f"{name} {W}x{H}"] = cases.pop(name)
        checks[f"{name} {W}x{H}"] = checks.pop(name)
    # the live atmosphere on config 4's K1-retired rays
    atms = {"half": rt.make_atmosphere(br.LutDims(**C4_HALF_DIMS),
                                       device=dev),
            "full": rt.make_atmosphere(cache_path=args.atmosphere_cache,
                                       device=dev)}
    c4 = None
    for dims, atm in atms.items():
        for w, h in C4_SIZES if dims == "half" else ((W, H),):
            sc, pe, env, L4, beta4, dir4, pos4 = config4(dev, atm, w, h, c4)
            if c4 is None:
                c4 = sc
            name = f"k4 atmosphere {dims} {w}x{h}"
            want = L4 + integrator.environment_radiance(sc, pe, pos4,
                                                       dir4) * beta4
            got = integrator.add_environment(sc, pe, L4.clone(), beta4, dir4,
                                             pos4, launch=env)
            same = (got.view(torch.int32) == want.view(torch.int32)).all(-1)
            checks[name] = dict(bit_share=float(same.double().mean()),
                                max_abs=float((got - want).abs().max()))
            if hasattr(rt, "ground_hit"):   # an older checkout has none
                from vpt_tpu_torch.tools.common import mixed_warp_share
                hits = rt.ground_hit(atm.params, pos4, dir4)[3]
                checks[name].update(
                    ground_share=float(hits.double().mean()),
                    mixed_warp_share=mixed_warp_share(hits))
            Lw4 = L4.clone()
            cases[name] = (lambda sc=sc, pe=pe, env=env, Lw4=Lw4, beta4=beta4,
                           dir4=dir4, pos4=pos4: integrator.add_environment(
                               sc, pe, Lw4, beta4, dir4, pos4, launch=env))
            del L4, got, want
    # the baked sky (SKY_CACHE), on the same rays at 1080p
    sc, pe, env, L4, beta4, dir4, _ = config4(dev, atms["half"], W, H, c4,
                                              baked=True)
    name = f"k4 sky_cache {W}x{H}"
    want = L4 + integrator.environment_radiance(sc, pe, dir4, dir4) * beta4
    got = integrator.add_environment(sc, pe, L4.clone(), beta4, dir4,
                                     launch=env)
    checks[name] = dict(max_abs=float((got - want).abs().max()))
    Lw4 = L4.clone()
    cases[name] = (lambda sc=sc, pe=pe, env=env, Lw4=Lw4, beta4=beta4,
                   dir4=dir4: integrator.add_environment(
                       sc, pe, Lw4, beta4, dir4, launch=env))
    del L4, got, want
    cases["earth 512x512"] = lambda: rt.render_earth(atms["full"], 512, 512)
    checks["earth 512x512"] = {}
    ms = {name: [] for name in cases}
    dev_ms = {name: [] for name in cases}
    spp = []
    for _ in range(args.turns):
        for name, fn in cases.items():
            ms[name].append(time_ms(fn, dev, args.calls)[0])
            dev_ms[name].append(profiled_ms(
                fn, args.calls,
                "primary_rays" if name.startswith("k2") else "environment"))
        w, h = W, H
        sc, pe = config4(dev, atms["half"], w, h, c4)[:2]
        rr = renderer.ProgressiveRenderer(sc, pe)
        rr.step(2)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rr.step(args.spp)
        torch.cuda.synchronize(dev)
        spp.append((time.perf_counter() - t0) * 1e3 / args.spp)
        sha = film_sha(rr.film)
        del rr
    for name in cases:
        print(json.dumps({"case": name, "device_ms": dev_ms[name],
                          "event_ms": ms[name], "calls": args.calls,
                          **checks[name]}), flush=True)
    print(json.dumps({"case": f"config4 live tracked {W}x{H}",
                      "ms_per_spp": spp, "spp": args.spp,
                      "film_sha256": sha}), flush=True)
    sky = cases[f"k4 sky {W}x{H}"]
    torch.cuda.synchronize()
    for _ in range(2000):
        sky()
    clock = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    print(json.dumps({"sm_clock_during_sky": clock}), flush=True)
    print(smi("name,power.limit"), flush=True)
    bad = [n for n, c in checks.items()
           if not c.get("bit_equal", True) or c.get("max_rel", 0) > K4_RTOL
           or c.get("bit_share", 1.0) != 1.0
           or ("sky_cache" in n and c["max_abs"] > 2e-6)]
    if bad:
        raise SystemExit(f"differs from the plain version: {bad}")


if __name__ == "__main__":
    main()
