"""Time kernels K4 (the environment) and K2 (primary rays) on the card at
1080p.

    python -m vpt_tpu_torch.tools.time_env [--calls 50] [--turns 3]

The camera is the CLI's default framing of chip_smoke.py's 200^3 grid
box, at 1920x1080; no volume is built.  Cases, each timed by CUDA events
over --calls back-to-back warm calls, --turns times (the turns
interleave the cases):

* ``k2 aperture 0`` and ``k2 aperture 0.5``: K2
  (``renderer._primary_rays_cuda``) on sample 0's key, the lens draws
  skipped and taken;
* ``k4 sky`` and ``k4 hdri``: K4 (``integrator.add_environment``) on
  K2's 1080p directions at aperture 0, beta 1, in place on L: the simple
  sky, and HDRI on chip_smoke.py's 512x256 c3 map.

Each turn also takes the kernel's device time per call (torch.profiler
over --calls calls, the kernels whose name holds ``primary_rays`` or
``environment``): where the wrapper's host work outlasts the kernel, as
K2's does, the event time measures the host.

Each kernel is held against its plain version on the card once
(``primary_rays_plain`` bit for bit; ``environment_radiance``: max abs
and max relative error, exit 1 after the report above K4_RTOL).  Prints
one JSON line per case, then the SM clock nvidia-smi reads while the sky
runs, then the nvidia-smi line.  It calls the renderer's and the
integrator's entry points, so run by its path with another checkout of
the package first on PYTHONPATH it times that checkout (one whose
tools/common.py has c3_map and profiled_ms).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import types

import torch

from vpt_tpu_torch.app.cli import default_framing
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.render import integrator, renderer
from vpt_tpu_torch.render.params import Environment, RenderParams
from vpt_tpu_torch.tools.common import c3_map, profiled_ms, time_ms

W, H = 1920, 1080
HALF = 100.0          # chip_smoke.py's grid box: [-100, 100]^3
K4_RTOL = 1e-5
HDR_H, HDR_W = 256, 512


def camera(dev, aperture):
    """The CLI's default framing of the box [-HALF, HALF]^3 at W x H."""
    box = types.SimpleNamespace(
        root_pmin=torch.full((3,), -HALF), root_pmax=torch.full((3,), HALF),
        device=dev)
    return default_framing(box, W, H, aperture=aperture)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--turns", type=int, default=3)
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
    ms = {name: [] for name in cases}
    dev_ms = {name: [] for name in cases}
    for _ in range(args.turns):
        for name, fn in cases.items():
            ms[name].append(time_ms(fn, dev, args.calls)[0])
            dev_ms[name].append(profiled_ms(
                fn, args.calls,
                "primary_rays" if name.startswith("k2") else "environment"))
    for name in cases:
        print(json.dumps({"case": f"{name} {W}x{H}", "device_ms": dev_ms[name],
                          "event_ms": ms[name], "calls": args.calls,
                          **checks[name]}), flush=True)
    sky = cases["k4 sky"]
    torch.cuda.synchronize()
    for _ in range(2000):
        sky()
    clock = smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    print(json.dumps({"sm_clock_during_sky": clock}), flush=True)
    print(smi("name,power.limit"), flush=True)
    bad = [n for n, c in checks.items()
           if not c.get("bit_equal", True) or c.get("max_rel", 0) > K4_RTOL]
    if bad:
        raise SystemExit(f"differs from the plain version: {bad}")


if __name__ == "__main__":
    main()
