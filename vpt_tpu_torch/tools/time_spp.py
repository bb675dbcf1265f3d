"""Wall milliseconds per sample of the main render path on the card.

    python -m vpt_tpu_torch.tools.time_spp [--modes cached tracked]
                                            [--spp 64] [--warmup 2]
                                            [--rays-per-lane 0]
                                            [--default-command]
                                            [--bigvol [N]]
                                            [--scene NAME]

Builds chip_smoke.py's scene at 1920x1080 (the procedural 200^3 grid,
one point light and the sun, shadow-baked on the card), then, for each
shadow mode, steps a ProgressiveRenderer through --warmup samples and
times --spp more by the host clock with one synchronize at the end.
Prints one JSON line per mode (ms/spp, and over all the samples the
mean walk steps per ray, the share of rays cut by the step cap, the
image mean and the SHA-256 of the film's five fields, which is equal for
two checkouts whose films agree bit for bit), then the nvidia-smi
line.  ``--rays-per-lane 1`` renders on the step budget of the queue
length 1 (128 steps a ray) where the default 0 resolves the 1080p frame
to 16 (render/params.py::resolve_queue).  ``--default-command`` times
instead `vpt-torch render procedural` as a user types it (the simple
sky, the sun and no point light) at 1920x1080 with --spp samples in each
mode, through the CLI's entry point in this process: its ``render_s``
per sample (the renderer's set-up and the display image included) and
the SHA-256 of the PNG it writes.  ``--bigvol`` times instead the
reference bench's bigvol_512 scene (tools/common.py::bigvol_scene: a
512^3 fBm grid, or N^3, in bfloat16 corner rows, shadow-baked with
tau_downsample 2, the raw density dropped) at 512x512 with cached
shadows: the corner table's GiB, the fill's, build's and bake's seconds,
the peak host RSS, then the renderer's ms/spp, iterations per ray and
trunc_frac over --spp samples.  ``--scene`` times instead an instanced
configuration at 512 x 512 in each mode: the bench's
``config5`` (1024 instances of the 24^3 puff with cell lists, CONSTANT,
shadow-baked for cached), or one of tools/common.py's ``loop8`` (the
static per-instance loop), ``config5_ext`` (config 5 with emission and
color), ``config5_union`` and ``config5_4k`` (the union grids, baked as
the bench bakes them): its build seconds, then per mode the renderer's
ms/spp, iterations per ray, trunc_frac and film SHA-256 as above, and K1
alone on the frame's rays by CUDA events (``k1_ms``, the mean of
K1_REPS launches at the frame's queue length).  It calls only the
renderer's and the CLI's public entry points (and, for k1_ms, the
renderer's ray and launch helpers), so run by its path with another
checkout of the package first on PYTHONPATH it times that checkout;
for a parent without tools/common.py's new configurations, ``config5``
only.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import resource
import subprocess
import tempfile
import time

import torch

from vpt_tpu_torch.accel.shadow import attach_shadow_cache
from vpt_tpu_torch.app import cli
from vpt_tpu_torch.lights.lights import PointLights
from vpt_tpu_torch.render.params import Environment, RenderParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer
from vpt_tpu_torch.scene.scene import build_scene
from vpt_tpu_torch.volume.procedural import create_procedural_grid

W, H = 1920, 1080
SCENE_SIZE, K1_REPS = 512, 5   # --scene: the frame, K1's timed launches
FIELDS = ("accum", "alpha", "depth", "cost", "trunc")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", nargs="+", default=["cached", "tracked"],
                    choices=["cached", "tracked"])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--rays-per-lane", type=int, default=0, choices=[0, 1])
    ap.add_argument("--default-command", action="store_true")
    ap.add_argument("--bigvol", type=int, nargs="?", const=512, default=0,
                    metavar="N", help="the bench's bigvol scene at N^3")
    ap.add_argument("--scene", default=None,
                    choices=["config5", "loop8", "config5_ext",
                             "config5_union", "config5_4k"])
    args = ap.parse_args(argv)
    if args.default_command:
        return default_command(args.modes, args.spp)
    if args.bigvol:
        return bigvol(args.bigvol, args.spp, args.warmup)
    if args.scene:
        return instanced(args.scene, args.modes, args.spp, args.warmup)
    dev = torch.device("cuda", 0)
    grid = create_procedural_grid(vmin=(-100.0,) * 3, vmax=(100.0,) * 3,
                                  device=dev)
    lights = PointLights.make([(0.0, 150.0, 150.0)], [[1.0, 1.0, 1.0]],
                              [20000.0], device=dev)
    scene = attach_shadow_cache(build_scene([grid], lights=lights,
                                            device=dev), 150.0, 30.0)
    scene = dataclasses.replace(scene,
                                camera=cli.default_framing(scene, W, H))
    for mode in args.modes:
        p = RenderParams(width=W, height=H, seed=0, ray_depth=50,
                         max_fused_steps=128, shadow_mode=mode,
                         azimuth=150.0, elevation=30.0,
                         environment_type=int(Environment.BLACK),
                         rays_per_lane=args.rays_per_lane)
        r = ProgressiveRenderer(scene, p)
        r.step(args.warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step(args.spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = W * H * (args.warmup + args.spp)
        print(json.dumps(dict(
            mode=mode, rays_per_lane=args.rays_per_lane, spp=args.spp,
            ms_per_spp=dt * 1e3 / args.spp,
            mean_iters_per_ray=float(r.film.cost.double().sum()) / n,
            trunc_frac=float(r.film.trunc.double().sum()) / n,
            image_mean=float(r.film.accum.double().mean()),
            film_sha256=_film_sha(r.film))), flush=True)
    print_smi()


def default_command(modes, spp):
    """`vpt-torch render procedural --spp spp` at W x H in each mode."""
    for mode in modes:
        st = {}
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "default.png")
            cli.main(["render", "procedural", "-o", out, "--spp", str(spp),
                      "--width", str(W), "--height", str(H),
                      "--shadow-mode", mode], stats=st)
            with open(out, "rb") as f:
                sha = hashlib.sha256(f.read()).hexdigest()
        print(json.dumps(dict(
            command="vpt-torch render procedural", mode=mode, spp=st["spp"],
            ms_per_spp=st["render_s"] * 1e3 / st["spp"],
            scene_s=st["scene_s"], bake_s=st["bake_s"],
            png_sha256=sha)), flush=True)
    print_smi()


def bigvol(n, spp, warmup):
    """The bench's bigvol scene at n^3, built, baked and rendered at
    512x512 with cached shadows."""
    from vpt_tpu_torch.tools.common import bigvol_params, bigvol_scene
    dev = torch.device("cuda", 0)
    st = {}
    scene = bigvol_scene(n, dev, st)
    rows = scene.atlas.density_corners
    p = bigvol_params()
    r = ProgressiveRenderer(scene, p)
    t0 = time.perf_counter()
    r.step(warmup)
    torch.cuda.synchronize()
    st["first_samples_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.step(spp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rays = p.width * p.height * (warmup + spp)
    print(json.dumps(dict(
        scene="bigvol", n=n, corner_table=list(rows.shape),
        corner_dtype=str(rows.dtype).replace("torch.", ""),
        corner_gib=rows.numel() * rows.element_size() / 2 ** 30,
        peak_host_rss_gib=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        peak_device_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        size=[p.width, p.height], spp=spp, ms_per_spp=dt * 1e3 / spp,
        mean_iters_per_ray=float(r.film.cost.double().sum()) / rays,
        trunc_frac=float(r.film.trunc.double().sum()) / rays,
        image_mean=float(r.film.accum.double().mean()),
        finite=bool(torch.isfinite(r.film.accum).all()), **st)),
        flush=True)
    print_smi()


def _film_sha(film):
    return hashlib.sha256(b"".join(getattr(film, f).cpu().numpy().tobytes()
                                   for f in FIELDS)).hexdigest()


def instanced(name, modes, spp, warmup):
    """An instanced configuration (--scene) at SCENE_SIZE^2, in each
    mode."""
    from vpt_tpu_torch.core import rng
    from vpt_tpu_torch.render import fused, renderer
    from vpt_tpu_torch.tools import common
    dev = torch.device("cuda", 0)
    w = h = SCENE_SIZE
    st = {}
    t0 = time.perf_counter()
    if name == "config5":
        # with the helpers every checkout from config 5's port on has
        ids, xforms = common.cloud_xforms(1024)
        scene = common.aim_cloud(build_scene(
            [common.bench_blob(n=24)], instance_grid_ids=ids,
            instance_xforms=xforms, device=dev))
    elif name == "loop8":
        scene = common.loop8_scene(dev)
    elif name == "config5_ext":
        scene = common.config5_ext_scene(dev)
    else:
        scene = common.union_scene(name, dev, st)
    torch.cuda.synchronize()
    st["scene_s"] = time.perf_counter() - t0
    baked = scene
    if name in ("config5", "loop8", "config5_ext"):
        t0 = time.perf_counter()
        baked = attach_shadow_cache(scene, 150.0, 30.0)
        torch.cuda.synchronize()
        st["bake_s"] = time.perf_counter() - t0
    print(json.dumps(dict(scene=name, size=[w, h], **st)), flush=True)
    for mode in modes:
        sc = baked if mode == "cached" else scene
        p = RenderParams(
            width=w, height=h, seed=0, ray_depth=50, max_fused_steps=128,
            shadow_mode=mode, azimuth=150.0, elevation=30.0,
            emission_scale=2.0 if name == "loop8" else 1.0,
            environment_type=int(Environment.BLACK if name == "loop8"
                                 else Environment.CONSTANT))
        r = ProgressiveRenderer(sc, p)
        r.step(warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step(spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = w * h * (warmup + spp)
        key = rng.render_key(0, 0)
        lt = renderer.prepare(sc, p)
        o, d = renderer._primary_rays_cuda(sc.camera, p, key, lt.raygen)
        q = renderer.frame_queue(p)
        tkey = renderer.tile_key(key)
        fused._fused_direct_cuda(sc, p, tkey, o, d, lt.fused, w, q)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K1_REPS):
            fused._fused_direct_cuda(sc, p, tkey, o, d, lt.fused, w, q)
        end.record()
        torch.cuda.synchronize()
        print(json.dumps(dict(
            scene=name, mode=mode, size=[w, h], spp=spp,
            ms_per_spp=dt * 1e3 / spp,
            mrays_per_s=w * h / (dt / spp) / 1e6,
            mean_iters_per_ray=float(r.film.cost.double().sum()) / n,
            trunc_frac=float(r.film.trunc.double().sum()) / n,
            image_mean=float(r.film.accum.double().mean()),
            k1_ms=start.elapsed_time(end) / K1_REPS,
            film_sha256=_film_sha(r.film))), flush=True)
    print_smi()


def print_smi():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
