"""Headless render CLI of the port (port of vpt_tpu/app/cli.py).

Usage:
    vpt-torch render procedural -o out.png --spp 64 --env-type black
    python -m vpt_tpu_torch.app.cli render procedural --env-type constant

The parser takes the reference's flags one for one (``build_parser``).
``render`` runs what the port has: the ``procedural`` scene, a
``.hdr`` scene (the procedural volume lit by the map) and a ``.ins``
file's lights variant (its point lights over the procedural volume; the
volumes variant exits, as ``.vdb`` scenes do, until the .vdb reader is
ported), an optional
``.hdr`` environment map (the positional ``env``), the fused and the
reference engine with the direct or the volumetric integrator, every
environment type (the
default is the simple sky, or HDRI when a map is given; ``--atmosphere``
puts the Bruneton atmosphere in the simple sky's place, baked into a sky
cache unless ``--no-bake-sky``), tracked or cached shadows, checkpoint
and resume (the reference's npz keys, so a checkpoint moves between the
two), PNG and EXR output and the alpha/cost/depth AOVs.  ``earth``
renders the planet from orbit.  Everything runs on the card (``cuda:0``)
through kernels K1-K5 unless ``--cpu`` asks for the CPU.  Every other
option, and the ``view`` subcommand, exit with a message naming the
ROADMAP item that ports it; nothing renders something else in its
place.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from vpt_tpu_torch.scene.ins import VDB_READER
from vpt_tpu_torch.utils.logger import log


def build_parser():
    ap = argparse.ArgumentParser(prog="vpt-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a scene to an image")
    r.add_argument("scene", help=".vdb/.ins/.hdr path or 'procedural' "
                   "(the port renders 'procedural' and .hdr)")
    r.add_argument("env", nargs="?", default=None,
                   help="optional .hdr environment map")
    r.add_argument("-o", "--output", default="render/out.png",
                   help="output image (.png/.exr; .jpg is not ported)")
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--ray-depth", type=int, default=50)
    r.add_argument("--volume-depth", type=int, default=1)
    r.add_argument("--integrator", choices=["direct", "volumetric"],
                   default="direct")
    r.add_argument("--engine", choices=["fused", "march", "reference"],
                   default="fused", help="the port renders 'fused'")
    r.add_argument("--env-type",
                   choices=["atmosphere", "hdri", "black", "constant"],
                   default=None,
                   help="default: hdri if env given else atmosphere")
    r.add_argument("--camera", nargs=6, type=float, metavar="V",
                   default=None, help="lookfrom xyz lookat xyz")
    r.add_argument("--fov", type=float, default=30.0)
    r.add_argument("--aperture", type=float, default=0.0)
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--azimuth", type=float, default=150.0)
    r.add_argument("--elevation", type=float, default=30.0)
    r.add_argument("--sun-mult", type=float, default=1.0)
    r.add_argument("--sky-mult", type=float, default=1.0)
    r.add_argument("--phase-g", type=float, default=0.0)
    r.add_argument("--density-mult", type=float, default=1.0)
    r.add_argument("--emission-scale", type=float, default=0.0)
    r.add_argument("--light", nargs=7, type=float, action="append",
                   metavar="V", default=None,
                   help="px py pz r g b power (repeatable)")
    r.add_argument("--union", default="off", metavar="off|auto|RES",
                   help="collapse an instanced .ins scene onto one world "
                        "grid (not ported)")
    r.add_argument("--shadow-mode", choices=["tracked", "cached"],
                   default="tracked",
                   help="cached = precomputed light-transmittance fields")
    r.add_argument("--denoise", choices=["none", "atrous", "nn"],
                   default="none", help="not ported")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="save the progressive film every N spp. Default "
                        "path: OUTPUT.ckpt.npz")
    r.add_argument("--checkpoint-path", default=None,
                   help="override the checkpoint file path")
    r.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume a checkpointed render (this CLI's or the "
                        "reference's) and continue to --spp total "
                        "samples; kill + resume is bit-identical to an "
                        "uninterrupted run")
    r.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    r.add_argument("--sharded", action="store_true",
                   help="render over all devices (not ported)")
    r.add_argument("--inst-shards", type=int, default=0,
                   help="shard the scene over N devices (not ported)")
    r.add_argument("--save-exr", action="store_true",
                   help="also save raw radiance as EXR next to output")
    r.add_argument("--aov",
                   choices=["none", "alpha", "cost", "depth", "dof",
                            "occupancy", "bvh"],
                   default="none", help="save an extra AOV image (the port "
                   "writes alpha, cost and depth)")
    r.add_argument("--atmosphere", action="store_true",
                   help="precompute/attach the full Bruneton atmosphere "
                   "(otherwise env-type=atmosphere uses the simple sky)")
    r.add_argument("--luminance", choices=["none", "approximate",
                                           "precomputed"], default="none",
                   help="Bruneton luminance mode (with --atmosphere)")
    r.add_argument("--white-balance", action="store_true",
                   help="CIE white balance (with --atmosphere)")
    r.add_argument("--atmosphere-cache", default="out/atmosphere_luts.npz",
                   help="npz LUT cache path (with --atmosphere)")
    r.add_argument("--bake-sky", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="bake the atmosphere to an equirect cache (with "
                        "--atmosphere)")

    e = sub.add_parser("earth", help="planetary render from orbit (the "
                       "reference's render_earth)")
    e.add_argument("-o", "--output", default="render/earth.png")
    e.add_argument("--width", type=int, default=512)
    e.add_argument("--height", type=int, default=512)
    e.add_argument("--azimuth", type=float, default=150.0)
    e.add_argument("--elevation", type=float, default=30.0)
    e.add_argument("--altitude", type=float, default=2.5,
                   help="camera distance in top-atmosphere radii")
    e.add_argument("--atmosphere-cache", default="out/atmosphere_luts.npz")
    e.add_argument("--cpu", action="store_true")

    v = sub.add_parser("view", help="interactive progressive viewer (not "
                       "ported)")
    v.add_argument("scene", help=".vdb/.ins/.hdr path or 'procedural'")
    v.add_argument("env", nargs="?", default=None)
    v.add_argument("--width", type=int, default=384)
    v.add_argument("--height", type=int, default=384)
    v.add_argument("--ray-depth", type=int, default=50)
    v.add_argument("--env-type",
                   choices=["atmosphere", "hdri", "black", "constant"],
                   default=None)
    v.add_argument("--light", nargs=7, type=float, action="append",
                   metavar="V", default=None)
    v.add_argument("--shadow-mode", choices=["tracked", "cached"],
                   default="tracked")
    v.add_argument("--atmosphere", action="store_true",
                   help="attach the Bruneton atmosphere")
    v.add_argument("--port", type=int, default=8787)
    v.add_argument("--cpu", action="store_true")
    v.add_argument("--open", action="store_true", help="open a browser")
    return ap


def _not_ported(what: str, item: str):
    raise SystemExit(f"vpt-torch: {what} is not ported yet ({item})")


def _check_render_slice(args) -> str:
    """Exit for every render option outside the port's slice; returns
    the environment name, resolved as the reference resolves it
    (vpt_tpu/app/cli.py:395-398): --env-type, else hdri when a map is
    given, else atmosphere (the simple sky)."""
    scene = args.scene
    if scene != "procedural" and not scene.endswith((".hdr", ".ins")):
        if scene.endswith(".vdb"):
            _not_ported("the .vdb scene", VDB_READER)
        raise SystemExit(f"unsupported scene file: {scene}")
    if scene.endswith(".ins"):
        from vpt_tpu_torch.scene.ins import read_ins
        try:
            volumes = read_ins(scene).lights is None
        except (OSError, ValueError, StopIteration) as e:
            raise SystemExit(f"unsupported scene file: {scene} ({e!r})") \
                from None
        if volumes:
            _not_ported("the .ins volumes variant (.vdb instances)",
                        VDB_READER)
    env = args.env_type or ("hdri" if (args.env or scene.endswith(".hdr"))
                            else "atmosphere")
    for flag, on, item in (
            ("--engine march", args.engine == "march",
             "ROADMAP A.8, render/march.py"),
            (f"--denoise {args.denoise}", args.denoise != "none",
             "ROADMAP A.9, denoisers"),
            ("--sharded", args.sharded, "ROADMAP A.11, multi-GPU"),
            (f"--inst-shards {args.inst_shards}", args.inst_shards > 1,
             "ROADMAP A.11, multi-GPU"),
            (f"--union {args.union}", args.union != "off", VDB_READER),
            (f"--aov {args.aov}", args.aov in ("occupancy", "bvh"),
             "ROADMAP A.8, render/debugviz.py")):
        if on:
            _not_ported(flag, item)
    from vpt_tpu_torch.utils.io import UNPORTED_FORMATS
    ext = os.path.splitext(args.output)[1].lower()
    if ext in UNPORTED_FORMATS:
        raise SystemExit(f"vpt-torch: {ext} output is not ported (PNG and "
                         "EXR are)")
    return env


def default_framing(scene, width, height, fov=30.0, aperture=0.0):
    """The CLI's default camera (vpt_tpu/app/cli.py:386-393): looking at
    the root box's centre from 1.2 diagonals in front and 0.15 of that
    above, on the scene's device."""
    from vpt_tpu_torch.core.camera import Camera
    lo = scene.root_pmin.cpu().numpy()
    hi = scene.root_pmax.cpu().numpy()
    c = (lo + hi) / 2
    dist = float(np.linalg.norm(hi - lo)) * 1.2
    return Camera.make(c + np.array([0.0, dist * 0.15, dist]), c, vfov=fov,
                       aspect=width / height, aperture=aperture,
                       device=scene.device)


def _load_scene(args, lights, device):
    """The scene of ``args.scene`` with ``args.env``'s map attached
    (vpt_tpu/app/cli.py:174-216, the ported cases)."""
    from vpt_tpu_torch.scene.scene import (attach_env_map, build_scene,
                                           load_hdr_env_scene)
    from vpt_tpu_torch.utils.hdr import load_hdr
    from vpt_tpu_torch.volume import procedural
    if args.scene.endswith(".hdr"):
        return load_hdr_env_scene(args.scene, lights=lights, device=device)
    if args.scene.endswith(".ins"):
        # the lights variant (_check_render_slice exits on the volumes
        # variant): the file's point lights over the procedural volume
        from vpt_tpu_torch.scene.ins import load_ins_scene
        scene = load_ins_scene(args.scene, device=device)
    else:
        scene = build_scene(
            [procedural.default_procedural_grid(device=device)],
            lights=lights, device=device)
    if args.env:
        scene = attach_env_map(scene, load_hdr(args.env))
    return scene


def _attach_atmosphere(scene, args, stats):
    """``--atmosphere``: the Bruneton atmosphere at full LutDims from the
    npz cache (precomputed on the scene's device and saved there when the
    file is absent), and its sky cache with ``--bake-sky``, logging as
    vpt_tpu/app/cli.py:401-417 does."""
    from vpt_tpu_torch.scene.scene import attach_atmosphere, attach_sky_cache
    from vpt_tpu_torch.sky.runtime import make_atmosphere
    os.makedirs(os.path.dirname(args.atmosphere_cache) or ".", exist_ok=True)
    sync = torch.cuda.synchronize if scene.device.type == "cuda" else None
    t1 = time.time()
    atm = make_atmosphere(cache_path=args.atmosphere_cache,
                          luminance_mode=args.luminance,
                          do_white_balance=args.white_balance,
                          device=scene.device)
    scene = attach_atmosphere(scene, atmosphere=atm)
    if sync:
        sync(scene.device)
    stats["atmosphere_s"] = time.time() - t1
    log(f"atmosphere LUTs ready in {stats['atmosphere_s']:.1f}s "
        f"(luminance={args.luminance})")
    if args.bake_sky:
        t1 = time.time()
        scene = attach_sky_cache(scene, azimuth=args.azimuth,
                                 elevation=args.elevation)
        if sync:
            sync(scene.device)
        stats["sky_bake_s"] = time.time() - t1
        log("sky cache baked")
    return scene


def cmd_render(args, stats=None):
    """``vpt-torch render``; fills ``stats`` (a dict, when given) with
    the scene, bake and render seconds and Mrays/s (and the atmosphere's
    and the sky bake's seconds with ``--atmosphere``)."""
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.render import film as film_mod
    from vpt_tpu_torch.render.params import (Environment, Integrator,
                                             RenderParams)
    from vpt_tpu_torch.render.renderer import ProgressiveRenderer
    from vpt_tpu_torch.utils.io import save_aov, save_image, write_png

    env_name = _check_render_slice(args)
    stats = {} if stats is None else stats
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)

    lights = PointLights.empty(device)
    if args.light:
        arr = np.array(args.light)
        lights = PointLights.make(arr[:, 0:3], arr[:, 3:6], arr[:, 6],
                                  device=device)

    t0 = time.time()
    scene = _load_scene(args, lights, device)
    stats["scene_s"] = time.time() - t0
    log(f"scene loaded in {stats['scene_s']:.1f}s on {device}")

    if args.camera:
        cam = Camera.make(args.camera[:3], args.camera[3:], vfov=args.fov,
                          aspect=args.width / args.height,
                          aperture=args.aperture, device=device)
    else:
        cam = default_framing(scene, args.width, args.height, args.fov,
                              args.aperture)
    scene = dataclasses.replace(scene, camera=cam)

    env_type = dict(atmosphere=Environment.ATMOSPHERE, hdri=Environment.HDRI,
                    black=Environment.BLACK,
                    constant=Environment.CONSTANT)[env_name]
    if args.atmosphere and env_name == "atmosphere":
        scene = _attach_atmosphere(scene, args, stats)
    params = RenderParams(
        width=args.width, height=args.height, ray_depth=args.ray_depth,
        volume_depth=args.volume_depth,
        integrator=int(Integrator.DIRECT if args.integrator == "direct"
                       else Integrator.VOLUMETRIC),
        environment_type=int(env_type),
        engine=args.engine, seed=args.seed, shadow_mode=args.shadow_mode,
    ).replace(
        exposure_scale=args.exposure, azimuth=args.azimuth,
        elevation=args.elevation, sun_mult=args.sun_mult,
        sky_mult=args.sky_mult, phase_g1=args.phase_g,
        density_mult=args.density_mult, emission_scale=args.emission_scale,
    )

    stats["bake_s"] = 0.0
    if args.shadow_mode == "cached":
        from vpt_tpu_torch.accel.shadow import attach_shadow_cache
        t1 = time.time()
        scene = attach_shadow_cache(scene, azimuth=args.azimuth,
                                    elevation=args.elevation)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["bake_s"] = time.time() - t1
        log(f"shadow cache baked in {stats['bake_s']:.1f}s")

    t0 = time.time()
    r = ProgressiveRenderer(scene, params)
    if args.resume:
        r.film, r.iteration = film_mod.load_film(args.resume, device=device)
        if tuple(r.film.accum.shape[:2]) != (args.height, args.width):
            raise SystemExit(
                f"--resume: checkpoint is "
                f"{r.film.accum.shape[1]}x{r.film.accum.shape[0]}, "
                f"render is {args.width}x{args.height}")
        log(f"resumed at {r.iteration} spp from {args.resume}")
    start = r.iteration
    if args.checkpoint_every:
        ckpt = (args.checkpoint_path
                or f"{os.path.splitext(args.output)[0]}.ckpt.npz")
        os.makedirs(os.path.dirname(ckpt) or ".", exist_ok=True)
        while r.iteration < args.spp:
            r.step(min(args.checkpoint_every, args.spp - r.iteration))
            film_mod.save_film(ckpt, r.film, r.iteration)
            log(f"checkpoint at {r.iteration}/{args.spp} spp -> {ckpt}")
        film = r.film
    else:
        film = r.render(max(args.spp - r.iteration, 0))
    img = r.display_image()[::-1]
    dt = time.time() - t0
    rendered = max(r.iteration - start, 0)
    stats.update(render_s=dt, spp=rendered,
                 mrays_per_s=args.width * args.height * rendered / dt / 1e6)
    log(f"{rendered} spp in {dt:.1f}s ({stats['mrays_per_s']:.2f} Mrays/s)")

    save_image(args.output, img, accum=film.accum.cpu().numpy()[::-1],
               save_exr=args.save_exr)
    if args.aov == "dof":
        viz = film_mod.dof_overlay(film, scene.camera, params.exposure_scale)
        write_png(f"{os.path.splitext(args.output)[0]}_dof.png",
                  viz.cpu().numpy()[::-1])
    elif args.aov != "none":
        save_aov(args.output, args.aov,
                 getattr(film, args.aov).cpu().numpy()[::-1])
    log(f"wrote {args.output}")
    return stats


def cmd_earth(args, stats=None):
    """``vpt-torch earth`` (vpt_tpu/app/cli.py:525-547): the planet from
    orbit through K4's ATMOSPHERE kind (sky/runtime.py::render_earth),
    written as an 8-bit PNG; ``stats`` gets the LUTs' and the render's
    seconds."""
    from vpt_tpu_torch.sky.runtime import make_atmosphere, render_earth
    from vpt_tpu_torch.utils.io import UNPORTED_FORMATS, write_png
    ext = os.path.splitext(args.output)[1].lower()
    if ext in UNPORTED_FORMATS:
        raise SystemExit(f"vpt-torch: {ext} output is not ported for earth "
                         "(PNG is)")
    stats = {} if stats is None else stats
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    os.makedirs(os.path.dirname(args.atmosphere_cache) or ".",
                exist_ok=True)
    t0 = time.time()
    atm = make_atmosphere(cache_path=args.atmosphere_cache, device=device)
    stats["atmosphere_s"] = time.time() - t0
    log(f"atmosphere LUTs ready in {stats['atmosphere_s']:.1f}s")
    t0 = time.time()
    img = render_earth(atm, args.width, args.height, azimuth=args.azimuth,
                       elevation=args.elevation,
                       altitude_factor=args.altitude).cpu().numpy()
    stats["render_s"] = time.time() - t0
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_png(args.output,
              (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    log(f"wrote {args.output}")
    return stats


def main(argv=None, stats=None):
    """Entry point of ``vpt-torch``; ``stats`` as in cmd_render."""
    args = build_parser().parse_args(argv)
    if args.cmd == "render":
        cmd_render(args, stats)
    elif args.cmd == "earth":
        cmd_earth(args, stats)
    elif args.cmd == "view":
        _not_ported("vpt view", "ROADMAP A.12, app")


if __name__ == "__main__":
    main()
