"""The Bruneton atmosphere on the card: the reference bench's config 4
(vpt_tpu's bench.py:649-681), K4's ATMOSPHERE and SKY_CACHE kinds and
K1's env_pos (in the bench's rows and in float32 rows), each held to its
plain version (ATMOSPHERE bit for bit on every ray), the LUT
precompute's, K4's packing's and the sky bake's seconds.

    python -m vpt_tpu_torch.tools.time_atmosphere [--quick | --memory]

Prints one JSON line per part and, last, a summary line; ``run`` is what
chip_smoke.py's phase ``atmosphere`` calls.  ``--quick`` renders 2 spp
and leaves out the full-size precompute, the 1080p render and the entry
points (a first check of a new build); ``--memory`` runs only
``stage_memory``.  Needs a CUDA device.

Config 4 as the bench builds it: the 64^3 puff
(tools/common.py::bench_blob) in bfloat16 corner rows with the octant
columns (``BENCH_ROWS``); the half LutDims; the camera 9 in front of the
root box's centre and 0.5 above it, vfov 40; ATMOSPHERE, the sun at
150/30, ray_depth 50, 512^2; tracked and cached shadows, live and baked
(attach_sky_cache at 256 x 512), 32 timed spp each after 2, and the live
tracked render beside in float32 rows without octant columns
(``live_tracked_f32``); the live atmosphere at 1080p, tracked, 16 spp.
K4's ATMOSPHERE kind is also timed at 1080p on the full LutDims (the
CLI's), on the same scene's K1-retired rays.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

AZIMUTH, ELEVATION = 150.0, 30.0
SIZE, SPP, WARM = 512, 32, 2
HD, HD_SPP = (1920, 1080), 16
CAMERA_OFFSET = (0.0, 0.5, 9.0)       # bench.py:661, aim_camera's offset
CACHE_H, CACHE_W = 256, 512
PARITY = 256                          # the kernels against the plain loop
MIN_SHARE = 0.99   # K1's rays bit for bit with the plain loop, the least
# a walk cut short at Q = 16: 16 steps in a 32 times denser puff (a few
# per cent of the rays are cut)
CUT = dict(max_fused_steps=1, density_mult=32.0)
# K1 against the plain loop: (name, scene, size, in-kernel rays, cut),
# each on both kinds of rows: the bench's (bfloat16, octant columns) and,
# as the name's ``_f32`` (the rows that ``vpt-torch render --atmosphere``
# builds), float32 without octant columns
K1_CASES = (("live_tracked", "live_tracked", PARITY, False, False),
            ("live_cached", "live_cached", PARITY, False, False),
            ("sphere_tracked", "sphere_tracked", PARITY, False, False),
            ("sphere_cached_in_kernel_q16", "sphere_cached", SIZE, True,
             False),
            ("live_cached_in_kernel_q16_cut", "live_cached", SIZE, True,
             True),
            ("sphere_tracked_q16_cut", "sphere_tracked", SIZE, False, True))
HALF = dict(transmittance_w=128, transmittance_h=32, r=16, mu=64, mu_s=16,
            nu=4, irradiance_w=32, irradiance_h=8)   # bench.py:653-656
# K4's operations per ray, counted from csrc/environment.cu (each
# arithmetic operation, comparison, conversion and transcendental one):
# a 2-D lookup 45 (coordinates 18, the blend of 3 channels 27), a pair
# of trilinear taps of the two scattering textures 146, a 4-D lookup
# pair (the uvwz map 45, two tap pairs, the nu lerp 18) 355, a
# transmittance lookup 65; the sky branch (entry 20, cosines 15, the
# transmittance, one 4-D pair, the phases 27) 480 and the ground branch
# (irradiance 75, the sun's transmittance 77, the aerial perspective:
# entry 35, two transmittance quotients 154, two 4-D pairs, the rest 60)
# 1,130, each with the head (the view and the ground hit, 30) and the sun
# disc and curve (40); the cache kind: its coordinates 31, six channels'
# blend 54, the disc and curve 40.
ATM_SKY_OPS, ATM_GROUND_OPS, SKY_CACHE_OPS = 550, 1200, 125
# bytes a ray: L read and written, beta and the direction read, and for
# the live kind the position; the LUTs (or the cache) once
ATM_BYTES, SKY_CACHE_BYTES = 60, 48


def bit_equal(a, b):
    """Per-ray bit equality of two (B, 3) float32 tensors."""
    return (a.contiguous().view(torch.int32)
            == b.contiguous().view(torch.int32)).all(-1)


def compare(got, want):
    """max |got - want|, the share of rays equal bit for bit, finite."""
    return dict(max_abs=float((got - want).abs().max()),
                bit_share=float(bit_equal(got, want).double().mean()),
                finite=bool(torch.isfinite(got).all()))


def run(dev, quick=False, out=print, tmp=None):
    """The atmosphere's part of chip_smoke.py: returns a dict with the
    config-4 runs, the kernels' checks and times, and the K4 kinds'
    launches on those runs (``launches``); raises on any failure."""
    from vpt_tpu_torch.accel.shadow import attach_shadow_cache
    from vpt_tpu_torch.app import cli
    from vpt_tpu_torch.core import rng
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.render import film as film_mod
    from vpt_tpu_torch.render import fused, integrator, renderer
    from vpt_tpu_torch.render.params import Environment, RenderParams
    from vpt_tpu_torch.scene.geometry import Sphere
    from vpt_tpu_torch.scene.scene import (attach_atmosphere,
                                           attach_sky_cache, build_scene)
    from vpt_tpu_torch.sky import bruneton as br
    from vpt_tpu_torch.sky import runtime as rt
    from vpt_tpu_torch.tools.common import (BENCH_ROWS, bench_blob, bound,
                                            mixed_warp_share, time_ms)
    from vpt_tpu_torch.utils.io import read_png

    def emit(part, **kw):
        out(json.dumps({"part": part, **kw}))

    def sync():
        torch.cuda.synchronize(dev)

    res = {}
    kernels = [fused.FUSED_DIRECT, fused.FUSED_DIRECT_PRIMARY,
               renderer.RAYGEN, film_mod.FILM_ACCUMULATE,
               integrator.ENVIRONMENT, integrator.ENVIRONMENT_ATMOSPHERE,
               integrator.ENVIRONMENT_SKY_CACHE, fused.FUSED_DIRECT_BF16,
               fused.FUSED_DIRECT_OCTANT]
    spp = 2 if quick else SPP

    def pack(a):
        """K4's layout of a's LUTs (packed here, once): seconds, bytes."""
        t0 = time.perf_counter()
        k4 = a.k4_luts
        sync()
        return dict(s=time.perf_counter() - t0, bytes=k4.nbytes,
                    lut_bytes=sum(getattr(a.luts, f.name).numel() * 4
                                  for f in dataclasses.fields(a.luts)))

    # ---- the LUTs: half dims for config 4, full dims timed -------------
    half = br.LutDims(**HALF)
    t_half = {}
    t0 = time.perf_counter()
    atm = rt.make_atmosphere(half, device=dev, timings=t_half)
    sync()
    res["precompute_half_s"] = time.perf_counter() - t0
    res["precompute_half_stages_s"] = t_half
    res["k4_pack_half"] = pack(atm)
    full = None
    if not quick:
        t_full = {}
        t0 = time.perf_counter()
        full = rt.make_atmosphere(br.LutDims(), device=dev, timings=t_full)
        sync()
        res["precompute_full_s"] = time.perf_counter() - t0
        res["precompute_full_stages_s"] = t_full
        res["full_luts_finite"] = all(
            bool(torch.isfinite(getattr(full.luts, f.name)).all())
            for f in dataclasses.fields(full.luts))
        res["k4_pack_full"] = pack(full)
    packed = atm.k4_luts
    emit("precompute", **res)

    # ---- config 4 ------------------------------------------------------
    t0 = time.perf_counter()
    scene = build_scene([bench_blob()], device=dev, **BENCH_ROWS)
    sync()
    res["build_s"] = time.perf_counter() - t0
    c = (scene.root_pmin + scene.root_pmax).cpu().numpy() / 2

    def aimed(s_, w, h):
        return dataclasses.replace(s_, camera=Camera.make(
            c + np.array(CAMERA_OFFSET), c, vfov=40.0, aspect=w / h,
            device=dev))

    live = attach_atmosphere(aimed(scene, SIZE, SIZE), atmosphere=atm)
    t0 = time.perf_counter()
    baked = attach_sky_cache(live, AZIMUTH, ELEVATION, CACHE_H, CACHE_W)
    sync()
    res["sky_bake_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    live_cached = attach_shadow_cache(live, AZIMUTH, ELEVATION)
    sync()
    res["shadow_bake_s"] = time.perf_counter() - t0
    baked_cached = dataclasses.replace(live_cached,
                                       sky_cache=baked.sky_cache)
    live_f32 = attach_atmosphere(aimed(build_scene([bench_blob()],
                                                   device=dev), SIZE, SIZE),
                                 atmosphere=atm)
    scenes = {"live_tracked": live, "live_cached": live_cached,
              "baked_tracked": baked, "baked_cached": baked_cached,
              "live_tracked_f32": live_f32}

    def params(w, h, mode, **kw):
        return RenderParams(**{**dict(
            width=w, height=h, ray_depth=50, max_fused_steps=128,
            shadow_mode=mode, azimuth=AZIMUTH, elevation=ELEVATION,
            environment_type=int(Environment.ATMOSPHERE)), **kw})

    def k4_counter(sc):
        return (integrator.ENVIRONMENT_SKY_CACHE if sc.sky_cache is not None
                else integrator.ENVIRONMENT_ATMOSPHERE)

    def timed_render(name, sc, pe, warm, n):
        for k in kernels:
            k.launches = 0
        rr = renderer.ProgressiveRenderer(sc, pe)
        rr.step(warm)
        sync()
        t1 = time.perf_counter()
        rr.step(n)
        sync()
        dt = time.perf_counter() - t1
        got = {k.name: k.launches for k in kernels}
        route = ({fused.FUSED_DIRECT_PRIMARY.name}
                 if renderer.RAYS_IN_KERNEL[pe.shadow_mode]
                 else {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
        on = route | {film_mod.FILM_ACCUMULATE.name, k4_counter(sc).name}
        if fused.rows_kernel(sc) is not None:
            on.add(fused.rows_kernel(sc).name)
        want = {k.name: (warm + n if k.name in on else 0) for k in kernels}
        if got != want:
            raise RuntimeError(f"atmosphere {name}: launches {got}, "
                               f"expected {want}")
        f = rr.film
        rays = pe.width * pe.height * (warm + n)
        rec = dict(size=[pe.width, pe.height], spp=n,
                   ms_per_spp=dt * 1e3 / n,
                   mean_iters_per_ray=float(f.cost.double().sum()) / rays,
                   trunc_frac=float(f.trunc.double().sum()) / rays,
                   image_mean=float(f.accum.double().mean()),
                   finite=bool(torch.isfinite(f.accum).all()),
                   launches=got)
        if not (rec["finite"] and rec["image_mean"] > 0.0):
            raise RuntimeError(f"atmosphere {name}: not finite, or black")
        return rr, rec

    runs, k4_launches = {}, {integrator.ENVIRONMENT_ATMOSPHERE.name: 0,
                             integrator.ENVIRONMENT_SKY_CACHE.name: 0,
                             fused.FUSED_DIRECT_BF16.name: 0}
    for name, sc in scenes.items():
        rr, runs[name] = timed_render(name, sc, params(
            SIZE, SIZE, name.split("_")[1]), WARM, spp)
        for k in k4_launches:
            k4_launches[k] += runs[name]["launches"][k]
        del rr
    if not quick:
        w, h = HD
        sc = dataclasses.replace(live, camera=aimed(live, w, h).camera)
        rr, runs["live_tracked_1080p"] = timed_render(
            "live 1080p", sc, params(w, h, "tracked"), WARM, HD_SPP)
        for k in (integrator.ENVIRONMENT_ATMOSPHERE, fused.FUSED_DIRECT_BF16):
            k4_launches[k.name] += runs["live_tracked_1080p"]["launches"][
                k.name]
        del rr
    res["runs"] = runs
    if not all(sc.atmosphere is atm for sc in scenes.values()) or \
            atm.k4_luts is not packed:
        raise RuntimeError("config 4's renders packed K4's LUTs again")
    emit("config4", runs=runs, build_s=res["build_s"],
         rows=dict(dtype="bfloat16", octant_cols=scene.atlas.octant_cols,
                   width=scene.atlas.density_corners.shape[1]),
         sky_bake_s=res["sky_bake_s"],
         shadow_bake_s=res["shadow_bake_s"], dims=HALF,
         cache=[CACHE_H, CACHE_W])

    # ---- K1 against the plain loop, env_pos included --------------------
    # the live atmosphere's scenes, and ones with a sphere in the puff's
    # lower half, whose events move env_pos to the sphere's anchor; on
    # the buffer route below the queue size, and at 512^2 (Q = 16) on
    # both routes, with the walk cut short (CUT) so that the unretired
    # slots' env_pos, their primary origin, is written too
    sph = Sphere.make(center=(c + np.array([0.0, -1.0, 1.5])).tolist(),
                      radius=1.2, color=(0.8, 0.8, 0.8), roughness=0.3,
                      device=dev)
    k1_scenes = {}
    for rows, (tracked, cached) in (
            ("", (live, live_cached)),
            ("_f32", (live_f32, attach_shadow_cache(live_f32, AZIMUTH,
                                                    ELEVATION)))):
        k1_scenes.update({
            f"live_tracked{rows}": tracked, f"live_cached{rows}": cached,
            f"sphere_tracked{rows}": dataclasses.replace(tracked,
                                                         sphere=sph),
            f"sphere_cached{rows}": dataclasses.replace(cached, sphere=sph)})
    key = rng.render_key(0, 0)
    tkey = renderer.tile_key(key)
    k1 = {}
    for (name, scene_name, size, in_kernel, cut), rows in itertools.product(
            K1_CASES, ("", "_f32")):
        name, sc = name + rows, k1_scenes[scene_name + rows]
        pe = params(size, size, scene_name.split("_")[1],
                    **(CUT if cut else {}))
        if in_kernel and not renderer.RAYS_IN_KERNEL[pe.shadow_mode]:
            raise RuntimeError(f"K1 {name}: the render takes the buffers")
        q = renderer.frame_queue(pe)
        o, d = renderer._primary_rays_cuda(sc.camera, pe, key)
        launch = fused.prepare_fused(sc, pe)
        if launch.params.defer_env != 2:
            raise RuntimeError(f"{name}: K1 does not write env_pos")
        if in_kernel:
            raygen = renderer._raygen_for_sample(
                renderer.prepare_raygen(sc.camera, pe), key)
            views = fused._launch_k1_primary(launch, tkey, raygen, q)
        else:
            views = fused._launch_k1(launch, tkey, o, d, pe.width, q)
        plain = fused.fused_direct_plain(sc, pe, tkey, o, d, q,
                                         deferred=True)
        same = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        for a_, b_ in zip(views[:5], plain[:5]):
            eq = a_.contiguous().view(torch.int32) == \
                b_.contiguous().view(torch.int32)
            same &= eq.all(-1) if eq.dim() == 2 else eq
        env_same = bit_equal(views[7], plain[7])
        rec = dict(
            rays=o.shape[0], queue=q, route="rays_in_kernel" if in_kernel
            else "rays_in_memory", rows=str(
                sc.atlas.density_corners.dtype).replace("torch.", ""),
            octant_cols=sc.atlas.octant_cols,
            outputs_bit_share=float(same.double().mean()),
            beta_dir_bit_share=float((bit_equal(views[5], plain[5])
                                      & bit_equal(views[6], plain[6])
                                      ).double().mean()),
            env_pos_bit_share=float(env_same.double().mean()),
            env_pos_equal_where_outputs_equal=bool((env_same | ~same).all()),
            env_pos_moved=int((~bit_equal(plain[7], o)).sum()),
            cut=int((plain[3] == 1.0).sum()))
        # K4 on K1's own retired rays against the plain lookup there
        L = views[0].clone()
        want = L + integrator.environment_radiance(
            sc, pe, views[7], views[6]) * views[5]
        got = integrator.add_environment(sc, pe, L, views[5], views[6],
                                         views[7], launch=launch.env)
        rec["k4"] = compare(got, want)
        k1[name] = rec
        if not (rec["outputs_bit_share"] >= MIN_SHARE
                and rec["beta_dir_bit_share"] >= MIN_SHARE
                and rec["env_pos_equal_where_outputs_equal"]
                and rec["k4"]["bit_share"] == 1.0):
            raise RuntimeError(f"K1 {name}: its outputs, beta, direction or "
                               f"env_pos differ from the plain loop's, or "
                               f"K4's from its plain version: {rec}")
        if scene_name.startswith("sphere") and rec["env_pos_moved"] == 0:
            raise RuntimeError(f"K1 {name}: no sphere event moved env_pos")
        if cut and (q == 1 or rec["cut"] == 0):
            raise RuntimeError(f"K1 {name}: no queue slot was cut: {rec}")
        del o, d, views, plain, L, want, got
    emit("k1_env_pos", **k1)
    res["k1_env_pos"] = k1

    # ---- K4's kinds against their plain versions, timed -----------------
    def k4_inputs(sc, w, h, mode):
        """K1's (L, beta, direction, env_pos) of one sample of sc at
        w x h, and K4's launch."""
        pe = params(w, h, mode)
        scw = dataclasses.replace(sc, camera=aimed(sc, w, h).camera)
        k_ = rng.render_key(0, 1)
        o, d = renderer._primary_rays_cuda(scw.camera, pe, k_)
        launch = fused.prepare_fused(scw, pe)
        views = fused._launch_k1(launch, renderer.tile_key(k_), o, d, w,
                                 renderer.frame_queue(pe))
        pos = views[7] if len(views) > 7 else None
        return scw, pe, launch.env, views[0], views[5], views[6], pos

    kinds = {}
    cases = [(kind, sc, size) for kind, sc in (("atmosphere", live),
                                               ("sky_cache", baked))
             for size in [(SIZE, SIZE)] + ([] if quick else [HD])]
    if full is not None:
        cases.append(("atmosphere_full", attach_atmosphere(
            live, atmosphere=full), HD))
    for kind, sc, (w, h) in cases:
        scw, pe, env, L, beta, dirn, pos = k4_inputs(sc, w, h,
                                                     "tracked")
        tk, got = time_ms(lambda: integrator.add_environment(
            scw, pe, L.clone(), beta, dirn, pos, launch=env), dev, 20)
        tp, want = time_ms(lambda: L + integrator.environment_radiance(
            scw, pe, pos if pos is not None else dirn, dirn) * beta,
            dev, 3)
        tc, _ = time_ms(lambda: L.clone(), dev, 20)
        rec = dict(size=[w, h], ms=tk - tc, clone_ms=tc, plain_ms=tp,
                   **compare(got, want))
        n = L.shape[0]
        if kind.startswith("atmosphere"):
            # the ground hit, as the kernel decides it, for the count
            hits = rt.ground_hit(scw.atmosphere.params, pos, dirn)[3]
            ground = float(hits.double().sum())
            rec["mixed_warp_share"] = mixed_warp_share(hits)
            # the (..., 3) LUTs once, whatever layout the kernel reads
            lut_bytes = sum(getattr(scw.atmosphere.luts, f.name).numel()
                            for f in dataclasses.fields(
                                scw.atmosphere.luts)) * 4
            rec.update(ground_share=ground / n, bound=bound(
                n * ATM_BYTES + lut_bytes,
                ground * ATM_GROUND_OPS + (n - ground) * ATM_SKY_OPS),
                dims=dataclasses.asdict(scw.atmosphere.dims))
            ok = rec["bit_share"] == 1.0
        else:
            rec["bound"] = bound(n * SKY_CACHE_BYTES
                                 + scw.sky_cache.numel() * 4,
                                 n * SKY_CACHE_OPS)
            ok = rec["max_abs"] <= 2e-6
        kinds[f"{kind}_{w}x{h}"] = rec
        if not (rec["finite"] and ok):
            raise RuntimeError(f"K4 {kind} at {w}x{h} differs from its "
                               f"plain version: {rec}")
        del L, beta, dirn, pos, got, want
    del full, cases
    res["k4_atmosphere"] = integrator.atmosphere_launch_info()
    emit("k4_kinds", **kinds, atmosphere_schedule=res["k4_atmosphere"])
    res["k4"] = kinds

    # ---- the entry points (left out by --quick) --------------------------
    res["launches"] = k4_launches
    if quick:
        return res
    tmp = tmp or tempfile.mkdtemp(prefix="vpt_atm_")
    cache = os.path.join(tmp, "luts.npz")

    def drive(argv, png, shape, counter):
        """One CLI command: its stats and its PNG's mean, the kernels'
        launches; raises unless the PNG has ``shape`` and ``counter``
        launched."""
        for k in kernels:
            k.launches = 0
        stats = {}
        cli.main(argv + ["-o", png, "--atmosphere-cache", cache], stats)
        img = read_png(png)
        got = {k.name: k.launches for k in kernels}
        if img.shape != shape or got[counter.name] == 0:
            raise RuntimeError(f"vpt-torch {argv[0]}: {img.shape}, "
                               f"launches {got}")
        return dict(stats, png_mean=float(img.mean()), launches=got)

    w, h = HD
    res["cli_render"] = drive(
        ["render", "procedural", "--atmosphere", "--bake-sky", "--width",
         str(w), "--height", str(h), "--spp", str(HD_SPP)],
        os.path.join(tmp, "atm.png"), (h, w, 3),
        integrator.ENVIRONMENT_SKY_CACHE)
    res["cli_render_live"] = drive(
        ["render", "procedural", "--atmosphere", "--no-bake-sky", "--width",
         str(w), "--height", str(h), "--spp", str(HD_SPP)],
        os.path.join(tmp, "atm_live.png"), (h, w, 3),
        integrator.ENVIRONMENT_ATMOSPHERE)
    res["cli_earth"] = drive(["earth"], os.path.join(tmp, "earth.png"),
                             (512, 512, 3), integrator.ENVIRONMENT_ATMOSPHERE)
    # earth's image against the plain version on the same rays
    eatm = rt.make_atmosphere(br.LutDims(), cache_path=cache, device=dev)
    pos, dirs = rt.earth_rays(eatm.params, 512, 512)
    res["cli_earth"].update(compare(
        integrator.atmosphere_on_rays(eatm, pos, dirs, AZIMUTH, ELEVATION),
        rt.sample_atmosphere(eatm, pos, dirs, AZIMUTH, ELEVATION, eatm.dims)))
    if res["cli_earth"]["bit_share"] != 1.0:
        raise RuntimeError(f"earth: K4 differs from the plain version: "
                           f"{res['cli_earth']}")
    emit("entry_points", cli_render=res["cli_render"],
         cli_render_live=res["cli_render_live"], cli_earth=res["cli_earth"])
    return res


def stage_memory(dev, out=print):
    """Each stage of the precompute at full LutDims on the default model,
    as the precompute runs it, and the scattering density also as one
    chunk: its peak device memory above its inputs
    (torch.cuda.max_memory_allocated) and its seconds, or that it ran out
    of memory.  Returns the dict it prints."""
    from vpt_tpu_torch.sky import bruneton as br
    dims = br.LutDims()
    p = br.default_model(device=dev)
    ttex = br.compute_transmittance_lut(p, dims)
    ray, mie = br.compute_single_scattering_lut(p, ttex, dims)
    irr = br.compute_direct_irradiance_lut(p, ttex, dims)
    zero = torch.zeros_like(ray)

    def density():
        return br.compute_scattering_density_lut(p, ttex, ray, mie, zero,
                                                 irr, 2, dims)

    dens = density()
    stages = {
        "transmittance": lambda: br.compute_transmittance_lut(p, dims),
        "single": lambda: br.compute_single_scattering_lut(p, ttex, dims),
        "density": density,
        "multiple": lambda: br.compute_multiple_scattering_lut(
            p, ttex, dens, dims),
        "density_one_chunk": density}
    chunk, res = br.CHUNK_SAMPLES, {}
    try:
        for name, fn in stages.items():
            if name == "density_one_chunk":
                br.CHUNK_SAMPLES = 1 << 62
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                fn()
                torch.cuda.synchronize(dev)
                res[name] = dict(peak_bytes=torch.cuda.max_memory_allocated(
                    dev) - base, s=time.perf_counter() - t0)
            except torch.cuda.OutOfMemoryError:
                res[name] = dict(out_of_memory=True)
    finally:
        br.CHUNK_SAMPLES = chunk
        torch.cuda.empty_cache()
    res = dict(chunk_samples=chunk, card_bytes=torch.cuda.
               get_device_properties(dev).total_memory, stages=res)
    out(json.dumps({"part": "precompute_memory", **res}))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--memory", action="store_true",
                    help="only the precompute's peak memory per stage "
                         "(stage_memory)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_atmosphere: needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.memory:
        stage_memory(dev)
        return 0
    res = run(dev, quick=args.quick)
    print(json.dumps({"summary": {k: v for k, v in res.items()
                                  if k in ("launches", "k4")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
