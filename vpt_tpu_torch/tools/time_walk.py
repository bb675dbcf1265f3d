"""Kernel K5 (csrc/walk.cu) on the card: the reference engine and the
volumetric integrator, timed and held to their plain versions.

    python -m vpt_tpu_torch.tools.time_walk
    python -m vpt_tpu_torch.tools.time_walk --against CHECKOUT
    python vpt_tpu_torch/tools/time_walk.py --timing
    python -m vpt_tpu_torch.tools.time_walk --scenes

chip_smoke.py runs it as its phases ``reference``, ``volumetric`` and
``walk_scenes`` (``--scenes`` alone: scenes_phase); it prints one JSON
line for each, and returns them for the kernels line.

``--timing`` prints one JSON line of the films and times that decide
whether a change kept K5's bits and what it gained: the 1080p films'
SHA-256 through ProgressiveRenderer (the reference engine on the main
scene, the volumetric integrator under the simple sky on the CLI's
scene, and that scene under the c3 map through the CDF at 512x512), each
render's ms/spp and K5 alone by CUDA events.  It calls only entry points
every checkout since K5's redesign has, so run by its path with another
checkout first on PYTHONPATH it times that checkout.  ``--against
CHECKOUT`` builds both checkouts' kernels (in parallel), then runs
``--timing`` in turns,
CHECKOUT, this one, this one, CHECKOUT, each in a process of its own;
it prints each run's line and a summary, and exits 1 unless every film's
hash is the same on both sides.

* ``reference``: the main path's scene (the procedural 200^3 grid, one
  point light, the sun, BLACK) through ProgressiveRenderer with
  engine="reference" at 1920x1080, ray_depth 50, 2 warm-up and 8 timed
  spp: ms/spp, Mrays/s, the primary walks' steps per ray, walk_direct
  and K3 launched once a sample and K1 never, the image finite and not
  black.  K5 alone on one sample's rays, timed by CUDA events, and once
  more counting its bounces, walk steps and sky evaluations (the bound's
  inputs); those rays through walk_direct in the launch's tiles, the
  leading 2048 rays of its first and its ragged last tile held bit for
  bit to direct_integrator_plain under their tile keys.  `vpt-torch
  render procedural --engine reference` with that light, BLACK, at
  1080p, 8 spp: the PNG decodes, the EXR is finite and not black,
  walk_direct once a sample.  K5 against direct_integrator_plain on the
  card at 256x256,
  one tile of all the rays, on that scene (density only) and on config
  2's puff with emission in float32 rows (EXT).
* ``volumetric``: ``vpt-torch render procedural --integrator
  volumetric`` as a user types it (the simple sky, 1920x1080, ray_depth
  50, 8 spp): the PNG decodes, the EXR is finite and not black, and each
  sample launches walk_volumetric once and K4 once; then the same scene
  under the c3 golden's HDRI map (512 x 256) at 512x512 with
  hdri_importance, so the CDF strategy runs; ms/spp, steps and bounces
  per ray; the CLI's scene at 1080p, ray_depth 50, held in the first and
  the ragged last tile as the reference engine's.  K5 against
  vol_integrator_plain at 256x256, ray_depth 8, on the sky, on the HDRI
  through the CDF, on the EXT puff and on the main scene with its point
  light.  Each K5 kernel's device ms by CUDA events between its kernels
  over four K5 launches, and each stage's bound from the bytes it moves.
* ``walk_scenes`` (``--scenes``; scenes_phase): the bench's
  configurations whose scenes and skies K5 takes beyond a single grid's
  float32 rows without octant columns under the run-time sky
  (walk_scene_configs: configs 2 and 4 in the bench's bfloat16 rows with
  octant columns, config 2 also in float32 rows with them, config 4 live
  and baked at the full LutDims and live in float32 rows, config 5 with
  cell lists, config5_ext, loop8), through both integrators at 512x512:
  render()'s numbers, every new instance launched (walk.VARIANTS), K5
  alone with its kernels' ms and bounds (scene_bytes, sky_ops), and K5
  against the plain integrator on the central 64x64 pixels' rays, bit
  for bit; the volumetric integrator at 1080p on config 5 and config 4
  live.  scene_kernel_entries turns it into the kernels line's entries.

The rule of a match (chip_smoke.py's phase 6): >= 99% of rays agree (L
within rtol 1e-4 + atol 1e-6, alpha within 1e-5, cost and trunc exact)
and the image means within 0.5%; and, since K5's redesign, every ray's
outputs bit for bit (the bit-for-bit share, printed, is 1.0).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
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
# tile_parity's tiles of the main path's launch (the first and the last)
# and the leading rays of each held to the plain integrator
TILE_CHECK, TILE_RAYS = (0, -1), 2048
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
# an instanced scene's step: the majorant cell row's 7 packed columns
# (its ids beside them with cell lists) and one corner row's 8 density
# taps; every instance row (24 floats) once
CELL_COLS, TAP_BYTES, INSTANCE_BYTES = 7, 8 * 4, 24 * 4


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


def config2_f32(dev, **rows):
    """Config 2's puff (the bench's 64^3 blob, emission 0.9 density) in
    float32 rows without octant columns (``rows``: build_scene's
    corner_dtype and octant_boxes), the ramp emission LUT, its camera 9
    in front of and 1 above its centre."""
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.scene.assets import ramp_lut
    from vpt_tpu_torch.scene.scene import build_scene
    from vpt_tpu_torch.tools.common import bench_blob
    s = build_scene([bench_blob(emission=True)], emission_lut=ramp_lut(),
                    device=dev, **rows)
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
    """The render path's kernel counters by name, K5's instances beyond
    SC_F32 under the run-time sky (walk.VARIANTS, where the checkout on
    PYTHONPATH has them: --timing runs older ones too) among them."""
    return {k.name: k for k in (
        walk.WALK_DIRECT, walk.WALK_VOLUMETRIC, film_mod.FILM_ACCUMULATE,
        fused.FUSED_DIRECT, fused.FUSED_DIRECT_PRIMARY, renderer.RAYGEN,
        integrator.ENVIRONMENT, integrator.ENVIRONMENT_ATMOSPHERE,
        integrator.ENVIRONMENT_SKY_CACHE, *walk.LAUNCH_KINDS,
        *getattr(walk, "VARIANTS", {}).values())}


def film_sha(film) -> str:
    """SHA-256 of the film's five fields: equal for two checkouts whose
    films agree bit for bit."""
    h = hashlib.sha256()
    for f in ("accum", "alpha", "depth", "cost", "trunc"):
        h.update(getattr(film, f).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


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
                mean=float(acc.double().mean()), film_sha256=film_sha(r.film))


def k5_ms(scene, p, dev, volumetric, reps=3):
    """K5 alone on one sample's primary rays (K2's), no K4: its device ms
    by CUDA events over ``reps`` launches after one, and the launch, its
    tile key, rays and tile (entry points only, for --timing)."""
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
    return start.elapsed_time(end) / reps, (launch, tkey, o, d, tile)


def k5_alone(scene, p, dev, volumetric, tiles=False):
    """k5_ms's time, then one launch counting the rays' bounces, walk
    steps and sky evaluations, by stage for walk_volumetric; and the bound
    of that work (common.bound: the rays, the outputs, each row visited
    once, and K5_OPS_* a step, a bounce and a sky evaluation).  The warp
    efficiency of a one-thread-a-ray schedule, from the cost AOV (the
    primary walks' steps of each ray: fused.warp_efficiency at 32).  Each
    K5 kernel's device ms a launch (kernel_split), and for walk_volumetric
    the queue lengths by bounce.  ``tiles``: also the same rays held to
    the plain integrator in the tiles of TILE_CHECK (tile_parity)."""
    ms, (launch, tkey, o, d, tile) = k5_ms(scene, p, dev, volumetric)
    stats = torch.zeros(walk.N_STATS_STAGES, dtype=torch.int64, device=dev)
    views = walk._launch_k5(launch, tkey, o, d, tile, stats)
    counts = [int(v) for v in stats.tolist()]
    bounces, steps, sky = counts[:3]
    n = o.shape[0]
    b = bound(n * (24 + out_bytes(launch))
              + scene_bytes(scene, launch, steps, sky=True),
              steps * K5_OPS_PER_STEP + bounces * K5_OPS_PER_BOUNCE
              + sky * sky_ops(launch))
    rec = dict(ms=ms, rays=n, bounces_per_ray=bounces / n,
               steps_per_ray=steps / n, sky_evals_per_ray=sky / n,
               primary_steps_per_ray=float(views[2].double().mean()),
               warp_efficiency=fused.warp_efficiency(views[2]),
               bound=b)
    queues = walk.queue_lengths(launch) if volumetric else None
    rec["kernels"] = kernel_split(scene, launch, tkey, o, d, tile, dev,
                                  counts, queues)
    if volumetric:
        rec["queues"] = queues
    if tiles:
        rec["tiles"] = tile_parity(scene, p, dev, volumetric,
                                   (launch, tkey, o, d, tile))
    return rec


def scene_bytes(scene, launch, steps: int, sky: bool = False) -> int:
    """The bytes of the scene's tables that ``steps`` walk steps read at
    least, each row once (render/walk.py::scene_kind): a single grid's 15
    columns a step loads, at 4 bytes (2 in bfloat16 rows), for min(steps,
    rows) corner rows; an instanced scene's majorant cell row (CELL_COLS
    and, with cell lists, the K ids) for min(steps, cells) cells, one
    corner row's 8 density taps for min(steps, rows) rows, and every
    instance row once; with ``sky``, under the Bruneton sky kinds, the
    atmosphere's LUTs in K4's layout or its cache once (what NEE reads)."""
    rows = scene.atlas.density_corners
    sc = launch.scene.kind
    if sc in (walk.SC_CELLS, walk.SC_LOOP):
        cells = launch.scene.R ** 3
        width = CELL_COLS + (launch.scene.k if sc == walk.SC_CELLS else 0)
        n = (min(steps, cells) * width * 4 + min(steps, rows.shape[0])
             * TAP_BYTES + scene.instances.count * INSTANCE_BYTES)
    else:
        n = min(steps, rows.shape[0]) * 15 * rows.element_size()
    if sky and launch.scene.sky == walk.SKY_ATMOSPHERE:
        n += scene.atmosphere.k4_luts.nbytes
    elif sky and launch.scene.sky == walk.SKY_CACHE:
        n += scene.sky_cache.numel() * 4
    return n


def sky_ops(launch) -> int:
    """The operations of one sky evaluation of the launch's NEE: the simple
    sky's march, or, under the Bruneton sky kinds, K4's counts
    (tools/time_atmosphere.py: a sky ray's, the fewer of a live one's two
    branches, or the cache's lookup)."""
    from vpt_tpu_torch.tools.time_atmosphere import (ATM_SKY_OPS,
                                                     SKY_CACHE_OPS)
    return {walk.SKY_ATMOSPHERE: ATM_SKY_OPS,
            walk.SKY_CACHE: SKY_CACHE_OPS}.get(launch.scene.sky, SKY_OPS)


def out_bytes(launch) -> int:
    """The bytes of one ray's outputs (write_out: 7 floats, 6 more for a
    deferred environment)."""
    return 4 * (7 + 6 * bool(launch.params.defer_env))


# what walk.cu's stages move a path: PathState's first four 16-byte words
# (load_state / store_state), its six (SCATTER's read), the two a light
# estimate reads (pos, dir), the estimate it writes (ld; the sky's phase
# sample xb and has_b), a queue entry, and a ray's origin and direction
STATE4, STATE6, NEE_READ, LD_BYTES, XB_BYTES, QUEUE = 64, 96, 32, 12, 16, 4
RAY_BYTES, ORIGIN = 24, 12


def stage_bytes(queues, out_b: int) -> dict:
    """The bytes each of walk_volumetric's stages moves in one launch, by
    bounce from its queue lengths (walk.queue_lengths), as walk.cu's
    stages read and write them: EXTEND reads the rays at bounce 0 and a
    queue entry and four state words after it, writes the outputs of a
    path that ends (reading its origin again after bounce 0), four state
    words and queue entries for one that goes on; NEE reads a queue entry
    and two state words and writes its estimate, once for each kind and
    once more for the sky's phase sample; SCATTER reads a queue entry and
    six state words, writes the outputs at the last bounce, four state
    words and a queue entry before it.  Rows are not in these (stage
    bounds add them)."""
    live, sc = queues["live"], queues["scatter"]
    depth = len(live)
    ext = nee = sca = 0
    for d in range(depth):
        ended = live[d] - sc[d]
        ext += live[d] * (RAY_BYTES if d == 0 else QUEUE + STATE4)
        ext += ended * (out_b + (ORIGIN if d else 0))
        lights = queues["sun"][d] + queues["point"][d] + queues["sky"][d]
        ext += sc[d] * (STATE4 + QUEUE) + lights * QUEUE
        nee += lights * (QUEUE + NEE_READ + LD_BYTES)
        nee += queues["sky"][d] * (QUEUE + NEE_READ + XB_BYTES)
        sca += sc[d] * (QUEUE + STATE6)
        sca += sc[d] * (out_b + ORIGIN if d + 1 >= depth
                        else STATE4 + QUEUE)
    return {"walk_extend": ext, "walk_nee": nee, "walk_scatter": sca}


def kernel_split(scene, launch, tkey, o, d, tile, dev, counts, queues,
                 reps=4):
    """Each K5 kernel's device ms per K5 launch, the mean over ``reps``
    timed launches (_launch_k5's kernel_ms: CUDA events between the
    kernels, every launch of every kernel timed); launches per K5 launch,
    and the bound of its share of the work (``counts``: N_STATS_STAGES
    counters of one launch; ``queues``: walk_volumetric's queue lengths):
    walk_keys its table written once, a key a threefry; walk_direct the
    whole launch's; each stage the bytes it moves (stage_bytes) and each
    row its walk steps visit once, and its walk steps at K5_OPS_PER_STEP
    (EXTEND also the bounces, NEE the sky evaluations), so the stages'
    operations add up to the integrator's."""
    torch.cuda.synchronize(dev)
    before = {k.name: k.launches for k in walk.LAUNCH_KINDS}
    ms = {}
    for _ in range(reps):
        walk._launch_k5(launch, tkey, o, d, tile, kernel_ms=ms)
    launched = {k.name: k.launches - before[k.name] for k in walk.LAUNCH_KINDS
                if k.launches > before[k.name]}
    n = o.shape[0]
    p = walk._launch_params(launch, n, tile, tkey)
    slab = p.key_scalars + p.key_walks * p.key_steps
    n_keys = p.n_tiles * p.key_depths * slab * (
        max(p.ray_depth, 1) if launch.volumetric else 1)
    bounces, steps, sky = counts[:3]
    bounds = {"walk_keys": bound(n_keys * 8, n_keys * 80)}
    steps_of = {}
    if launch.volumetric:
        moved = stage_bytes(queues, out_bytes(launch))
        steps_of = {"walk_extend": counts[3], "walk_nee": sum(counts[4:7]),
                    "walk_scatter": counts[7]}
        ops = {"walk_extend": bounces * K5_OPS_PER_BOUNCE,
               "walk_nee": sky * sky_ops(launch), "walk_scatter": 0}
        for name, st in steps_of.items():
            bounds[name] = bound(
                moved[name] + scene_bytes(scene, launch, st,
                                          sky=name == "walk_nee"),
                st * K5_OPS_PER_STEP + ops[name])
    else:
        bounds["walk_direct"] = bound(
            n * (24 + out_bytes(launch)) + scene_bytes(scene, launch, steps),
            steps * K5_OPS_PER_STEP + bounces * K5_OPS_PER_BOUNCE)
    out = {}
    for k in walk.LAUNCH_KINDS:
        if k.name not in bounds:
            continue
        out[k.name] = dict(ms=ms[k.name] / reps,
                           launches=launched[k.name] / reps,
                           bound=bounds[k.name], steps=steps_of.get(k.name))
        if k is walk.WALK_NEE:
            out[k.name]["steps_by_kind"] = dict(zip(
                walk.STEP_STAGES[1:4], counts[4:7]))
    return out


def parity_cases(dev, scene, volumetric):
    """The phases' parity cases at PARITY^2, {name: (scene, params)} on
    ``scene`` (main_scene's): the reference engine on it (density only)
    and on config 2's puff (EXT); the volumetric integrator at ray_depth
    VOL_PARITY_DEPTH on it without its point light under the simple sky
    and under the c3 map through the CDF, on config 2's puff, and on it
    with its point light under the simple sky (all three NEE kinds)."""
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.scene.scene import attach_env_map
    if not volumetric:
        pp = params(PARITY, PARITY, engine="reference")
        return {"density": (framed(scene, PARITY, PARITY), pp),
                "ext_config2_f32": (config2_f32(dev),
                                    pp.replace(emission_scale=2.0))}
    sky = dataclasses.replace(scene, lights=PointLights.empty(dev))
    hdri = attach_env_map(sky, c3_map(*HDRI_MAP))
    pv = dict(integrator=1, ray_depth=VOL_PARITY_DEPTH)
    atm = dict(environment_type=int(Environment.ATMOSPHERE), **pv)
    return {
        "sky": (framed(sky, PARITY, PARITY), params(PARITY, PARITY, **atm)),
        "hdri_cdf": (framed(hdri, PARITY, PARITY), params(
            PARITY, PARITY, environment_type=int(Environment.HDRI),
            hdri_importance=True, **pv)),
        "ext_config2_f32": (config2_f32(dev), params(
            PARITY, PARITY, emission_scale=2.0, **pv)),
        "sky_point": (framed(scene, PARITY, PARITY),
                      params(PARITY, PARITY, **atm))}


def parity(scene, p, dev, volumetric, crop=None):
    """K5 (and K4 after it) against the plain integrator on the card on
    the frame's rays (the PARITY^2 frame's in parity_cases), or on the
    central ``crop`` x ``crop`` pixels' of it, as one tile under the
    sample's tile key: match()'s numbers, the plain version's ms (one
    call, host clock after a sync) and K5's."""
    from vpt_tpu_torch.render.integrator import direct_integrator_plain
    from vpt_tpu_torch.render.vol_integrator import vol_integrator_plain
    key = rng.render_key(SEED, 1)
    o, d = renderer._primary_rays_cuda(scene.camera, p, key)
    if crop:
        y = torch.arange(crop, device=dev) + (p.height - crop) // 2
        x = torch.arange(crop, device=dev) + (p.width - crop) // 2
        i = (y[:, None] * p.width + x[None, :]).reshape(-1)
        o, d = o[i].contiguous(), d[i].contiguous()
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


def tile_parity(scene, p, dev, volumetric, shot):
    """The main path's launch held to the plain integrator at its own
    shapes: walk_direct or walk_volumetric (K4 after it) on ``shot``'s
    rays (k5_ms's launch, tile key, rays and tile) in tiles of ``tile``,
    and the plain integrator on the leading TILE_RAYS rays of each tile of
    TILE_CHECK (the first and the last, ragged at 1080p) under that tile's
    key fold_in(tkey, 1000 + t), where a ray's draws are those of its
    index in its tile.  Every output bit for bit (raises otherwise):
    match()'s numbers, the rays that entered the box and the plain
    version's ms (host clock after a sync), by tile."""
    from vpt_tpu_torch.core.vecmath import aabb_intersect
    from vpt_tpu_torch.render.integrator import direct_integrator_plain
    from vpt_tpu_torch.render.vol_integrator import vol_integrator_plain
    launch, tkey, o, d, tile = shot
    run = walk.walk_volumetric if volumetric else walk.walk_direct
    plain = vol_integrator_plain if volumetric else direct_integrator_plain
    got = run(scene, p, tkey, o, d, launch, tile)
    B = o.shape[0]
    tiles = walk.n_tiles(B, tile)
    out = {}
    for t in TILE_CHECK:
        t %= tiles
        a = t * tile
        m = min(TILE_RAYS, B - a)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        want = plain(scene, p, rng.fold_in(tkey, walk.TILE_FOLD + t),
                     o[a:a + m], d[a:a + m])
        torch.cuda.synchronize(dev)
        rec = match(tuple(v[a:a + m] for v in got), want)
        hit = aabb_intersect(scene.root_pmin, scene.root_pmax, o[a:a + m],
                             d[a:a + m])[0]
        rec.update(tile=t, first_ray=a, tile_rays=min(tile, B - a),
                   in_box=int(hit.sum()), ray_depth=p.ray_depth,
                   plain_ms=(time.perf_counter() - t0) * 1e3)
        if rec["bit_share"] != 1.0:
            raise RuntimeError(f"K5 at {p.width}x{p.height}, tile {t}: "
                               f"not bit for bit with its plain version: "
                               f"{rec}")
        out[str(t)] = rec
    return out


def keys_check(scene, p, dev, volumetric, depths=(0, 7)):
    """walk_keys_kernel's table for one sample's launch (its tiles of
    fused_tile rays) at bounces ``depths`` against key_table_plain on the
    card, bit for bit: the kernel's and the plain version's ms (CUDA
    events, mean of the bounces), the table's keys a bounce and whether
    every key agrees (raises otherwise)."""
    launch = walk.prepare_walk(scene, p, volumetric)
    n = p.width * p.height
    tile = min(p.fused_tile, n)
    tkey = rng.split(rng.render_key(SEED, 0))[1]
    layout = walk.launch_layout(launch)
    k_ms = p_ms = 0.0
    for d0 in depths:
        walk.key_table(launch, tkey, n, tile, d0)
        start = torch.cuda.Event(enable_timing=True)
        mid = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = walk.key_table(launch, tkey, n, tile, d0)
        mid.record()
        want = walk.key_table_plain(layout, tkey, walk.n_tiles(n, tile), tile,
                                    d0, got.shape[1], dev)
        end.record()
        torch.cuda.synchronize(dev)
        k_ms += start.elapsed_time(mid) / len(depths)
        p_ms += mid.elapsed_time(end) / len(depths)
        if not torch.equal(got, want):
            raise RuntimeError(f"walk_keys: the table at bounce {d0} "
                               "differs from key_table_plain")
    return dict(ms=k_ms, plain_ms=p_ms, keys=int(got[:, :1].numel() // 2),
                bit_equal=True, max_abs=0.0)


def check(where, m):
    if not (m["share"] >= MIN_SHARE and m["mean_rel"] <= MAX_MEAN_REL
            and m["mean"] > 0 and m["bit_share"] == 1.0):
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
    rec["k5_alone"] = k5_alone(main, p, dev, False, tiles=True)
    rec["cli"] = cli_run(
        dev, ["--engine", "reference", "--env-type", "black", "--light",
              *(str(v) for v in LIGHT_POS), "1", "1", "1", str(LIGHT_POWER)],
        "walk_direct", 0)
    rec["parity"] = {name: parity(sc, pp, dev, False) for name, (sc, pp)
                     in parity_cases(dev, scene, False).items()}
    for name, m in rec["parity"].items():
        check(f"reference/{name}", m)
    rec["launch_info"] = {f"ext{e}": {
        st: walk.launch_info(False, bool(e), st) for st in ("direct", "keys")}
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
            or launches["fused_direct"] or launches["fused_direct_primary"]
            or launches[walk.WALK_KEYS.name] <= 0):
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
    rec["k5_alone_sky"] = k5_alone(framed(sky, W, H), pv, dev, True,
                                   tiles=True)
    hdri = attach_env_map(sky, c3_map(*HDRI_MAP))
    ph = params(HDRI_SIZE, HDRI_SIZE, integrator=1, hdri_importance=True,
                environment_type=int(Environment.HDRI))
    hd = framed(hdri, HDRI_SIZE, HDRI_SIZE)
    rec["keys"] = keys_check(framed(sky, W, H), pv, dev, True)
    rec["hdri_cdf"] = render(hd, ph, dev)
    rec["hdri_cdf"]["k5_alone"] = k5_alone(hd, ph, dev, True)
    # the main scene with its point light: NEE's point-light kind
    pp_ = params(HDRI_SIZE, HDRI_SIZE, integrator=1,
                 environment_type=int(Environment.ATMOSPHERE))
    sp = framed(scene, HDRI_SIZE, HDRI_SIZE)
    rec["point"] = render(sp, pp_, dev)
    rec["point"]["k5_alone"] = k5_alone(sp, pp_, dev, True)
    for name in ("hdri_cdf", "point"):
        r = rec[name]
        if not (r["finite"] and r["mean"] > 0
                and r["launches"]["walk_volumetric"] == TIMED_SPP):
            raise RuntimeError(f"volumetric: {name}: {r}")
    # every stage kernel of the wavefront launched on these paths
    for k in (walk.WALK_KEYS, *walk.STAGE_KERNELS):
        if sum(rec[n]["launches"][k.name] for n in ("hdri_cdf", "point")
               ) + rec["cli"]["launches"][k.name] <= 0:
            raise RuntimeError(f"volumetric: {k.name} never launched")
    rec["parity"] = {name: parity(sc, pp, dev, True) for name, (sc, pp)
                     in parity_cases(dev, scene, True).items()}
    for name, m in rec["parity"].items():
        check(f"volumetric/{name}", m)
    rec["launch_info"] = {f"ext{e}": {
        st: walk.launch_info(True, bool(e), st) for st in walk.STAGES
        if st != "direct"} for e in (0, 1)}
    return rec


# the walk_scenes phase: the bench's configurations whose scenes and
# skies K5 takes beyond float32 rows without octant columns under the
# run-time sky, at SCENES_SIZE^2 through both integrators, each held bit
# for bit to its plain version on the central CROP^2 pixels' rays
# (the volumetric integrator at ray_depth VOL_PARITY_DEPTH), and the
# volumetric integrator at 1080p on SCENES_HD
SCENES_SIZE, CROP = 512, 64
SCENES_HD = ("config5", "config4_live")
CONFIG4_OFFSET = (0.0, 0.5, 9.0)   # bench.py:661, aim_camera's offset


def walk_scene_configs(dev, timings=None) -> dict:
    """{name: (scene, its params' keywords, a function of the aspect that
    reframes the scene)} as the bench builds them (tools/common.py): config
    2 (bench.py:583-596: the 64^3 puff with emission, bfloat16 rows with
    the octant columns, BLACK, emission_scale 2) and beside it in float32
    rows with the octant columns; config 4 (bench.py:649-681: the puff in
    the bench's rows under the Bruneton atmosphere at the full LutDims,
    live, and baked at 256 x 512) and live in float32 rows without octant
    columns; config 5 (bench.py:629-704: 1024 instances of the 24^3 puff
    with cell lists at R 64, CONSTANT); config5_ext (its instances with
    emission and color) and loop8 (bench.py:710-800: the static loop,
    BLACK, emission_scale 2).  ``timings`` receives each build's seconds
    (the atmosphere's precompute under "config4_luts")."""
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.scene.scene import (attach_atmosphere,
                                           attach_sky_cache, build_scene)
    from vpt_tpu_torch.sky.bruneton import LutDims
    from vpt_tpu_torch.sky.runtime import make_atmosphere
    from vpt_tpu_torch.tools import common
    t = {} if timings is None else timings
    atm = dict(environment_type=int(Environment.ATMOSPHERE))
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        sc = fn()
        torch.cuda.synchronize(dev)
        t[name] = time.perf_counter() - t0
        return sc

    def emit_aim(s_, aspect=1.0):
        c = (s_.root_pmin + s_.root_pmax).cpu().numpy() / 2
        return dataclasses.replace(s_, camera=Camera.make(
            c + np.array(EMIT_CAMERA), c, vfov=40.0, aspect=aspect,
            device=dev))

    def c4_aim(s_, aspect=1.0):
        c = (s_.root_pmin + s_.root_pmax).cpu().numpy() / 2
        return dataclasses.replace(s_, camera=Camera.make(
            c + np.array(CONFIG4_OFFSET), c, vfov=40.0, aspect=aspect,
            device=dev))

    c2 = dict(emission_scale=2.0)
    out["config2"] = (timed("config2", lambda: config2_f32(
        dev, **common.BENCH_ROWS)), c2, emit_aim)
    out["config2_f32_octant"] = (timed("config2_f32_octant", lambda:
                                       config2_f32(dev, octant_boxes=True)),
                                 c2, emit_aim)
    luts = timed("config4_luts", lambda: make_atmosphere(LutDims(),
                                                         device=dev))
    live = timed("config4", lambda: c4_aim(attach_atmosphere(build_scene(
        [common.bench_blob()], device=dev, **common.BENCH_ROWS),
        atmosphere=luts)))
    out["config4_live"] = (live, atm, c4_aim)
    out["config4_baked"] = (timed("config4_bake", lambda: attach_sky_cache(
        live, AZIMUTH, ELEVATION, 256, 512)), atm, c4_aim)
    out["config4_f32_live"] = (timed("config4_f32", lambda: c4_aim(
        attach_atmosphere(build_scene([common.bench_blob()], device=dev),
                          atmosphere=luts))), atm, c4_aim)
    const = dict(environment_type=int(Environment.CONSTANT))

    def config5():
        ids, xforms = common.cloud_xforms(1024)
        return common.aim_cloud(build_scene(
            [common.bench_blob(n=24)], instance_grid_ids=ids,
            instance_xforms=xforms, device=dev))
    out["config5"] = (timed("config5", config5), const, common.aim_cloud)
    out["config5_ext"] = (timed("config5_ext", lambda:
                                common.config5_ext_scene(dev)), const,
                          common.aim_cloud)
    out["loop8"] = (timed("loop8", lambda: common.loop8_scene(dev)), c2,
                    common.aim_loop8)
    return out


def _instances_launched(rec, names) -> dict:
    """{instance name: its launches in a render record}; raises where one
    of ``names`` never launched."""
    got = {n: rec["launches"].get(n, 0) for n in names}
    missing = [n for n, k in got.items() if k <= 0]
    if missing:
        raise RuntimeError(f"walk_scenes: {missing} never launched: "
                           f"{rec['launches']}")
    return got


def scenes_phase(dev, out=print):
    """The ``walk_scenes`` phase's record: for each of walk_scene_configs,
    its build seconds; through each integrator at SCENES_SIZE^2 (ray_depth
    50): render()'s ms/spp, the image finite and not black, the instances
    the launches ran (walk.instance_names), each launched in the timed spp;
    K5 alone (k5_alone: ms, bounces and walk steps a ray from the launch's
    counters, each kernel's ms by CUDA events and bound); K5 against the
    plain integrator on the central CROP^2 pixels' rays, every output bit
    for bit (the volumetric integrator at ray_depth VOL_PARITY_DEPTH);
    then the volumetric integrator at 1920x1080 on SCENES_HD (render() and
    k5_alone).  Raises on any difference, black or non-finite image, or
    an instance that did not launch; prints a line a run."""
    timings = {}
    configs = walk_scene_configs(dev, timings)
    rec = {"build_s": timings}
    for name, (scene, kw, aim) in configs.items():
        rec[name] = {}
        for volumetric in (False, True):
            p = params(SCENES_SIZE, SCENES_SIZE, engine="reference",
                       integrator=int(volumetric), **kw)
            launch = walk.prepare_walk(scene, p, volumetric)
            names = walk.instance_names(volumetric, launch.ext,
                                        launch.scene.kind, launch.scene.sky)
            r = render(scene, p, dev)
            if not (r["finite"] and r["mean"] > 0):
                raise RuntimeError(f"walk_scenes {name}: the image is not "
                                   f"finite or black: {r}")
            r["instances"] = _instances_launched(r, names.values())
            r["stage_instances"] = names
            r["k5_alone"] = k5_alone(scene, p, dev, volumetric)
            pp = p.replace(ray_depth=VOL_PARITY_DEPTH) if volumetric else p
            m = parity(scene, pp, dev, volumetric, crop=CROP)
            m.update(crop=CROP, ray_depth=pp.ray_depth)
            check(f"walk_scenes/{name}/"
                  f"{'volumetric' if volumetric else 'reference'}", m)
            r["parity"] = m
            key = "volumetric" if volumetric else "reference"
            rec[name][key] = r
            out(json.dumps({"walk_scene": name, "integrator": key,
                            "ms_per_spp": r["ms_per_spp"],
                            "k5_ms": r["k5_alone"]["ms"],
                            "parity": m}))
    for name in SCENES_HD:
        scene, kw, aim = configs[name]
        hd = aim(scene, W / H)
        p = params(W, H, engine="reference", integrator=1, **kw)
        r = render(hd, p, dev)
        if not (r["finite"] and r["mean"] > 0):
            raise RuntimeError(f"walk_scenes {name} at 1080p: {r}")
        r["k5_alone"] = k5_alone(hd, p, dev, True)
        rec[name]["volumetric_1080p"] = r
        out(json.dumps({"walk_scene": name, "integrator": "volumetric",
                        "size": [W, H], "ms_per_spp": r["ms_per_spp"],
                        "k5_ms": r["k5_alone"]["ms"]}))
    return rec


def scene_kernel_entries(rec) -> list:
    """The kernels line's entries of the instances the walk_scenes phase
    (scenes_phase's ``rec``) launched: each instance's launches summed over
    its SCENES_SIZE^2 renders' timed spp; its ms and bound per K5 launch
    (kernel_split) on the first configuration that ran it, and that
    run's parity (the plain integrator's ms on the CROP^2 rays, the
    largest |dL| over every run of the instance: 0 where bit for bit)."""
    entries = {}
    for name, runs in rec.items():
        if name == "build_s":
            continue
        for integ in ("reference", "volumetric"):
            r = runs[integ]
            for stage, inst in r["stage_instances"].items():
                k = walk.VARIANTS[inst]
                split = r["k5_alone"]["kernels"][stage]
                sites = [site for t, site in walk.KIND_SITES.items()
                         if inst.endswith(f"_{t}") or f"_{t}_" in inst]
                e = entries.setdefault(inst, dict(
                    name=inst, route=k.route, source=k.source,
                    replaces=k.replaces, also_replaces="; ".join(sites),
                    launches=0, max_abs_err=0.0, ms=split["ms"],
                    plain_ms=r["parity"]["plain_ms"],
                    bound_ms=split["bound"][0], bound_by=split["bound"][1],
                    library_ms=None, library_ms_note="none exists",
                    shape=f"{name}, {SCENES_SIZE}x{SCENES_SIZE}, {integ}, "
                          f"ray_depth {RAY_DEPTH}: ms and bound per K5 "
                          f"launch; plain_ms the plain integrator's on "
                          f"the central {CROP}x{CROP} pixels' rays",
                    bounces_per_ray=r["k5_alone"]["bounces_per_ray"],
                    steps_per_ray=r["k5_alone"]["steps_per_ray"],
                    configs=[]))
                e["launches"] += r["instances"][inst]
                e["max_abs_err"] = max(e["max_abs_err"],
                                       r["parity"]["max_abs"])
                e["configs"].append(f"{name}/{integ}")
    return list(entries.values())


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def timing_record(dev, scene=None) -> dict:
    """``--timing``'s record: the films' SHA-256 and ms/spp of the three
    renders (render()), and K5 alone by CUDA events (k5_ms) on
    each; entry points only, so it times whichever checkout is first on
    PYTHONPATH."""
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.scene.scene import attach_env_map
    scene = main_scene(dev) if scene is None else scene
    sky = dataclasses.replace(scene, lights=PointLights.empty(dev))
    hdri = framed(attach_env_map(sky, c3_map(*HDRI_MAP)), HDRI_SIZE,
                  HDRI_SIZE)
    cases = (
        ("reference", framed(scene, W, H), params(W, H, engine="reference"),
         False),
        ("volumetric", framed(sky, W, H),
         params(W, H, integrator=1,
                environment_type=int(Environment.ATMOSPHERE)), True),
        ("hdri_cdf", hdri,
         params(HDRI_SIZE, HDRI_SIZE, integrator=1, hdri_importance=True,
                environment_type=int(Environment.HDRI)), True))
    rec = {}
    for name, sc, p, volumetric in cases:
        r = render(sc, p, dev)
        rec[name] = dict(ms_per_spp=r["ms_per_spp"],
                         film_sha256=r["film_sha256"],
                         k5_ms=k5_ms(sc, p, dev, volumetric)[0])
    return rec


def against(other: str) -> int:
    """``--against``: both checkouts' kernels built at once, then
    --timing in turns (other, this, this, other), each in a process of its
    own; 1 unless every film hash agrees."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(other)
    script = os.path.abspath(__file__)

    def env(root):
        return dict(os.environ, PYTHONPATH=root)

    builds = [subprocess.Popen(
        [sys.executable, "-c", "from vpt_tpu_torch.ops import cuda; "
         "cuda.load_library()"], env=env(root)) for root in (other, here)]
    if any(b.wait() for b in builds):
        raise SystemExit("time_walk --against: a build failed")
    runs = []
    for side, root in (("parent", other), ("this", here), ("this", here),
                       ("parent", other)):
        res = subprocess.run([sys.executable, script, "--timing"],
                             env=env(root), capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"time_walk --timing on {root} failed:\n"
                             f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec.update(side=side, root=root)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    names = [k for k in runs[0] if isinstance(runs[0][k], dict)]
    same = all(len({r[n]["film_sha256"] for r in runs}) == 1 for n in names)
    summary = {"against": other, "order": [r["side"] for r in runs],
               "films_same": same, "nvidia_smi": smi_line()}
    for n in names:
        summary[n] = {f: [r[n][f] for r in runs]
                      for f in ("ms_per_spp", "k5_ms")}
        summary[n]["film_sha256"] = runs[0][n]["film_sha256"]
    print(json.dumps(summary), flush=True)
    return 0 if same else 1


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--scenes", action="store_true")
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_walk: needs an NVIDIA GPU")
    if args.against:
        return against(args.against)
    dev = torch.device("cuda", 0)
    if args.scenes:
        print(json.dumps({"phase": "walk_scenes", "nvidia_smi": smi_line(),
                          **scenes_phase(dev)}), flush=True)
        return 0
    scene = main_scene(dev)
    if args.timing:
        print(json.dumps({"nvidia_smi": smi_line(),
                          **timing_record(dev, scene)}), flush=True)
        return 0
    for name, fn in (("reference", reference_phase),
                     ("volumetric", volumetric_phase)):
        print(json.dumps({"phase": name, **fn(dev, scene)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
