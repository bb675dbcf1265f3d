#!/usr/bin/env python3
"""Drive the port's main render path and its entry points once on one
NVIDIA GPU.

    python3 chip_smoke.py [--save DIR]

Phases, one JSON line each:
  1. device  — the card's name and power limit, torch and CUDA versions;
  2. build   — K1-K5 and the probe kernels P1-P3 (nvcc, csrc/*.cu, one
               process per source, each source's seconds) from the
               sources in this checkout, and
               K3's first launch; K1's registers and spills (ptxas) and
               its schedule (SMs, resident blocks per SM) for both routes;
  2b. divide — K4's division by the sky's constants HR and HM
               (csrc/vpt_common.cuh::div_known2, with RN(1/d) from
               sky_constants) against IEEE float32 division over all 2^32
               patterns of x on the card (environment.cu::
               vpt_div_known_sweep): 0 mismatches for each divisor;
  3. scene   — the procedural 200^3 fBm grid (vpt render procedural),
               one point light and the sun, built and shadow-baked on the
               card;
  4. parity  — a quick early gate at 256x256, 2 spp: each kernel against
               its plain PyTorch version on the same inputs, to the
               tolerances of phase 6 (K2 bit for bit at aperture 0,
               where it skips the lens draws, at aperture 0.5 and with a
               -0.0 origin component, where it takes them, and
               lens_draws_needed must say which; K1's in-kernel-ray route
               bit for bit its buffer route at aperture 0.5 too; K3 bit
               for bit, also at a size
               whose pixel count is no multiple of 4, where
               ProgressiveRenderer also renders 2 spp in both shadow
               modes, each step's film held to accumulate_plain on
               the same sample bit for bit), and K1's
               in-kernel-ray route against its buffer route on K2's rays,
               bit for bit; K3 on views that start 1-3 floats past a
               16-byte boundary (its scalar route), bit for bit; K4 on
               K1's (L, beta, direction) of a sky and an HDRI sample
               against environment_radiance (max relative error <=
               K4_RTOL), and K1 + K4 against the plain pipeline with each
               environment in both shadow modes (the share rule);
  5. main    — 1920x1080 through ProgressiveRenderer: cached shadows,
               2 warm-up + 64 timed spp, then tracked shadows, 64 spp;
               with cached shadows K1's in-kernel-ray route and K3 must
               have launched, the standalone K2 and K1's buffer route
               never; with tracked shadows K2, K1's buffer route and K3,
               the in-kernel-ray route never; K4 never (BLACK); the
               image must be finite and not black;
  5b. c1     — the step budget at queued sizes (render/params.py::
               resolve_queue): tracked shadows at 512x512 and 1080p on
               the new rule (Q = 16: 16 x 128 steps a ray) and on the
               parent's (Q = 1, rays_per_lane=1): ms/spp, iterations per
               ray, trunc_frac; and one 1080p tracked sample on both
               rules from the same key, where every ray the parent's rule
               did not cut must be bit for bit the same;
  6. timing  — each kernel beside its plain version on the main path's
               1080p inputs, both timed and held together: K2 exactly
               (K2_TOL) and bit for bit in the three lens settings of
               phase 4, timed at apertures 0 and 0.5, K3 on the rendered
               film bit for bit, K1 (at the
               frame's queue length, Q = 16) ray by ray
               in both shadow modes (>= 99% of rays agree: L within rtol
               1e-4 + atol 1e-6, alpha within 1e-5, cost and unfinished
               exact; image means within 0.5%), its buffer route against
               fused_direct_plain on K2's rays and its in-kernel-ray route
               against the plain pipeline and, bit for bit, against the
               buffer route (also at aperture 0.5); the warp efficiency
               of the launch-order
               schedule from the cost AOV, at 32 and 128;
  6a. env   — K4 at 1080p on K1's (L, beta, direction) of a sky and an
               HDRI sample, timed beside environment_radiance and held to
               it (max relative error <= K4_RTOL; max_abs reported);
  6b. schedule — K1's live schedule choices at 1080p on both routes, each
               held to the default launch bit for bit: the refill rule
               and slot tiles (SCHEDULES), and corner rows padded to 32
               floats (one aligned 128-byte line per row);
  7. profile — torch.profiler over 8 cached spp at 1080p: each kernel's
               device time (a wrapper's kernels: their mean launch times
               the launches its own count made) and the device's idle
               share of that run's wall time (the profiler's own host
               cost included);
  8. cli     — `vpt-torch render procedural` (vpt_tpu_torch.app.cli.main)
               at 1920x1080, black environment, cached shadows, the
               light of phase 3, 16 spp, --save-exr, into a temporary
               directory: the PNG must decode to (1080, 1920, 3), the EXR
               must be finite and not black, and K1's in-kernel-ray route
               and K3 must each launch 16 times, K2 and K1's buffer route
               never;
  8b. default — `vpt-torch render procedural` as a user types it: no
               --env-type (the simple sky), 1920x1080, 16 spp, in both
               shadow modes: finite, not black, sky in the background
               corners, K4 launched once a sample;
  8c. hdri   — the script writes a 512x256 RGBE .hdr (the c3 golden's
               gradient and hot texel) and renders `vpt-torch render
               procedural that.hdr` at 1080p, 16 spp: K4 once a sample;
  8d. emission — K1's EXT variant (emission, color, volume_depth > 1) on
               the reference bench's config 2 (the 64^3 puff with
               emission 0.9 density, BLACK, emission_scale 2, cached and
               tracked) and config 3 (the puff with color, its HDRI map,
               aperture 0.25, tracked) at 512x512, each as the bench
               builds it (bfloat16 corner rows with the octant columns:
               K1's _bf16 instances), each beside the same render in
               float32 rows without octant columns (*_f32), config 2
               also in float32 rows with them (K1's _octant instances),
               the 200^3 grid with
               emission 0.9 density at 1080p (cached and tracked, 64 timed
               spp) and the main path's scene at volume_depth 2 (256x256,
               both modes, beside volume_depth 1 there, which is not
               counted), every scene with the ramp emission LUT
               (scene/assets.py::ramp_lut): ms/spp, iterations per ray,
               trunc_frac, each render's launches (the EXT variant and K3
               once a sample, K4 for config 3, the rows' instances),
               finite and not black;
               config 2 with the sun off and no light not black; K1
               against fused_direct_plain at 256x256 on each scene by
               phase 6's rule, the routes bit for bit; the EXT variant
               timed beside the plain loop on config 2 (in each of its
               three rows) and at 1080p;
  8e. instanced — K1's CELLS variant on the reference bench's config 5:
               1024 instances of the 24^3 puff (cloud_xforms, seed 7)
               with cell lists at R 64, CONSTANT, the bench's camera,
               built on the card (seconds per stage: splat, octant
               columns, cell lists; K; the cell rows' bytes) and
               shadow-baked (attach_shadow_cache at the default world
               resolution); K1 against fused_direct_plain at 256x256 in
               both modes by phase 6's rule (the bit-for-bit share and max
               |dL| printed), the routes bit for bit; 32 spp at 512x512
               and 1920x1080 in both modes: ms/spp, Mrays/s, iterations
               per ray, trunc_frac, launches (CELLS and K3 once a
               sample), finite and not black; the CELLS variant timed
               beside the plain loop at 512x512; and the c5 golden's
               scene (27 instances of the 12^3 blob), built by the port
               on the card, K1 against the plain loop there too, with its
               golden render's mean beside the golden's;
  8e2. instanced_loop — K1's CELLS instances with LOOP on loop8
               (tools/common.py::loop8_scene: 8 instances of two 64^3 grids
               with emission and color, no cell lists, BLACK,
               emission_scale 2), built and baked on the card (the world
               tau grid); K1 against fused_direct_plain at 256x256 in both
               modes by phase 6's rule with the bit-for-bit share, the
               routes bit for bit; 32 spp after 2 at 512x512 and 1080p in
               both modes: ms/spp, Mrays/s, iterations per ray,
               trunc_frac, launches (LOOP, EXT, CELLS x EXT and K3 once a
               sample), finite and not black; K1 timed beside the plain
               loop at 512x512;
  8e3. instanced_ext — K1's CELLS instances with EXT on config5_ext
               (config 5 with emission and color, cell lists over each
               whole box, CONSTANT), the same checks at 512x512;
  8e4. union — config5_union (1024 instances) and config5_4k (4096) as
               bench.py builds them (tools/common.py::union_scene: the
               union grid at 320, bfloat16 rows with octant columns, the
               sun baked), through K1's _bf16 instances: the resample's,
               corner pack's and bake's seconds and
               union_error_at_resolution beside each run; config5_union
               at 512x512 and 1080p in both modes, config5_4k at 512x512
               cached (the port's AUTO queue), with phase 8e2's checks;
  8f. atmosphere — the Bruneton atmosphere on the reference bench's
               config 4 (vpt_tpu_torch/tools/time_atmosphere.py::run, its
               parts printed as they end): the LUT precompute on the card
               at the half dims and at the full LutDims (seconds per
               stage), the sky bake; the 64^3 puff as the bench builds
               it (bfloat16 rows, octant columns; no cuts, on a line of
               their own) with the
               camera at (0, 0.5, 9) off its centre, ATMOSPHERE, the sun
               at 150/30, ray_depth 50, 512x512, tracked and cached, live
               and baked (256 x 512), 32 timed spp each, live tracked in
               float32 rows without octant columns beside, and the live
               atmosphere at 1080p, tracked, 16 spp: ms/spp, iterations
               per ray, trunc_frac, launches (K4's kind once a sample),
               finite and not black; K1's env_pos (its DEFER 2 variant)
               against fused_direct_plain's at 256x256 in both modes and
               with a sphere whose events move it, bit for bit, and K4 on
               its rays bit for bit; K4's packing of the LUTs (seconds
               and bytes, once per atmosphere); K4's ATMOSPHERE kind on
               K1's retired rays at 512x512 and 1080p, and at 1080p on
               the full LutDims, bit for bit with its plain version on
               every ray (its ground share, registers and blocks per SM
               printed), and SKY_CACHE at 512x512 and 1080p (max |diff|
               <= 2e-6), timed beside them; `vpt-torch render procedural
               --atmosphere` at 1080p, 16 spp, baked and live, the LUT
               cache in a temporary directory, and `vpt-torch earth` at
               512x512, K4 held to the plain version on its rays bit for
               bit;
  8g. bigvol — the reference bench's bigvol_512 (tools/common.py::
               bigvol_scene: the fBm grid in bfloat16 rows, cut from
               512^3 to 384^3 for the phase's time, the cut named on its
               line; still tau_downsample 2), the sun
               and one light baked with tau_downsample 2, the raw density
               dropped): the corner table's GiB, the fill's, build's and
               bake's seconds, the peak host RSS and device memory; 2 + 16
               spp at 512x512, cached: ms/spp, iterations per ray,
               trunc_frac, launches (K1's _bf16 instance and K3 once a
               sample), finite and not black; K1 against
               fused_direct_plain on the middle 64x64 of the frame's rays
               by phase 6's rule, and K1 alone on the frame, timed;
  8h. reference — kernel K5's walk_direct (csrc/walk.cu; vpt_tpu_torch/
               tools/time_walk.py): the main path's scene through
               ProgressiveRenderer with engine="reference" at 1920x1080,
               ray_depth 50, 2 warm-up + 8 timed spp: ms/spp, Mrays/s,
               steps per ray, walk_direct and K3 once a sample and K1
               never, finite and not black; K5 alone on one sample's
               rays (CUDA events), its bounces, walk steps and bound;
               those rays through walk_direct in the 1080p launch's tiles
               of 16384, the leading 2048 rays of the first tile and of
               the ragged last one held to direct_integrator_plain under
               their tile keys, bit for bit;
               `vpt-torch render procedural --engine reference` with the
               light of phase 3 at 1080p, 8 spp (the PNG decodes, the EXR
               finite and not black, walk_direct once a sample); K5
               against direct_integrator_plain at 256x256 on that scene
               and on config 2's puff with emission in float32 rows (its
               EXT instance) by phase 6's rule, the bit-for-bit share
               printed;
  8i. volumetric — K5's walk_volumetric: `vpt-torch render procedural
               --integrator volumetric` as a user types it (the simple
               sky, 1920x1080, --ray-depth 50, 8 spp): the PNG decodes,
               the EXR is finite and not black, walk_volumetric and K4
               once a sample; the same scene under the c3 map with
               hdri_importance (the CDF strategy) at 512x512; ms/spp,
               steps and bounces per ray; K5 against vol_integrator_plain
               at 256x256, ray_depth 8, on the sky, on the HDRI through
               the CDF, on the EXT puff and on the main scene with its
               point light (all three NEE kinds), by phase 6's rule
               and bit for bit; the main scene with its point light at
               512x512 (NEE's point-light kind); every stage kernel of
               the wavefront and the key table launched, each timed by
               CUDA events between K5's kernels, per K5 launch, with its
               walk steps, queue lengths by bounce and bound (the bytes
               the stage moves); the CLI's scene at 1080p, ray_depth 50,
               the leading 2048 rays of the first and the ragged last
               tile held to vol_integrator_plain, bit for bit; the key
               table against key_table_plain at 1080p, bit for bit;
  8j. walk_scenes — K5 on the bench's other scenes and skies
               (time_walk.scenes_phase): config 2 as the bench builds it
               (bfloat16 rows, octant columns, EXT) and in float32 rows
               with octant columns, config 4 under the Bruneton
               atmosphere at the full LutDims (live, baked, and live in
               float32 rows), config 5 (cell lists), config5_ext (cell
               lists x EXT) and loop8 (the static loop); each through
               both integrators at 512x512, ray_depth 50: ms/spp, K5
               alone by CUDA events with its bounces and walk steps a ray
               and each kernel's ms and bound, every new instance
               launched in the timed spp (each counted under its name,
               walk.VARIANTS), K5 against the plain integrator on the
               central 64x64 pixels' rays (the volumetric one at
               ray_depth 8) bit for bit; the volumetric integrator at
               1080p on config 5 and config 4 live; the phase's seconds;
  9. probes  — the probe entry points (vpt_tpu_torch/tools/probe_*.py)
               with their sweeps and the corner-table point, through
               P1-P3, each of which must launch, and P2 in each of its
               designs (shared-memory strips on both axes, the L2 route
               past them); then each probe kernel beside its plain
               version (max |diff| must be 0: integer-index copies and
               in-order adds) and its library call, in turns (library,
               kernel, kernel, library), at the tools' largest shapes:
               P1 at the corner table, and at widths 1, 10, 31 and 128 in
               both index modes with every out-of-range kind planted
               (equal, NaN where NaN); P2 at iters 1 and at iters 64 in
               every design, P3 at (8, 128) and (4096, 128); then the
               small-shape wrappers' host cost: device time (profiler)
               beside event time, and the wrapper's parts by the host
               clock.
Then the nvidia-smi line, the kernels' JSON line (K5's walk_direct and
walk_volumetric at 1080p with their parity cases and bounces per ray,
K5's key table and the wavefront's stage kernels; each of K5's
instances beyond float32 rows without octant columns under the run-time
sky that phase walk_scenes launched, with its launches there, its ms and
bound per K5 launch on the first configuration that ran it, and its
parity;
K1 on both routes, its
EXT variant at 1080p on the emissive grid with config 2 beside, its
_bf16 instances on config 2 as the bench builds it with bigvol beside,
its _octant instances on config 2 in float32 rows with octant columns,
its CELLS variant on config 5 at 512x512, tracked with cached beside, its
CELLS instances with LOOP on loop8 and with EXT on config5_ext, likewise;
K4's
ATMOSPHERE and SKY_CACHE kinds at 1080p on config 4, 512x512 beside; K2,
its own launches beside those of K1's in-kernel-ray route, which runs
its code, and its time at aperture 0.5; K3 at 1080p; K4 at 1080p for the
sky, with HDRI's numbers beside, its launches those of phases 8b and
8c; P1-P3 at the probes' shapes, P1 with its sector floor; each with its
design and its bound: the larger of the bytes it must move over 3.35
TB/s and its operations over 67 TFLOP/s, the H100 SXM's published
float32 rate, integer operations of K2 at half that rate, the INT32
pipe's), and the result line.
Any failure raises, and the script exits non-zero without a result.
Without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

SEED = 0
GRID_N = 200
LIGHT_POS = (0.0, 150.0, 150.0)
LIGHT_POWER = 20000.0
AZIMUTH, ELEVATION = 150.0, 30.0
W, H = 1920, 1080
WARMUP_SPP, TIMED_SPP, TRACKED_SPP, PROFILED_SPP = 2, 64, 64, 8
PARITY_SIZE, PARITY_SPP = 256, 2
MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
K2_TOL = 0.0       # K2 against primary_rays_plain on the card: exact
K4_RTOL = 1e-5     # K4 against environment_radiance on the card
OFFSETS = (1, 2, 3)  # K3 on views this many floats past 16 bytes
ENV_SPP = 16       # the default command's and the HDRI render's spp
HDR_H, HDR_W = 256, 512
C1_SIZES = ((512, 512), (W, H))
C1_SPP = 32
RAGGED = (37, 29)  # K3 at a pixel count that is no multiple of 4
CLI_SPP = 16
# Operations per ray step of K1, counted from the source: a threefry-2x32
# is 80 integer operations (20 rounds of add, rotate, xor, plus 6 key
# injections); K1 draws 5 uniforms and one step key per step, plus ~200
# float operations of fetch, flight and NEE.
K1_OPS_PER_STEP = 6 * 80 + 200
# K2's operations per pixel, counted from csrc/raygen.cuh, without and
# with the lens draws: each draw 75 integer operations (the threefry's
# 72, then xor, shift and or) and one float; the pixel's x and y and the
# jitter counters 5 integer; the film coordinates 6 float, the direction
# and its normalisation 25; the lens 19 float.  Integer operations run
# on the INT32 pipe at half the float32 rate, so they count twice.
K2_INT_OPS = {False: 2 * 75 + 5, True: 4 * 75 + 5}
K2_FLOAT_OPS = {False: 2 + 6 + 25, True: 4 + 6 + 25 + 19}
K2_APERTURE = 0.5  # the aperture of K2's lens-drawing checks
K1_ROW_BYTES = 15 * 4  # the columns every step loads (taus not counted)


def k1_row_bytes(atlas, emission):
    """The bytes of a visited row that K1's steps read, counted as
    K1_ROW_BYTES counts them: the 15 density columns, the 8 emission
    columns on an emissive scene (EXT), and where the rows carry the 72
    octant columns the 3 that an empty box's exit reads; each at the
    rows' element width, the taus not counted."""
    cols = 15 + 8 * bool(emission) + 3 * bool(atlas.octant_cols)
    return cols * atlas.density_corners.element_size()


EMIT_SIZE, EMIT_SPP, VD_SPP = 512, 32, 16   # configs 2 and 3; volume_depth 2
EMIT_CAMERA = (0.0, 1.0, 9.0)   # the bench's aim_camera offset
C3_APERTURE = 0.25
EMIT_OF_DENSITY = 0.9   # the 200^3 grid's emission, as the bench's blob
# config 5 of the reference bench: 1024 instances of the 24^3 puff
C5_INSTANCES, C5_BLOB_N, C5_SPP = 1024, 24, 32
C5_SIZES = ((512, 512), (W, H))
# the bench's bigvol_512 (tools/common.py::bigvol_scene) at BIGVOL_N^3,
# 512x512, cached; K1 against the plain loop on a BIGVOL_CROP^2 crop of
# its rays.  Cut to 384^3 (still tau_downsample 2): at 512^3 the host
# build alone took 219.6 s on the H100 machine, past the phase's 180 s
# (tools/time_spp.py --bigvol renders the 512^3 scene, PERF.md)
BIGVOL_N, BIGVOL_SPP, BIGVOL_CROP = 384, 16, 64
# K4's operations per ray, counted from csrc/environment.cu (each
# arithmetic operation, comparison and transcendental one): the sky's
# head (two sphere tests of 25, the phases) 76, each of its 16 view
# samples 297 (a sphere test toward the sun, 8 light samples of 27, the
# three channels' extinction 27), the tail 30; HDRI's uv, taps and
# bilinear blend 74.  Bytes: L read and written, beta and the direction
# read, 48 a ray, and the map once.
K4_SKY_OPS_PER_RAY, K4_HDRI_OPS_PER_RAY, K4_BYTES_PER_RAY = 4858, 74, 48
# P2's operations per step of the reference loop (tools/probe_dyngather.py
# :59-69): the gather, acc + r, int32(acc), two adds and the mod; the last
# step's reindex is dead, so a chain of n steps needs 6 n - 4.
P2_OPS_PER_STEP = 6
L2_ROWS = 16384    # P2 at iters 64 on axis 0 past the shared-memory strip
ROLL_ROWS = 4096   # P3's sweep point beside torch.roll
ROUTES = ("rays_in_memory", "rays_in_kernel")  # K1's two ray sources
# K1's refill rules timed in phase 6b: FusedParams overrides
SCHEDULES = {
    "any_idle": dict(refill_min=1, tile_w=0, tile_h=0),
    "half_idle": dict(refill_min=16, tile_w=0, tile_h=0),
    "24_idle": dict(refill_min=24, tile_w=0, tile_h=0),
    "whole_warp": dict(refill_min=32, tile_w=0, tile_h=0),
    "tile8x4_whole_warp": dict(refill_min=32, tile_w=8, tile_h=4),
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def k2_ops(lens):
    """K2's operations per pixel in float32-rate units (an integer
    operation counts twice: the INT32 pipe runs at half the rate)."""
    return K2_FLOAT_OPS[lens] + 2 * K2_INT_OPS[lens]


def lens_cameras(cam):
    """K2's three lens settings on camera ``cam`` (aperture 0): aperture
    0, where the lens draws are skipped; aperture K2_APERTURE, and a -0.0
    origin component, where they are taken (lens_draws_needed)."""
    import torch
    o = cam.origin.clone()
    o[0] = -0.0
    return {"aperture_0": (cam, False),
            f"aperture_{K2_APERTURE}": (dataclasses.replace(
                cam, lens_radius=torch.tensor(K2_APERTURE / 2.0,
                                              device=o.device)), True),
            "origin_minus_0": (dataclasses.replace(cam, origin=o), True)}


def max_abs(a, b):
    """Max |a - b| over two tuples of tensors."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def film_fields(film):
    from vpt_tpu_torch.render.film import _FIELDS
    return tuple(getattr(film, name) for name in _FIELDS)


def k1_agreement(pairs):
    """K1 against the plain fused_direct over (kernel, plain) output
    pairs: share of rays agreeing, relative difference of the image
    means, max |dL| and the number of rays."""
    agree = rays = 0
    sum_k = sum_p = worst = 0.0
    for out_k, out_p in pairs:
        Lk, Lp = out_k[0], out_p[0]
        ok = ((Lk - Lp).abs() <= 1e-6 + 1e-4 * Lp.abs()).all(-1)
        ok &= (out_k[1] - out_p[1]).abs() <= 1e-5
        ok &= (out_k[2] == out_p[2]) & (out_k[3] == out_p[3])
        agree += int(ok.sum())
        rays += ok.numel()
        sum_k += float(Lk.double().sum())
        sum_p += float(Lp.double().sum())
        worst = max(worst, float((Lk - Lp).abs().max()))
    return dict(share=agree / rays,
                mean_rel=abs(sum_k - sum_p) / max(abs(sum_p), 1e-12),
                max_abs=worst, rays=rays)


def same_bits(a, b):
    """True when two tuples of float32 tensors are equal bit for bit."""
    import torch
    return all(x.shape == y.shape and torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32))
               for x, y in zip(a, b))


def check_parity(where, k1, k2_err, k3_same, routes_same):
    for mode, st in k1.items():
        if st["share"] < MIN_SHARE or st["mean_rel"] > MAX_MEAN_REL:
            raise RuntimeError(f"{where}: K1 disagrees with the plain "
                               f"pipeline ({mode}): {st}")
    for mode, same in routes_same.items():
        if not same:
            raise RuntimeError(f"{where}: K1's in-kernel-ray route differs "
                               f"from its buffer route on K2's rays ({mode})")
    if not k2_err <= K2_TOL:
        raise RuntimeError(f"{where}: K2 disagrees with the plain version: "
                           f"{k2_err}")
    if not k3_same:
        raise RuntimeError(f"{where}: K3 differs from the plain version")


def check_lens(where, k2_lens, routes_lens):
    for name, st in k2_lens.items():
        if not (st["bit_equal"] and st["max_abs"] <= K2_TOL):
            raise RuntimeError(f"{where}: K2 ({name}) differs from "
                               f"primary_rays_plain: {st}")
    for mode, same in routes_lens.items():
        if not same:
            raise RuntimeError(f"{where}: K1's in-kernel-ray route differs "
                               f"from its buffer route at aperture "
                               f"{K2_APERTURE} ({mode})")


def k1_variant(route, defer, ext, cells=0, rows=""):
    """K1's variant name: the route, "_env" for the deferred environment
    (HDRI, the skies), "_envpos" for the live Bruneton atmosphere (env_pos
    too), "_ext" for emission, color or volume_depth > 1, "_cells" for an
    instanced scene with cell lists (``cells`` 1), "_loop" for one without
    them (2, the CELLS instances with LOOP); then the rows' instances:
    "_octant" for float32 rows with the octant columns, "_bf16" for
    bfloat16 rows (ROW_SUFFIX)."""
    return (route + ("", "_env", "_envpos")[int(defer)] + "_ext" * int(ext)
            + ("", "_cells", "_loop")[int(cells)] + rows)


# K1's instances of a single grid's rows: the name's suffix, the
# template's row type and OCT flag as mangled, and the ROWS_* that takes
# them (ops/cuda.py::row_kind)
ROW_SUFFIX = {"": ("f", "0", 0), "_octant": ("f", "1", 1),
              "_bf16": ("13__nv_bfloat16", "1", 2)}
# K1's variants: (deferred environment 0-2, EXT, CELLS 0-2 (none, cell
# lists, LOOP), rows) on either route; CELLS only on float32 rows without
# octant columns
K1_VARIANTS = [(d, e, c, r) for d in (0, 1, 2)
               for e, c, r in ((0, 0, ""), (1, 0, ""), (0, 1, ""),
                               (1, 1, ""), (0, 2, ""), (1, 2, ""),
                               (0, 0, "_octant"), (1, 0, "_octant"),
                               (0, 0, "_bf16"), (1, 0, "_bf16"))]
K1_NEW = ("_octant", "_bf16")   # the rows' instances: reported, not gated


def k1_registers(summary):
    """K1's ptxas lines by variant (its template arguments)."""
    out = {}
    rows = {(t, o): suf for suf, (t, o, _) in ROW_SUFFIX.items()}
    for n, v in summary.items():
        m = re.search(r"fused_direct_kernelILb([01])ELi([012])ELb([01])E"
                      r"Lb([01])E(f|13__nv_bfloat16)Lb([01])ELb([01])E", n)
        if m:
            cells = int(m.group(4)) * (1 + int(m.group(7)))
            out[k1_variant(ROUTES[int(m.group(1))], int(m.group(2)),
                           m.group(3) == "1", cells,
                           rows[m.group(5), m.group(6)])] = v
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", default=None,
                    help="directory for the 1080p display image (.npy)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    import numpy as np

    from vpt_tpu_torch.accel.shadow import attach_shadow_cache
    from vpt_tpu_torch.app import cli
    from vpt_tpu_torch.core import rng
    from vpt_tpu_torch.lights.lights import PointLights
    from vpt_tpu_torch.ops import cuda, probe
    from vpt_tpu_torch.render import film as film_mod
    from vpt_tpu_torch.render import fused, integrator, renderer, walk
    from vpt_tpu_torch.render.params import Environment, RenderParams
    from vpt_tpu_torch.scene.scene import attach_env_map, build_scene
    from vpt_tpu_torch.tools.common import (HBM_BYTES_PER_S, bound, c3_map,
                                            device_times, nan_equal,
                                            profiled_ms, time_ms)
    from vpt_tpu_torch.utils.hdr import load_hdr, write_hdr
    from vpt_tpu_torch.volume.procedural import create_procedural_grid

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")
    dev = torch.device("cuda", 0)

    def cuda_ms(fn, reps):
        """(mean device ms of fn() over reps back-to-back calls after a
        warm-up call, the last result), by CUDA events."""
        return time_ms(fn, dev, reps)

    def k4_inputs(scene_, p, tkey, o, d, frame_width=None, queue=1):
        """K1 alone on the buffer route: its launch and the (L, beta,
        direction) it hands K4."""
        launch = fused.prepare_fused(scene_, p)
        views = fused._launch_k1(launch, tkey, o, d, frame_width, queue)
        return launch, views[0], views[5], views[6]

    def k4_errors(scene_, p, launch, L, beta, dirn):
        """K4 on a copy of L against L + environment_radiance * beta,
        both on the card: max absolute and relative difference."""
        got = integrator.add_environment(scene_, p, L.clone(), beta, dirn,
                                         launch=launch.env)
        want = L + integrator.environment_radiance(scene_, p, dirn,
                                                   dirn) * beta
        diff = (got - want).abs()
        rel = diff / want.abs().clamp_min(1e-30)
        return dict(max_abs=float(diff.max()), max_rel=float(rel.max()),
                    finite=bool(torch.isfinite(got).all()))

    def check_k4(where, errs_):
        for name, e in errs_.items():
            if not (e["finite"] and e["max_rel"] <= K4_RTOL):
                raise RuntimeError(f"{where}: K4 ({name}) disagrees with "
                                   f"environment_radiance: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [fused.FUSED_DIRECT, fused.FUSED_DIRECT_PRIMARY, renderer.RAYGEN,
               film_mod.FILM_ACCUMULATE, integrator.ENVIRONMENT,
               fused.FUSED_DIRECT_EXT, fused.FUSED_DIRECT_CELLS,
               integrator.ENVIRONMENT_ATMOSPHERE,
               integrator.ENVIRONMENT_SKY_CACHE, fused.FUSED_DIRECT_BF16,
               fused.FUSED_DIRECT_OCTANT, fused.FUSED_DIRECT_LOOP,
               fused.FUSED_DIRECT_CELLS_EXT, walk.WALK_DIRECT,
               walk.WALK_VOLUMETRIC, walk.WALK_KEYS, *walk.STAGE_KERNELS]

    # ---- 1. device ---------------------------------------------------
    smi = smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    lib = cuda.load_library()
    t_nvcc = time.perf_counter() - t0
    regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
            if "registers" in ln]
    t0 = time.perf_counter()
    z = torch.zeros((4, 4), device=dev)
    film_mod.accumulate(film_mod.Film.zeros(4, 4, dev),
                        torch.zeros((4, 4, 3), device=dev), z, 0,
                        depth=z, cost=z, trunc=z)
    torch.cuda.synchronize()
    t_k3 = time.perf_counter() - t0
    k1_ptxas = k1_registers(cuda.ptxas_summary(lib.ptxas_log))
    k1_launch = {k1_variant(route, defer, ext, cells, rows):
                 fused.launch_info(route == "rays_in_kernel", 128, defer,
                                   bool(ext), bool(cells),
                                   ROW_SUFFIX[rows][2], loop=cells == 2)
                 for route in ROUTES for defer, ext, cells, rows in K1_VARIANTS}
    emit("build", nvcc_s=t_nvcc, nvcc_source_s=lib.nvcc_seconds,
         k3_first_launch_s=t_k3, library=lib.path, ptxas=regs,
         k1_ptxas=k1_ptxas, k1_launch=k1_launch)
    # the density-only variants as before: 5 blocks per SM, no spills
    # (ptxas reports only when this run built the library); EXT's,
    # CELLS's, env_pos's and the rows' new instances are reported
    for name, info in k1_launch.items():
        v = k1_ptxas.get(name, {})
        if not name.endswith(("_ext", "_cells", "_loop") + K1_NEW) \
                and "_envpos" not in name and (
                info["blocks_per_sm"] != 5
                                   or v.get("spill_stores")
                                   or v.get("spill_loads")):
            raise RuntimeError(f"K1 {name}: {v}, {info}")

    # ---- 2b. K4's division by HR and HM, over every float32 -------------
    from vpt_tpu_torch.sky.procedural import sky_constants
    consts = sky_constants()
    divide = {}
    for d_name in ("hr", "hm"):
        t0 = time.perf_counter()
        bad, first = integrator.div_known_sweep(
            consts[d_name], consts[d_name + "_inv"], 0, 2 ** 32, dev)
        divide[d_name] = dict(d=consts[d_name], y=consts[d_name + "_inv"],
                              mismatches=bad, first_mismatch=first,
                              seconds=time.perf_counter() - t0)
    emit("divide", patterns=2 ** 32,
         covers="every float32 x: |x| >= 2^-100 and +-Inf by the "
                "three-operation path, zero, smaller |x| and NaN by IEEE "
                "division; a mismatch is a bit difference where not both "
                "are NaN", divisors=divide)
    for d_name, v in divide.items():
        if v["mismatches"] != 0:
            raise RuntimeError(f"div_known2 differs from IEEE division by "
                               f"{d_name}: {v}")

    # ---- 3. scene ----------------------------------------------------
    stage = {}
    t0 = time.perf_counter()
    half = GRID_N / 2
    grid = create_procedural_grid(vmin=(-half,) * 3, vmax=(half,) * 3,
                                  device=dev)
    stage["procedural_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lights = PointLights.make([LIGHT_POS], [[1.0, 1.0, 1.0]], [LIGHT_POWER],
                              device=dev)
    scene = build_scene([grid], lights=lights, device=dev)
    torch.cuda.synchronize()
    stage["build_scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = attach_shadow_cache(scene, AZIMUTH, ELEVATION)
    torch.cuda.synchronize()
    stage["shadow_bake_s"] = time.perf_counter() - t0
    corners = scene.atlas.density_corners

    def framed(w, h):
        return dataclasses.replace(
            scene, camera=cli.default_framing(scene, w, h))

    emit("scene", grid=[int(v) for v in grid.dim], voxels=int(corners.shape[0]),
         corner_table=list(corners.shape),
         corner_bytes=int(corners.numel() * corners.element_size()),
         light_pos=LIGHT_POS, light_power=LIGHT_POWER, azimuth=AZIMUTH,
         elevation=ELEVATION, max_density=float(scene.max_extinction),
         **stage)

    def params(w, h, mode):
        return RenderParams(width=w, height=h, seed=SEED, ray_depth=50,
                            max_fused_steps=128, shadow_mode=mode,
                            azimuth=AZIMUTH, elevation=ELEVATION,
                            environment_type=int(Environment.BLACK))

    # ---- 4. kernel vs plain at 256^2: a quick early gate ---------------
    s256 = framed(PARITY_SIZE, PARITY_SIZE)
    k2_err, k3_same = 0.0, True
    pairs = {"cached": [], "tracked": []}
    gen_pairs = {"cached": [], "tracked": []}
    routes_same = {"cached": True, "tracked": True}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for it in range(PARITY_SPP):
        p = params(PARITY_SIZE, PARITY_SIZE, "cached")
        key = rng.render_key(SEED, it)
        rays = renderer._primary_rays_cuda(s256.camera, p, key)
        rays_p = renderer.primary_rays_plain(s256.camera, p, key)
        k2_err = max(k2_err, max_abs(rays, rays_p))
        tkey = renderer.tile_key(key)
        for mode in pairs:
            pm = params(PARITY_SIZE, PARITY_SIZE, mode)
            out_b = fused._fused_direct_cuda(s256, pm, tkey, *rays)
            out_g = renderer._trace_primary_cuda(s256, pm, key)
            routes_same[mode] &= same_bits(out_g, out_b)
            pairs[mode].append(
                (out_b, fused.fused_direct_plain(s256, pm, tkey, *rays)))
            gen_pairs[mode].append(
                (out_g, fused.fused_direct_plain(s256, pm, tkey, *rays_p)))
        # K3 on a random film state, with non-finite pixels injected, at
        # the parity size and at one whose pixel count is no multiple of 4
        for hw in ((PARITY_SIZE, PARITY_SIZE), RAGGED):
            f0 = film_mod.Film(*(torch.rand(s, generator=gen, device=dev)
                                 for s in (hw + (3,), hw, hw, hw, hw)))
            val = torch.rand(hw + (3,), generator=gen, device=dev) * 4.0
            val[::17, ::13, 1] = float("nan")
            val[::19, ::11, 2] = float("inf")
            a = torch.rand(hw, generator=gen, device=dev)
            a[::23, ::7] = float("nan")
            aux = [torch.rand(hw, generator=gen, device=dev)
                   for _ in range(3)]
            k3_same &= same_bits(
                film_fields(film_mod._accumulate_cuda(f0, val, a, it + 3,
                                                      *aux)),
                film_fields(film_mod.accumulate_plain(f0, val, a, it + 3,
                                                      *aux)))
    # the renderer itself at the ragged size, both shadow modes: K1's
    # outputs (views into one buffer) go to K3 as they are, and each
    # step's film must be accumulate_plain's on the same sample
    rag_same = {}
    for mode in ("cached", "tracked"):
        pr = params(RAGGED[1], RAGGED[0], mode)
        rr = renderer.ProgressiveRenderer(framed(RAGGED[1], RAGGED[0]), pr)
        rag_same[mode] = True
        for it in range(PARITY_SPP):
            prev = rr.film
            val, a, aux = renderer.render_rays(
                rr.scene, pr, rng.render_key(SEED, it), rr.launches)
            want = film_mod.accumulate_plain(prev, val, a, it,
                                             aux["depth"], aux["cost"],
                                             aux["trunc"])
            rag_same[mode] &= same_bits(film_fields(rr.step()),
                                        film_fields(want))
    k3_same &= all(rag_same.values())
    # K3 on views that start 1-3 floats past a 16-byte boundary: its
    # scalar route, at the parity size and at the ragged one
    def offset_view(t, k):
        flat = torch.empty(t.numel() + k, device=dev)
        view = flat[k:].view(t.shape)
        view.copy_(t)
        return view
    k3_offsets = {}
    for hw in ((PARITY_SIZE, PARITY_SIZE), RAGGED):
        f0 = film_mod.Film(*(torch.rand(s_, generator=gen, device=dev)
                             for s_ in (hw + (3,), hw, hw, hw, hw)))
        val = torch.rand(hw + (3,), generator=gen, device=dev) * 4.0
        val[::17, ::13, 1] = float("nan")
        a = torch.rand(hw, generator=gen, device=dev)
        aux = [torch.rand(hw, generator=gen, device=dev) for _ in range(3)]
        for k in OFFSETS:
            fk = film_mod.Film(*(offset_view(t, k) for t in film_fields(f0)))
            k3_args = (fk, offset_view(val, k), offset_view(a, k), 5,
                       *(offset_view(t, k) for t in aux))
            if film_mod.accumulate_design(
                    t.data_ptr() for t in film_fields(fk)) != "scalar":
                raise RuntimeError("K3: an offset view took the float4 route")
            k3_offsets[f"{hw[0]}x{hw[1]}+{k}"] = same_bits(
                film_fields(film_mod._accumulate_cuda(*k3_args)),
                film_fields(film_mod.accumulate_plain(*k3_args)))
    k3_same &= all(k3_offsets.values())
    # K2 in its three lens settings, bit for bit, and K1's in-kernel-ray
    # route against its buffer route where the lens draws are taken
    key = rng.render_key(SEED, 0)
    k2_lens, routes_lens = {}, {}
    for name, (cam, need) in lens_cameras(s256.camera).items():
        p = params(PARITY_SIZE, PARITY_SIZE, "cached")
        got = renderer._primary_rays_cuda(cam, p, key)
        want = renderer.primary_rays_plain(cam, p, key)
        k2_lens[name] = dict(lens_draws=renderer.lens_draws_needed(cam),
                             max_abs=max_abs(got, want),
                             bit_equal=same_bits(got, want))
        if k2_lens[name]["lens_draws"] != need:
            raise RuntimeError(f"lens_draws_needed is wrong for {name}")
    s_lens = dataclasses.replace(
        s256, camera=lens_cameras(s256.camera)[f"aperture_{K2_APERTURE}"][0])
    for mode in ("cached", "tracked"):
        pm = params(PARITY_SIZE, PARITY_SIZE, mode)
        routes_lens[mode] = same_bits(
            renderer._trace_primary_cuda(s_lens, pm, key),
            renderer._trace_buffers_cuda(s_lens, pm, key))
    # K4 on K1's (L, beta, direction) of a sky and an HDRI sample, and K1
    # + K4 against the plain pipeline with each environment
    hdr_map = c3_map(HDR_H, HDR_W)
    env_types = {"sky": Environment.ATMOSPHERE, "hdri": Environment.HDRI}
    env256 = {"sky": s256, "hdri": attach_env_map(s256, hdr_map)}
    key = rng.render_key(SEED, 0)
    tkey = renderer.tile_key(key)
    rays = renderer._primary_rays_cuda(s256.camera, params(
        PARITY_SIZE, PARITY_SIZE, "cached"), key)
    k4_256, k1_env = {}, {}
    for env, se in env256.items():
        for mode in ("cached", "tracked"):
            pe = params(PARITY_SIZE, PARITY_SIZE, mode).replace(
                environment_type=int(env_types[env]))
            k4_256[f"{env}_{mode}"] = k4_errors(
                se, pe, *k4_inputs(se, pe, tkey, *rays))
            k1_env[f"{env}_{mode}"] = k1_agreement([(
                fused._fused_direct_cuda(se, pe, tkey, *rays),
                fused.fused_direct_plain(se, pe, tkey, *rays))])
    k1_256 = {m: k1_agreement(pr) for m, pr in pairs.items()}
    k1_256.update({f"{m}_{ROUTES[1]}": k1_agreement(pr)
                   for m, pr in gen_pairs.items()})
    del pairs, gen_pairs
    emit("parity", size=PARITY_SIZE, spp=PARITY_SPP, k1=k1_256,
         k1_routes_bit_equal=routes_same, k2_max_abs=k2_err,
         k3_bit_equal=k3_same, k3_ragged=RAGGED,
         k3_renderer_ragged_bit_equal=rag_same,
         k3_offset_views_bit_equal=k3_offsets, k4=k4_256, k4_rtol=K4_RTOL,
         k1_k4_env=k1_env, k2_lens=k2_lens,
         k1_routes_bit_equal_lens=routes_lens)
    check_parity("256^2", k1_256, k2_err, k3_same, routes_same)
    check_lens("256^2", k2_lens, routes_lens)
    check_parity("256^2 environments", k1_env, 0.0, True, {})
    check_k4("256^2", k4_256)

    # ---- 5. the main path at 1080p -------------------------------------
    s1080 = framed(W, H)
    pc, pt = params(W, H, "cached"), params(W, H, "tracked")
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = renderer.ProgressiveRenderer(s1080, pc)
    r.step(WARMUP_SPP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.step(TIMED_SPP)
    torch.cuda.synchronize()
    t_cached = time.perf_counter() - t0
    by_mode = {"cached": {k.name: k.launches for k in kernels}}
    for k in kernels:
        k.launches = 0
    rt = renderer.ProgressiveRenderer(s1080, pt)
    t0 = time.perf_counter()
    rt.step(TRACKED_SPP)
    torch.cuda.synchronize()
    t_tracked = time.perf_counter() - t0
    by_mode["tracked"] = {k.name: k.launches for k in kernels}
    launches = {k.name: sum(m[k.name] for m in by_mode.values())
                for k in kernels}
    peak = torch.cuda.max_memory_allocated()

    def summary(film, spp, seconds, timed_spp):
        n = W * H * spp
        return dict(ms_per_spp=seconds * 1e3 / timed_spp,
                    mrays_per_s=W * H * timed_spp / seconds / 1e6,
                    mean_iters_per_ray=float(film.cost.double().sum()) / n,
                    trunc_frac=float(film.trunc.double().sum()) / n,
                    image_mean=float(film.accum.double().mean()),
                    finite=bool(torch.isfinite(film.accum).all()))
    cached_sum = summary(r.film, WARMUP_SPP + TIMED_SPP, t_cached, TIMED_SPP)
    tracked_sum = summary(rt.film, TRACKED_SPP, t_tracked, TRACKED_SPP)
    emit("main", width=W, height=H, cached=cached_sum, tracked=tracked_sum,
         launches=launches, launches_by_mode=by_mode,
         rays_in_kernel=renderer.RAYS_IN_KERNEL, peak_mem_bytes=int(peak))
    # K1 on the ray source of its shadow mode, and nothing else
    for mode, got in by_mode.items():
        on = {film_mod.FILM_ACCUMULATE.name}
        on |= ({fused.FUSED_DIRECT_PRIMARY.name}
               if renderer.RAYS_IN_KERNEL[mode] else
               {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
        for name, n in got.items():
            if (n > 0) != (name in on):
                raise RuntimeError(f"the main path ({mode}) launched {name} "
                                   f"{n} times; expected "
                                   f"{'some' if name in on else 'none'}")
    for name, sm in (("cached", cached_sum), ("tracked", tracked_sum)):
        if not sm["finite"] or not sm["image_mean"] > 0.0:
            raise RuntimeError(f"1080p {name} image is not finite or black")
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        np.save(os.path.join(args.save, "chip_smoke_1080p_cached.npy"),
                r.display_image())
        np.save(os.path.join(args.save, "chip_smoke_1080p_tracked.npy"),
                rt.display_image())

    # ---- 5b. C1: the step budget at queued sizes, tracked shadows -------
    c1 = {}
    for w, h in C1_SIZES:
        sc = s1080 if (w, h) == (W, H) else framed(w, h)
        for rule, rpl in (("new", 0), ("parent", 1)):
            pr = params(w, h, "tracked").replace(rays_per_lane=rpl)
            rr = renderer.ProgressiveRenderer(sc, pr)
            rr.step(1)
            rr.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rr.step(C1_SPP)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = w * h * C1_SPP
            c1[f"{w}x{h}_{rule}"] = dict(
                queue=renderer.frame_queue(pr),
                ms_per_spp=dt * 1e3 / C1_SPP,
                mean_iters_per_ray=float(rr.film.cost.double().sum()) / n,
                trunc_frac=float(rr.film.trunc.double().sum()) / n,
                image_mean=float(rr.film.accum.double().mean()))
            del rr
    # one 1080p tracked sample on both rules from the same key: a ray the
    # parent's rule (Q = 1, 128 steps) did not cut is the same bits
    ckey = rng.render_key(SEED, 1000)
    new = renderer._trace_buffers_cuda(s1080, pt, ckey, rt.launches)
    old = renderer._trace_buffers_cuda(
        s1080, pt.replace(rays_per_lane=1), ckey, rt.launches)
    kept = old[3] == 0.0
    c1_same = all(torch.equal(a[kept].view(torch.int32),
                              b[kept].view(torch.int32))
                  for a, b in zip(new, old))
    emit("c1", spp=C1_SPP, rules=c1, sample_rays=W * H,
         sample_cut_parent=int((old[3] == 1.0).sum()),
         sample_cut_new=int((new[3] == 1.0).sum()),
         sample_uncut_bit_equal=c1_same)
    if not c1_same:
        raise RuntimeError("C1: a ray the parent's rule did not cut changed")
    if renderer.frame_queue(pt) != 16:
        raise RuntimeError("C1: 1080p does not resolve to Q = 16")
    del new, old, kept

    # ---- 6. each kernel beside its plain version at 1080p --------------
    # kernels from prepared launches, so the events time the kernel; the
    # outputs of the timed calls are held against each other
    key = rng.render_key(SEED, r.iteration)
    tkey = renderer.tile_key(key)
    lc, lt = r.launches, rt.launches
    # K2's events over back-to-back calls time its wrapper's host work:
    # its ms is the profiler's device time
    k2_event, (o, d) = cuda_ms(lambda: renderer._primary_rays_cuda(
        s1080.camera, pc, key, lc.raygen), 20)
    tp, rays_p = cuda_ms(lambda: renderer.primary_rays_plain(
        s1080.camera, pc, key), 5)
    timing = {"primary_rays": (profiled_ms(lambda: renderer._primary_rays_cuda(
        s1080.camera, pc, key, lc.raygen), 20), tp)}
    k2_1080 = max_abs((o, d), rays_p)
    # K2 in its three lens settings at 1080p, each timed and held to the
    # plain version bit for bit; K1's two routes at aperture 0.5
    k2_lens_1080, routes_lens_1080 = {}, {}
    for name, (cam, need) in lens_cameras(s1080.camera).items():
        lr = renderer.prepare_raygen(cam, pc)
        t_lens, got = cuda_ms(lambda: renderer._primary_rays_cuda(
            cam, pc, key, lr), 20)
        want = renderer.primary_rays_plain(cam, pc, key)
        k2_lens_1080[name] = dict(
            lens_draws=bool(lr.lens_draws), event_ms=t_lens,
            ms=profiled_ms(lambda: renderer._primary_rays_cuda(
                cam, pc, key, lr), 20),
            bound=bound(W * H * 24, W * H * k2_ops(need)),
            max_abs=max_abs(got, want), bit_equal=same_bits(got, want))
        if k2_lens_1080[name]["lens_draws"] != need:
            raise RuntimeError(f"1080p: K2 took the wrong variant ({name})")
        del got, want
    s_lens = dataclasses.replace(
        s1080, camera=lens_cameras(s1080.camera)[f"aperture_{K2_APERTURE}"][0])
    for mode, p in (("cached", pc), ("tracked", pt)):
        routes_lens_1080[mode] = same_bits(
            renderer._trace_primary_cuda(s_lens, p, key),
            renderer._trace_buffers_cuda(s_lens, p, key))
    del s_lens
    k1_1080, warp_eff, routes_same = {}, {}, {}
    q1080 = renderer.frame_queue(pc)   # 16: the frame's step budget
    for mode, p, lts, reps in (("cached", pc, lc, 5),
                               ("tracked", pt, lt, 3)):
        tk, out_k = cuda_ms(lambda: fused._fused_direct_cuda(
            s1080, p, tkey, o, d, lts.fused, W, q1080), reps)
        tg, out_g = cuda_ms(lambda: renderer._trace_primary_cuda(
            s1080, p, key, lts), reps)
        tp, out_p = cuda_ms(lambda: fused.fused_direct_plain(
            s1080, p, tkey, o, d, q1080), 1)
        sfx = "" if mode == "cached" else "_tracked"
        timing["fused_direct" + sfx] = (tk, tp)
        # the plain pipeline: primary_rays_plain, then fused_direct_plain
        timing["fused_direct_primary" + sfx] = (
            tg, timing["primary_rays"][1] + tp)
        k1_1080[mode] = k1_agreement([(out_k, out_p)])
        routes_same[mode] = same_bits(out_g, out_k)
        out_pp = fused.fused_direct_plain(s1080, p, tkey, *rays_p, q1080)
        k1_1080[f"{mode}_{ROUTES[1]}"] = k1_agreement([(out_g, out_pp)])
        del out_g, out_pp
        # the launch-order schedule's lane use, from this spp's cost AOV
        warp_eff[mode] = {g: fused.warp_efficiency(out_k[2], g)
                          for g in (32, 128)}
        if mode == "cached":
            sample = out_k
        del out_k, out_p
    # K3 on the rendered 1080p film with the next sample the path made
    f = r.film
    L, alpha, cost, unfinished, depth = sample
    val, aux = L.reshape(H, W, 3), [x.reshape(H, W)
                                    for x in (depth, cost, unfinished)]
    alpha = alpha.reshape(H, W)
    # K3's events over back-to-back calls time its wrapper's host work
    # where that outlasts the kernel: its ms is the profiler's device time
    def k3():
        return film_mod._accumulate_cuda(f, val, alpha, r.iteration, *aux)
    k3_event, fk = cuda_ms(k3, 50)
    tp, fp = cuda_ms(lambda: film_mod.accumulate_plain(
        f, val, alpha, r.iteration, *aux), 50)
    timing["film_accumulate"] = (profiled_ms(k3, 50), tp)
    k3_1080 = max_abs(film_fields(fk), film_fields(fp))
    k3_same = same_bits(film_fields(fk), film_fields(fp))
    emit("timing", shapes=f"{W}x{H}",
         ms={k: {"kernel": v[0], "plain": v[1]} for k, v in timing.items()},
         k1=k1_1080, k1_routes_bit_equal=routes_same, k2_max_abs=k2_1080,
         k2_event_ms=k2_event,
         k3_max_abs=k3_1080, k3_bit_equal=k3_same, k3_event_ms=k3_event,
         k1_launch_order_warp_efficiency=warp_eff,
         k1_launch=k1_launch, k1_ptxas=k1_ptxas,
         k1_grid_blocks={r_: v["sms"] * v["blocks_per_sm"]
                         for r_, v in k1_launch.items()},
         k1_schedule=fused.SCHEDULE, k2_lens=k2_lens_1080,
         k1_routes_bit_equal_lens=routes_lens_1080)
    check_parity("1080p", k1_1080, k2_1080, k3_same, routes_same)
    check_lens("1080p", k2_lens_1080, routes_lens_1080)

    # ---- 6a. K4 at 1080p on the path's (L, beta, direction) ---------------
    k4_1080 = {}
    for env in ("sky", "hdri"):
        se = s1080 if env == "sky" else attach_env_map(s1080, hdr_map)
        pe = pt.replace(environment_type=int(env_types[env]))
        launch, L, beta, dirn = k4_inputs(se, pe, tkey, o, d, W,
                                          renderer.frame_queue(pe))
        e = k4_errors(se, pe, launch, L, beta, dirn)
        Lw = L.clone()

        def k4():
            return integrator.add_environment(se, pe, Lw, beta, dirn,
                                              launch=launch.env)
        t_event, _ = cuda_ms(k4, 20)
        tp, _ = cuda_ms(lambda: L + integrator.environment_radiance(
            se, pe, dirn, dirn) * beta, 2)
        ops = W * H * (K4_SKY_OPS_PER_RAY if env == "sky"
                       else K4_HDRI_OPS_PER_RAY)
        nbytes = W * H * K4_BYTES_PER_RAY + (hdr_map.nbytes if env == "hdri"
                                             else 0)
        k4_1080[env] = dict(ms=profiled_ms(k4, 20), event_ms=t_event,
                            plain_ms=tp, bound=bound(nbytes, ops),
                            beta_zero_rays=int((beta == 0).all(1).sum()), **e)
        del launch, L, beta, dirn, Lw
    emit("env", shapes=f"{W}x{H}", k4=k4_1080, k4_rtol=K4_RTOL,
         ops_per_ray={"sky": K4_SKY_OPS_PER_RAY,
                      "hdri": K4_HDRI_OPS_PER_RAY},
         hdr_map=[HDR_H, HDR_W, 3])
    check_k4("1080p", k4_1080)

    # ---- 6b. K1's live schedule choices at 1080p on both routes ---------
    def with_params(launch, **kw):
        q = type(launch.params).from_buffer_copy(launch.params)
        for name, v in kw.items():
            setattr(q, name, v)
        return dataclasses.replace(launch, params=q)
    schedule = {}
    for mode, p, lts, reps in (("cached", pc, lc, 5),
                               ("tracked", pt, lt, 3)):
        ref = fused._fused_direct_cuda(s1080, p, tkey, o, d, lts.fused,
                                       queue=q1080)
        schedule[mode] = {}
        for name, kw in SCHEDULES.items():
            fl = with_params(lts.fused, **kw)
            lv = dataclasses.replace(lts, fused=fl)
            tm, out_m = cuda_ms(lambda: fused._fused_direct_cuda(
                s1080, p, tkey, o, d, fl, W, q1080), reps)
            tg, out_g = cuda_ms(lambda: renderer._trace_primary_cuda(
                s1080, p, key, lv), reps)
            if not (same_bits(out_m, ref) and same_bits(out_g, ref)):
                raise RuntimeError(f"K1 with refill {name} ({mode}) differs "
                                   f"from the default")
            schedule[mode][name] = {ROUTES[0]: tm, ROUTES[1]: tg}
        padded = torch.nn.functional.pad(corners, (0, 1)).contiguous()
        fl = dataclasses.replace(with_params(lts.fused, row_w=32),
                                 corners=padded)
        tm, out_m = cuda_ms(lambda: fused._fused_direct_cuda(
            s1080, p, tkey, o, d, fl, W, q1080), reps)
        if not same_bits(out_m, ref):
            raise RuntimeError(f"K1 on padded rows ({mode}) differs")
        schedule[mode]["rows_padded_to_32"] = {ROUTES[0]: tm}
        del ref, out_m, out_g, padded
    emit("schedule", ms=schedule, default=fused.SCHEDULE)

    # ---- 7. profile: device time and idle share over 8 cached spp ------
    from torch.profiler import ProfilerActivity, profile
    # the wrappers' kernels by the device functions' names
    wrapped = {"fused_direct_kernel": (fused.FUSED_DIRECT,
                                       fused.FUSED_DIRECT_PRIMARY),
               "primary_rays_kernel": (renderer.RAYGEN,),
               "film_accumulate_": (film_mod.FILM_ACCUMULATE,),
               "environment_kernel": (integrator.ENVIRONMENT,)}
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(PROFILED_SPP)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    made = {f: sum(k.launches for k in ks) for f, ks in wrapped.items()}
    # a wrapper's kernels: their mean launch (the profiler may miss one
    # at the edge of its window) times the launches its count made; a
    # kernel of no wrapper (K1's counter memset): the launches seen
    groups = {}
    for name, (ms, n) in device_times(prof).items():
        g = next((f for f in wrapped if f in name), name)
        g_ms, g_n = groups.get(g, (0.0, 0))
        groups[g] = (g_ms + ms, g_n + n)
    dev_ms = {g: (ms / n * made[g] if g in made else ms) / PROFILED_SPP
              for g, (ms, n) in groups.items()}
    busy = sum(dev_ms.values())
    emit("profile", spp=PROFILED_SPP, wall_ms_per_spp=wall_ms / PROFILED_SPP,
         device_ms_per_spp=dev_ms,
         launches_seen={g: n for g, (_, n) in groups.items()},
         launches_made={g: made[g] for g in groups if g in made},
         device_busy_ms_per_spp=busy if dev_ms else None,
         idle_share=1.0 - busy * PROFILED_SPP / wall_ms if dev_ms else None)

    # the bounds of K1-K3 at 1080p, from this run's data
    n_rays = W * H
    steps = float(sample[2].double().sum())  # K1 walk steps, cached
    rows = min(steps, corners.shape[0])
    bounds = {
        # rays in (origin, direction), L/alpha/cost/unfinished/depth out,
        # and at most one 15-column row per step, each row once
        "fused_direct": bound(n_rays * (24 + 28) + rows * K1_ROW_BYTES,
                              steps * K1_OPS_PER_STEP),
        # the same with the rays made in the lanes: no ray bytes in,
        # K2's operations added
        "fused_direct_primary": bound(
            n_rays * 28 + rows * K1_ROW_BYTES,
            steps * K1_OPS_PER_STEP + n_rays * k2_ops(False)),
        "primary_rays": bound(n_rays * 24, n_rays * k2_ops(False)),
        # 7 film fields and value/alpha/depth/cost/trunc in, 7 fields out
        "film_accumulate": bound(n_rays * (7 + 7 + 7) * 4, n_rays * 20)}

    # ---- 8. the `render` entry point at 1080p ---------------------------
    from vpt_tpu_torch.utils.exr import read_exr_rgb
    from vpt_tpu_torch.utils.io import read_png
    for k in kernels:
        k.launches = 0
    cli_stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli.main(["render", "procedural", "-o", os.path.join(tmp, "cli.png"),
                  "--spp", str(CLI_SPP), "--width", str(W),
                  "--height", str(H), "--env-type", "black",
                  "--shadow-mode", "cached", "--save-exr", "--light",
                  *(str(v) for v in LIGHT_POS), "1", "1", "1",
                  str(LIGHT_POWER)], stats=cli_stats)
        t_cli = time.perf_counter() - t0
        img = read_png(os.path.join(tmp, "cli.png"))
        rad = read_exr_rgb(os.path.join(tmp, "cli.exr"))
    cli_launches = {k.name: k.launches for k in kernels}
    emit("cli", png_shape=list(img.shape),
         png_mean=float(img.mean()), exr_mean=float(rad.mean()),
         exr_finite=bool(np.isfinite(rad).all()), launches=cli_launches,
         wall_s=t_cli, **cli_stats)
    if img.shape != (H, W, 3) or not img.max() > 0:
        raise RuntimeError(f"cli: PNG {img.shape} max {img.max()}")
    if not np.isfinite(rad).all() or not rad.mean() > 0.0:
        raise RuntimeError("cli: the EXR is not finite or black")
    want = {k.name: 0 for k in kernels}
    want.update({fused.FUSED_DIRECT_PRIMARY.name: CLI_SPP,
                 film_mod.FILM_ACCUMULATE.name: CLI_SPP})
    if cli_launches != want:
        raise RuntimeError(f"cli: launches {cli_launches}, expected {want}")
    del img, rad

    # ---- 8b/8c. the default command (the simple sky) and an .hdr map ------
    env_runs, k4_path_launches = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        hdr_path = os.path.join(tmp, "c3_sky.hdr")
        write_hdr(hdr_path, hdr_map)
        hdr_read = load_hdr(hdr_path)
        # RGBE keeps 8 mantissa bits of the largest component
        if not np.allclose(hdr_read, hdr_map, rtol=0, atol=40.0 / 128):
            raise RuntimeError("the written .hdr does not read back")
        for name, extra, mode in (
                ("default_tracked", [], "tracked"),
                ("default_cached", ["--shadow-mode", "cached"], "cached"),
                ("hdri_tracked", [hdr_path], "tracked")):
            for k in kernels:
                k.launches = 0
            st = {}
            out = os.path.join(tmp, f"{name}.png")
            t0 = time.perf_counter()
            cli.main(["render", "procedural", *extra, "-o", out, "--spp",
                      str(ENV_SPP), "--width", str(W), "--height", str(H),
                      "--save-exr"], stats=st)
            wall = time.perf_counter() - t0
            got = {k.name: k.launches for k in kernels}
            rad = read_exr_rgb(out[:-4] + ".exr")
            corners = rad[[0, 0, -1, -1], [0, -1, 0, -1]]
            env_runs[name] = dict(
                launches=got, wall_s=wall,
                ms_per_spp=st["render_s"] * 1e3 / max(st["spp"], 1),
                exr_mean=float(rad.mean()),
                exr_finite=bool(np.isfinite(rad).all()),
                corners=corners.tolist(), **st)
            k4_path_launches += got[integrator.ENVIRONMENT.name]
            want = {k.name: 0 for k in kernels}
            route = ({fused.FUSED_DIRECT_PRIMARY.name} if
                     renderer.RAYS_IN_KERNEL[mode] else
                     {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
            want.update({n_: ENV_SPP for n_ in route | {
                film_mod.FILM_ACCUMULATE.name, integrator.ENVIRONMENT.name}})
            if got != want:
                raise RuntimeError(f"{name}: launches {got}, expected {want}")
            if not (np.isfinite(rad).all() and rad.mean() > 0.0
                    and (corners > 0.0).all()):
                raise RuntimeError(f"{name}: the image is not finite, black "
                                   f"or without sky in its corners")
            if name.startswith("default") and not (
                    corners[:, 2] > corners[:, 0]).all():
                raise RuntimeError(f"{name}: the corners are not sky blue")
            del rad
    emit("environments", spp=ENV_SPP, width=W, height=H, runs=env_runs,
         hdr_map=[HDR_H, HDR_W, 3])
    launches[integrator.ENVIRONMENT.name] = k4_path_launches

    # ---- 8d. emission, color and volume_depth 2 (K1's EXT variant) -------
    from vpt_tpu_torch.core.camera import Camera
    from vpt_tpu_torch.scene.assets import ramp_lut
    from vpt_tpu_torch.tools.common import (BENCH_ROWS, bench_blob,
                                            bench_env_map)
    lut = ramp_lut()

    def aimed(s_, aperture=0.0):
        """The bench's aim_camera: 9 in front of the root box's centre and
        1 above it, vfov 40, square."""
        c = (s_.root_pmin + s_.root_pmax).cpu().numpy() / 2
        return dataclasses.replace(s_, camera=Camera.make(
            c + np.array(EMIT_CAMERA), c, vfov=40.0, aspect=1.0,
            aperture=aperture, device=dev))

    def c2_scene(**rows):
        return aimed(build_scene([bench_blob(emission=True)],
                                 emission_lut=lut, device=dev, **rows))

    def c3_scene(**rows):
        return attach_env_map(aimed(build_scene(
            [bench_blob(color=True)], emission_lut=lut, device=dev, **rows),
            aperture=C3_APERTURE), bench_env_map())

    # configs 2 and 3 as the bench builds them (bfloat16 rows, octant
    # columns), and beside them in float32 rows without octant columns
    # (K1's instances without the octant branch) and, for config 2, in
    # float32 rows with them (K1's float32 OCT instances)
    t0 = time.perf_counter()
    c2 = c2_scene(**BENCH_ROWS)
    torch.cuda.synchronize()
    c2_build_s = time.perf_counter() - t0
    c2_cached = attach_shadow_cache(c2, AZIMUTH, ELEVATION)
    c3 = c3_scene(**BENCH_ROWS)
    c2_f32 = attach_shadow_cache(c2_scene(), AZIMUTH, ELEVATION)
    c2_oct = attach_shadow_cache(c2_scene(octant_boxes=True), AZIMUTH,
                                 ELEVATION)
    c3_f32 = c3_scene()
    big = build_scene([dataclasses.replace(
        grid, emission_zyx=(EMIT_OF_DENSITY * grid.density_zyx).astype(
            np.float32))], lights=lights, emission_lut=lut, device=dev)
    big = attach_shadow_cache(big, AZIMUTH, ELEVATION)
    torch.cuda.synchronize()
    emit_build_s = time.perf_counter() - t0
    c2_kw = dict(emission_scale=2.0, emission_pivot=1.0)
    hdri = dict(environment_type=int(Environment.HDRI))
    # (scene, params, warm-up spp, timed spp, the route's kernels and K4)
    runs = {
        "config2_cached": (c2_cached, params(EMIT_SIZE, EMIT_SIZE, "cached")
                           .replace(**c2_kw), 2, EMIT_SPP),
        "config2_tracked": (c2, params(EMIT_SIZE, EMIT_SIZE, "tracked")
                            .replace(**c2_kw), 2, EMIT_SPP),
        "config3_tracked": (c3, params(EMIT_SIZE, EMIT_SIZE, "tracked")
                            .replace(**hdri), 2, EMIT_SPP),
        "config2_cached_f32": (c2_f32, params(EMIT_SIZE, EMIT_SIZE,
                                              "cached").replace(**c2_kw), 2,
                               EMIT_SPP),
        "config2_cached_f32_octant": (
            c2_oct, params(EMIT_SIZE, EMIT_SIZE, "cached").replace(**c2_kw),
            2, EMIT_SPP),
        "config3_tracked_f32": (c3_f32, params(EMIT_SIZE, EMIT_SIZE,
                                               "tracked").replace(**hdri), 2,
                                EMIT_SPP),
        "emissive200_cached": (
            dataclasses.replace(big, camera=cli.default_framing(big, W, H)),
            params(W, H, "cached").replace(emission_scale=2.0), 2,
            TIMED_SPP),
        "emissive200_tracked": (
            dataclasses.replace(big, camera=cli.default_framing(big, W, H)),
            params(W, H, "tracked").replace(emission_scale=2.0), 0,
            TRACKED_SPP),
        "vd2_cached": (s256, params(PARITY_SIZE, PARITY_SIZE, "cached")
                       .replace(volume_depth=2), 2, VD_SPP),
        "vd2_tracked": (s256, params(PARITY_SIZE, PARITY_SIZE, "tracked")
                        .replace(volume_depth=2), 2, VD_SPP)}
    def timed_render(sc, pe, warm, spp):
        """A renderer on (sc, pe) after warm + spp samples, and the
        summary of its film: ms/spp over the timed spp, iterations per
        ray, trunc_frac, the image mean, whether it is finite."""
        rr = renderer.ProgressiveRenderer(sc, pe)
        rr.step(warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr.step(spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = pe.width * pe.height * (warm + spp)
        f = rr.film
        return rr, dict(
            size=[pe.width, pe.height], spp=spp, ms_per_spp=dt * 1e3 / spp,
            mean_iters_per_ray=float(f.cost.double().sum()) / n,
            trunc_frac=float(f.trunc.double().sum()) / n,
            image_mean=float(f.accum.double().mean()),
            finite=bool(torch.isfinite(f.accum).all()))

    emit_runs, ext_launches = {}, 0
    rows_launches = {fused.FUSED_DIRECT_BF16.name: 0,
                     fused.FUSED_DIRECT_OCTANT.name: 0}
    for name, (sc, pe, warm, spp) in runs.items():
        for k in kernels:
            k.launches = 0
        rr, emit_runs[name] = timed_render(sc, pe, warm, spp)
        got = {k.name: k.launches for k in kernels}
        emit_runs[name]["launches"] = got
        emit_runs[name]["rows"] = dict(
            dtype=str(sc.atlas.density_corners.dtype).replace("torch.", ""),
            octant_cols=sc.atlas.octant_cols,
            width=sc.atlas.density_corners.shape[1])
        ext_launches += got[fused.FUSED_DIRECT_EXT.name]
        for k_ in rows_launches:
            rows_launches[k_] += got[k_]
        mode = pe.shadow_mode
        route = ({fused.FUSED_DIRECT_PRIMARY.name} if
                 renderer.RAYS_IN_KERNEL[mode] else
                 {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
        on = route | {fused.FUSED_DIRECT_EXT.name,
                      film_mod.FILM_ACCUMULATE.name}
        if fused.rows_kernel(sc) is not None:
            on.add(fused.rows_kernel(sc).name)
        if pe.environment_type == int(Environment.HDRI):
            on.add(integrator.ENVIRONMENT.name)
        want = {k.name: (warm + spp if k.name in on else 0)
                for k in kernels}
        if got != want:
            raise RuntimeError(f"emission {name}: launches {got}, expected "
                               f"{want}")
        if not (emit_runs[name]["finite"]
                and emit_runs[name]["image_mean"] > 0.0):
            raise RuntimeError(f"emission {name}: not finite, or black")
        if args.save and name.startswith(("config", "emissive200")):
            np.save(os.path.join(args.save, f"chip_smoke_{name}.npy"),
                    rr.display_image())
        del rr
    for k_, n_ in rows_launches.items():
        if n_ <= 0:
            raise RuntimeError(f"emission: {k_} never launched")
    # volume_depth 1 on the same 256^2 scene: vd2's baseline
    vd1 = {mode: timed_render(s256, params(PARITY_SIZE, PARITY_SIZE, mode),
                              2, VD_SPP)[1] for mode in ("cached", "tracked")}
    # config 2 with the sun off and no light: its emission alone lights it
    dark = renderer.ProgressiveRenderer(c2, runs["config2_tracked"][1]
                                        .replace(sun_mult=0.0))
    dark_mean = float(dark.step(4).accum.double().mean())
    del dark
    # K1 against fused_direct_plain at 256^2 on each render's scene, by
    # phase 6's rule; the in-kernel-ray route bit for bit the buffer route
    emit_k1, emit_routes = {}, {}
    key = rng.render_key(SEED, 0)
    tkey = renderer.tile_key(key)
    for name, (sc, pe, _, _) in runs.items():
        p256 = pe.replace(width=PARITY_SIZE, height=PARITY_SIZE)
        if name.startswith("emissive200"):
            sc = dataclasses.replace(sc, camera=cli.default_framing(
                sc, PARITY_SIZE, PARITY_SIZE))
        rays = renderer._primary_rays_cuda(sc.camera, p256, key)
        out_k = fused._fused_direct_cuda(sc, p256, tkey, *rays)
        emit_k1[name] = k1_agreement([(out_k, fused.fused_direct_plain(
            sc, p256, tkey, *rays))])
        emit_routes[name] = same_bits(
            renderer._trace_primary_cuda(sc, p256, key), out_k)
    # K1's EXT variant timed beside the plain loop on the cached config 2
    # (512^2) and the cached 200^3 emissive grid (1080p), at the frame's
    # queue length; the timed outputs held together by the share rule:
    # config 2 in float32 rows (no octant branch), in float32 rows
    # with octant columns and as the bench builds it (bfloat16, octant)
    ext_time = {}
    for name in ("config2_cached_f32", "config2_cached_f32_octant",
                 "config2_cached", "emissive200_cached"):
        sc, pe, _, _ = runs[name]
        lt = renderer.prepare(sc, pe)
        o, d = renderer._primary_rays_cuda(sc.camera, pe, key, lt.raygen)
        q = renderer.frame_queue(pe)
        tk, out_k = cuda_ms(lambda: fused._fused_direct_cuda(
            sc, pe, tkey, o, d, lt.fused, pe.width, q), 3)
        tp, out_p = cuda_ms(lambda: fused.fused_direct_plain(
            sc, pe, tkey, o, d, q), 1)
        steps = float(out_k[2].double().sum())
        corners_ = sc.atlas.density_corners
        rows = min(steps, corners_.shape[0])
        # rays in and out and the operations of every step; and each
        # row once, the columns a step reads (k1_row_bytes)
        row_bytes = k1_row_bytes(sc.atlas, True)
        ext_time[name] = dict(
            size=[pe.width, pe.height], ms=tk, plain_ms=tp,
            row_bytes=row_bytes,
            bound=bound(o.shape[0] * (24 + 28) + rows * row_bytes,
                        steps * K1_OPS_PER_STEP),
            steps=steps, **k1_agreement([(out_k, out_p)]))
        del o, d, out_k, out_p, lt
    emit("emission", lut="scene/assets.py::ramp_lut", build_s=emit_build_s,
         config2_build_s=c2_build_s,
         runs=emit_runs, vd1_baseline=vd1, emission_alone_mean=dark_mean,
         k1=emit_k1,
         k1_routes_bit_equal=emit_routes, k1_ext_timed=ext_time,
         k1_ext_launches=ext_launches, k1_rows_launches=rows_launches,
         rows="configs 2 and 3 as bench.py builds them: bfloat16 rows, "
              "octant_boxes=True; the *_f32 runs in float32 rows without "
              "octant columns, *_f32_octant in float32 rows with them")
    check_parity("emission 256^2", emit_k1, 0.0, True, emit_routes)
    check_parity("emission timed", ext_time, 0.0, True, {})
    if not dark_mean > 0.0:
        raise RuntimeError("config 2 with emission alone is black")
    launches[fused.FUSED_DIRECT_EXT.name] = ext_launches
    launches.update(rows_launches)
    at_size = ext_time["emissive200_cached"]
    timing["fused_direct_ext"] = (at_size["ms"], at_size["plain_ms"])
    bounds["fused_direct_ext"] = at_size["bound"]
    for k_, run_ in ((fused.FUSED_DIRECT_BF16, "config2_cached"),
                     (fused.FUSED_DIRECT_OCTANT,
                      "config2_cached_f32_octant")):
        timing[k_.name] = (ext_time[run_]["ms"], ext_time[run_]["plain_ms"])
        bounds[k_.name] = ext_time[run_]["bound"]
    del c2, c2_cached, c3, c2_f32, c2_oct, c3_f32, big, runs

    # ---- 8e. instanced: config 5's cloudscape through K1's CELLS variant
    from vpt_tpu_torch.tools.common import (aim_cloud, c5_params,
                                            cloud_xforms, golden_blob,
                                            golden_c5_instances,
                                            golden_camera)
    c5_ids, c5_xf = cloud_xforms(C5_INSTANCES)
    c5_build = {}
    t0 = time.perf_counter()
    c5 = build_scene([bench_blob(n=C5_BLOB_N)], instance_grid_ids=c5_ids,
                     instance_xforms=c5_xf, device=dev, timings=c5_build)
    torch.cuda.synchronize()
    c5_build["build_scene_s"] = time.perf_counter() - t0
    c5 = aim_cloud(c5)
    c5_res = c5.majorant.resolution
    t0 = time.perf_counter()
    c5_cached = attach_shadow_cache(c5, AZIMUTH, ELEVATION)
    torch.cuda.synchronize()
    c5_build["shadow_bake_s"] = time.perf_counter() - t0
    c5_k = c5.majorant.cell_instances.shape[1]
    c5_scenes = {"tracked": c5, "cached": c5_cached}
    c5_row_bytes = {m: sc.majorant.cell_rows.numel() * 4
                    for m, sc in c5_scenes.items()}

    def bit_share(out_k, out_p):
        """Share of rays whose five outputs are the same bits."""
        same = (out_k[0].view(torch.int32) == out_p[0].view(torch.int32)
                ).all(-1)
        for a_, b_ in zip(out_k[1:], out_p[1:]):
            same &= a_.view(torch.int32) == b_.view(torch.int32)
        return float(same.double().mean())

    def cells_parity(scenes_, size, p_of):
        """K1 (buffer route) against fused_direct_plain on K2's rays at
        size^2 by phase 6's rule, with the bit-for-bit share; the
        in-kernel-ray route bit for bit the buffer route."""
        par, routes = {}, {}
        key = rng.render_key(SEED, 0)
        tkey = renderer.tile_key(key)
        for mode, sc in scenes_.items():
            pe = p_of(size, size, mode)
            rays = renderer._primary_rays_cuda(sc.camera, pe, key)
            out_k = fused._fused_direct_cuda(sc, pe, tkey, *rays)
            out_p = fused.fused_direct_plain(sc, pe, tkey, *rays)
            par[mode] = dict(**k1_agreement([(out_k, out_p)]),
                             bit_share=bit_share(out_k, out_p))
            routes[mode] = same_bits(
                renderer._trace_primary_cuda(sc, pe, key), out_k)
        return par, routes

    c5_par, c5_routes = cells_parity(c5_scenes, PARITY_SIZE, c5_params)
    check_parity("instanced 256^2", c5_par, 0.0, True, c5_routes)
    # the timed renders: 32 spp after 2 at the bench's 512^2 and at 1080p
    c5_runs, cells_launches = {}, 0
    for (w, h) in C5_SIZES:
        for mode, sc in c5_scenes.items():
            name = f"{w}x{h}_{mode}"
            sc = dataclasses.replace(sc, camera=aim_cloud(sc, w / h).camera)
            for k in kernels:
                k.launches = 0
            rr, c5_runs[name] = timed_render(sc, c5_params(w, h, mode), 2,
                                             C5_SPP)
            got = {k.name: k.launches for k in kernels}
            c5_runs[name]["launches"] = got
            c5_runs[name]["mrays_per_s"] = (
                w * h / (c5_runs[name]["ms_per_spp"] * 1e-3) / 1e6)
            cells_launches += got[fused.FUSED_DIRECT_CELLS.name]
            route = ({fused.FUSED_DIRECT_PRIMARY.name} if
                     renderer.RAYS_IN_KERNEL[mode] else
                     {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
            on = route | {fused.FUSED_DIRECT_CELLS.name,
                          film_mod.FILM_ACCUMULATE.name}
            want = {k.name: (2 + C5_SPP if k.name in on else 0)
                    for k in kernels}
            if got != want:
                raise RuntimeError(f"instanced {name}: launches {got}, "
                                   f"expected {want}")
            if not (c5_runs[name]["finite"]
                    and c5_runs[name]["image_mean"] > 0.0):
                raise RuntimeError(f"instanced {name}: not finite, or black")
            if args.save:
                np.save(os.path.join(args.save, f"chip_smoke_c5_{name}.npy"),
                        rr.display_image())
            del rr
    # K1's CELLS variant timed beside the plain loop at 512^2, the
    # frame's queue length, both modes; the timed outputs held together
    cells_time = {}
    key = rng.render_key(SEED, 0)
    tkey = renderer.tile_key(key)
    for mode, sc in c5_scenes.items():
        pe = c5_params(C5_SIZES[0][0], C5_SIZES[0][1], mode)
        lt = renderer.prepare(sc, pe)
        o, d = renderer._primary_rays_cuda(sc.camera, pe, key, lt.raygen)
        q = renderer.frame_queue(pe)
        tk, out_k = cuda_ms(lambda: fused._fused_direct_cuda(
            sc, pe, tkey, o, d, lt.fused, pe.width, q), 3)
        tp, out_p = cuda_ms(lambda: fused.fused_direct_plain(
            sc, pe, tkey, o, d, q), 1)
        steps = float(out_k[2].double().sum())
        rows_w = sc.majorant.cell_rows.shape[1]
        n_cells = sc.majorant.cell_rows.shape[0]
        table_bytes = (sc.instances.packed_rows.numel()
                       + sc.atlas.density_corners.numel()) * 4
        cells_time[mode] = dict(
            size=[pe.width, pe.height], queue=q, ms=tk, plain_ms=tp,
            # rays in and out, each cell row visited once (at most every
            # row), the instance rows and corner table once, and K1's
            # operations of every step (the slots' not counted)
            bound=bound(o.shape[0] * (24 + 28)
                        + min(steps, n_cells) * rows_w * 4 + table_bytes,
                        steps * K1_OPS_PER_STEP),
            # the traffic as a step issues it: the cell row's 7 box and K
            # id columns, and 19 + 8 floats per slot (all K counted)
            step_bytes_ms=steps * (7 + c5_k + c5_k * (19 + 8)) * 4
            / HBM_BYTES_PER_S * 1e3,
            steps=steps, **k1_agreement([(out_k, out_p)]),
            bit_share=bit_share(out_k, out_p))
        del o, d, out_k, out_p, lt
    check_parity("instanced timed", cells_time, 0.0, True, {})
    # the c5 golden's scene (27 instances of the 12^3 blob, R 64), built by
    # the port on the card: K1 against the plain loop at 256^2 in both
    # modes, and its golden render (32^2, 8 spp) beside the golden's mean
    gl_ids, gl_xf = golden_c5_instances()
    gl = golden_camera(build_scene([golden_blob()], instance_grid_ids=gl_ids,
                                   instance_xforms=gl_xf, device=dev))
    gl_scenes = {"tracked": gl,
                 "cached": attach_shadow_cache(gl, AZIMUTH, ELEVATION)}

    def gl_params(w, h, mode):
        return RenderParams(width=w, height=h, ray_depth=4, max_track_steps=64,
                            max_fused_steps=256, shadow_mode=mode,
                            environment_type=int(Environment.CONSTANT))
    gl_par, gl_routes = cells_parity(gl_scenes, PARITY_SIZE, gl_params)
    check_parity("instanced golden", gl_par, 0.0, True, gl_routes)
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "golden", "c5_instanced__fused.npz")
    gl_img = renderer.ProgressiveRenderer(gl, gl_params(32, 32, "tracked")
                                          ).render(8).accum
    gl_want = float(np.load(golden_path)["accum"].mean())
    gl_render = dict(mean=float(gl_img.double().mean()), golden_mean=gl_want,
                     finite=bool(torch.isfinite(gl_img).all()),
                     k=gl.majorant.cell_instances.shape[1])
    if not (gl_render["finite"] and gl_render["mean"] > 0.0):
        raise RuntimeError(f"instanced golden render: {gl_render}")
    emit("instanced", instances=C5_INSTANCES, blob=C5_BLOB_N,
         resolution=c5_res, k=c5_k,
         cell_row_bytes=c5_row_bytes, build=c5_build,
         k1_cells=c5_par, k1_routes_bit_equal=c5_routes, runs=c5_runs,
         k1_cells_timed=cells_time, k1_cells_launches=cells_launches,
         golden=dict(k1=gl_par, routes_bit_equal=gl_routes,
                     render=gl_render),
         ptxas={k: v for k, v in k1_ptxas.items() if "_cells" in k},
         launch={k: v for k, v in k1_launch.items() if "_cells" in k})
    launches[fused.FUSED_DIRECT_CELLS.name] = cells_launches
    at_c5 = cells_time["tracked"]
    timing["fused_direct_cells"] = (at_c5["ms"], at_c5["plain_ms"])
    bounds["fused_direct_cells"] = at_c5["bound"]
    del c5, c5_cached, c5_scenes, gl, gl_scenes

    def instanced_runs(where, scenes_, p_of, aim, sizes, on_extra,
                       spp=C5_SPP):
        """spp timed samples after 2 of each scene at each size: ms/spp,
        Mrays/s, iterations per ray, trunc_frac; each run's launches must
        be the route's, K3's and those named in ``on_extra`` once a
        sample and no
        other; finite and not black.  Returns (runs, launches summed)."""
        runs_, total = {}, {k.name: 0 for k in kernels}
        for (w, h) in sizes:
            for mode, sc in scenes_.items():
                name = f"{w}x{h}_{mode}"
                sc = aim(sc, w / h)
                for k in kernels:
                    k.launches = 0
                rr, runs_[name] = timed_render(sc, p_of(w, h, mode), 2, spp)
                got = {k.name: k.launches for k in kernels}
                runs_[name]["launches"] = got
                runs_[name]["mrays_per_s"] = (
                    w * h / (runs_[name]["ms_per_spp"] * 1e-3) / 1e6)
                for k_, n_ in got.items():
                    total[k_] += n_
                route = ({fused.FUSED_DIRECT_PRIMARY.name} if
                         renderer.RAYS_IN_KERNEL[mode] else
                         {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
                on = route | {film_mod.FILM_ACCUMULATE.name} | set(on_extra)
                want = {k.name: (2 + spp if k.name in on else 0)
                        for k in kernels}
                if got != want:
                    raise RuntimeError(f"{where} {name}: launches {got}, "
                                       f"expected {want}")
                if not (runs_[name]["finite"]
                        and runs_[name]["image_mean"] > 0.0):
                    raise RuntimeError(f"{where} {name}: not finite, or "
                                       "black")
                if args.save:
                    np.save(os.path.join(args.save,
                                         f"chip_smoke_{where}_{name}.npy"),
                            rr.display_image())
                del rr
        return runs_, total

    def k1_timed(scenes_, p_of, size, reps=3):
        """K1 (buffer route, the frame's queue) beside fused_direct_plain
        on each scene's K2 rays at size^2, held together by the share
        rule: device ms, the bound (rays in and out, each visited row of
        the cell or packed table once, the instance rows and the corner
        table once; K1's operations a step) and the bit-for-bit share."""
        out_ = {}
        key = rng.render_key(SEED, 0)
        tkey = renderer.tile_key(key)
        for mode, sc in scenes_.items():
            pe = p_of(size, size, mode)
            lt = renderer.prepare(sc, pe)
            o, d = renderer._primary_rays_cuda(sc.camera, pe, key, lt.raygen)
            q = renderer.frame_queue(pe)
            tk, out_k = cuda_ms(lambda: fused._fused_direct_cuda(
                sc, pe, tkey, o, d, lt.fused, pe.width, q), reps)
            tp, out_p = cuda_ms(lambda: fused.fused_direct_plain(
                sc, pe, tkey, o, d, q), 1)
            steps = float(out_k[2].double().sum())
            if sc.majorant is not None:
                tab = (sc.majorant.packed if sc.majorant.cell_rows is None
                       else sc.majorant.cell_rows)
                visited = min(steps, tab.shape[0]) * tab.shape[1] * 4
                table_bytes = (sc.instances.packed_rows.numel() * 4
                               + sc.atlas.density_corners.numel()
                               * sc.atlas.density_corners.element_size())
            else:
                corners_ = sc.atlas.density_corners
                visited = min(steps, corners_.shape[0]) * k1_row_bytes(
                    sc.atlas, sc.atlas.has_emission)
                table_bytes = 0
            out_[mode] = dict(
                size=[pe.width, pe.height], queue=q, ms=tk, plain_ms=tp,
                bound=bound(o.shape[0] * (24 + 28) + visited + table_bytes,
                            steps * K1_OPS_PER_STEP),
                steps=steps, **k1_agreement([(out_k, out_p)]),
                bit_share=bit_share(out_k, out_p))
            del o, d, out_k, out_p, lt
        return out_

    # ---- 8e2. instanced_loop: loop8 through K1's CELLS instances with LOOP
    from vpt_tpu_torch.tools.common import (aim_loop8, config5_ext_scene,
                                            loop8_params, loop8_scene,
                                            union_error, union_scene)
    lp_t = {}
    t0 = time.perf_counter()
    lp = loop8_scene(dev, lp_t)
    torch.cuda.synchronize()
    lp_t["build_scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp_scenes = {"tracked": lp,
                 "cached": attach_shadow_cache(lp, AZIMUTH, ELEVATION)}
    torch.cuda.synchronize()
    lp_t["shadow_bake_s"] = time.perf_counter() - t0
    lp_par, lp_routes = cells_parity(lp_scenes, PARITY_SIZE, loop8_params)
    check_parity("instanced_loop 256^2", lp_par, 0.0, True, lp_routes)
    lp_ext = {k.name for k in (fused.FUSED_DIRECT_LOOP, fused.FUSED_DIRECT_EXT,
                               fused.FUSED_DIRECT_CELLS_EXT)}
    lp_runs, lp_launches = instanced_runs(
        "instanced_loop", lp_scenes, loop8_params, aim_loop8, C5_SIZES,
        lp_ext)
    lp_time = k1_timed(lp_scenes, loop8_params, C5_SIZES[0][0])
    check_parity("instanced_loop timed", lp_time, 0.0, True, {})
    emit("instanced_loop", config="loop8 (tools/common.py::loop8_scene)",
         instances=lp.instances.count, grids=int(lp.atlas.offset.numel()),
         resolution=lp.majorant.resolution,
         packed_cols=lp.majorant.packed.shape[1],
         world_tau=list(lp_scenes["cached"].world_tau.shape), build=lp_t,
         k1=lp_par, k1_routes_bit_equal=lp_routes, runs=lp_runs,
         k1_timed=lp_time,
         ptxas={k: v for k, v in k1_ptxas.items() if "_loop" in k},
         launch={k: v for k, v in k1_launch.items() if "_loop" in k})
    del lp, lp_scenes

    # ---- 8e3. instanced_ext: config 5 with emission and color (CELLS x EXT)
    cx_t = {}
    t0 = time.perf_counter()
    cx = config5_ext_scene(dev, cx_t)
    torch.cuda.synchronize()
    cx_t["build_scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cx_scenes = {"tracked": cx,
                 "cached": attach_shadow_cache(cx, AZIMUTH, ELEVATION)}
    torch.cuda.synchronize()
    cx_t["shadow_bake_s"] = time.perf_counter() - t0
    cx_par, cx_routes = cells_parity(cx_scenes, PARITY_SIZE, c5_params)
    check_parity("instanced_ext 256^2", cx_par, 0.0, True, cx_routes)
    cx_ext = {k.name for k in (fused.FUSED_DIRECT_CELLS,
                               fused.FUSED_DIRECT_EXT,
                               fused.FUSED_DIRECT_CELLS_EXT)}
    cx_runs, cx_launches = instanced_runs(
        "instanced_ext", cx_scenes, c5_params, aim_cloud, C5_SIZES[:1],
        cx_ext)
    cx_time = k1_timed(cx_scenes, c5_params, C5_SIZES[0][0])
    check_parity("instanced_ext timed", cx_time, 0.0, True, {})
    emit("instanced_ext",
         config="config5_ext (tools/common.py::config5_ext_scene)",
         instances=cx.instances.count, resolution=cx.majorant.resolution,
         k=cx.majorant.cell_instances.shape[1], build=cx_t, k1=cx_par,
         k1_routes_bit_equal=cx_routes, runs=cx_runs, k1_timed=cx_time,
         ptxas={k: v for k, v in k1_ptxas.items() if "_ext_cells" in k},
         launch={k: v for k, v in k1_launch.items() if "_ext_cells" in k})
    del cx, cx_scenes

    # ---- 8e4. union: config5_union and config5_4k through K1's _bf16 ----
    un_res, un_launches = {}, {k.name: 0 for k in kernels}
    for uname, sizes, modes in (("config5_union", C5_SIZES,
                                 ("tracked", "cached")),
                                ("config5_4k", C5_SIZES[:1], ("cached",))):
        u_t = {}
        t0 = time.perf_counter()
        us = union_scene(uname, dev, u_t)
        torch.cuda.synchronize()
        u_t["scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        u_err = union_error(uname, dev)
        u_t["error_s"] = time.perf_counter() - t0
        u_scenes = {m: us for m in modes}
        u_par, u_routes = cells_parity(u_scenes, PARITY_SIZE, c5_params)
        check_parity(f"{uname} 256^2", u_par, 0.0, True, u_routes)
        u_runs, u_got = instanced_runs(uname, u_scenes, c5_params,
                                       aim_cloud, sizes,
                                       {fused.FUSED_DIRECT_BF16.name})
        for k_, n_ in u_got.items():
            un_launches[k_] += n_
        for r_ in u_runs.values():
            r_["union_field_error"] = u_err
        u_time = k1_timed(u_scenes, c5_params, C5_SIZES[0][0])
        check_parity(f"{uname} timed", u_time, 0.0, True, {})
        rows_ = us.atlas.density_corners
        un_res[uname] = dict(
            grid=[int(v) for v in us.atlas.dim[0]],
            rows=list(rows_.shape),
            rows_gib=rows_.numel() * rows_.element_size() / 2 ** 30,
            build=u_t, union_field_error=u_err, k1=u_par,
            k1_routes_bit_equal=u_routes, runs=u_runs, k1_timed=u_time)
        del us, u_scenes
    emit("union", config="tools/common.py::union_scene (bench.py:710-800)",
         **un_res)
    launches[fused.FUSED_DIRECT_BF16.name] += un_launches[
        fused.FUSED_DIRECT_BF16.name]
    launches[fused.FUSED_DIRECT_LOOP.name] = lp_launches[
        fused.FUSED_DIRECT_LOOP.name]
    launches[fused.FUSED_DIRECT_CELLS_EXT.name] = (
        lp_launches[fused.FUSED_DIRECT_CELLS_EXT.name]
        + cx_launches[fused.FUSED_DIRECT_CELLS_EXT.name])
    launches[fused.FUSED_DIRECT_EXT.name] += (
        lp_launches[fused.FUSED_DIRECT_EXT.name]
        + cx_launches[fused.FUSED_DIRECT_EXT.name])
    launches[fused.FUSED_DIRECT_CELLS.name] += cx_launches[
        fused.FUSED_DIRECT_CELLS.name]
    for k_, t_ in ((fused.FUSED_DIRECT_LOOP, lp_time["tracked"]),
                   (fused.FUSED_DIRECT_CELLS_EXT, cx_time["tracked"])):
        timing[k_.name] = (t_["ms"], t_["plain_ms"])
        bounds[k_.name] = t_["bound"]

    # ---- 8f. the Bruneton atmosphere (config 4) ---------------------------
    from vpt_tpu_torch.tools import time_atmosphere
    emit("atmosphere_cuts", config="config4 (bench.py:649-681)", cut={},
         kept={"volume": "the 64^3 puff", "rows": "bfloat16, octant_boxes "
               "(a float32 run without octant columns beside)",
               "luts": time_atmosphere.HALF,
               "camera_offset": time_atmosphere.CAMERA_OFFSET,
               "size": [time_atmosphere.SIZE] * 2, "ray_depth": 50,
               "sun": [AZIMUTH, ELEVATION]})
    with tempfile.TemporaryDirectory(prefix="vpt_atm_") as atm_tmp:
        atm_res = time_atmosphere.run(
            dev, out=lambda ln: print(ln, flush=True), tmp=atm_tmp)
    emit("atmosphere", **{k: v for k, v in atm_res.items()
                          if k not in ("runs", "k4", "k1_env_pos")})
    atm_errs = {}
    for kind, k_ in (("atmosphere", integrator.ENVIRONMENT_ATMOSPHERE),
                     ("sky_cache", integrator.ENVIRONMENT_SKY_CACHE)):
        at = atm_res["k4"][f"{kind}_{W}x{H}"]
        launches[k_.name] = atm_res["launches"][k_.name]
        timing[k_.name] = (at["ms"], at["plain_ms"])
        bounds[k_.name] = at["bound"]
        atm_errs[k_.name] = max(v["max_abs"] for n_, v
                                in atm_res["k4"].items()
                                if n_.startswith(kind))
        if launches[k_.name] <= 0:
            raise RuntimeError(f"{k_.name} never launched on config 4")
    launches[fused.FUSED_DIRECT_BF16.name] += atm_res["launches"][
        fused.FUSED_DIRECT_BF16.name]

    # ---- 8g. bigvol: the bench's 512^3 grid in bfloat16 rows ------------
    import resource

    from vpt_tpu_torch.tools.common import (BIGVOL_N as BENCH_BIGVOL_N,
                                            bigvol_params, bigvol_scene)
    bv_t = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bv = bigvol_scene(BIGVOL_N, dev, bv_t)
    bv_t["phase_build_s"] = time.perf_counter() - t0
    bv_rows = bv.atlas.density_corners
    bv_p = bigvol_params()
    for k in kernels:
        k.launches = 0
    rr, bv_run = timed_render(bv, bv_p, 2, BIGVOL_SPP)
    got = {k.name: k.launches for k in kernels}
    route = ({fused.FUSED_DIRECT_PRIMARY.name} if
             renderer.RAYS_IN_KERNEL[bv_p.shadow_mode] else
             {fused.FUSED_DIRECT.name, renderer.RAYGEN.name})
    on = route | {fused.FUSED_DIRECT_BF16.name,
                  film_mod.FILM_ACCUMULATE.name}
    want = {k.name: (2 + BIGVOL_SPP if k.name in on else 0) for k in kernels}
    if got != want:
        raise RuntimeError(f"bigvol: launches {got}, expected {want}")
    if not (bv_run["finite"] and bv_run["image_mean"] > 0.0):
        raise RuntimeError(f"bigvol: not finite, or black: {bv_run}")
    if args.save:
        np.save(os.path.join(args.save, "chip_smoke_bigvol.npy"),
                rr.display_image())
    del rr
    launches[fused.FUSED_DIRECT_BF16.name] += got[fused.FUSED_DIRECT_BF16.name]
    # K1 (its bfloat16 density-only instance) against the plain loop on
    # a crop of the frame's rays, at the frame's queue, by phase 6's
    # rule; then K1 alone on the whole frame, timed
    key = rng.render_key(SEED, 0)
    tkey = renderer.tile_key(key)
    q = renderer.frame_queue(bv_p)
    o, d = renderer._primary_rays_cuda(bv.camera, bv_p, key)
    lo_ = (bv_p.width - BIGVOL_CROP) // 2
    crop = [x.view(bv_p.height, bv_p.width, 3)[
        lo_:lo_ + BIGVOL_CROP, lo_:lo_ + BIGVOL_CROP].reshape(-1, 3)
        .contiguous() for x in (o, d)]
    out_k = fused._fused_direct_cuda(bv, bv_p, tkey, *crop, None,
                                     BIGVOL_CROP, q)
    out_p = fused.fused_direct_plain(bv, bv_p, tkey, *crop, q)
    bv_k1 = dict(crop=[BIGVOL_CROP] * 2, queue=q,
                 **k1_agreement([(out_k, out_p)]),
                 bit_share=bit_share(out_k, out_p))
    lt = renderer.prepare(bv, bv_p)
    tk, out_k = cuda_ms(lambda: fused._fused_direct_cuda(
        bv, bv_p, tkey, o, d, lt.fused, bv_p.width, q), 3)
    steps = float(out_k[2].double().sum())
    bv_k1.update(ms=tk, steps=steps, bound=bound(
        o.shape[0] * (24 + 28) + min(steps, bv_rows.shape[0])
        * k1_row_bytes(bv.atlas, False), steps * K1_OPS_PER_STEP))
    check_parity("bigvol crop", {"cached": bv_k1}, 0.0, True, {})
    emit("bigvol", n=BIGVOL_N,
         cut=(None if BIGVOL_N == BENCH_BIGVOL_N else
              f"{BENCH_BIGVOL_N}^3 -> {BIGVOL_N}^3: the phase's time"),
         corner_table=list(bv_rows.shape),
         corner_dtype=str(bv_rows.dtype).replace("torch.", ""),
         corner_gib=bv_rows.numel() * bv_rows.element_size() / 2 ** 30,
         octant_cols=bv.atlas.octant_cols, **bv_t, run=bv_run, launches=got,
         peak_host_rss_gib=resource.getrusage(
             resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         k1=bv_k1)
    del bv, bv_rows, o, d, crop, out_k, out_p, lt
    torch.cuda.empty_cache()

    # ---- 8h/8i. kernel K5: the reference engine, the volumetric ----------
    # integrator (vpt_tpu_torch/tools/time_walk.py)
    from vpt_tpu_torch.tools import time_walk
    walk_res = {}
    for name, fn in (("reference", time_walk.reference_phase),
                     ("volumetric", time_walk.volumetric_phase)):
        t0 = time.perf_counter()
        walk_res[name] = fn(dev, scene)
        emit(name, phase_s=time.perf_counter() - t0, **walk_res[name])
    ref_res, vol_res = walk_res["reference"], walk_res["volumetric"]
    launches[walk.WALK_DIRECT.name] = ref_res["render"]["launches"][
        walk.WALK_DIRECT.name]
    launches[walk.WALK_VOLUMETRIC.name] = vol_res["cli"]["launches"][
        walk.WALK_VOLUMETRIC.name]
    timing[walk.WALK_DIRECT.name] = (
        ref_res["k5_alone"]["ms"], ref_res["parity"]["density"]["plain_ms"])
    bounds[walk.WALK_DIRECT.name] = ref_res["k5_alone"]["bound"]
    timing[walk.WALK_VOLUMETRIC.name] = (
        vol_res["k5_alone_sky"]["ms"], vol_res["parity"]["sky"]["plain_ms"])
    bounds[walk.WALK_VOLUMETRIC.name] = vol_res["k5_alone_sky"]["bound"]
    # K5's own kernels: the key table on both integrators' paths, the
    # wavefront's stages on the volumetric phase's renders (the CLI's, the
    # c3 map's and the point light's), each counted from 0 just before
    # its render; a stage's time and bound per K5 launch at 1080p, its
    # outputs held through walk_volumetric's parity cases
    vol_paths = ("cli", "hdri_cdf", "point")
    for k_ in (walk.WALK_KEYS, *walk.STAGE_KERNELS):
        launches[k_.name] = sum(vol_res[n_]["launches"][k_.name]
                                for n_ in vol_paths)
        if k_ is walk.WALK_KEYS:
            launches[k_.name] += ref_res["render"]["launches"][k_.name]
        if launches[k_.name] <= 0:
            raise RuntimeError(f"{k_.name} never launched on K5's paths")
        split = vol_res["k5_alone_sky"]["kernels"][k_.name]
        timing[k_.name] = (split["ms"], vol_res["keys"]["plain_ms"]
                           if k_ is walk.WALK_KEYS
                           else vol_res["parity"]["sky"]["plain_ms"])
        bounds[k_.name] = split["bound"]

    def to_stderr(text):
        print(text, file=sys.stderr, flush=True)

    # ---- 8j. K5 on the bench's other scenes and skies ------------------
    # configs 2, 4 (live and baked), 5, config5_ext and loop8 as the bench
    # builds them through both integrators, each instance held bit for bit
    # to its plain version and counted from 0 just before its render
    t0 = time.perf_counter()
    scenes_res = time_walk.scenes_phase(dev, out=to_stderr)
    emit("walk_scenes", phase_s=time.perf_counter() - t0, **scenes_res)
    scene_entries = time_walk.scene_kernel_entries(scenes_res)

    # ---- 9. the probe entry points, then each probe kernel timed ---------
    from vpt_tpu_torch.tools import probe_axis0, probe_dyngather, \
        probe_gather, time_probes

    for k in probe.KERNELS:
        k.launches = 0
    for d in probe.DESIGNS:
        probe.design_launches[d] = 0
    recs = {m.__name__.rsplit(".", 1)[1]: m.run(dev, out=to_stderr)
            for m in (probe_gather, probe_axis0, probe_dyngather)}
    probe_launches = {k.name: k.launches for k in probe.KERNELS}
    designs = dict(probe.design_launches)
    emit("probes", launches=probe_launches, take_along_designs=designs,
         records=recs)
    if not all(designs.values()):
        raise RuntimeError(f"probes: a P2 design never ran: {designs}")
    bad = [r["name"] for rs in recs.values() for r in rs
           if not r.get("ok", True)]
    if bad:
        raise RuntimeError(f"probes: kernel disagrees with plain: {bad}")
    for k in probe.KERNELS:
        if probe_launches[k.name] <= 0:
            raise RuntimeError(f"{k.name} was never launched by the probes")
    launches.update(probe_launches)

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows_n, width = probe_gather.CORNER_ROWS, probe_gather.CORNER_W
    table = torch.rand((rows_n, width), generator=g, device=dev)
    idx = torch.randint(0, rows_n, (W * H,), generator=g, device=dev,
                        dtype=torch.int32)
    tl, _ = cuda_ms(lambda: torch.index_select(table, 0, idx), 20)
    tk, got = cuda_ms(lambda: probe.gather_rows(table, idx), 20)
    tk2, _ = cuda_ms(lambda: probe.gather_rows(table, idx), 20)
    tl2, _ = cuda_ms(lambda: torch.index_select(table, 0, idx), 20)
    tp, want = cuda_ms(lambda: probe.gather_rows_plain(table, idx), 5)
    errs = {"gather_rows": max_abs((got,), (want,))}
    timing.update(gather_rows=((tk + tk2) / 2, tp, (tl + tl2) / 2))
    rows_used = torch.unique(idx).to(torch.int64)
    io_bytes = idx.numel() * 4 + got.numel() * 4
    bounds["gather_rows"] = bound(rows_used.numel() * width * 4 + io_bytes,
                                  0)
    # the sector floor: the whole 32-byte sectors the distinct rows touch
    first = rows_used * (width * 4) // 32
    last = (rows_used * (width * 4) + width * 4 - 1) // 32
    span = torch.arange(int((last - first).max()) + 1, device=dev)
    ids = first[:, None] + span
    sectors = int(torch.unique(ids[ids <= last[:, None]]).numel())
    sector_floor = bound(sectors * 32 + io_bytes, 0)[0]
    shapes = {"gather_rows": f"table ({rows_n},{width}) f32, "
                             f"{idx.numel()} random int32 rows"}
    del got, want, ids
    # P1 exactly, NaN where NaN, in both index modes with every
    # out-of-range kind planted: at the corner table, and at widths 1, 10,
    # 31 and 128 with a batch that is no multiple of a block's rows
    cases = [(table, probe_gather.planted(idx, rows_n), "corner")]
    for w in (1, 10, 31, 128):
        t = torch.rand((probe_gather.V, w), generator=g, device=dev)
        i = torch.randint(0, probe_gather.V, (probe_gather.B + 5,),
                          generator=g, device=dev, dtype=torch.int32)
        cases.append((t, probe_gather.planted(i, probe_gather.V),
                      f"width {w}"))
    for t, i, label in cases:
        for clip in (False, True):
            same = nan_equal(probe.gather_rows(t, i, clip),
                             probe.gather_rows_plain(t, i, clip))
            errs[f"gather_rows {label} {'clip' if clip else 'fill'}"] = \
                0.0 if same else float("inf")
    del table, idx, cases, t, i

    n = probe_dyngather.NS[-1]
    x = torch.rand((n, 128), generator=g, device=dev)
    i32 = torch.randint(0, n, (n, 128), generator=g, device=dev,
                        dtype=torch.int32)
    i64 = i32.to(torch.int64)
    tl, _ = cuda_ms(lambda: torch.gather(x, 0, i64), 50)
    tk, got = cuda_ms(lambda: probe.take_along(x, i32, 0), 50)
    tk2, _ = cuda_ms(lambda: probe.take_along(x, i32, 0), 50)
    tl2, _ = cuda_ms(lambda: torch.gather(x, 0, i64), 50)
    tp, want = cuda_ms(lambda: probe.take_along_plain(x, i32, 0), 50)
    errs["take_along"] = max_abs((got,), (want,))
    timing.update(take_along=((tk + tk2) / 2, tp, (tl + tl2) / 2))
    touched = int(torch.unique(i64 * 128 + torch.arange(128, device=dev)
                               ).numel())
    bounds["take_along"] = bound((touched + 2 * x.numel()) * 4, x.numel())
    shapes["take_along"] = f"x ({n},128) f32, axis 0, iters 1"
    # iters 64 (T5) in each design: the shapes' strips in shared memory
    # on both axes, and axis 0 past the shared-memory strip (the L2 route)
    iters64 = {}
    for axis, rows in ((0, n), (1, n), (0, L2_ROWS)):
        xs = torch.rand((rows, 128), generator=g, device=dev)
        ix = torch.randint(0, xs.shape[axis], xs.shape, generator=g,
                           device=dev, dtype=torch.int32)
        design = probe.take_along_design(rows, 128, axis, 64, torch.int32,
                                         *probe.device_limits(dev)).name
        t64, got64 = cuda_ms(lambda: probe.take_along(xs, ix, axis, 64), 20)
        tp64, want64 = cuda_ms(
            lambda: probe.take_along_plain(xs, ix, axis, 64), 3)
        iters64[f"axis{axis}_N{rows}"] = dict(
            design=design, ms=t64, plain_ms=tp64,
            max_abs=max_abs((got64,), (want64,)),
            bound=bound(3 * xs.numel() * 4,
                        xs.numel() * (P2_OPS_PER_STEP * 64 - 4)))
        errs[f"take_along iters 64 axis {axis} N {rows} ({design})"] = \
            iters64[f"axis{axis}_N{rows}"]["max_abs"]
    del xs, ix, got64, want64

    roll_pts = {}
    for rows in (8, ROLL_ROWS):
        xr = torch.arange(rows * 128, dtype=torch.float32,
                          device=dev).reshape(rows, 128)
        tl, _ = cuda_ms(lambda: torch.roll(xr, 3, 1), 50)
        tk, got = cuda_ms(lambda: probe.roll(xr, 3, 1), 50)
        tk2, _ = cuda_ms(lambda: probe.roll(xr, 3, 1), 50)
        tl2, _ = cuda_ms(lambda: torch.roll(xr, 3, 1), 50)
        want = probe.roll_plain(xr, 3, 1)
        # the plain version is torch.roll, the library call too
        roll_pts[rows] = dict(ms=(tk + tk2) / 2, library_ms=(tl + tl2) / 2,
                              max_abs=max_abs((got,), (want,)),
                              bound=bound(2 * xr.numel() * 4, 0))
        errs[f"roll ({rows},128)"] = roll_pts[rows]["max_abs"]
    xr = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8,
                                                                        128)
    errs["roll"] = roll_pts[8]["max_abs"]
    timing.update(roll=(roll_pts[8]["ms"], roll_pts[8]["library_ms"],
                        roll_pts[8]["library_ms"]))
    bounds["roll"] = roll_pts[8]["bound"]
    shapes["roll"] = "x (8,128) f32, shift 3, axis 1"
    emit("probe_timing",
         ms={k: {"kernel": timing[k][0], "plain": timing[k][1],
                 "library": timing[k][2]} for k in shapes},
         take_along_iters64=iters64,
         roll_points={f"({r},128)": v for r, v in roll_pts.items()},
         max_abs=errs, shapes=shapes)
    for name, err in errs.items():
        if err != 0.0:
            raise RuntimeError(f"{name} differs from its plain version by "
                               f"{err}")

    # the small-shape wrappers' host cost: each call's device time (the
    # profiler) beside its event time, and the wrapper's parts by the
    # host clock (time_probes.host_parts)
    calls = {"take_along": lambda: probe.take_along(x, i32, 0),
             "torch.gather": lambda: torch.gather(x, 0, i64),
             "roll": lambda: probe.roll(xr, 3, 1),
             "torch.roll": lambda: torch.roll(xr, 3, 1)}
    emit("host_cost",
         device_us={k: profiled_ms(fn, 200) * 1e3 for k, fn in calls.items()},
         event_us={k: cuda_ms(fn, 200)[0] * 1e3 for k, fn in calls.items()},
         host_us=time_probes.host_parts(dev, 2000))
    del x, i32, i64
    errs["environment"] = max(e["max_abs"] for e in (
        *k4_256.values(), *k4_1080.values()))
    timing["environment"] = (k4_1080["sky"]["ms"], k4_1080["sky"]["plain_ms"])
    bounds["environment"] = k4_1080["sky"]["bound"]
    errs.update(atm_errs)
    cfg2_oct = ext_time["config2_cached_f32_octant"]
    cfg2_16 = ext_time["config2_cached"]
    errs.update(fused_direct_bf16=cfg2_16["max_abs"],
                fused_direct_octant=cfg2_oct["max_abs"])
    errs.update(fused_direct_loop=lp_time["tracked"]["max_abs"],
                fused_direct_cells_ext=cx_time["tracked"]["max_abs"])
    for k_, res_, alone in ((walk.WALK_DIRECT, ref_res, ref_res["k5_alone"]),
                            (walk.WALK_VOLUMETRIC, vol_res,
                             vol_res["k5_alone_sky"])):
        errs[k_.name] = max(m["max_abs"] for m in (
            *res_["parity"].values(), *alone["tiles"].values()))
    for k_ in walk.STAGE_KERNELS:
        errs[k_.name] = errs[walk.WALK_VOLUMETRIC.name]
    errs[walk.WALK_KEYS.name] = vol_res["keys"]["max_abs"]
    errs.update(fused_direct_cells=at_c5["max_abs"],
                fused_direct_ext=at_size["max_abs"],
                fused_direct=k1_1080["cached"]["max_abs"],
                fused_direct_primary=k1_1080[f"cached_{ROUTES[1]}"]["max_abs"],
                primary_rays=k2_1080, film_accumulate=k3_1080)
    line = {"kernels": [dict(
        name=k.name, route=k.route, source=k.source, replaces=k.replaces,
        launches=launches[k.name], max_abs_err=errs[k.name],
        ms=timing[k.name][0], plain_ms=timing[k.name][1],
        bound_ms=bounds[k.name][0], bound_by=bounds[k.name][1],
        library_ms=timing[k.name][2] if len(timing[k.name]) > 2 else None)
        for k in kernels + list(probe.KERNELS)]}
    by_name = {k["name"]: k for k in line["kernels"]}
    by_name["fused_direct"].update(
        agree_share={m: st["share"] for m, st in k1_1080.items()},
        routes_bit_equal=routes_same,
        tracked_ms=timing["fused_direct_tracked"][0],
        tracked_plain_ms=timing["fused_direct_tracked"][1])
    by_name["fused_direct_primary"].update(
        also_replaces="vpt_tpu/render/renderer.py:37",
        # against the plain pipeline, whose rays differ from K2's by up to
        # k2 max_abs_err: held by the share rule of phase 6, and to the
        # buffer route on K2's rays bit for bit
        agree_share={m: k1_1080[f"{m}_{ROUTES[1]}"]["share"]
                     for m in ("cached", "tracked")},
        tolerance=f"share of rays agreeing >= {MIN_SHARE}, image means "
                  f"within {MAX_MEAN_REL}; bit-equal to the buffer route",
        routes_bit_equal=routes_same,
        tracked_ms=timing["fused_direct_primary_tracked"][0],
        tracked_plain_ms=timing["fused_direct_primary_tracked"][1])
    cfg2 = ext_time["config2_cached_f32"]
    by_name["fused_direct_ext"].update(
        also_replaces="vpt_tpu/render/tracking.py:245 (_emission_lut)",
        shape=f"{W}x{H}, the 200^3 grid with emission "
              f"{EMIT_OF_DENSITY} x density, cached, the frame's queue",
        design="K1's EXT template variant on either route: the EMIT walk "
               "(the emission LUT read from global memory beside the "
               "density color LUT), Cd from the row's 24 color columns, "
               "volume_depth > 1; density-only scenes run the variants "
               "without it",
        agree_share=at_size["share"], steps=at_size["steps"],
        config2_512=dict(ms=cfg2["ms"], plain_ms=cfg2["plain_ms"],
                         bound_ms=cfg2["bound"][0],
                         bound_by=cfg2["bound"][1],
                         agree_share=cfg2["share"],
                         max_abs_err=cfg2["max_abs"], steps=cfg2["steps"]),
        ptxas={k: v for k, v in k1_ptxas.items() if "_ext" in k},
        launch={k: v for k, v in k1_launch.items() if "_ext" in k})
    by_name["fused_direct_cells"].update(
        also_replaces="vpt_tpu/render/tracking.py:150 (_cells_banded_fetch)",
        shape=f"512x512, config 5: {C5_INSTANCES} instances of the "
              f"{C5_BLOB_N}^3 puff, R {c5_res}, K {c5_k}, tracked, the "
              "frame's queue",
        design="K1's CELLS template variant on either route: one cell row "
               "(T_box, box extents, 3 of the 72 octant columns on an "
               "empty cell, K ids, the folded taus), then per listed "
               "instance its row through the read-only path and its 8 "
               "corner taps; arguments in a struct of their own",
        agree_share=at_c5["share"], bit_share=at_c5["bit_share"],
        steps=at_c5["steps"], step_bytes_ms=at_c5["step_bytes_ms"],
        cached=dict(ms=cells_time["cached"]["ms"],
                    plain_ms=cells_time["cached"]["plain_ms"],
                    bound_ms=cells_time["cached"]["bound"][0],
                    bound_by=cells_time["cached"]["bound"][1],
                    agree_share=cells_time["cached"]["share"],
                    bit_share=cells_time["cached"]["bit_share"],
                    max_abs_err=cells_time["cached"]["max_abs"],
                    steps=cells_time["cached"]["steps"]),
        ptxas={k: v for k, v in k1_ptxas.items() if "_cells" in k},
        launch={k: v for k, v in k1_launch.items() if "_cells" in k})
    for k_, t_, shape, design in (
            (fused.FUSED_DIRECT_LOOP, lp_time,
             "512x512, loop8: 8 instances of two 64^3 grids (emission and "
             "color), no cell lists, BLACK, tracked, the frame's queue",
             "K1's CELLS instances with LOOP (a template argument): the "
             "majorant grid's packed row (T_box, box extents, 3 of the 72 "
             "octant columns on an empty cell), then every instance in "
             "order, its row and 8 corner taps; in cached mode one row of "
             "the world tau grid at an accepted event"),
            (fused.FUSED_DIRECT_CELLS_EXT, cx_time,
             "512x512, config5_ext: config 5's 1024 instances of the 24^3 "
             "puff with emission and color, cell lists over each whole "
             "box, CONSTANT, tracked, the frame's queue",
             "K1's CELLS instances with EXT: an EMIT sample sums each "
             "listed slot's emission LUT row, an accepted event takes Cd "
             "as the max over the slots (white for a grid without color), "
             "both from the cell the reference's lookup picks; no "
             "empty-box jumps on EMIT walks")):
        by_name[k_.name].update(
            shape=shape, design=design, agree_share=t_["tracked"]["share"],
            bit_share=t_["tracked"]["bit_share"],
            steps=t_["tracked"]["steps"],
            cached=dict(ms=t_["cached"]["ms"],
                        plain_ms=t_["cached"]["plain_ms"],
                        bound_ms=t_["cached"]["bound"][0],
                        bound_by=t_["cached"]["bound"][1],
                        agree_share=t_["cached"]["share"],
                        bit_share=t_["cached"]["bit_share"],
                        max_abs_err=t_["cached"]["max_abs"],
                        steps=t_["cached"]["steps"]))
    rows_design = ("K1's template instances of a single grid's rows: every "
                   "row read through one typed load (a 2-byte load widened "
                   "by __bfloat162float for bfloat16), and on an empty box "
                   "the exit widened by the anchored box of the ray's "
                   "octant and major axis (3 of the 72 columns at 15), "
                   "taken where the launch's rows carry them")
    by_name["fused_direct_bf16"].update(
        also_replaces="vpt_tpu/render/fused.py:100, "
                      "vpt_tpu/render/tracking.py:502 (octant_exit)",
        shape="512x512, config 2 as the bench builds it (bfloat16 rows, "
              "octant columns; EXT), cached, the frame's queue",
        design=rows_design, row_bytes=cfg2_16["row_bytes"],
        agree_share=cfg2_16["share"], steps=cfg2_16["steps"],
        bound_counts="rays x 52 B + each row visited once, the 26 "
                     "columns a step reads (15 density, 8 emission, 3 "
                     "octant; 2 B a column) + K1's operations a step",
        f32_rows=dict(ms=cfg2["ms"], plain_ms=cfg2["plain_ms"],
                      steps=cfg2["steps"]),
        unions={n_: {m: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                             bound_ms=v["bound"][0], bound_by=v["bound"][1],
                             agree_share=v["share"],
                             bit_share=v["bit_share"], steps=v["steps"])
                     for m, v in r_["k1_timed"].items()}
                for n_, r_ in un_res.items()},
        bigvol=dict(n=BIGVOL_N, ms=bv_k1["ms"], bound_ms=bv_k1["bound"][0],
                    bound_by=bv_k1["bound"][1], steps=bv_k1["steps"],
                    crop_agree_share=bv_k1["share"],
                    crop_bit_share=bv_k1["bit_share"],
                    crop_max_abs_err=bv_k1["max_abs"]),
        ptxas={k: v for k, v in k1_ptxas.items() if k.endswith("_bf16")},
        launch={k: v for k, v in k1_launch.items() if k.endswith("_bf16")})
    by_name["fused_direct_octant"].update(
        also_replaces="vpt_tpu/render/fused.py:100",
        shape="512x512, config 2 in float32 rows with the octant columns "
              "(EXT), cached, the frame's queue",
        design=rows_design, row_bytes=cfg2_oct["row_bytes"],
        agree_share=cfg2_oct["share"], steps=cfg2_oct["steps"],
        bound_counts="rays x 52 B + each row visited once, the 26 "
                     "columns a step reads (15 density, 8 emission, 3 "
                     "octant; 4 B a column) + K1's operations a step",
        ptxas={k: v for k, v in k1_ptxas.items() if k.endswith("_octant")},
        launch={k: v for k, v in k1_launch.items()
                if k.endswith("_octant")})
    # K2's ray also runs inside K1's in-kernel-ray route, once per launch
    lens_name = f"aperture_{K2_APERTURE}"
    by_name["primary_rays"].update(
        also_replaces="vpt_tpu/core/camera.py:73",
        design="one thread a pixel; the lens draws skipped at aperture 0 "
               "(lens_draws_needed, a kernel variant each way); 32-bit "
               "draw counters; origins and directions staged in shared "
               "memory and stored as contiguous 16-byte words",
        runs_inside="fused_direct_primary",
        inside_launches=launches["fused_direct_primary"],
        event_ms=k2_event,
        lens_ms=k2_lens_1080[lens_name]["ms"],
        lens_bound_ms=k2_lens_1080[lens_name]["bound"][0],
        lens_bound_by=k2_lens_1080[lens_name]["bound"][1],
        lens_bit_equal={n_: v["bit_equal"] for n_, v in
                        k2_lens_1080.items()})
    by_name["gather_rows"].update(
        also_replaces="tools/probe_gather.py:135",
        sector_floor_ms=sector_floor,
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("gather_rows")),
        checked=sorted(k for k in errs if k.startswith("gather_rows ")))
    by_name["take_along"].update(
        also_replaces="tools/probe_dyngather.py:73",
        designs_launched=designs,
        iters64={k: dict(design=v["design"], ms=v["ms"],
                         plain_ms=v["plain_ms"], max_abs_err=v["max_abs"],
                         bound_ms=v["bound"][0], bound_by=v["bound"][1])
                 for k, v in iters64.items()})
    by_name["take_along"]["max_abs_err"] = max(
        v for k, v in errs.items() if k.startswith("take_along"))
    by_name["roll"].update(
        max_abs_err=max(v for k, v in errs.items() if k.startswith("roll")),
        points={f"({r},128)": dict(ms=v["ms"], library_ms=v["library_ms"],
                                   bound_ms=v["bound"][0],
                                   bound_by=v["bound"][1])
                for r, v in roll_pts.items()})
    by_name["environment"].update(
        shape=f"{W}x{H}, the simple sky (HDRI: a {HDR_W}x{HDR_H} map)",
        design="one thread a ray, a kernel for each environment; the sky "
               "divides by HR and HM with div_known2 (a correctly rounded "
               "reciprocal product and one FMA correction, no MUFU), "
               "proved over all 2^32 inputs in phase 2b",
        sky_max_abs={k: v["max_abs"] for k, v in k4_256.items()
                     if k.startswith("sky")} | {
                         "1080p": k4_1080["sky"]["max_abs"]},
        hdri_max_abs={k: v["max_abs"] for k, v in k4_256.items()
                      if k.startswith("hdri")} | {
                          "1080p": k4_1080["hdri"]["max_abs"]},
        also_replaces="vpt_tpu/sky/procedural.py:44, "
                      "vpt_tpu/sky/envmap.py:36",
        max_rel_err=max(e["max_rel"] for e in (*k4_256.values(),
                                               *k4_1080.values())),
        tolerance=f"max relative error <= {K4_RTOL}",
        event_ms=k4_1080["sky"]["event_ms"],
        hdri_ms=k4_1080["hdri"]["ms"],
        hdri_plain_ms=k4_1080["hdri"]["plain_ms"],
        hdri_bound_ms=k4_1080["hdri"]["bound"][0],
        hdri_bound_by=k4_1080["hdri"]["bound"][1],
        launches_by_path={n_: r_["launches"][integrator.ENVIRONMENT.name]
                          for n_, r_ in env_runs.items()})
    for kind, k_ in (("atmosphere", integrator.ENVIRONMENT_ATMOSPHERE),
                     ("sky_cache", integrator.ENVIRONMENT_SKY_CACHE)):
        small = atm_res["k4"][f"{kind}_512x512"]
        by_name[k_.name].update(
            shape=f"{W}x{H}, config 4's K1-retired rays, tracked"
                  + (f", a {time_atmosphere.CACHE_H}x"
                     f"{time_atmosphere.CACHE_W} cache"
                     if kind == "sky_cache" else ", the half LutDims"),
            design="one thread a ray; " + (
                "its own kernel: the LUTs packed once per atmosphere as "
                "16-byte texels, scattering and single Mie in one 32-byte "
                "sector; each lookup in turn, a 4-D slice row by row; "
                "the rays in K1's order (ground and sky warps sorted "
                "measured slower); registers capped for 5 blocks of 256 "
                "an SM"
                if kind == "atmosphere" else
                "a kind of K4's environment kernel, four taps of the "
                "(H, W, 6) cache"),
            bit_share=atm_res["k4"][f"{kind}_{W}x{H}"]["bit_share"],
            tolerance="bit for bit on every ray" if kind == "atmosphere"
            else "max |diff| <= 2e-6 (the tonemapped output lies in "
                 "[0, 1])",
            at_512=dict(ms=small["ms"], plain_ms=small["plain_ms"],
                        bound_ms=small["bound"][0],
                        bound_by=small["bound"][1],
                        bit_share=small["bit_share"]))
    full_hd = atm_res["k4"][f"atmosphere_full_{W}x{H}"]
    by_name[integrator.ENVIRONMENT_ATMOSPHERE.name].update(
        ground_share=atm_res["k4"][f"atmosphere_{W}x{H}"]["ground_share"],
        schedule=atm_res["k4_atmosphere"],
        packed_luts=dict(half=atm_res["k4_pack_half"],
                         full=atm_res["k4_pack_full"]),
        at_full_dims=dict(ms=full_hd["ms"], plain_ms=full_hd["plain_ms"],
                          bound_ms=full_hd["bound"][0],
                          bound_by=full_hd["bound"][1],
                          bit_share=full_hd["bit_share"],
                          ground_share=full_hd["ground_share"]),
        earth_bit_share=atm_res["cli_earth"]["bit_share"])
    for k_, res_, alone, shape in (
            (walk.WALK_DIRECT, ref_res, ref_res["k5_alone"],
             f"{W}x{H}, the main path's scene (the 200^3 grid, one point "
             f"light, the sun, BLACK), ray_depth {time_walk.RAY_DEPTH}, "
             "one sample's rays in the reference's tiles of 16384"),
            (walk.WALK_VOLUMETRIC, vol_res, vol_res["k5_alone_sky"],
             f"{W}x{H}, the CLI's procedural scene (the 200^3 grid, no "
             f"point light), the simple sky, ray_depth "
             f"{time_walk.RAY_DEPTH}, one sample's rays")):
        by_name[k_.name].update(
            shape=shape,
            design=(("persistent warps: a lane runs one bounce of its ray "
                     "a turn and takes the next ray from a counter when "
                     "its own ends" if k_ is walk.WALK_DIRECT else
                     "a wavefront of stage kernels over compacted path "
                     "queues, per bounce: the keys, EXTEND, one NEE kernel "
                     "per light kind, SCATTER; the path state in device "
                     "buffers, queue lengths on the card, persistent "
                     "blocks") + "; the tile's keys (bounce, walk and step "
                    "keys) read from the per-tile key table, each draw "
                    "computed in the thread from its counter; "
                    "density-only and EXT instances; K4 after it for the "
                    "sky, HDRI and the atmosphere"),
            tolerance=f"share of rays agreeing >= {MIN_SHARE}, image means "
                      f"within {MAX_MEAN_REL}, and every ray bit for bit",
            parity={n_: {f: m[f] for f in ("share", "bit_share",
                                            "mean_rel", "max_abs",
                                            "plain_ms", "kernel_ms")}
                    for n_, m in res_["parity"].items()},
            parity_size=f"{time_walk.PARITY}x{time_walk.PARITY}",
            tiles_at_size={t: {f: m[f] for f in (
                "first_ray", "tile_rays", "rays", "in_box", "bit_share",
                "max_abs", "plain_ms")} for t, m in alone["tiles"].items()},
            bounces_per_ray=alone["bounces_per_ray"],
            steps_per_ray=alone["steps_per_ray"],
            sky_evals_per_ray=alone["sky_evals_per_ray"],
            launch_info=res_["launch_info"],
            library_ms_note="none exists")
    for k_ in (walk.WALK_KEYS, *walk.STAGE_KERNELS):
        alone = vol_res["k5_alone_sky"]
        by_name[k_.name].update(
            shape=f"{W}x{H}, the CLI's procedural scene, the simple sky, "
                  f"ray_depth {time_walk.RAY_DEPTH}; ms and bound per K5 "
                  "launch",
            launches_per_k5=alone["kernels"][k_.name]["launches"],
            walk_steps=alone["kernels"][k_.name]["steps"],
            point_light_512=vol_res["point"]["k5_alone"]["kernels"].get(
                k_.name),
            launch_info=vol_res["launch_info"]["ext0"][
                walk.STAGES[walk.LAUNCH_KINDS.index(k_)]],
            plain_note=("key_table_plain at 1080p on the card, the table "
                        "bit for bit" if k_ is walk.WALK_KEYS else
                        "no plain version of its own: held through "
                        "walk_volumetric's parity cases; plain_ms is "
                        "vol_integrator_plain's"),
            library_ms_note="none exists")
    by_name[walk.WALK_VOLUMETRIC.name].update(
        queues=vol_res["k5_alone_sky"]["queues"],
        hdri_cdf_512=dict(ms=vol_res["hdri_cdf"]["k5_alone"]["ms"],
                          bound_ms=vol_res["hdri_cdf"]["k5_alone"]["bound"][0],
                          bound_by=vol_res["hdri_cdf"]["k5_alone"]["bound"][1],
                          bounces_per_ray=vol_res["hdri_cdf"]["k5_alone"][
                              "bounces_per_ray"]))
    for name, shape in shapes.items():
        by_name[name]["shape"] = shape
    line["kernels"] += scene_entries
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
