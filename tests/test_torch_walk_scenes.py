"""The reference engine's direct integrator and the volumetric integrator
in vpt_tpu_torch against vpt_tpu, ray by ray, on every scene and sky that
kernel K5 takes beyond a single grid in float32 rows without octant
columns (csrc/walk.cuh's scene kinds SC_CELLS, SC_LOOP, SC_BF16 and the
sky kinds SKY_ATMOSPHERE, SKY_CACHE), both integrators on each:

- an instanced scene with cell lists: 12 of the c5 golden's instances
  (tools/common.py::golden_c5_instances) of the 12^3 blob at R 16,
  density-only and with emission and color;
- an instanced scene without lists (the static loop): 4 instances of two
  grids, one with emission and color;
- a single grid in bfloat16 rows with the octant columns, with emission
  and color (EXT; volume_depth 2 for the direct integrator), under the
  Bruneton atmosphere on the golden tiny LUTs (no precompute runs), live
  and baked (a 32 x 64 sky cache), as the bench builds config 4: the
  volumetric integrator's sky estimate and both terminal lookups.

The reference builds each scene, scene_from_arrays carries it over, so
both packages walk the same tables; a 12 x 12 frame's worth of rays
(144) from the camera over the root box, ray_depth 4.

Tolerances: torch_parity.agreement's (a ray agrees when L is within rtol
1e-4 + atol 1e-6, alpha within 1e-5, cost and trunc equal; at least 99%
of rays agree and the image means lie within 0.5%), as test_torch_vol.py
and test_torch_walks.py hold the integrators; under ATMOSPHERE L's rtol
is test_torch_atmosphere.py's SKY_RTOL (2e-3): the simple sky's two
marches differ by up to that (test_torch_env.py), and so does the
Bruneton runtime from the reference's packed LUT corners; the same share
and mean rule; the live atmosphere by test_torch_atmosphere.py's rule
for a view that sees the ground at grazing angles, where the aerial
perspective amplifies the LUT corners' last bits (its NEE samples every
direction): at least LIVE_SHARE (85%) of rays within LIVE_RTOL (5e-2)
and within SKY_RTOL, the image means within LIVE_MEAN (0.5%).  The depth
AOV within rtol 1e-4 + atol 1e-4, as test_torch_vol.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import _blob, _camera
from tests.test_torch_atmosphere import (GOLDEN_LUTS, J_TINY, LIVE_MEAN,
                                         LIVE_RTOL, LIVE_SHARE, SKY_RTOL)
from tests.torch_parity import agreement, jax_scene_arrays
from vpt_tpu.lights.lights import PointLights as JLights
from vpt_tpu.render.integrator import direct_integrator as j_direct
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.render.vol_integrator import vol_integrator as j_vol
from vpt_tpu.scene import scene as j_scene
from vpt_tpu_torch.render import walk
from vpt_tpu_torch.render.integrator import direct_integrator
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.render.vol_integrator import vol_integrator
from vpt_tpu_torch.scene.assets import ramp_lut
from vpt_tpu_torch.scene.convert import scene_from_arrays
from vpt_tpu_torch.tools.common import golden_c5_instances

MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
N_RAYS = 144
KEY = jax.random.PRNGKey(17)
TKEY = tuple(int(k) for k in np.asarray(KEY))
BASE = dict(ray_depth=4, max_track_steps=64, phase_g1=0.3,
            emission_scale=1.5, azimuth=150.0, elevation=30.0)
LIGHTS = ([[3.0, 5.0, 4.0]], [[1.0, 1.0, 1.0]], [40.0])
# {case: (walk.cuh's scene kind, its sky kind for the volumetric
# integrator, the params beyond BASE)}
CASES = {
    "cells": (walk.SC_CELLS, walk.SKY_RUNTIME,
              dict(environment_type=int(JEnv.CONSTANT), sky_mult=0.4)),
    "cells_ext": (walk.SC_CELLS, walk.SKY_RUNTIME,
                  dict(environment_type=int(JEnv.ATMOSPHERE))),
    "loop": (walk.SC_LOOP, walk.SKY_RUNTIME,
             dict(environment_type=int(JEnv.CONSTANT), sky_mult=0.4)),
    "bf16_ext_atmosphere": (walk.SC_BF16, walk.SKY_ATMOSPHERE,
                            dict(environment_type=int(JEnv.ATMOSPHERE))),
    "bf16_ext_sky_cache": (walk.SC_BF16, walk.SKY_CACHE,
                           dict(environment_type=int(JEnv.ATMOSPHERE))),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the walks' small ops take as long
    on one as on eight, and the other test workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(case):
    """CASES[case]'s scene, built by the reference and framed as the
    goldens frame theirs."""
    lights = JLights.make(*LIGHTS)
    if case.startswith("cells"):
        ext = case.endswith("_ext")
        ids, xforms = golden_c5_instances()
        return _camera(j_scene.build_scene(
            [_blob(n=12, emission=ext, color=ext)], instance_grid_ids=ids[:12],
            instance_xforms=xforms[:12], majorant_resolution=16,
            lights=lights, emission_lut=ramp_lut()))
    if case == "loop":
        xforms = []
        for i in range(4):
            xf = np.diag([0.2, 0.2, 0.2, 1.0])
            xf[3, :3] = (1.5 * i, 0.4 * (i % 3), 0.0)
            xforms.append(xf)
        return _camera(j_scene.build_scene(
            [_blob(n=10, emission=True, color=True), _blob(n=8)],
            instance_grid_ids=[0, 1, 0, 1], instance_xforms=xforms,
            majorant_resolution=16, lights=lights, emission_lut=ramp_lut()),
            dist_scale=0.8)
    js = j_scene.attach_atmosphere(_camera(j_scene.build_scene(
        [_blob(n=16, emission=True, color=True)], lights=lights,
        emission_lut=ramp_lut(), majorant_resolution=0, octant_boxes=True,
        corner_dtype="bfloat16")), cache_path=GOLDEN_LUTS, dims=J_TINY)
    if case.endswith("sky_cache"):
        js = j_scene.attach_sky_cache(js, 150.0, 30.0, 32, 64)
    return js


@pytest.fixture(scope="module")
def scenes():
    """{case: (the reference's scene, the port's)}, each built on first
    use and kept for the module."""
    class _Scenes(dict):
        def __missing__(self, case):
            js = _build(case)
            self[case] = (js, scene_from_arrays(jax_scene_arrays(js),
                                                device="cpu"))
            return self[case]
    return _Scenes()


def _rays(js, n=N_RAYS, seed=3):
    """n rays from the camera toward the root box, spread over it."""
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(js.root_pmin), np.asarray(js.root_pmax)
    o = np.tile(np.asarray(js.camera.origin)[None], (n, 1)).astype(np.float32)
    d = (lo + hi) / 2 + r.uniform(-0.45, 0.45, (n, 3)) * (hi - lo) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("integrator", ["direct", "volumetric"])
@pytest.mark.parametrize("case", list(CASES))
def test_walk_ray_by_ray(scenes, case, integrator):
    js, ts = scenes[case]
    sc, sky, kw = CASES[case]
    volumetric = integrator == "volumetric"
    kw = dict(BASE, **kw)
    if "_ext" in case and not volumetric:
        kw["volume_depth"] = 2
    tp = TParams(**kw)
    assert walk.scene_kind(ts) == sc
    assert walk.sky_kind(ts, tp, volumetric) == (sky if volumetric
                                                 else walk.SKY_RUNTIME)
    o, d = _rays(js)
    j_fn, t_fn = ((j_vol, vol_integrator) if volumetric
                  else (j_direct, direct_integrator))
    L, alpha, aux = j_fn(js, JParams(**kw), KEY, jnp.asarray(o),
                         jnp.asarray(d))
    want = [np.asarray(x) for x in (L, alpha, aux["cost"], aux["trunc"],
                                    aux["depth"])]
    got = [x.numpy() for x in t_fn(ts, tp, TKEY, torch.as_tensor(o),
                                   torch.as_tensor(d))]
    assert want[0].mean() > 0 and want[2].mean() > 1
    if sky == walk.SKY_ATMOSPHERE:
        # the live atmosphere's ground at grazing angles (its NEE samples
        # every direction): test_torch_atmosphere.py's rule for it
        share, rel = agreement(got, want, rtol=LIVE_RTOL)
        assert share >= LIVE_SHARE and rel <= LIVE_MEAN, (share, rel)
        share, _ = agreement(got, want, rtol=SKY_RTOL)
        assert share >= LIVE_SHARE, share
    else:
        rtol = (SKY_RTOL if kw["environment_type"] == int(JEnv.ATMOSPHERE)
                else 1e-4)
        share, rel = agreement(got, want, rtol=rtol)
        assert share >= MIN_SHARE, share
        assert rel <= MAX_MEAN_REL, rel
    np.testing.assert_allclose(got[4], want[4], rtol=1e-4, atol=1e-4)


def test_scene_kinds_of_the_cases(scenes):
    """The carried scenes are the kinds they stand for: cell lists with
    their slots, the loop's packed rows with the octant columns, bfloat16
    rows with the 72 octant columns and emission, the golden tiny LUTs and
    the cache."""
    ts = scenes["cells"][1]
    assert ts.majorant.cell_instances is not None and ts.instances.count == 12
    ts = scenes["loop"][1]
    assert ts.majorant.cell_instances is None
    assert ts.majorant.packed.shape[1] == 79
    ts = scenes["bf16_ext_sky_cache"][1]
    assert ts.atlas.density_corners.dtype == torch.bfloat16
    assert ts.atlas.octant_cols == 72 and ts.atlas.has_emission
    assert ts.atmosphere is not None
    assert tuple(ts.sky_cache.shape) == (32, 64, 6)
