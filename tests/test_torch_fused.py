"""The port's fused_direct and render slice against vpt_tpu's, ray by ray
on the identical tables (scene_from_arrays) and the identical threefry
draws.

Tolerances (the ones chip_smoke.py holds the CUDA kernel to): a ray
agrees when L is within rtol 1e-4 + atol 1e-6, alpha within 1e-5, and
cost and unfinished are equal; >= 99% of rays must agree (float rounding
of XLA's and torch's transcendental functions may flip a rare accept
decision and decorrelate that one ray) and the image means must agree
within 0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import _blob, _camera
from tests.test_golden import _compare
from tests.torch_parity import agreement, jax_scene_arrays
from vpt_tpu.accel.shadow import attach_shadow_cache
from vpt_tpu.lights.lights import PointLights
from vpt_tpu.render.fused import fused_direct as j_fused
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.render.renderer import ProgressiveRenderer as JRenderer
from vpt_tpu.scene.geometry import Sphere
from vpt_tpu.scene.scene import build_scene
from vpt_tpu_torch.render import fused as t_fused
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer as TRenderer
from vpt_tpu_torch.render.tracking import _sphere_block
from vpt_tpu_torch.scene.convert import scene_from_arrays

MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
CASES = {"cached_black": dict(shadow_mode="cached",
                              environment_type=int(JEnv.BLACK)),
         "tracked_constant": dict(shadow_mode="tracked",
                                  environment_type=int(JEnv.CONSTANT),
                                  sky_mult=0.4)}
BASE = dict(ray_depth=6, max_fused_steps=256, phase_g1=0.3)


@pytest.fixture(scope="module")
def scenes():
    """The 24^3 blob with one point light and the reference sphere moved
    into the frame, so rays hit it and its sun walk runs."""
    lights = PointLights.make([[3.0, 4.0, 5.0]], [[1.0, 0.9, 0.8]], [40.0])
    js = _camera(build_scene([_blob()], lights=lights,
                             sphere=Sphere.make(center=(3.6, 3.4, 4.0),
                                                radius=0.7)))
    js = attach_shadow_cache(js, 150.0, 30.0)
    return js, scene_from_arrays(jax_scene_arrays(js), device="cpu")


def _rays(js, n=2048, seed=0):
    r = np.random.default_rng(seed)
    c = (np.asarray(js.root_pmin) + np.asarray(js.root_pmax)) / 2
    o = np.tile(np.asarray(js.camera.origin)[None], (n, 1)).astype(np.float32)
    d = c + r.uniform(-3.0, 3.0, (n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_direct_ray_by_ray(scenes, case):
    js, ts = scenes
    kw = dict(BASE, **CASES[case])
    o, d = _rays(js)
    hit, _ = _sphere_block(ts, torch.as_tensor(o), torch.as_tensor(d))
    assert int(hit.sum()) > 20             # the sphere branch runs
    key = jax.random.PRNGKey(3)
    want = [np.asarray(x) for x in
            j_fused(js, JParams(**kw), key, jnp.asarray(o), jnp.asarray(d))]
    got = [x.numpy() for x in t_fused.fused_direct(
        ts, TParams(**kw), tuple(int(k) for k in np.asarray(key)),
        torch.as_tensor(o), torch.as_tensor(d))]
    assert want[0].mean() > 0 and want[2].mean() > 1
    share, rel = agreement(got, want)
    assert share >= MIN_SHARE, share
    assert rel <= MAX_MEAN_REL, rel
    np.testing.assert_array_equal(got[3], want[3])


def test_slice_progressive_renderer(scenes):
    """JAX ProgressiveRenderer against the port's at 32x32, 4 spp,
    ray_depth 4, cached shadows (the bench's north-star mode)."""
    js, ts = scenes
    kw = dict(width=32, height=32, ray_depth=4, max_fused_steps=256,
              shadow_mode="cached", environment_type=int(JEnv.BLACK))
    jf = JRenderer(js, JParams(**kw)).render(4)
    tr = TRenderer(ts, TParams(**kw))
    tf = tr.render(4)
    assert tr.iteration == 4
    want = {f.name: np.asarray(getattr(jf, f.name))
            for f in dataclasses.fields(jf)}
    got = {k: getattr(tf, k).numpy() for k in want}
    share, rel = agreement(
        (got["accum"].reshape(-1, 3), got["alpha"].reshape(-1),
         got["cost"].reshape(-1), got["trunc"].reshape(-1)),
        (want["accum"].reshape(-1, 3), want["alpha"].reshape(-1),
         want["cost"].reshape(-1), want["trunc"].reshape(-1)))
    assert share >= MIN_SHARE, share
    assert rel <= MAX_MEAN_REL, rel
    assert want["accum"].mean() > 0
    _compare(got["accum"], want["accum"], label="torch-vs-jax slice")
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4,
                               atol=1e-4)
    img = tr.display_image()
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8


def test_out_of_slice_options_raise(scenes):
    _, ts = scenes
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3)) / np.sqrt(3.0)
    for kw in (dict(use_majorant=False), dict(integrator=1),
               dict(rays_per_lane=4), dict(engine="reference"),
               dict(jitter="bluenoise")):
        with pytest.raises(NotImplementedError):
            t_fused.fused_direct(ts, TParams(**kw), (0, 1), o, d)


def test_cached_without_bake_raises():
    bare = scene_from_arrays(jax_scene_arrays(build_scene(
        [_blob()], lights=PointLights.make([[3.0, 4.0, 5.0]], [[1, 1, 1]],
                                           [5.0]))), device="cpu")
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        t_fused.fused_direct(bare, TParams(shadow_mode="cached",
                                           environment_type=2), (0, 1),
                             o, o + 1.0)
