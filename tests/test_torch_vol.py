"""The reference engine's direct integrator and the volumetric
integrator in vpt_tpu_torch against vpt_tpu: a tile of 16384 rays ray by
ray, the renderer's tiles against the reference's tile keys, and the
reference engine's c3, c4 and c5 goldens.

Tolerances: the share rule of test_torch_fused.py (>= 99% of rays agree:
L within rtol 1e-4 + atol 1e-6, alpha within 1e-5, cost and trunc
exact; image means within 0.5%), with the simple sky's rtol of 2e-3 for
L under the sky (test_torch_env.py: the two sky marches differ by up to
that), not met here: the sky's estimate is held in test_torch_walks.py;
the goldens by tests/test_golden.py::_compare at its own
tolerance (mean |error| below 0.5% of the golden's mean, correlation
above 0.995).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import BASE_KW, SPP, _blob, _camera
from tests.test_golden import GOLDEN_DIR, _compare
from tests.torch_parity import agreement, jax_scene_arrays
from vpt_tpu.lights.lights import PointLights
from vpt_tpu.render.integrator import direct_integrator as j_direct
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.render.vol_integrator import vol_integrator as j_vol
from vpt_tpu.scene.geometry import Sphere
from vpt_tpu.scene.scene import attach_env_map, build_scene
from vpt_tpu_torch.render import renderer as t_renderer
from vpt_tpu_torch.render.integrator import direct_integrator
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.render.vol_integrator import vol_integrator
from vpt_tpu_torch.scene.convert import scene_from_arrays
from vpt_tpu_torch.tools.common import c3_map

MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
TILE = 16384
KEY = jax.random.PRNGKey(11)
TKEY = tuple(int(k) for k in np.asarray(KEY))
BASE = dict(ray_depth=4, max_track_steps=64, phase_g1=0.3,
            emission_scale=1.5)
CASES = {
    # volume_depth 2 (EXT's scatter-and-march-on), point lights, the
    # sphere's shading and its sun walk, emission and color, CONSTANT
    "direct": ("direct", dict(volume_depth=2,
                              environment_type=int(JEnv.CONSTANT),
                              sky_mult=0.4)),
    # the three-way light pick, the sky's MIS through the map's CDF
    "volumetric_hdri_cdf": ("volumetric",
                            dict(environment_type=int(JEnv.HDRI),
                                 hdri_importance=True, ray_depth=3)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the walks' small ops take as long
    on one as on eight, and the other test workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    lights = PointLights.make([[3.0, 4.0, 5.0], [0.5, 5.0, 1.0]],
                              [[1.0, 0.9, 0.8], [0.4, 0.6, 1.0]],
                              [40.0, 25.0])
    js = _camera(build_scene([_blob(emission=True, color=True)],
                             lights=lights,
                             sphere=Sphere.make(center=(3.6, 3.4, 4.0),
                                                radius=0.7)))
    js = attach_env_map(js, c3_map(32, 64))
    return js, scene_from_arrays(jax_scene_arrays(js), device="cpu")


def _tile(js, n=TILE, seed=0):
    """A tile of primary-like rays from the camera over the root box."""
    r = np.random.default_rng(seed)
    c = (np.asarray(js.root_pmin) + np.asarray(js.root_pmax)) / 2
    o = np.tile(np.asarray(js.camera.origin)[None], (n, 1)).astype(
        np.float32)
    d = c + r.uniform(-3.0, 3.0, (n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_integrator_tile_ray_by_ray(scene, case):
    js, ts = scene
    kind, kw = CASES[case]
    kw = dict(BASE, **kw)
    o, d = _tile(js)
    j_fn, t_fn = ((j_direct, direct_integrator) if kind == "direct"
                  else (j_vol, vol_integrator))
    L, alpha, aux = j_fn(js, JParams(**kw), KEY, jnp.asarray(o),
                         jnp.asarray(d))
    want = [np.asarray(x) for x in (L, alpha, aux["cost"], aux["trunc"],
                                    aux["depth"])]
    got = [x.numpy() for x in t_fn(ts, TParams(**kw), TKEY,
                                   torch.as_tensor(o), torch.as_tensor(d))]
    assert want[0].mean() > 0 and want[2].mean() > 1
    share, rel = agreement(got, want)
    assert share >= MIN_SHARE, share
    assert rel <= MAX_MEAN_REL, rel
    np.testing.assert_allclose(got[4], want[4], rtol=1e-4, atol=1e-4)


def _tiles_kw():
    return dict(BASE, width=16, height=16, fused_tile=100,
                engine="reference", environment_type=int(JEnv.CONSTANT),
                sky_mult=0.4)


@pytest.mark.parametrize("integrator", [0, 1])
def test_renderer_tiles_are_the_reference_tiles(scene, integrator):
    """A sample of the reference engine (or the volumetric integrator)
    across tile boundaries (fused_tile 100 on a 16x16 frame: two tiles
    and a short one) is the integrator on each tile of fused_tile rays
    under fold_in(split(key)[1], 1000 + t), the reference's tile keys
    (vpt_tpu/render/renderer.py:276-281), bit for bit; each tile's
    integrator is held against the reference above."""
    from vpt_tpu_torch.core import rng
    _, ts = scene
    tp = TParams(**dict(_tiles_kw(), integrator=integrator))
    key = rng.render_key(0, 3)
    L, alpha, aux = t_renderer.render_rays(ts, tp, key)
    o, d = t_renderer.primary_rays(ts.camera, tp, key)
    trace_key = rng.split(key)[1]
    run = vol_integrator if integrator else direct_integrator
    parts = [run(ts, tp, rng.fold_in(trace_key, 1000 + t), o[a:a + 100],
                 d[a:a + 100])
             for t, a in enumerate(range(0, 256, 100))]
    np.testing.assert_array_equal(L.reshape(-1, 3).numpy(),
                                  torch.cat([p[0] for p in parts]).numpy())
    np.testing.assert_array_equal(aux["cost"].reshape(-1).numpy(),
                                  torch.cat([p[2] for p in parts]).numpy())
    assert float(L.mean()) > 0


def _golden_scene(name):
    """The reference's c3, c4 or c5 golden scene and params, as
    tests/golden_scenes.py builds them (c3's map is c3_map(32, 64))."""
    from vpt_tpu.render.params import RenderParams
    if name == "c3_hdri_color":
        s = attach_env_map(_camera(build_scene([_blob(color=True)])),
                           c3_map(32, 64))
        env = JEnv.HDRI
    elif name == "c4_procedural_sky":
        s, env = _camera(build_scene([_blob()])), JEnv.ATMOSPHERE
    else:
        ids, xforms = [], []
        rng = np.random.RandomState(3)
        for i in range(27):
            iz, iy, ix = np.unravel_index(i, (3, 3, 3))
            xf = np.diag([0.2, 0.2, 0.2, 1.0])
            xf[3, :3] = (np.array([ix, iy, iz], np.float64) * 4.0
                         + rng.uniform(-1, 1, 3))
            ids.append(0)
            xforms.append(xf)
        s = _camera(build_scene([_blob(n=12)], instance_grid_ids=ids,
                                instance_xforms=xforms))
        env = JEnv.CONSTANT
    return s, RenderParams(environment_type=int(env), **BASE_KW)


@pytest.mark.parametrize("name", ["c3_hdri_color", "c4_procedural_sky",
                                  "c5_instanced"])
def test_reference_engine_golden(name):
    """The port's reference engine on the golden scenes, carried from the
    reference's build, against the reference engine's goldens."""
    golden = np.load(os.path.join(GOLDEN_DIR,
                                  f"{name}__reference.npz"))["accum"]
    js, jp = _golden_scene(name)
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    tp = TParams(**{f.name: getattr(jp, f.name)
                    for f in dataclasses.fields(TParams)}).replace(
                        engine="reference")
    film = t_renderer.ProgressiveRenderer(ts, tp).render(SPP)
    _compare(film.accum.numpy(), golden, label=f"torch reference/{name}")


def test_engine_options():
    """The renderer takes both engines with either integrator; the march
    engine still raises, and fused_direct still refuses what is not its
    own (test_torch_fused.py)."""
    from vpt_tpu_torch.render.params import check_fused, check_slice
    for kw in (dict(engine="reference"), dict(integrator=1),
               dict(engine="reference", integrator=1)):
        check_slice(TParams(**kw))
        with pytest.raises(NotImplementedError):
            check_fused(TParams(**kw))
    with pytest.raises(NotImplementedError):
        check_slice(TParams(engine="march"))
    with pytest.raises(ValueError):
        check_slice(TParams(integrator=2))
