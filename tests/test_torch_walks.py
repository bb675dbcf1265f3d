"""The reference engine's walks, next-event estimates and environment CDF
in vpt_tpu_torch against vpt_tpu, ray by ray on the identical tables
(scene_from_arrays) and the identical threefry draws.

Tolerances:
- the walks (delta_track, transmittance, estimate_emission) and the
  sun and point-light estimates: the share rule of test_torch_fused.py
  (>= 99% of rays agree: floats within rtol 1e-4 + atol 1e-6, flags and
  step counts exact), measured at 100%;
- estimate_sky: the same rule, with the simple sky's own rtol of 2e-3
  for its radiance (tests/test_torch_env.py: XLA's and torch's sky march
  differ by up to that in float32);
- the CDF tables from the same |value| exactly (XLA's blocked prefix
  sums reproduced), |value| within 1 ulp (XLA's CPU root is not
  correctly rounded), the map's 180^2 resample within 1e-6 relative
  (its sums run in another order); sample_env_cdf and pdf_env_cdf on the
  same tables within 1e-6 (acos/atan2/sin/cos of two libraries);
  sample_spherical and power_heuristic bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import _blob, _camera
from tests.torch_parity import jax_scene_arrays
from vpt_tpu.core import phase as j_phase
from vpt_tpu.lights.lights import PointLights
from vpt_tpu.render import nee as j_nee
from vpt_tpu.render import tracking as j_tracking
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.scene.geometry import Sphere
from vpt_tpu.scene.scene import attach_env_map, attach_sky_cdf, build_scene
from vpt_tpu.sky import cdf as j_cdf
from vpt_tpu_torch.core import phase as t_phase
from vpt_tpu_torch.render import nee as t_nee
from vpt_tpu_torch.render import tracking as t_tracking
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.scene.convert import scene_from_arrays
from vpt_tpu_torch.sky import cdf as t_cdf
from vpt_tpu_torch.tools.common import c3_map

MIN_SHARE = 0.99
RTOL, ATOL, SKY_RTOL = 1e-4, 1e-6, 2e-3
N = 1024
KEY = jax.random.PRNGKey(5)
TKEY = tuple(int(k) for k in np.asarray(KEY))
WALK = dict(max_track_steps=64, phase_g1=0.3, emission_scale=1.5,
            sky_mult=0.7, sun_color=(1.0, 0.9, 0.7), sun_mult=1.3)


def _params(**kw):
    kw = dict(WALK, **kw)
    return JParams(**kw), TParams(**kw)


def _lights(n):
    r = np.random.default_rng(n)
    return (r.uniform(-1.0, 6.0, (n, 3)).tolist(),
            r.uniform(0.3, 1.0, (n, 3)).tolist(),
            r.uniform(10.0, 60.0, n).tolist())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: the walks' small ops take as long
    on one as on eight, and the other test workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """{name: (JAX scene, port scene)}: the 24^3 blob with emission and
    color, the sphere of test_torch_fused.py in the frame, 2 point lights,
    the simple sky's CDF; the same with the c3 map and its CDF; the
    density-only blob with 12 lights (the budget of 11 bites)."""
    sph = Sphere.make(center=(3.6, 3.4, 4.0), radius=0.7)
    js = _camera(build_scene([_blob(emission=True, color=True)],
                             lights=PointLights.make(*_lights(2)),
                             sphere=sph))
    js = attach_sky_cdf(js)
    out = {"ext": js, "hdri": attach_env_map(js, c3_map(32, 64)),
           "lights12": _camera(build_scene(
               [_blob()], lights=PointLights.make(*_lights(12)),
               sphere=sph))}
    return {k: (v, scene_from_arrays(jax_scene_arrays(v), device="cpu"))
            for k, v in out.items()}


def _rays(js, n=N, seed=0):
    """Seeded rays from points in and around the root box (a quarter on
    the camera), each toward a random direction."""
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(js.root_pmin), np.asarray(js.root_pmax)
    o = r.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    o[: n // 4] = np.asarray(js.camera.origin)
    d = r.normal(size=(n, 3))
    c = (lo + hi) / 2
    d[: n // 4] = c + r.uniform(-3.0, 3.0, (n // 4, 3)) - o[: n // 4]
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _share(got, want, rtol=RTOL, exact=()):
    """Share of rays whose every output agrees: float outputs within rtol
    + ATOL, those in ``exact`` (indices) equal."""
    ok = np.ones(got[0].shape[0], bool)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if i in exact:
            same = g == w
        else:
            same = np.abs(g - w) <= ATOL + rtol * np.abs(w)
        ok &= same.reshape(same.shape[0], -1).all(-1)
    return float(ok.mean())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("walk", ["delta_track", "transmittance",
                                  "estimate_emission"])
def test_walks_ray_by_ray(scenes, walk):
    js, ts = scenes["ext"]
    jp, tp = _params()
    o, d = _rays(js)
    active = np.arange(N) % 7 != 0
    jargs = (js, jp, KEY, jnp.asarray(o), jnp.asarray(d))
    targs = (ts, tp, TKEY, torch.as_tensor(o), torch.as_tensor(d))
    if walk == "transmittance":
        want = [j_tracking.transmittance(*jargs)]
        got = [t_tracking.transmittance(*targs)]
        exact = ()
        assert 0.05 < float(np.mean(_np(want[0]))) < 0.95
    else:
        fn = walk
        want = getattr(j_tracking, fn)(*jargs, jnp.asarray(active))
        got = getattr(t_tracking, fn)(*targs, torch.as_tensor(active))
        if walk == "delta_track":
            exact = (1, 3, 5)   # interaction, hit_sphere, steps
            assert _np(want[1]).mean() > 0.03 and _np(want[3]).any()
        else:
            want, got, exact = [want], [got], ()
            assert _np(want[0]).max() > 0
    share = _share([_np(g) for g in got], [_np(w) for w in want],
                   exact=exact)
    assert share >= MIN_SHARE, share


@pytest.mark.parametrize("case", ["sun", "lights2_plain_falloff",
                                  "lights12"])
def test_sun_and_point_lights(scenes, case):
    name = "lights12" if case.startswith("lights12") else "ext"
    js, ts = scenes[name]
    jp, tp = _params(reference_falloff=not case.endswith("plain_falloff"))
    o, d = _rays(js, seed=1)
    fn = "estimate_sun" if case == "sun" else "estimate_point_lights"
    want = _np(getattr(j_nee, fn)(js, jp, KEY, jnp.asarray(o),
                                  jnp.asarray(d)))
    got = _np(getattr(t_nee, fn)(ts, tp, TKEY, torch.as_tensor(o),
                                 torch.as_tensor(d)))
    assert want.max() > 0
    assert _share([got], [want]) >= MIN_SHARE


SKY_CASES = {"constant": ("ext", dict(environment_type=int(JEnv.CONSTANT),
                                      sky_color=(0.6, 0.7, 0.9))),
             "hdri_uniform": ("hdri", dict(environment_type=int(JEnv.HDRI))),
             "hdri_cdf": ("hdri", dict(environment_type=int(JEnv.HDRI),
                                       hdri_importance=True)),
             "sky_cdf": ("ext", dict(environment_type=int(JEnv.ATMOSPHERE)))}


@pytest.mark.parametrize("case", list(SKY_CASES))
def test_estimate_sky(scenes, case):
    name, kw = SKY_CASES[case]
    js, ts = scenes[name]
    jp, tp = _params(**kw)
    assert t_nee.uses_env_cdf(ts, tp) == case.endswith("cdf")
    o, d = _rays(js, n=1024, seed=2)
    want = _np(j_nee.estimate_sky(js, jp, KEY, jnp.asarray(o),
                                  jnp.asarray(d)))
    got = _np(t_nee.estimate_sky(ts, tp, TKEY, torch.as_tensor(o),
                                 torch.as_tensor(d)))
    assert want.max() > 0 and np.isfinite(got).all()
    rtol = SKY_RTOL if case.startswith("sky") else RTOL
    assert _share([got], [want], rtol=rtol) >= MIN_SHARE
    assert abs(got.mean() / want.mean() - 1.0) <= 1e-4


def test_build_env_cdf_tables():
    """The tables from the reference's |value| bit for bit, and the port's
    |value| within 1 ulp, on a grid and a wide map (blocked prefix sums
    of 180, 64 and 512 columns)."""
    r = np.random.default_rng(0)
    for shape in ((180, 180, 3), (32, 64, 3), (256, 512, 3)):
        v = (r.random(shape).astype(np.float32) ** 4).astype(np.float32)
        want = j_cdf.build_env_cdf(jnp.asarray(v))
        tables = t_cdf.env_cdf_tables(torch.as_tensor(v),
                                      torch.as_tensor(np.asarray(want.func)))
        for f in ("cdf", "marginal_func", "marginal_cdf", "marginal_int"):
            np.testing.assert_array_equal(_np(getattr(tables, f)),
                                          _np(getattr(want, f)), err_msg=f)
        got = t_cdf.build_env_cdf(torch.as_tensor(v))
        np.testing.assert_allclose(_np(got.func), _np(want.func),
                                   rtol=2.4e-7, atol=0)


def test_build_sky_and_envmap_cdf():
    """The sky's CDF within the sky's tolerance (its values differ as
    sample_sky does); the map's resample within 1e-6 relative of its
    largest value, at 180^2 and at the map's own size."""
    want = j_cdf.build_sky_cdf(jnp.float32(150.0), jnp.float32(30.0),
                               jnp.ones(3, jnp.float32))
    got = t_cdf.build_sky_cdf(150.0, 30.0, (1.0, 1.0, 1.0), device="cpu")
    np.testing.assert_allclose(_np(got.value), _np(want.value),
                               rtol=SKY_RTOL, atol=1e-7)
    np.testing.assert_allclose(_np(got.cdf), _np(want.cdf), atol=1e-4)
    m = c3_map(256, 512)
    for res in (180, None):
        want = j_cdf.build_envmap_cdf(jnp.asarray(m), res=res)
        got = t_cdf.build_envmap_cdf(m, res=res)
        scale = float(np.abs(_np(want.value)).max())
        np.testing.assert_allclose(_np(got.value), _np(want.value),
                                   atol=1e-6 * scale, rtol=0)
        np.testing.assert_allclose(_np(got.cdf), _np(want.cdf), atol=1e-6)


def test_sample_and_pdf_env_cdf():
    want_t = j_cdf.build_sky_cdf(jnp.float32(150.0), jnp.float32(30.0),
                                 jnp.ones(3, jnp.float32))
    tables = t_cdf.EnvCDF(*(torch.as_tensor(np.asarray(getattr(want_t, f)))
                            for f in ("value", "func", "cdf",
                                      "marginal_func", "marginal_cdf",
                                      "marginal_int")))
    r = np.random.default_rng(3)
    u1, u2 = r.random((2, 4096)).astype(np.float32)
    u1[:3], u2[:3] = [0.0, 1.0 - 2 ** -24, 0.5], [0.0, 1.0 - 2 ** -24, 0.5]
    wj, pj = j_cdf.sample_env_cdf(want_t, jnp.asarray(u1), jnp.asarray(u2))
    wt, pt = t_cdf.sample_env_cdf(tables, torch.as_tensor(u1),
                                  torch.as_tensor(u2))
    np.testing.assert_allclose(_np(wt), _np(wj), atol=1e-6)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-6, atol=1e-6)
    d = r.normal(size=(4096, 3)).astype(np.float32)
    d[:3] = [[0, 1, 0], [0, -1, 0], [-1, 0.2, 0]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    qj = _np(j_cdf.pdf_env_cdf(want_t, jnp.asarray(d)))
    qt = _np(t_cdf.pdf_env_cdf(tables, torch.as_tensor(d)))
    np.testing.assert_allclose(qt, qj, rtol=1e-6, atol=1e-6 * qj.max())


def test_sample_spherical_and_power_heuristic():
    wj, pj = j_phase.sample_spherical(KEY, (4096,))
    wt, pt = t_phase.sample_spherical(TKEY, (4096,), "cpu")
    np.testing.assert_allclose(_np(wt), _np(wj), atol=2e-7)
    np.testing.assert_array_equal(_np(pt), _np(pj))
    r = np.random.default_rng(4)
    f, g = r.random((2, 4096)).astype(np.float32)
    f[:4], g[:4] = [0.0, 0.0, 1e-12, 3.0], [0.0, 1e-15, 0.0, 0.0]
    np.testing.assert_array_equal(
        _np(t_phase.power_heuristic(1.0, torch.as_tensor(f), 1.0,
                                    torch.as_tensor(g))),
        _np(j_phase.power_heuristic(1.0, jnp.asarray(f), 1.0,
                                    jnp.asarray(g))))


def test_scene_carries_env_cdf(scenes):
    """scene_from_arrays carries the reference's CDF leaves; the port's
    attach_env_map and attach_sky_cdf build their own."""
    from vpt_tpu_torch.scene.scene import attach_env_map as t_attach_map
    from vpt_tpu_torch.scene.scene import attach_sky_cdf as t_attach_sky
    js, ts = scenes["hdri"]
    np.testing.assert_array_equal(_np(ts.env_cdf.cdf), _np(js.env_cdf.cdf))
    own = t_attach_map(dataclasses.replace(ts, env_cdf=None), c3_map(32, 64))
    np.testing.assert_allclose(_np(own.env_cdf.cdf), _np(js.env_cdf.cdf),
                               atol=1e-6)
    assert t_attach_map(ts, c3_map(32, 64),
                        importance_sample=False).env_cdf is None
    sky = t_attach_sky(ts)
    assert sky.env_cdf.cdf.shape == (t_cdf.CDF_RES, t_cdf.CDF_RES)
