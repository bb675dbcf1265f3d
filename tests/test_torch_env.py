"""The port's terminal environments against vpt_tpu's, on the CPU: the
simple sky, the equirect map lookup, environment_radiance in all four
cases, the .hdr reader, the fused engine ray by ray on a sky scene and an
HDRI scene, and the c4_procedural_sky golden.

Tolerances, set from the spread measured on a CPU (torch against XLA):
- sample_sky: median relative error 4e-6, 99th percentile 2e-4, the
  largest 6.4e-4.  The model subtracts numbers of 4e13 in float32
  (|pos|^2 - R^2 in the sphere tests) and takes the near root of a
  quadratic by cancellation (-b - sqrt(disc), ~1e7 each, for ~1e3 m), so
  one last-bit difference in a product (XLA may contract a multiply-add)
  moves the result by up to ~1e-3 relative.  Held: every direction
  within 2e-3 relative, 90% within 1e-4, the mean within 1e-5.
- sample_env_map: atan2 and acos differ in the last bit between the two
  libraries, which moves the bilinear weights: within 2e-5 relative
  plus 2e-5 absolute (the c3 map's gradient, and its hot texel of 40:
  3.4e-5 absolute, 5.3e-6 relative measured there), bit-equal on a
  majority of directions.
- the fused engine: the share rule of test_torch_fused.py (a ray agrees
  when L is within rtol 1e-4 + atol 1e-6 ...), with the sky's rtol of
  2e-3 for L in the sky scene, where every ray that leaves the volume
  adds the sky.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import BASE_KW, SPP, _blob, _camera
from tests.test_golden import GOLDEN_DIR, _compare
from tests.torch_parity import agreement, jax_scene_arrays
from vpt_tpu.render import integrator as j_integrator
from vpt_tpu.render.fused import fused_direct as j_fused
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.scene.scene import attach_env_map as j_attach_env_map
from vpt_tpu.scene.scene import build_scene
from vpt_tpu.sky import envmap as j_envmap
from vpt_tpu.sky import procedural as j_sky
from vpt_tpu.utils import hdr as j_hdr
from vpt_tpu_torch.render import fused as t_fused
from vpt_tpu_torch.render import integrator as t_integrator
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer as TRenderer
from vpt_tpu_torch.scene.convert import scene_from_arrays, scene_to_arrays
from vpt_tpu_torch.sky import envmap as t_envmap
from vpt_tpu_torch.sky import procedural as t_sky
from vpt_tpu_torch.utils import hdr as t_hdr

SKY_RTOL, SKY_RTOL_90, SKY_MEAN_RTOL = 2e-3, 1e-4, 1e-5
ENV_TOL = 2e-5
MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
SKY_COLOR = (1.0, 0.9, 0.8)


def _c3_map():
    """The c3_hdri_color golden's map (tests/golden_scenes.py:73-77): a
    vertical gradient with one hot texel."""
    eh, ew = 32, 64
    ty = np.linspace(1.0, 0.0, eh, dtype=np.float32)[:, None, None]
    env = (np.array([0.3, 0.5, 1.0], np.float32) * ty
           + np.array([0.9, 0.6, 0.3], np.float32) * (1.0 - ty))
    env = np.broadcast_to(env, (eh, ew, 3)).copy()
    env[eh // 4, ew // 3] = [40.0, 38.0, 30.0]
    return env


def _directions(n=4096, seed=0):
    """Seeded unit directions with the special cases planted: straight up
    and down, the horizon, below it, and the u seam (z = 0, x < 0, where
    atan2 turns from +pi to -pi)."""
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0.05, 1], [0, -0.3, 1],
             [-1, 0.2, 0], [-1, 0.2, 1e-7], [-1, 0.2, -1e-7]]
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def sky_reference():
    d = _directions()
    want = np.asarray(j_sky.sample_sky(jnp.asarray(d), 150.0, 30.0,
                                       jnp.asarray(SKY_COLOR, jnp.float32)))
    return d, want


def _check_sky(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert rel.max() <= SKY_RTOL, rel.max()
    assert np.mean(rel.max(axis=-1) <= SKY_RTOL_90) >= 0.9
    assert abs(got.mean() / want.mean() - 1.0) <= SKY_MEAN_RTOL


def test_sample_sky_matches_reference(sky_reference):
    d, want = sky_reference
    got = t_sky.sample_sky(torch.as_tensor(d), 150.0, 30.0,
                           torch.tensor(SKY_COLOR)).numpy()
    assert np.isfinite(got).all() and want.min() > 0
    _check_sky(got, want)


def test_sky_miss_is_red():
    """A ray that misses the atmosphere reads the reference's RED
    sentinel; from the observer every unit direction hits it, so a NaN
    direction (whose sphere test fails) stands for the miss."""
    nan = [[float("nan")] * 3]
    got = t_sky.sample_sky(torch.tensor(nan), 150.0, 30.0, torch.ones(3))
    want = j_sky.sample_sky(jnp.asarray(nan, jnp.float32), 150.0, 30.0,
                            jnp.ones(3))
    np.testing.assert_array_equal(got.numpy(), [t_sky.RED])
    np.testing.assert_array_equal(np.asarray(want), [t_sky.RED])


def test_sample_env_map_matches_reference():
    env = _c3_map()
    d = _directions()
    got = t_envmap.sample_env_map(torch.as_tensor(env),
                                  torch.as_tensor(d)).numpy()
    for packed in (j_envmap.pack_env_map(env), jnp.asarray(env)):
        want = np.asarray(j_envmap.sample_env_map(packed, jnp.asarray(d)))
        np.testing.assert_allclose(got, want, rtol=ENV_TOL, atol=ENV_TOL)
        assert np.mean(np.all(got == want, axis=-1)) > 0.5
    u, _ = t_envmap.env_uv(torch.as_tensor(d[5:8]))
    assert float(u.min()) < 0.01 and float(u.max()) > 0.99  # the seam


@pytest.mark.parametrize("env", ["black", "constant", "hdri", "hdri_no_map",
                                 "atmosphere"])
def test_environment_radiance_matches_reference(env, sky_reference):
    d = sky_reference[0][:512]
    et = dict(black=JEnv.BLACK, constant=JEnv.CONSTANT, hdri=JEnv.HDRI,
              hdri_no_map=JEnv.HDRI, atmosphere=JEnv.ATMOSPHERE)[env]
    kw = dict(environment_type=int(et), sky_color=SKY_COLOR, sky_mult=0.7,
              azimuth=150.0, elevation=30.0)
    m = _c3_map() if env == "hdri" else None
    js = types.SimpleNamespace(
        env_map=None if m is None else j_envmap.pack_env_map(m),
        atmosphere=None)
    ts = types.SimpleNamespace(
        env_map=None if m is None else torch.as_tensor(m), atmosphere=None)
    want = np.asarray(j_integrator.environment_radiance(
        js, JParams(**kw), jnp.asarray(d), jnp.asarray(d)))
    got = t_integrator.environment_radiance(
        ts, TParams(**kw), torch.as_tensor(d), torch.as_tensor(d)).numpy()
    assert got.shape == want.shape == (512, 3)
    if env == "atmosphere":
        _check_sky(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=ENV_TOL, atol=ENV_TOL)
    # the CPU wrapper of K4 is the plain version: L + env * beta
    beta = np.random.default_rng(1).uniform(0, 1, (512, 3)).astype(
        np.float32)
    L = torch.ones((512, 3))
    out = t_integrator.add_environment(ts, TParams(**kw), L,
                                       torch.as_tensor(beta),
                                       torch.as_tensor(d))
    assert torch.equal(out, L + torch.as_tensor(got) * torch.as_tensor(
        beta))


def test_bruneton_atmosphere_raises():
    """An attached atmosphere that is not sky/runtime.py's Atmosphere is
    refused (the Bruneton atmosphere itself: tests/test_torch_
    atmosphere.py)."""
    ts = types.SimpleNamespace(env_map=None, atmosphere=object())
    d = torch.tensor([[0.0, 1.0, 0.0]])
    with pytest.raises(TypeError, match="Atmosphere"):
        t_integrator.environment_radiance(ts, TParams(), d, d)


def _write_old_rle(path, rgbe, repeat_at, count):
    """A flat .hdr whose first scanline repeats pixel repeat_at - 1 by an
    old-style (1, 1, 1, count) marker at column repeat_at."""
    h, w = rgbe.shape[:2]
    body = bytearray()
    for y in range(h):
        if y == 0:
            body += rgbe[0, :repeat_at].tobytes() + bytes([1, 1, 1, count])
            body += rgbe[0, repeat_at + count:].tobytes()
        else:
            body += rgbe[y].tobytes()
    with open(path, "wb") as f:
        f.write(f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
                .encode() + bytes(body))


@pytest.mark.parametrize("kind", ["flat", "rle", "old_rle"])
def test_load_hdr_matches_reference(tmp_path, kind):
    img = np.random.default_rng(2).uniform(0, 8, (7, 37, 3)).astype(
        np.float32)
    img[3, 5:20] = [2.0, 1.0, 0.5]          # a run for the RLE encoders
    path = str(tmp_path / f"{kind}.hdr")
    if kind == "old_rle":
        img[0, 5:12] = img[0, 4]            # 7 repeats of pixel 4
        _write_old_rle(path, t_hdr.float_to_rgbe(img), 5, 7)
    else:
        t_hdr.write_hdr(path, img, rle=kind == "rle")
    got, want = t_hdr.load_hdr(path), j_hdr.load_hdr(path)
    assert got.shape == (7, 37, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # RGBE keeps 8 mantissa bits of the largest component
    np.testing.assert_allclose(got, img, rtol=0, atol=img.max() / 128)


def test_load_hdr_rejects_overrunning_repeat(tmp_path):
    """An old-style repeat longer than the rest of its scanline: the
    reference reads the file out of step without a word; the port
    raises."""
    img = np.random.default_rng(3).uniform(0, 4, (3, 10, 3))
    path = str(tmp_path / "bad.hdr")
    rgbe = t_hdr.float_to_rgbe(img)
    _write_old_rle(path, rgbe, 8, 2)        # fills the row exactly: fine
    np.testing.assert_array_equal(t_hdr.load_hdr(path), j_hdr.load_hdr(path))
    with open(path, "rb") as f:
        data = bytearray(f.read())
    at = data.index(bytes([1, 1, 1, 2]))
    data[at + 3] = 9                        # 9 repeats at column 8 of 10
    with open(path, "wb") as f:
        f.write(bytes(data))
    j_hdr.load_hdr(path)                    # no error in the reference
    with pytest.raises(ValueError, match="overruns"):
        t_hdr.load_hdr(path)


def _scene_pair(kind):
    """The c4_procedural_sky scene (tests/golden_scenes.py) or the blob
    lit by the c3 map, with no color channel, and their params."""
    js = _camera(build_scene([_blob()]))
    if kind == "hdri":
        js = j_attach_env_map(js, _c3_map())
        et = JEnv.HDRI
    else:
        et = JEnv.ATMOSPHERE
    kw = dict(BASE_KW, environment_type=int(et))
    return js, scene_from_arrays(jax_scene_arrays(js), device="cpu"), kw


@pytest.mark.parametrize("kind", ["sky", "hdri"])
def test_fused_direct_env_ray_by_ray(kind):
    js, ts, kw = _scene_pair(kind)
    if kind == "hdri":
        np.testing.assert_array_equal(ts.env_map.numpy(), _c3_map())
    n = 2048
    r = np.random.default_rng(4)
    c = (np.asarray(js.root_pmin) + np.asarray(js.root_pmax)) / 2
    o = np.tile(np.asarray(js.camera.origin)[None], (n, 1)).astype(
        np.float32)
    d = c + r.uniform(-4.0, 4.0, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = [np.asarray(x) for x in j_fused(
        js, JParams(**kw), key, jnp.asarray(o), jnp.asarray(d))]
    got = [x.numpy() for x in t_fused.fused_direct(
        ts, TParams(**kw), tuple(int(k) for k in np.asarray(key)),
        torch.as_tensor(o), torch.as_tensor(d))]
    assert want[0].mean() > 0 and want[2].mean() > 1
    share, rel = agreement(got, want,
                           rtol=SKY_RTOL if kind == "sky" else 1e-4)
    assert share >= MIN_SHARE, share
    assert rel <= MAX_MEAN_REL, rel
    np.testing.assert_array_equal(got[3], want[3])


def test_c4_procedural_sky_golden():
    """The port renders the c4_procedural_sky golden's scene and params
    (32x32, 8 spp) and meets tests/test_golden.py::_compare at the
    tol_scale test_torch_fused.py uses (1)."""
    _, ts, kw = _scene_pair("sky")
    golden = np.load(f"{GOLDEN_DIR}/c4_procedural_sky__fused.npz")["accum"]
    img = TRenderer(ts, TParams(**kw)).render(SPP).accum.numpy()
    assert img.shape == golden.shape and np.isfinite(img).all()
    _compare(img, golden, label="torch c4_procedural_sky")


def test_env_map_round_trips_through_arrays():
    _, ts, _ = _scene_pair("hdri")
    back = scene_from_arrays(scene_to_arrays(ts), device="cpu")
    assert torch.equal(back.env_map, ts.env_map)
    bare = dataclasses.replace(ts, env_map=None)
    assert "env_map" not in scene_to_arrays(bare)
