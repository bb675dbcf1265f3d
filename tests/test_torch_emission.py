"""Emission, color and volume_depth > 1 in the port against vpt_tpu, on
the CPU, at 24^3: the emission and color corner columns (and the
emission-safe zero band) bit for bit, the fetch of both channels, the
emission LUT on its index boundaries, fused_direct ray by ray on the c2
(emission) and c3 (color + HDRI) golden scenes and at volume_depth 2 and
3, the renderer on the c2 scene, the c3_hdri_color golden, the
depth-of-field overlay, and the LUT assets.

Scenes are built by the reference's build_scene and carried over by
scene_from_arrays, so both packages render the same tables.  The c2
scene takes an explicit non-white LUT (scene/assets.py::ramp_lut): the
blackbody EXR is not in the repository, and white would hide the LUT's
index.  Tolerances are test_torch_fused.py's: a ray agrees when L is
within rtol 1e-4 + atol 1e-6, alpha within 1e-5 and cost and unfinished
are equal; >= 99% of rays agree and the image means within 0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import BASE_KW, SPP, _blob, _camera
from tests.test_golden import GOLDEN_DIR, _compare
from tests.test_torch_env import _c3_map
from tests.test_torch_fused import _rays
from tests.torch_parity import agreement, jax_scene_arrays
from vpt_tpu.accel.shadow import attach_shadow_cache
from vpt_tpu.core.camera import Camera as JCamera
from vpt_tpu.render import film as j_film
from vpt_tpu.render import tracking as j_tracking
from vpt_tpu.render.fused import fused_direct as j_fused
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.render.renderer import ProgressiveRenderer as JRenderer
from vpt_tpu.scene import assets as j_assets
from vpt_tpu.scene.scene import attach_env_map, build_scene
from vpt_tpu.volume.grid import HostGrid
from vpt_tpu_torch.core.camera import Camera as TCamera
from vpt_tpu_torch.render import film as t_film
from vpt_tpu_torch.render import fused as t_fused
from vpt_tpu_torch.render import tracking as t_tracking
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer as TRenderer
from vpt_tpu_torch.scene import assets as t_assets
from vpt_tpu_torch.scene.convert import scene_from_arrays
from vpt_tpu_torch.scene.scene import build_scene as t_build
from vpt_tpu_torch.utils.exr import write_exr

MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
RAMP = t_assets.ramp_lut()
C2_KW = dict(BASE_KW, environment_type=int(JEnv.BLACK), emission_scale=1.5)
C3_KW = dict(BASE_KW, environment_type=int(JEnv.HDRI))


def _emission_past_density(n=24):
    """A blob whose emission reaches two voxels past its density: the
    empty boxes there must shrink (the emission-safe zero band)."""
    z, y, x = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
    dens = np.clip(1.0 - r / (n / 3.0), 0.0, 1.0).astype(np.float32)
    em = np.clip(1.0 - r / (n / 3.0 + 2.0), 0.0, 1.0).astype(np.float32)
    return HostGrid(density_zyx=dens, emission_zyx=em, color_zyx=None,
                    bbox_min=np.zeros(3, np.int32),
                    dim=np.array([n, n, n], np.int32),
                    transform=np.diag([0.2, 0.2, 0.2, 1.0]), voxel_size=0.2,
                    max_density=float(dens.max()), min_density=1e-6)


GRIDS = {"emission": lambda: _blob(emission=True),
         "color": lambda: _blob(color=True),
         "both": lambda: _blob(emission=True, color=True),
         "emission_past_density": _emission_past_density}


def _pair(js):
    return js, scene_from_arrays(jax_scene_arrays(js), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """{name: (JAX scene, port scene, params)}: the c2 and c3 golden
    scenes (the c2 one with the ramp LUT), each bare (tracked) and
    shadow-baked (cached)."""
    c2 = _camera(build_scene([_blob(emission=True)], emission_lut=RAMP))
    c3 = attach_env_map(_camera(build_scene([_blob(color=True)])),
                        _c3_map())
    out = {}
    for name, js, kw in (("c2", c2, C2_KW), ("c3", c3, C3_KW)):
        out[f"{name}_tracked"] = _pair(js) + (dict(kw,
                                                   shadow_mode="tracked"),)
        out[f"{name}_cached"] = _pair(attach_shadow_cache(js, 150.0, 30.0)) \
            + (dict(kw, shadow_mode="cached"),)
    return out


@pytest.mark.parametrize("case", list(GRIDS))
def test_corner_rows_bit_for_bit(case):
    """The emission (8) and color (24) columns, and the zero band that
    the emission's 3^3 majorant shrinks, equal the reference's bit for
    bit; so do the instance row's channel offsets."""
    g = GRIDS[case]()
    js = build_scene([g])
    ts = t_build([g], device="cpu")
    want = np.asarray(js.atlas.density_corners)
    got = ts.atlas.density_corners.numpy()
    assert got.shape == want.shape == (24 ** 3, 15 + 8 * (
        g.emission_zyx is not None) + 24 * (g.color_zyx is not None))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.instances.packed_rows.numpy(),
                                  np.asarray(js.instances.packed_rows))
    assert ts.atlas.has_emission == js.atlas.has_emission
    assert ts.atlas.has_color == js.atlas.has_color
    if case == "emission_past_density":
        bare = t_build([dataclasses.replace(g, emission_zyx=None)],
                       device="cpu").atlas.density_corners.numpy()
        shrunk = (got[:, 8] == 0) & (got[:, 9:15].sum(1)
                                     < bare[:, 9:15].sum(1))
        assert shrunk.sum() > 100


def test_fetch_channels_match_reference():
    """emission_raw, its valid flag and Cd from one row, at points in,
    around and outside the grid."""
    js, ts = _pair(build_scene([_blob(emission=True, color=True)]))
    r = np.random.default_rng(1)
    lo, hi = np.asarray(js.root_pmin), np.asarray(js.root_pmax)
    pos = r.uniform(lo - 0.5, hi + 0.5, (4096, 3)).astype(np.float32)
    d = r.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = j_tracking._unified_fetch_single(
        js, JParams(), jnp.asarray(pos), jnp.asarray(d), banded=True,
        full=True)
    got = t_tracking.unified_fetch_full(ts, TParams(), torch.as_tensor(pos),
                                        torch.as_tensor(d))
    valid = np.asarray(want.emission_valid)
    assert 0.1 < valid.mean() < 0.9
    np.testing.assert_array_equal(got.emission_valid.numpy(), valid)
    np.testing.assert_allclose(got.emission_raw.numpy(),
                               np.asarray(want.emission_raw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               rtol=1e-6, atol=1e-7)
    assert float(got.color.max()) > 0.5


def test_emission_lut_on_index_boundaries():
    """_emission_lut truncates raw * 255 / pivot (QUIRKS #15): at pivot
    0.7, on every index boundary and one float either side of it, below 0
    and past the pivot, the port's indexed load equals the reference's
    one-hot product exactly."""
    js, ts = _pair(build_scene([_blob(emission=True)], emission_lut=RAMP))
    edge = (np.arange(257, dtype=np.float32) * np.float32(0.7)
            / np.float32(255.0))
    raw = np.concatenate([edge, np.nextafter(edge, np.float32(-1)),
                          np.nextafter(edge, np.float32(2)),
                          [-1.0, -1e-30, 0.7, 0.71, 5.0]]).astype(np.float32)
    valid = np.arange(raw.size) % 7 != 3
    kw = dict(emission_pivot=0.7, emission_scale=1.5)
    want = np.asarray(j_tracking._emission_lut(
        js, JParams(**kw), jnp.asarray(raw), jnp.asarray(valid)))
    got = t_tracking._emission_lut(ts, TParams(**kw), torch.as_tensor(raw),
                                   torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want[valid], axis=0)) > 200


FUSED_CASES = [("c2_cached", 1), ("c2_tracked", 1), ("c3_cached", 1),
               ("c3_tracked", 1), ("c2_cached", 2), ("c2_tracked", 2),
               ("c2_cached", 3), ("c2_tracked", 3)]


@pytest.mark.parametrize("name,vd", FUSED_CASES,
                         ids=[f"{n}_vd{v}" for n, v in FUSED_CASES])
def test_fused_direct_ray_by_ray(scenes, name, vd):
    js, ts, kw = scenes[name]
    kw = dict(kw, volume_depth=vd)
    o, d = _rays(js)
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


def test_emission_alone_lights_c2(scenes):
    """With the sun off and no light the c2 scene is lit by its EMIT walks
    alone: black at emission_scale 0, not black at 1.5."""
    _, ts, kw = scenes["c2_tracked"]
    o, d = (torch.as_tensor(a) for a in _rays(scenes["c2_tracked"][0],
                                             n=1024, seed=2))
    L = {scale: t_fused.fused_direct(
        ts, TParams(**dict(kw, sun_mult=0.0, emission_scale=scale)), (0, 9),
        o, d)[0] for scale in (0.0, 1.5)}
    assert float(L[0.0].abs().max()) == 0.0
    assert float(L[1.5].mean()) > 0.01


def test_progressive_renderer_c2(scenes):
    """The renderers at 32x32, 4 spp, cached shadows, on the c2 scene."""
    js, ts, kw = scenes["c2_cached"]
    kw = dict(kw, width=32, height=32)
    jf = JRenderer(js, JParams(**kw)).render(4)
    tf = TRenderer(ts, TParams(**kw)).render(4)
    fields = ("accum", "alpha", "cost", "trunc")
    want = [np.asarray(getattr(jf, f)).reshape(-1, *(
        (3,) if f == "accum" else ())) for f in fields]
    got = [getattr(tf, f).numpy().reshape(w.shape)
           for f, w in zip(fields, want)]
    share, rel = agreement(got, want)
    assert share >= MIN_SHARE and rel <= MAX_MEAN_REL, (share, rel)
    assert want[0].mean() > 0
    _compare(got[0].reshape(32, 32, 3), want[0].reshape(32, 32, 3),
             label="torch-vs-jax c2")


def test_c3_hdri_color_golden(scenes):
    """The port renders the c3_hdri_color golden's scene and params and
    meets tests/test_golden.py::_compare at tol_scale 1."""
    _, ts, kw = scenes["c3_tracked"]
    golden = np.load(f"{GOLDEN_DIR}/c3_hdri_color__fused.npz")["accum"]
    img = TRenderer(ts, TParams(**kw)).render(SPP).accum.numpy()
    assert img.shape == golden.shape and np.isfinite(img).all()
    _compare(img, golden, label="torch c3_hdri_color")


def test_dof_overlay_exact():
    """dof_overlay equals the reference's uint8 image on a film whose
    depths lie before, on the edges of, inside and past the focus band."""
    r = np.random.default_rng(5)
    h, w = 24, 32
    accum = r.uniform(0.0, 3.0, (h, w, 3)).astype(np.float32)
    look = dict(lookfrom=[0.0, 1.0, 9.0], lookat=[0.0, 0.0, 0.0], vfov=40.0,
                aperture=0.5)
    jcam = JCamera.make(**look)
    tcam = TCamera.make(**look, device="cpu")
    fd, aof = float(jcam.focus_dist), 1.0 / float(jcam.lens_radius)
    depth = np.float32(fd) + r.uniform(-2.0 * aof, 2.0 * aof, (h, w)).astype(
        np.float32)
    depth[0, :4] = [fd - aof, fd + aof, 0.0, fd]
    zero = np.zeros((h, w), np.float32)
    jf = j_film.Film(accum=jnp.asarray(accum), alpha=jnp.asarray(zero),
                     depth=jnp.asarray(depth), cost=jnp.asarray(zero),
                     trunc=jnp.asarray(zero))
    tf = t_film.Film(*(torch.as_tensor(a) for a in
                       (accum, zero, depth, zero, zero)))
    want = np.asarray(j_film.dof_overlay(jf, jcam, 1.3))
    got = t_film.dof_overlay(tf, tcam, 1.3).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    band = (depth >= fd - aof) & (depth <= fd + aof)
    assert 0.2 < band.mean() < 0.8


def test_lut_assets_load_alike(tmp_path, monkeypatch):
    """Both build_scenes load the emission and density color LUTs from
    the same 256x1 EXRs (fault C5: the port used to take white)."""
    t = np.linspace(0.0, 1.0, 256, dtype=np.float32)[None]
    for name, rgb in (("blackbody_texture.exr", (t, t ** 2, t ** 4)),
                      ("density_color_texture2.exr", (1 - t, t, 0.5 + 0 * t))):
        write_exr(str(tmp_path / name), dict(zip("RGB", rgb)))
    monkeypatch.setattr(j_assets, "DEFAULT_ASSET_DIRS", [str(tmp_path)])
    monkeypatch.setattr(t_assets, "DEFAULT_ASSET_DIRS", [str(tmp_path)])
    g = _blob(n=8)
    js = build_scene([g])
    ts = t_build([g], device="cpu")
    for lut in ("emission_lut", "density_color_lut"):
        want = np.asarray(getattr(js, lut))
        np.testing.assert_array_equal(getattr(ts, lut).numpy(), want)
        assert want.shape == (256, 3) and not (want == 1.0).all()
    np.testing.assert_array_equal(ts.emission_lut.numpy()[:, 1], t[0] ** 2)
