"""The port's core math against vpt_tpu's, elementwise on random inputs
made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.core import camera as jcam
from vpt_tpu.core import phase as jphase
from vpt_tpu.core import tonemap as jtone
from vpt_tpu.core import vecmath as jvec
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.scene.geometry import _sphere_roots as j_sphere_roots
from vpt_tpu_torch.core import camera as tcam
from vpt_tpu_torch.core import phase as tphase
from vpt_tpu_torch.core import tonemap as ttone
from vpt_tpu_torch.core import vecmath as tvec
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.scene.geometry import _sphere_roots as t_sphere_roots


def _rays(seed, n=512):
    """Origins inside, on the surface of and outside the unit-ish box;
    directions uniform on the sphere."""
    r = np.random.default_rng(seed)
    o = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[: n // 4] = r.uniform(-0.9, 0.9, (n // 4, 3))      # inside
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aabb_intersect(seed):
    o, d = _rays(seed)
    lo = np.array([-1.0, -1.5, -0.5], np.float32)
    hi = np.array([1.0, 0.5, 2.0], np.float32)
    jh, jt0, jt1 = jvec.aabb_intersect(jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(o), jnp.asarray(d))
    th, tt0, tt1 = tvec.aabb_intersect(_t(lo), _t(hi), _t(o), _t(d))
    jh = np.asarray(jh)
    assert jh.any() and (~jh).any()            # hits and misses
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(tt0.numpy(), np.asarray(jt0), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tt1.numpy(), np.asarray(jt1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        tvec.aabb_contains(_t(lo), _t(hi), _t(o)).numpy(),
        np.asarray(jvec.aabb_contains(jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(o))))


@pytest.mark.parametrize("seed", [0, 1])
def test_sphere_roots(seed):
    o, d = _rays(seed)
    c = np.array([0.3, -0.2, 0.5], np.float32)
    rad = np.float32(1.1)
    jh, jt0, jt1 = j_sphere_roots(jnp.asarray(c), jnp.asarray(rad),
                                  jnp.asarray(o), jnp.asarray(d))
    th, tt0, tt1 = t_sphere_roots(_t(c), torch.tensor(rad), _t(o), _t(d))
    jh = np.asarray(jh)
    assert jh.any() and (~jh).any()
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(tt0.numpy()[jh], np.asarray(jt0)[jh],
                               rtol=1e-5, atol=1e-5)


def test_vector_helpers():
    r = np.random.default_rng(5)
    a = r.normal(size=(64, 3)).astype(np.float32)
    b = r.normal(size=(64, 3)).astype(np.float32)
    m = r.normal(size=(4, 4)).astype(np.float32)
    A, B = jnp.asarray(a), jnp.asarray(b)
    pairs = [(tvec.normalize(_t(a)), jvec.normalize(A)),
             (tvec.cross(_t(a), _t(b)), jvec.cross(A, B)),
             (tvec.reflect(_t(a), _t(b)), jvec.reflect(A, B)),
             (tvec.length(_t(a)), jvec.length(A)),
             (tvec.transform_point(_t(m), _t(a)),
              jvec.transform_point(jnp.asarray(m), A))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    for az, el in ((150.0, 30.0), (0.0, 90.0), (400.0, -100.0)):
        np.testing.assert_allclose(
            tvec.degree_to_cartesian(az, el).numpy(),
            np.asarray(jvec.degree_to_cartesian(az, el)), atol=1e-7)


@pytest.mark.parametrize("g1,g2,f,double", [(0.0, 0.0, 1.0, False),
                                            (0.6, 0.0, 1.0, False),
                                            (-0.4, 0.0, 1.0, False),
                                            (0.7, -0.3, 0.6, True)])
def test_phase_eval_and_sample(g1, g2, f, double):
    kw = dict(phase_g1=g1, phase_g2=g2, phase_f=f, use_double_hg=double)
    jp, tp = JParams(**kw), TParams(**kw)
    r = np.random.default_rng(3)
    cos = r.uniform(-1, 1, 256).astype(np.float32)
    np.testing.assert_allclose(
        tphase.phase_eval(tp, _t(cos)).numpy(),
        np.asarray(jphase.phase_eval(jp, jnp.asarray(cos))),
        rtol=1e-6, atol=1e-6)
    d = r.normal(size=(256, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 7)
    jd, jv = jphase.phase_sample(jp, jnp.asarray(d), key)
    td, tv = tphase.phase_sample(tp, _t(d), tuple(int(k) for k in
                                                   np.asarray(key)))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_camera_make_and_get_rays(aperture):
    kw = dict(vup=(0.0, 1.0, 0.0), vfov=35.0, aspect=16 / 9,
              aperture=aperture)
    jc = jcam.Camera.make([1.0, 2.0, 6.0], [0.2, 0.1, -0.3], **kw)
    tc = tcam.Camera.make([1.0, 2.0, 6.0], [0.2, 0.1, -0.3], **kw,
                          device="cpu")
    for name in ("origin", "lower_left_corner", "horizontal", "vertical",
                 "u", "v", "w", "lens_radius", "focus_dist"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-6)
    r = np.random.default_rng(4)
    s = r.uniform(0, 1, 300).astype(np.float32)
    t = r.uniform(0, 1, 300).astype(np.float32)
    key = jax.random.PRNGKey(21)
    jo, jd = jc.get_rays(jnp.asarray(s), jnp.asarray(t), key)
    to, td = tc.get_rays(_t(s), _t(t), tuple(int(k) for k in
                                             np.asarray(key)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def test_tonemap():
    r = np.random.default_rng(8)
    rgb = np.abs(r.normal(size=(32, 32, 3)) * 2).astype(np.float32)
    np.testing.assert_allclose(
        ttone.aces_tonemap(_t(rgb), 1.3).numpy(),
        np.asarray(jtone.aces_tonemap(jnp.asarray(rgb), 1.3)), atol=1e-6)
    np.testing.assert_allclose(
        ttone.gamma_encode(_t(rgb)).numpy(),
        np.asarray(jtone.gamma_encode(jnp.asarray(rgb))), atol=1e-6)
    got = ttone.to_display(_t(rgb)).numpy().astype(int)
    want = np.asarray(jtone.to_display(jnp.asarray(rgb))).astype(int)
    assert np.abs(got - want).max() <= 1
