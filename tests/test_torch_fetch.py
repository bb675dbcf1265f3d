"""The port's corner-row fetch against vpt_tpu's _unified_fetch_single at
random in-box, out-of-box and face positions, banded and not, with and
without the cached taus (rtol 1e-5), on the identical tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import _blob
from tests.torch_parity import jax_scene_arrays
from vpt_tpu.accel.shadow import attach_shadow_cache
from vpt_tpu.lights.lights import PointLights
from vpt_tpu.render import tracking as jtrack
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.scene.scene import build_scene
from vpt_tpu_torch.render import tracking as ttrack
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.scene.convert import scene_from_arrays


@pytest.fixture(scope="module")
def scenes():
    js = attach_shadow_cache(build_scene(
        [_blob()], lights=PointLights.make([[3.0, 4.0, 5.0]], [[1, 1, 1]],
                                           [50.0])), 150.0, 30.0)
    return js, scene_from_arrays(jax_scene_arrays(js), device="cpu")


def _positions(js, seed):
    """World positions inside the grid box, outside it, and exactly on
    its faces; unit directions (some axis-aligned)."""
    r = np.random.default_rng(seed)
    lo = np.asarray(js.instances.pmin[0])
    hi = np.asarray(js.instances.pmax[0])
    n = 300
    inside = r.uniform(lo, hi, (n, 3))
    outside = r.uniform(lo - 3.0, hi + 3.0, (n, 3))
    face = r.uniform(lo, hi, (n, 3))
    axis = r.integers(0, 3, n)
    face[np.arange(n), axis] = np.where(r.random(n) < 0.5, lo[axis],
                                        hi[axis])
    pos = np.concatenate([inside, outside, face]).astype(np.float32)
    d = r.normal(size=pos.shape)
    d[:50] = np.eye(3)[r.integers(0, 3, 50)] * np.sign(r.normal(size=(50, 1)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return pos, d


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("with_tau", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fetch_matches(scenes, banded, with_tau, seed):
    js, ts = scenes
    pos, d = _positions(js, seed)
    want = jtrack._unified_fetch_single(js, JParams(), jnp.asarray(pos),
                                        jnp.asarray(d), with_tau=with_tau,
                                        banded=banded)
    got = ttrack._unified_fetch_single(ts, TParams(), torch.as_tensor(pos),
                                       torch.as_tensor(d), with_tau=with_tau,
                                       banded=banded)
    assert len(got) == len(want)
    dens = np.asarray(want[0])
    assert (dens > 0).any() and (dens == 0).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_density_color_lut(scenes):
    js, ts = scenes
    r = np.random.default_rng(4)
    lut = r.uniform(0, 2, (256, 3)).astype(np.float32)
    import dataclasses
    js2 = dataclasses.replace(js, density_color_lut=jnp.asarray(lut))
    ts2 = dataclasses.replace(ts, density_color_lut=torch.as_tensor(lut))
    dens = r.uniform(-0.1, 1.2, 500).astype(np.float32)
    kw = dict(emission_pivot=0.7)
    np.testing.assert_array_equal(
        ttrack.density_color_lut(ts2, TParams(**kw),
                                 torch.as_tensor(dens)).numpy(),
        np.asarray(jtrack.density_color_lut(js2, JParams(**kw),
                                            jnp.asarray(dens))))


def test_no_cache_raises(scenes):
    js, _ = scenes
    bare = scene_from_arrays(jax_scene_arrays(build_scene([_blob()])),
                             device="cpu")
    p = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        ttrack._unified_fetch_single(bare, TParams(), p, p + 1.0,
                                     with_tau=True, banded=True)
