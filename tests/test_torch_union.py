"""Union grids (vpt_tpu_torch/volume/union.py) against vpt_tpu, on the CPU.

resample_union_grid's fields, exact_density_at, union_field_error,
union_error_at_resolution and choose_union_resolution equal the
reference's exactly (the same float64 coordinates, each tap rounded to
float32 as the reference's numpy rounds it, the instances added in the
same order); build_union_scene's corner rows bit for bit; and a union
render within tests/test_union.py's bound of the exact instanced render
(the image means within 8%, both rendered by the port).  Small sizes:
grids of 6-12^3, 12 instances, union resolutions of 16-48.
"""

import dataclasses

import numpy as np
import pytest

from tests.golden_scenes import _blob, _camera
from tests.torch_parity import jax_scene_arrays
from vpt_tpu.scene.scene import build_scene as jbuild
from vpt_tpu.volume import union as ju
from vpt_tpu_torch.accel.shadow import attach_shadow_cache
from vpt_tpu_torch.render.params import Environment, RenderParams
from vpt_tpu_torch.render.renderer import ProgressiveRenderer
from vpt_tpu_torch.scene.convert import scene_from_arrays
from vpt_tpu_torch.volume import union as tu

RENDER_MEAN_REL = 0.08   # tests/test_union.py::test_union_render_matches_exact


def _scene(ext):
    """12 instances of a 10^3 blob (with emission and color where
    ``ext``) and an 8^3 one, alternating, scaled 0.7-1.3 and scattered
    over a 4^3 box from seed 1 (reference HostGrids)."""
    rng = np.random.RandomState(1)
    grids = [_blob(n=10, emission=ext, color=ext), _blob(n=8)]
    ids, xforms = [], []
    for i in range(12):
        xf = np.diag([0.2, 0.2, 0.2, 1.0]) * rng.uniform(0.7, 1.3)
        xf[3, 3] = 1.0
        xf[3, :3] = rng.uniform(0.0, 4.0, 3)
        ids.append(i % 2)
        xforms.append(xf)
    return grids, ids, xforms


RESAMPLE_CASES = [(ext, res) for ext in (False, True) for res in (16, 40)]


@pytest.mark.parametrize("ext,res", RESAMPLE_CASES,
                         ids=[f"{'ext' if e else 'density'}_{r}"
                              for e, r in RESAMPLE_CASES])
def test_resample_union_grid_exact(ext, res):
    """Density and emission summed, color the max from 0, on every voxel
    of the world grid, bit for bit; the grid's dims, transform and
    bounds equal."""
    grids, ids, xforms = _scene(ext)
    want = ju.resample_union_grid(grids, ids, xforms, res)
    got = tu.resample_union_grid(grids, ids, xforms, res, device="cpu")
    for f in ("density_zyx", "emission_zyx", "color_zyx", "bbox_min", "dim",
              "transform"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None) == (not ext and f != "density_zyx"
                                               and f.endswith("_zyx"))
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.voxel_size, got.max_density, got.min_density) == (
        want.voxel_size, want.max_density, want.min_density)
    assert want.density_zyx.max() > 0.5


def test_exact_density_and_field_error_exact():
    """exact_density_at at 600 points (float64, summed in instance order)
    and union_field_error of a built union grid equal the reference's."""
    grids, ids, xforms = _scene(True)
    pts = ju._sample_points(grids, ids, xforms, 600, 4)
    np.testing.assert_array_equal(
        tu.exact_density_at(grids, ids, xforms, pts, device="cpu"),
        ju.exact_density_at(grids, ids, xforms, pts))
    u = ju.resample_union_grid(grids, ids, xforms, 24)
    assert tu.union_field_error(u, grids, ids, xforms, n=300,
                                device="cpu") == ju.union_field_error(
        u, grids, ids, xforms, n=300)


@pytest.mark.parametrize("res", [16, 24, 48])
def test_union_error_at_resolution_exact(res):
    """The error estimate at a resolution without building the grid,
    equal to the reference's."""
    grids, ids, xforms = _scene(False)
    got = tu.union_error_at_resolution(grids, ids, xforms, res, n=256,
                                       seed=3, device="cpu")
    assert got == ju.union_error_at_resolution(grids, ids, xforms, res,
                                               n=256, seed=3)
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("budget", [0.15, 1e-6])
def test_choose_union_resolution_exact(budget):
    """The coarsest candidate within the budget, or the finest with its
    error when none is: the reference's pick and error."""
    grids, ids, xforms = _scene(False)
    kw = dict(candidates=(12, 24, 40), n=128, seed=2)
    got = tu.choose_union_resolution(grids, ids, xforms, budget,
                                     device="cpu", **kw)
    assert got == ju.choose_union_resolution(grids, ids, xforms, budget,
                                             **kw)
    assert got[0] == 40 if budget < 1e-3 else got[1] <= budget


def test_build_union_scene_rows_exact():
    """build_union_scene's corner rows (float32, with the octant columns)
    and root box bit for bit the reference's; its default rows are
    bfloat16."""
    grids, ids, xforms = _scene(True)
    kw = dict(resolution=20, corner_dtype="float32", octant_boxes=True)
    want = ju.build_union_scene(grids, ids, xforms, **kw)
    got = tu.build_union_scene(grids, ids, xforms, device="cpu", **kw)
    np.testing.assert_array_equal(got.atlas.density_corners.numpy(),
                                  np.asarray(want.atlas.density_corners))
    for f in ("root_pmin", "root_pmax", "max_extinction"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.atlas.octant_cols == 72 and got.instances.count == 1
    default = tu.build_union_scene(grids, ids, xforms, resolution=12,
                                   device="cpu")
    assert str(default.atlas.density_corners.dtype) == "torch.bfloat16"


@pytest.mark.parametrize("cached", [False, True])
def test_union_render_matches_exact(cached):
    """The port's union scene (resolution 64, float32 rows) renders 32x32,
    8 spp, CONSTANT, within RENDER_MEAN_REL of the port's exact instanced
    render of the same 12 instances (cell-less: the static loop), tracked
    or, on the union, cached."""
    grids, ids, xforms = _scene(False)
    exact = scene_from_arrays(jax_scene_arrays(_camera(jbuild(
        grids, instance_grid_ids=ids, instance_xforms=xforms,
        majorant_resolution=16, instance_list_threshold=16))), device="cpu")
    uscene = tu.build_union_scene(grids, ids, xforms, resolution=64,
                                  corner_dtype="float32", device="cpu")
    uscene = dataclasses.replace(uscene, camera=exact.camera)
    params = RenderParams(width=32, height=32, ray_depth=4,
                          max_fused_steps=256,
                          environment_type=int(Environment.CONSTANT))
    uparams = params
    if cached:
        uscene = attach_shadow_cache(uscene, azimuth=150.0, elevation=30.0)
        uparams = params.replace(shadow_mode="cached")
    a = ProgressiveRenderer(exact, params).render(8).accum.numpy()
    b = ProgressiveRenderer(uscene, uparams).render(8).accum.numpy()
    assert np.isfinite(b).all() and a.mean() > 0
    assert abs(b.mean() - a.mean()) / a.mean() < RENDER_MEAN_REL, (
        a.mean(), b.mean())
