"""The port's scene builder against vpt_tpu's build_scene +
attach_shadow_cache: the 8 taps, T_box and box extents exactly, the
baked taus within rtol 1e-4, the fBm fill within atol 1e-5."""

import numpy as np
import pytest
import torch

from tests.golden_scenes import _blob
from tests.torch_parity import jax_scene_arrays
from vpt_tpu.accel import shadow as jshadow
from vpt_tpu.lights.lights import PointLights as JLights
from vpt_tpu.scene.scene import build_scene as jbuild
from vpt_tpu.volume import procedural as jproc
from vpt_tpu_torch.accel import shadow as tshadow
from vpt_tpu_torch.lights.lights import PointLights as TLights
from vpt_tpu_torch.scene.convert import scene_from_arrays, scene_to_arrays
from vpt_tpu_torch.scene.scene import build_scene as tbuild
from vpt_tpu_torch.volume import grid as tgrid
from vpt_tpu_torch.volume import procedural as tproc

PROC_KW = dict(vmin=(-16.0, -16.0, -16.0), vmax=(16.0, 16.0, 16.0),
               res=1.0, scale=0.05, seed=123)
TAU_RTOL, TAU_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def grids():
    return {"blob24": (_blob(), [3.0, 4.0, 5.0]),
            "proc32": (jproc.create_procedural_grid(**PROC_KW),
                       [0.0, 24.0, 24.0])}


@pytest.fixture(scope="module")
def built(grids):
    out = {}
    for name, (g, lp) in grids.items():
        js = jshadow.attach_shadow_cache(
            jbuild([g], lights=JLights.make([lp], [[1, 1, 1]], [50.0])),
            150.0, 30.0)
        ts = tshadow.attach_shadow_cache(
            tbuild([g], lights=TLights.make([lp], [[1, 1, 1]], [50.0],
                                             device="cpu"),
                   device="cpu"),
            150.0, 30.0)
        out[name] = (js, ts)
    return out


def test_fbm_fill_matches():
    jg = jproc.create_procedural_grid(**PROC_KW)
    tg = tproc.create_procedural_grid(**PROC_KW, device="cpu")
    assert (jg.density_zyx > 0).mean() > 0.1
    np.testing.assert_allclose(tg.density_zyx, jg.density_zyx, atol=1e-5)
    assert tg.max_density == pytest.approx(jg.max_density, abs=1e-5)
    np.testing.assert_array_equal(tg.dim, jg.dim)
    np.testing.assert_array_equal(tg.transform, jg.transform)


def test_hash_wraps_negative_lattice():
    """The lattice hash is uint32 arithmetic on negative ints too."""
    import jax.numpy as jnp
    r = np.random.default_rng(0)
    ix, iy, iz = (r.integers(-2**31, 2**31 - 1, 200) for _ in range(3))
    want = np.asarray(jproc._hash3(jnp.asarray(ix, jnp.int32),
                                   jnp.asarray(iy, jnp.int32),
                                   jnp.asarray(iz, jnp.int32), 123))
    got = tproc._hash3(torch.as_tensor(ix), torch.as_tensor(iy),
                       torch.as_tensor(iz), 123).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("name", ["blob24", "proc32"])
def test_corner_rows_exact(built, name):
    js, ts = built[name]
    jc = np.asarray(js.atlas.density_corners)
    tc = ts.atlas.density_corners.numpy()
    assert jc.shape == tc.shape == (jc.shape[0], 15 + 8 * 2)
    np.testing.assert_array_equal(tc[:, :15], jc[:, :15])
    for f in ("root_pmin", "root_pmax", "max_extinction", "min_extinction"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in ("xform", "inv_xform", "pmin", "pmax", "packed_rows"):
        np.testing.assert_array_equal(getattr(ts.instances, f).numpy(),
                                      np.asarray(getattr(js.instances, f)))


@pytest.mark.parametrize("name", ["blob24", "proc32"])
def test_taus_match(built, name):
    js, ts = built[name]
    jt = np.asarray(js.atlas.density_corners)[:, 15:]
    tt = ts.atlas.density_corners.numpy()[:, 15:]
    assert jt.max() > 0.5
    np.testing.assert_allclose(tt, jt, rtol=TAU_RTOL, atol=TAU_ATOL)


def test_big_layout_bake_matches():
    """tau_downsample=2 runs the >= 32 M-voxel layout: a 2x pooled proxy,
    240x480 angular cells and 2-voxel radial steps."""
    g = _blob()
    lp = [[3.0, 4.0, 5.0]]
    js = jshadow.attach_shadow_cache(
        jbuild([g], lights=JLights.make(lp, [[1, 1, 1]], [50.0])),
        150.0, 30.0, tau_downsample=2)
    ts = tshadow.attach_shadow_cache(
        tbuild([g], lights=TLights.make(lp, [[1, 1, 1]], [50.0], device="cpu"),
               device="cpu"),
        150.0, 30.0, tau_downsample=2)
    np.testing.assert_allclose(ts.atlas.density_corners.numpy()[:, 15:],
                               np.asarray(js.atlas.density_corners)[:, 15:],
                               rtol=TAU_RTOL, atol=TAU_ATOL)


def test_pool_and_upsample_match():
    r = np.random.default_rng(2)
    a = r.uniform(0, 1, (7, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(tshadow._downsample2(torch.as_tensor(a)),
                               jshadow._downsample2(a), rtol=1e-6)
    np.testing.assert_allclose(
        tshadow._upsample_tau(torch.as_tensor(a), (14, 12, 10), 2.0),
        jshadow._upsample_tau(a, (14, 12, 10), 2.0), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("band", [0.0, 0.2])
def test_torch_sweep_equals_native(grids, band):
    """The torch box-growth sweep grows the same boxes as
    native/vdb_codec.cpp, loaded through the reference's own loader."""
    from scipy import ndimage

    from vpt_tpu.utils.compression import _load_native
    occ = grids["proc32"][0].density_zyx > band
    nz, ny, nx = occ.shape
    zz, yy, xx = np.nonzero(~occ)
    cheb = ndimage.distance_transform_cdt(~occ, metric="chessboard")
    r = np.ascontiguousarray(np.maximum(cheb[zz, yy, xx] - 1, 0), np.int32)
    ii = np.zeros((nz + 1, ny + 1, nx + 1), np.int32)
    ii[1:, 1:, 1:] = occ.astype(np.int32).cumsum(0).cumsum(1).cumsum(2)
    coords = np.ascontiguousarray(np.stack([xx, yy, zz]).astype(np.int32))
    dll = _load_native()
    assert dll, "native/build/libvdb_codec.so did not build"
    native = np.empty((6, coords.shape[1]), np.int32)
    assert dll.grow_empty_boxes(ii.ctypes.data, coords.ctypes.data,
                                r.ctypes.data, coords.shape[1], nx, ny, nz,
                                native.ctypes.data) == 0
    sweep = tgrid._grow_boxes_sweep(ii.reshape(-1), coords, r, nx, ny, nz,
                                    "cpu")
    assert native.max() > 0
    np.testing.assert_array_equal(sweep, native)


def test_scene_from_arrays_round_trip(built):
    js, ts = built["blob24"]
    arrays = jax_scene_arrays(js)
    conv = scene_from_arrays(arrays, device="cpu")
    back = scene_to_arrays(conv)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(arrays[k], v.dtype),
                                      err_msg=k)
    again = scene_to_arrays(scene_from_arrays(scene_to_arrays(ts),
                                               device="cpu"))
    for k, v in scene_to_arrays(ts).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_out_of_slice_scenes_raise(grids):
    """What the port still refuses: octant columns or bfloat16 rows on an
    instanced scene (ROADMAP A.10); two grids build (one instance each,
    the static loop: the majorant grid's packed rows, no lists), and a
    single grid's rows of the reference with both are carried over."""
    g = grids["blob24"][0]
    two = tbuild([g, g], device="cpu")
    assert two.instances.count == 2 and two.majorant.cell_rows is None
    assert two.atlas.offset.tolist() == [0, g.density_zyx.size]
    with pytest.raises(NotImplementedError, match="A.10"):
        tbuild([g, g], corner_dtype="bfloat16", device="cpu")
    small = _blob(n=8, emission=True, color=True)
    ids = [0] * 9
    xf = [np.diag([0.2, 0.2, 0.2, 1.0]) for _ in ids]
    for kw in (dict(octant_boxes=True), dict(corner_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            tbuild([_blob(n=8)], instance_grid_ids=ids, instance_xforms=xf,
                   device="cpu", **kw)
    conv = scene_from_arrays(jax_scene_arrays(jbuild(
        [small], octant_boxes=True, corner_dtype="bfloat16")), device="cpu")
    assert conv.atlas.octant_cols == 72
    assert conv.atlas.density_corners.dtype == torch.bfloat16
