"""bfloat16 corner rows and a single grid's octant columns in the port
against vpt_tpu, on the CPU: the rows bit for bit (as 16-bit patterns) on
the bench's 24^3 puff with emission and with color; the box extents
rounded down where the reference's round to nearest (a 4 x 4 x 600 grid,
where the reference's over-claim); each row's taps at most its T_box;
the fetch at random positions and directions; fused_direct ray by ray on
small config-2 (emission, BLACK), config-3 (color, HDRI) and config-4
(the Bruneton atmosphere on the golden tiny LUTs) scenes in both shadow
modes; the arrays carried both ways; and that the port never imports
ml_dtypes.

Scenes are built by the reference's build_scene with
``octant_boxes=True, corner_dtype="bfloat16"``, as bench.py builds
configs 2-4, and carried over by scene_from_arrays, so both packages
render the identical rows.  Tolerances are test_torch_fused.py's (the
atmosphere's radiance at test_torch_atmosphere.py's SKY_RTOL): a ray
agrees when L is within rtol 1e-4 + atol 1e-6, alpha within 1e-5 and cost
and unfinished are equal; >= 99% of rays agree and the image means within
0.5%.  The fetch within rtol 1e-5, as test_torch_fetch.py's.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden_scenes import _camera
from tests.test_torch_atmosphere import GOLDEN_LUTS, J_TINY, SKY_RTOL
from tests.torch_parity import agreement, jax_scene_arrays
from vpt_tpu.accel.shadow import attach_shadow_cache as j_bake
from vpt_tpu.render import tracking as j_tracking
from vpt_tpu.render.fused import fused_direct as j_fused
from vpt_tpu.render.params import Environment as JEnv
from vpt_tpu.render.params import RenderParams as JParams
from vpt_tpu.scene import scene as j_scene
from vpt_tpu.volume import grid as jgrid
from vpt_tpu_torch.accel.shadow import attach_shadow_cache as t_bake
from vpt_tpu_torch.render import fused as t_fused
from vpt_tpu_torch.render import tracking as t_tracking
from vpt_tpu_torch.render.params import RenderParams as TParams
from vpt_tpu_torch.scene.assets import ramp_lut
from vpt_tpu_torch.scene.convert import scene_from_arrays, scene_to_arrays
from vpt_tpu_torch.scene.scene import build_scene as t_build
from vpt_tpu_torch.tools.common import bench_blob, bench_env_map
from vpt_tpu_torch.volume import grid as tgrid

MIN_SHARE, MAX_MEAN_REL = 0.99, 0.005
ROWS16 = dict(octant_boxes=True, corner_dtype="bfloat16")
# the reference's single-instance walk reads no majorant grid: build none
NO_GRID = dict(majorant_resolution=0)
EXT = slice(9, 87)   # the box extents: symmetric 9:15, octant 15:87
BASE = dict(ray_depth=6, max_fused_steps=256)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_torch_thread():
    """One torch thread for a test that packs rows in torch: the box
    sweeps are many small CPU ops, and with a thread per core each waits
    on the others when test workers share the cores (the 4 x 4 x 600
    build took 89 s on 8 threads and 1.0 s on one, beside 7 busy
    processes).  No result here depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jhost(g):
    """The port's HostGrid as the reference's."""
    return jgrid.HostGrid(**{f.name: getattr(g, f.name)
                             for f in dataclasses.fields(g)})


def _bits(rows):
    """16-bit patterns of bfloat16 rows: the reference's (ml_dtypes) or
    the port's (torch)."""
    if isinstance(rows, torch.Tensor):
        return rows.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(rows).view(np.uint16)


def _wide_grid():
    """4 x 4 x 600 voxels (x longest), density 1 at x < 2: its empty
    boxes reach past 256 voxels, where bfloat16 integers are even only."""
    d = np.zeros((4, 4, 600), np.float32)
    d[:, :, :2] = 1.0
    return tgrid.HostGrid(
        density_zyx=d, emission_zyx=None, color_zyx=None,
        bbox_min=np.zeros(3, np.int32), dim=np.array([600, 4, 4], np.int32),
        transform=np.eye(4), voxel_size=1.0, max_density=1.0,
        min_density=1e-6)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("channel", ["emission", "color"])
def test_rows_bit_for_bit(channel):
    g = bench_blob(n=24, **{channel: True})
    want = jgrid.build_atlas([_jhost(g)], **ROWS16)
    got = tgrid.build_atlas([g], device="cpu", **ROWS16)
    assert got.density_corners.dtype == torch.bfloat16
    assert got.octant_cols == want.octant_cols == 72
    assert tgrid.unified_layout(got) == jgrid.unified_layout(want)
    np.testing.assert_array_equal(_bits(got.density_corners),
                                  _bits(want.density_corners))
    # the octant columns are there: some empty voxel's box reaches out
    assert float(got.density_corners[:, 15:87].float().max()) > 0.0


@pytest.mark.usefixtures("one_torch_thread")
def test_extents_never_over_claim():
    """The reference's bf16 extents round to nearest, above the float32
    count for some of the odd counts past 256 (its fault,
    vpt_tpu/volume/grid.py:576-598); the port's never lie above, and equal
    the reference's bits wherever the reference keeps its guarantee."""
    g = _wide_grid()
    f32 = jgrid.build_atlas([_jhost(g)], octant_boxes=True)
    ref = jgrid.build_atlas([_jhost(g)], **ROWS16)
    got = tgrid.build_atlas([g], device="cpu", **ROWS16)
    exact = np.asarray(f32.density_corners)[:, EXT]
    ref_ext = np.asarray(ref.density_corners).astype(np.float32)[:, EXT]
    got_ext = got.density_corners.float().numpy()[:, EXT]
    assert exact.max() > 256
    assert int((ref_ext > exact).sum()) == 250080   # of 748,800 entries
    assert not (got_ext > exact).any()
    keep = np.ones(ref.density_corners.shape, bool)
    keep[:, EXT] = ref_ext <= exact
    np.testing.assert_array_equal(_bits(got.density_corners)[keep],
                                  _bits(ref.density_corners)[keep])
    # each the largest bfloat16 not above its count: one step up is above
    ext16 = got.density_corners[:, EXT]
    up = (ext16.view(torch.int16) + 1).view(torch.bfloat16).float().numpy()
    free = exact >= 0.0   # -1 marks an occupied voxel, exact in bf16
    assert (up[free] > exact[free]).all()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("grid", ["emission", "wide"])
def test_taps_within_their_bound(grid):
    """Each row's largest tap is at most its T_box, as float32 values,
    though T_box keeps the nearest rounding."""
    g = bench_blob(n=24, emission=True) if grid == "emission" \
        else _wide_grid()
    rows = tgrid.build_atlas([g], device="cpu", **ROWS16).density_corners
    rows = rows.float()
    assert bool((rows[:, :8].amax(1) <= rows[:, 8]).all())
    assert float(rows[:, 8].max()) > 0.0


@pytest.fixture(scope="module")
def configs():
    """{name: (reference scene tracked, cached, environment params)}: the
    bench's configs 2-4 at 24^3 with bf16 rows and octant columns."""
    cams = {}
    c2 = _camera(j_scene.build_scene(
        [_jhost(bench_blob(n=24, emission=True))],
        emission_lut=ramp_lut(), **NO_GRID, **ROWS16))
    cams["config2"] = (c2, dict(environment_type=int(JEnv.BLACK),
                                emission_scale=2.0))
    c3 = j_scene.attach_env_map(_camera(j_scene.build_scene(
        [_jhost(bench_blob(n=24, color=True))], **NO_GRID, **ROWS16)),
        bench_env_map(32, 64))
    cams["config3"] = (c3, dict(environment_type=int(JEnv.HDRI)))
    c4 = j_scene.attach_atmosphere(_camera(j_scene.build_scene(
        [_jhost(bench_blob(n=24))], **NO_GRID, **ROWS16)),
        cache_path=GOLDEN_LUTS,
        dims=J_TINY)
    cams["config4"] = (c4, dict(environment_type=int(JEnv.ATMOSPHERE)))
    return {k: (s, j_bake(s, 150.0, 30.0), kw) for k, (s, kw) in cams.items()}


def _rays(js, n=512, seed=0):
    r = np.random.default_rng(seed)
    c = (np.asarray(js.root_pmin) + np.asarray(js.root_pmax)) / 2
    o = np.tile(np.asarray(js.camera.origin)[None], (n, 1)).astype(np.float32)
    d = c + r.uniform(-0.6, 0.6, (n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("with_tau", [True, False])
def test_fetch_matches(configs, banded, with_tau):
    js = configs["config2"][1]
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    assert ts.atlas.density_corners.dtype == torch.bfloat16
    assert ts.atlas.octant_cols == 72
    r = np.random.default_rng(2)
    lo = np.asarray(js.instances.pmin[0])
    hi = np.asarray(js.instances.pmax[0])
    pos = r.uniform(lo - 0.5, hi + 0.5, (900, 3)).astype(np.float32)
    d = r.normal(size=pos.shape)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    want = j_tracking._unified_fetch_single(
        js, JParams(), jnp.asarray(pos), jnp.asarray(d), with_tau=with_tau,
        banded=banded)
    got = t_tracking._unified_fetch_single(
        ts, TParams(), torch.as_tensor(pos), torch.as_tensor(d),
        with_tau=with_tau, banded=banded)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    if banded and not with_tau:
        # the octant boxes reach further than the symmetric ones
        sym = dataclasses.replace(ts, atlas=dataclasses.replace(
            ts.atlas, octant_cols=0))
        s_sym = t_tracking._unified_fetch_single(
            sym, TParams(), torch.as_tensor(pos), torch.as_tensor(d),
            banded=True)[1]
        assert bool((got[1] > s_sym).any())
        assert bool((got[1] >= s_sym).all())


@pytest.mark.parametrize("mode", ["cached", "tracked"])
@pytest.mark.parametrize("config", ["config2", "config3", "config4"])
def test_walk_ray_by_ray(configs, config, mode):
    tracked, cached, env = configs[config]
    js = cached if mode == "cached" else tracked
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    kw = dict(BASE, shadow_mode=mode, **env)
    o, d = _rays(js)
    key = jax.random.PRNGKey(3)
    want = [np.asarray(x) for x in
            j_fused(js, JParams(**kw), key, jnp.asarray(o), jnp.asarray(d))]
    got = [x.numpy() for x in t_fused.fused_direct(
        ts, TParams(**kw), tuple(int(k) for k in np.asarray(key)),
        torch.as_tensor(o), torch.as_tensor(d))]
    assert want[0].mean() > 0 and want[2].mean() > 1.5
    rtol = SKY_RTOL if config == "config4" else 1e-4
    share, rel = agreement(got, want, rtol=rtol)
    assert share >= MIN_SHARE and rel <= MAX_MEAN_REL, (share, rel)
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.usefixtures("one_torch_thread")
def test_arrays_round_trip():
    """The port's bf16 scene out as a uint16 view with its dtype key and
    back, bit for bit; the taus of its bake in bfloat16, each the nearest
    bfloat16 of the float32 bake's."""
    g = bench_blob(n=16, emission=True)
    f32 = t_bake(t_build([g], device="cpu", octant_boxes=True), 150.0, 30.0)
    s = t_bake(t_build([g], device="cpu", **ROWS16), 150.0, 30.0)
    rows = s.atlas.density_corners
    assert rows.dtype == torch.bfloat16 and rows.shape[1] == 15 + 72 + 8 + 8
    tau_off = tgrid.unified_layout(s.atlas)[2]
    assert torch.equal(rows[:, tau_off:],
                       f32.atlas.density_corners[:, tau_off:].to(
                           torch.bfloat16))
    arrays = scene_to_arrays(s)
    assert arrays["atlas.density_corners"].dtype == np.uint16
    assert str(arrays["atlas.density_corners_dtype"]) == "bfloat16"
    back = scene_from_arrays(arrays, device="cpu")
    assert back.atlas.octant_cols == 72
    assert torch.equal(back.atlas.density_corners.view(torch.int16),
                       rows.view(torch.int16))


@pytest.mark.usefixtures("one_torch_thread")
def test_build_scene_options():
    """``octant_boxes="auto"`` resolves to False, as the reference's; an
    instanced scene with either option raises, in build_scene and, with
    rows swapped for bfloat16 ones, in the walk (K1's CELLS variant and
    the cell fetch read float32 rows)."""
    g = bench_blob(n=8)
    assert t_build([g], device="cpu").atlas.octant_cols == 0
    ids, xf = [0] * 9, []
    for i in range(9):
        xf.append(np.diag([0.1, 0.1, 0.1, 1.0]))
        xf[-1][3, 0] = float(i)
    for kw in (dict(octant_boxes=True), dict(corner_dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="A.10"):
            t_build([g], instance_grid_ids=ids, instance_xforms=xf,
                    device="cpu", **kw)
    ts = t_build([g], instance_grid_ids=ids, instance_xforms=xf,
                 majorant_resolution=16, device="cpu")
    ts = dataclasses.replace(ts, atlas=dataclasses.replace(
        ts.atlas, density_corners=ts.atlas.density_corners.to(
            torch.bfloat16)))
    o = ts.camera.origin.expand(8, 3).contiguous()
    d = torch.nn.functional.normalize(
        (ts.root_pmin + ts.root_pmax) / 2 - o, dim=-1)
    with pytest.raises(NotImplementedError, match="A.10"):
        t_fused.fused_direct(ts, TParams(**BASE), (0, 1), o, d)


def test_port_leaves_out_ml_dtypes():
    """Building, baking and walking a bf16 octant scene imports neither
    ml_dtypes nor jax nor vpt_tpu."""
    code = (
        "import sys, torch\n"
        "from vpt_tpu_torch.accel.shadow import attach_shadow_cache\n"
        "from vpt_tpu_torch.render import fused\n"
        "from vpt_tpu_torch.render.params import RenderParams\n"
        "from vpt_tpu_torch.scene.scene import build_scene\n"
        "from vpt_tpu_torch.tools.common import bench_blob\n"
        "s = attach_shadow_cache(build_scene([bench_blob(n=8)], "
        "device='cpu', octant_boxes=True, corner_dtype='bfloat16'), "
        "150.0, 30.0)\n"
        "o = s.camera.origin.expand(4, 3).contiguous()\n"
        "d = torch.nn.functional.normalize((s.root_pmin + s.root_pmax) / 2 "
        "- o, dim=-1)\n"
        "fused.fused_direct(s, RenderParams(shadow_mode='cached'), (0, 1), "
        "o, d)\n"
        "bad = [m for m in ('ml_dtypes', 'jax', 'vpt_tpu') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
